"""The per-rank progress engine: worker thread, op queue, fusion.

One engine per island rank.  ``submit`` enqueues an op and returns a
:class:`~bluefog_tpu_torch.progress.handles.WinHandle`; the worker thread
drains the queue in FIFO order, coalescing runs of compatible deposits
(same window, same kind, same weights) into one wire op — the
reference's tensor-fusion idea, bounded by ``BFTPU_PROGRESS_FUSION_MB``.
While the queue is idle the worker prefetches in-edge mailboxes so the
caller's next collect runs warm.

Queue state machine (model-checked by the ``progress`` verifier family,
``analysis/progress_rules.py``)::

    SUBMITTED --pop--> EXECUTING --ok--> DONE (handle resolved)
        ^                  |
        |   quiesce/epoch  | requeue (epoch changed under the op)
        +------------------+

Invariants: every submitted op resolves its handle exactly once; ops on
one window execute in submission order; a quiesce (membership-epoch
switch) parks the worker AFTER the in-flight op completes and leaves the
queue intact, so nothing is lost or double-executed across the segment
rebind.

The engine executes ops through a duck-typed ``backend``:

- ``execute(kind, window, payload, weights, kwargs)`` — run one op;
- ``fuse(kind, window, payloads)`` — coalesce deposit payloads
  (optional; default: last-write-wins for ``put``);
- ``prefetch(windows)`` — idle-time mailbox warm-read (optional);
- ``epoch()`` — current membership epoch (optional; enables requeue
  detection when an op fails because the epoch moved under it).

Tests drive the engine in **manual mode** (``start_worker=False``):
no thread is spawned and :meth:`ProgressEngine.step` processes one
batch synchronously — that, plus the injectable ``clock``, makes the
queue/fusion/handle machinery deterministic under test.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from bluefog_tpu_torch.progress.handles import WinHandle
from bluefog_tpu_torch.telemetry import registry as _telemetry

KINDS = ("put", "accumulate", "update")

#: deposits are retried at most this many times across epoch switches
#: before their handle fails — a backstop, not a steady state
MAX_REQUEUES = 3


class Op:
    """One queued window op (internal; callers hold the handle)."""

    __slots__ = ("kind", "window", "payload", "weights", "kwargs",
                 "handle", "seq", "epoch", "submit_ts", "nbytes",
                 "requeues")

    def __init__(self, kind: str, window: str, payload=None, weights=None,
                 kwargs: Optional[Dict[str, Any]] = None, nbytes: int = 0):
        self.kind = kind
        self.window = window
        self.payload = payload
        self.weights = weights
        self.kwargs = dict(kwargs or {})
        self.handle = WinHandle()
        self.seq = -1
        self.epoch = -1
        self.submit_ts = 0.0
        self.nbytes = int(nbytes)
        self.requeues = 0


class ProgressEngine:
    """Background progress engine for one rank (see module docstring)."""

    def __init__(self, backend, *, queue_depth: Optional[int] = None,
                 fusion_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "progress", idle_poll_s: float = 0.002,
                 start_worker: bool = True):
        from bluefog_tpu_torch import progress as _progress

        self._backend = backend
        self._depth = (_progress.queue_depth() if queue_depth is None
                       else max(1, int(queue_depth)))
        self._fusion_bytes = (_progress.fusion_bytes() if fusion_bytes is None
                              else max(0, int(fusion_bytes)))
        self._clock = clock
        self.name = str(name)
        self._idle_poll_s = float(idle_poll_s)
        self._start_worker = bool(start_worker)

        self._q: Deque[Op] = collections.deque()
        self._cv = threading.Condition()
        self._parked = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._quiesced = False
        self._inflight: Optional[str] = None  # "kind:window" while executing
        self._seq = 0

        # plain-int stats (GIL-atomic bumps; mirrored to telemetry)
        self.submitted = 0
        self.executed = 0
        self.fused_batches = 0
        self.fused_ops = 0
        self.requeued = 0
        self.prefetches = 0
        self.queued_s_total = 0.0
        self.windows_seen: set = set()

    # -- submission ------------------------------------------------------

    def submit(self, kind: str, window: str, payload=None, weights=None,
               nbytes: int = 0, **kwargs) -> WinHandle:
        """Enqueue one op; returns its handle.  Blocks (backpressure)
        while the queue is at ``BFTPU_PROGRESS_QUEUE_DEPTH`` — bounded
        memory under a producer that outruns the wire.  ``payload`` may
        be a zero-arg callable: it is materialized on the worker thread,
        which is where a device→host stage belongs."""
        if kind not in KINDS:
            raise ValueError(f"unknown op kind {kind!r}; expected {KINDS}")
        op = Op(kind, window, payload=payload, weights=weights,
                kwargs=kwargs, nbytes=nbytes)
        with self._cv:
            if self._stopping:
                raise RuntimeError("progress engine is stopped")
            # backpressure only in threaded mode: a manual-mode engine
            # has nobody to drain the queue while we wait
            while (self._thread is not None and len(self._q) >= self._depth
                   and not self._stopping):
                self._cv.wait(0.05)
            if self._stopping:
                raise RuntimeError("progress engine is stopped")
            op.seq = self._seq
            self._seq += 1
            op.submit_ts = self._clock()
            op.epoch = self._backend_epoch()
            self._q.append(op)
            self.submitted += 1
            self.windows_seen.add(window)
            self._cv.notify_all()
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("progress.submitted", kind=kind).inc()
            reg.gauge("progress.queue_depth").set(len(self._q))
        if self._start_worker:
            self._ensure_worker()
        return op.handle

    def _backend_epoch(self) -> int:
        fn = getattr(self._backend, "epoch", None)
        if fn is None:
            return -1
        try:
            return int(fn())
        except Exception:  # noqa: BLE001 - epoch is advisory
            return -1

    def _ensure_worker(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(target=self._run, daemon=True,
                             name=f"bftpu-progress:{self.name}")
        self._thread = t
        t.start()

    # -- quiesce / resume (membership-epoch integration) -----------------

    def quiesce(self, timeout: float = 60.0) -> int:
        """Park the worker: the in-flight op completes, queued ops stay
        queued.  Called by the epoch switch BEFORE the old epoch's shm
        segments close — and by the ORPHAN transition on quorum loss
        (islands._enter_orphan), where no :meth:`resume` follows until
        ``merge_orphan`` re-admits the rank under a fresh epoch.
        Returns the number of ops that will re-execute against the new
        epoch's windows after :meth:`resume`."""
        with self._cv:
            self._quiesced = True
            pending = len(self._q)
            self._cv.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._parked.wait(timeout)
        if pending:
            self.requeued += pending
        reg = _telemetry.get_registry()
        if reg.enabled:
            if pending:
                reg.counter("progress.requeued").add(pending)
            reg.journal("progress_quiesce", pending=pending,
                        inflight=self._inflight or "")
        return pending

    def resume(self) -> None:
        """Unpark after an epoch switch: queued ops resolve their window
        by NAME at execution time, so they land in the new epoch's
        segments with no payload rewrite."""
        with self._cv:
            self._quiesced = False
            self._parked.clear()
            self._cv.notify_all()
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.journal("progress_resume", pending=len(self._q))

    # -- draining / shutdown ---------------------------------------------

    def drain(self, window: Optional[str] = None,
              timeout: Optional[float] = None) -> bool:
        """Wait until no op for ``window`` (all windows when None) is
        queued or in flight.  Manual-mode engines step inline."""
        deadline = None if timeout is None else self._clock() + timeout

        def busy_locked() -> bool:
            if any(window is None or op.window == window for op in self._q):
                return True
            return (self._inflight is not None
                    and (window is None
                         or self._inflight.endswith(f":{window}")))

        while True:
            with self._cv:
                if not busy_locked():
                    return True
                threaded = self._thread is not None and self._thread.is_alive()
                if threaded:
                    self._cv.wait(0.01)
            if not threaded:
                if not self.step():
                    return not self._q
            if deadline is not None and self._clock() > deadline:
                return False

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Shut the engine down.  ``drain=True`` executes the remaining
        queue first; otherwise queued handles fail with RuntimeError."""
        dropped: List[Op] = []
        with self._cv:
            if not drain:
                dropped = list(self._q)
                self._q.clear()
            self._stopping = True
            self._quiesced = False
            self._parked.clear()
            self._cv.notify_all()
        for op in dropped:
            if not op.handle.done():
                op.handle._fail(RuntimeError("progress engine stopped"))
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if drain:
            while self._q:  # manual mode (or a worker that never started)
                if not self.step():
                    break

    @property
    def stopped(self) -> bool:
        return self._stopping

    # -- worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch: Optional[List[Op]] = None
            prefetch = False
            with self._cv:
                while True:
                    if self._quiesced and not self._stopping:
                        self._parked.set()
                        self._cv.wait()
                        continue
                    self._parked.clear()
                    if self._q:
                        batch = self._pop_batch_locked()
                        break
                    if self._stopping:
                        return
                    timed_out = not self._cv.wait(self._idle_poll_s)
                    if timed_out and not self._q and not self._stopping \
                            and not self._quiesced:
                        prefetch = True
                        break
            if prefetch:
                self._do_prefetch()
                continue
            self._execute(batch)

    def step(self) -> int:
        """Manual mode: process one batch on the calling thread.
        Returns the number of ops processed (0 = queue empty or
        quiesced)."""
        with self._cv:
            if not self._q or self._quiesced:
                return 0
            batch = self._pop_batch_locked()
        self._execute(batch)
        return len(batch)

    def _pop_batch_locked(self) -> List[Op]:
        first = self._q.popleft()
        batch = [first]
        # put always fuses (last-write-wins needs no backend help);
        # accumulate only when the backend can actually sum payloads
        fusable = (first.kind == "put"
                   or (first.kind == "accumulate"
                       and getattr(self._backend, "fuse", None) is not None))
        if fusable and self._fusion_bytes > 0:
            budget = self._fusion_bytes - max(first.nbytes, 0)
            while self._q:
                nxt = self._q[0]
                # fuse only a CONTIGUOUS run of compatible ops: stopping
                # at the first mismatch is what preserves per-window
                # submission order (progress.fusion-order rule)
                if (nxt.kind != first.kind or nxt.window != first.window
                        or nxt.weights != first.weights
                        or nxt.kwargs != first.kwargs
                        or nxt.nbytes > budget):
                    break
                budget -= nxt.nbytes
                batch.append(self._q.popleft())
        self._inflight = f"{first.kind}:{first.window}"
        return batch

    def _fuse_payloads(self, kind: str, window: str, payloads: List[Any]):
        fuse = getattr(self._backend, "fuse", None)
        if fuse is not None:
            return fuse(kind, window, payloads)
        # last-write-wins is always correct for put (each deposit
        # overwrites the slot); accumulate NEEDS a backend fuse, so
        # without one we refuse to coalesce (callers see per-op results)
        if kind == "put":
            return payloads[-1]
        raise TypeError("backend has no fuse(); cannot coalesce "
                        f"{len(payloads)} {kind} ops")

    def _execute(self, batch: List[Op]) -> None:
        from bluefog_tpu_torch.progress import staging
        from bluefog_tpu_torch.tracing import tracer as _tracing

        first = batch[0]
        tr = _tracing.get_tracer()
        ttok = (tr.begin(f"progress.{first.kind}", window=first.window)
                if tr.enabled else None)
        reg = _telemetry.get_registry()
        try:
            with staging.worker_scope():
                payloads = [op.payload() if callable(op.payload)
                            else op.payload for op in batch]
                if first.kind == "update":
                    payload = None
                elif len(payloads) == 1:
                    payload = payloads[0]
                else:
                    payload = self._fuse_payloads(first.kind, first.window,
                                                  payloads)
                result = self._backend.execute(
                    first.kind, first.window, payload, first.weights,
                    first.kwargs)
        except Exception as e:  # noqa: BLE001 - resolved via handle/requeue
            if self._maybe_requeue(batch):
                if ttok is not None:
                    tr.end(ttok)
                return
            for op in batch:
                if not op.handle.done():
                    op.handle._fail(e)
        else:
            now = self._clock()
            for op in batch:
                self.queued_s_total += max(0.0, now - op.submit_ts)
                if not op.handle.done():
                    op.handle._complete(result)
            self.executed += len(batch)
            if reg.enabled:
                reg.counter("progress.executed",
                            kind=first.kind).add(len(batch))
                if len(batch) > 1:
                    reg.counter("progress.fused_batches").inc()
                    reg.counter("progress.fused_ops").add(len(batch) - 1)
            if len(batch) > 1:
                self.fused_batches += 1
                self.fused_ops += len(batch) - 1
        finally:
            if ttok is not None:
                tr.end(ttok)
            with self._cv:
                self._inflight = None
                self._cv.notify_all()
            if reg.enabled:
                reg.gauge("progress.queue_depth").set(len(self._q))

    def _maybe_requeue(self, batch: List[Op]) -> bool:
        """An op that failed because the membership epoch moved under it
        (quiesce raced the submit) goes back to the FRONT of the queue —
        same per-window order — up to MAX_REQUEUES times."""
        ep = self._backend_epoch()
        if ep < 0:
            return False
        stale = [op for op in batch if op.epoch != ep]
        if not stale or any(op.requeues >= MAX_REQUEUES for op in batch):
            return False
        for op in batch:
            op.requeues += 1
            op.epoch = ep
        with self._cv:
            self._q.extendleft(reversed(batch))
            self._cv.notify_all()
        self.requeued += len(batch)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("progress.requeued").add(len(batch))
        return True

    def _do_prefetch(self) -> None:
        fn = getattr(self._backend, "prefetch", None)
        if fn is None or not self.windows_seen:
            return
        try:
            n = int(fn(tuple(sorted(self.windows_seen))) or 0)
        except Exception:  # noqa: BLE001 - prefetch must never kill the worker
            n = 0
        if n:
            self.prefetches += n
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("progress.prefetch_reads").add(n)

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Live stats for the status page / ``bftpu-top``."""
        return {
            "queue_depth": len(self._q),
            "inflight": self._inflight,
            "submitted": self.submitted,
            "executed": self.executed,
            "fused_batches": self.fused_batches,
            "fused_ops": self.fused_ops,
            "requeued": self.requeued,
            "prefetches": self.prefetches,
            "queued_s_total": self.queued_s_total,
        }
