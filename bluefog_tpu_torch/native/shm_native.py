"""Shared-memory mailbox veneer (shm_mailbox.cc) + pure-Python fallback.

Counterpart of ``bluefog_tpu/native/shm_native.py``, with the same segment
layout and ABI (a window one package writes, the other reads).
Process-to-process transport for the asynchronous island window ops
(:mod:`bluefog_tpu_torch.islands`) — the sibling of the reference's
passive-target MPI RMA windows (``MPI_Win_create/Put/Accumulate/lock`` in
``bluefog/common/mpi_controller.cc`` [U]).  The native path is a chunked
seqlock mailbox in POSIX shm (protocol v2): each slot's payload is divided
into ``chunk_bytes`` chunks, each guarded by its own seqlock and committed
in ascending order, so a pipelined consumer can chase the commit frontier;
collect/reset drain via an O(1) ``drained`` version marker instead of a
zeroing pass; deposits fuse an optional ``scale`` into the copy loop and
``combine`` fuses the reader-side ``acc += weight * payload`` — the three
sequential payload traversals of the v1 protocol collapse into ~one.  The
fallback implements the same interface over an mmap'd file with
``fcntl.lockf`` byte-range locks — slower, zero native deps, used only when
``BLUEFOG_SHM_FALLBACK=1`` asks for it (:func:`transport_kind`); a native
library that cannot be built raises.

Both paths share slot geometry: per window, ``nranks`` exposed slots (the
owner-published tensor ``win_get`` reads) followed by ``nranks × maxd``
mailbox slots (slot ``(d, k)`` = last deposit from d's k-th in-neighbor).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import re
import struct
import time
from typing import Optional, Tuple

import numpy as np

from bluefog_tpu_torch.native import get_lib, loaded_lib
from bluefog_tpu_torch.native import capabilities as _caps
from bluefog_tpu_torch.telemetry import registry as _telemetry

_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2}


#: A mutex wait is "contended" (worth a per-holder counter + trace
#: instant) past this many nanoseconds; uncontended acquires stay on the
#: aggregate counters only, so the hot path adds no label lookups.
_CONTENDED_WAIT_NS = 1_000_000


def _timed_mutex_acquire(acquire, rank: int, timeout: Optional[float],
                         holders=None, me: int = -1):
    """Run a transport's raw mutex acquire under telemetry timing: total
    wall nanoseconds spent waiting (``shm.mutex_wait_ns``), acquire count,
    and timeout count — the contention signals docs/OBSERVABILITY.md
    points at when win_mutex latency climbs.

    With a ``holders`` board (:class:`HolderBoard`) the wait additionally
    attributes to the *current holder* — the rank whose release we are
    actually waiting on, which under lock-all gossip is usually NOT the
    window owner ``rank``: the holder word is sampled at wait start, a
    contended wait bumps ``shm.mutex_wait_by_holder{holder=..}`` and
    emits a ``mutex_wait`` trace instant carrying the holder rank, and
    the board is stamped with ``me`` after a successful acquire.
    Returns the holder rank observed at wait start (None when free,
    unknown, or it was us)."""
    observed = None
    if holders is not None:
        h = holders.holder(rank)
        if h is not None and h != me:
            observed = h
    reg = _telemetry.get_registry()
    if not reg.enabled and holders is None:
        acquire(rank, timeout)
        return None
    t0 = time.perf_counter_ns()
    try:
        acquire(rank, timeout)
    except TimeoutError:
        if reg.enabled:
            reg.counter("shm.mutex_timeouts").inc()
        raise
    finally:
        wait_ns = time.perf_counter_ns() - t0
        if reg.enabled:
            reg.counter("shm.mutex_wait_ns").add(wait_ns)
            reg.counter("shm.mutex_acquires").inc()
        if observed is not None and wait_ns >= _CONTENDED_WAIT_NS:
            if reg.enabled:
                reg.counter("shm.mutex_wait_by_holder",
                            holder=observed).inc()
            from bluefog_tpu_torch.tracing import tracer as _tracing

            tr = _tracing.get_tracer()
            if tr.enabled:
                tr.instant("mutex_wait", aux=int(observed))
    if holders is not None:
        holders.set_holder(rank, me)
    return observed


def _deposit_counters(obj, reg):
    """Memoized (deposits, chunk_commits) counter pair for a window object.
    Handle lookup costs ~1.5µs each; deposits ride every win op, so the
    write paths cache the live handles on the window, invalidating when
    telemetry is reset to a different registry."""
    cache = getattr(obj, "_tel_cache", None)
    if cache is None or cache[0] is not reg:
        obj._tel_cache = cache = (
            reg, reg.counter("shm.deposits"), reg.counter("shm.chunk_commits"))
    return cache

# ---------------------------------------------------------------------------
# protocol specification (model-checked)
# ---------------------------------------------------------------------------
#
# The seqlock step orders below are the ground truth the static verifier's
# exhaustive interleaving model (bluefog_tpu/analysis/seqlock_model.py)
# mirrors; the model asserts its generated programs match these tuples, so
# a protocol change in shm_mailbox.cc must update BOTH this spec and the
# model — the checker cannot silently drift from the implementation.

#: slot_write() in shm_mailbox.cc: spinlock, seq -> odd, mutate payload,
#: seq -> even (release), unlock.  The odd phase is what makes concurrent
#: plain readers retry instead of copying a half-written payload.
SEQLOCK_WRITER_STEPS = (
    "acquire_lock",
    "seq_to_odd",
    "mutate_payload",
    "seq_to_even",
    "release_lock",
)

#: slot_read() in shm_mailbox.cc: wait-free w.r.t. writers — no lock;
#: retry until the same even seq brackets the whole copy.
SEQLOCK_READER_STEPS = (
    "read_seq_before_retry_if_odd",
    "copy_payload",
    "read_seq_after_retry_if_changed",
)

#: bf_shm_win_read(collect=1): the read AND the drain happen inside ONE
#: critical section — the push-sum mass-conservation primitive (a deposit
#: can never land between the read and the drain marker).
COLLECT_IS_ATOMIC = True

#: slot_deposit() in shm_mailbox.cc, per chunk: chunk_seq -> odd, mutate
#: the chunk, release-fence, chunk_seq -> even.  The release fence before
#: the even publish is what makes an even chunk_seq imply the chunk bytes
#: are globally visible — the verifier's chunk-ring model seeds a variant
#: with the fence dropped and must catch it.
CHUNK_WRITER_STEPS = (
    "chunk_seq_to_odd",
    "mutate_chunk",
    "chunk_seq_to_even",
)

#: Per-chunk consumer bracket (the pipelined drain): same retry discipline
#: as the whole-slot reader, applied to one chunk_seq.
CHUNK_READER_STEPS = (
    "read_chunk_seq_before_retry_if_odd",
    "copy_chunk",
    "read_chunk_seq_after_retry_if_changed",
)

#: slot_deposit() commits chunks in ASCENDING index order: observing chunk
#: c committed at episode E implies every chunk < c is committed at >= E
#: (the frontier invariant a pipelined consumer relies on).  The model
#: checks the reversed-order variant loses this ("reordered chunk commit").
CHUNK_COMMIT_IN_ORDER = True

#: collect/reset drain by storing ``drained = version`` (an O(1) marker;
#: a drained slot READS as zeros by contract) in the same critical section
#: as the copy-out — no memset pass, and still no window for a concurrent
#: accumulate to be marked drained without having been read (model-checked
#: "no lost deposit").
DRAINED_COLLECT_IS_ATOMIC = True

#: Chunk size of the v2 transport.  64 KiB x pipeline_depth 4 keeps the
#: probe ring L2-resident on common parts, which is where the measured
#: pipelined bandwidth peaks (see benchmarks/gossip_bandwidth.py's sweep).
DEFAULT_CHUNK_BYTES = 64 * 1024
DEFAULT_PIPELINE_DEPTH = 4


def chunk_bytes() -> int:
    """Configured chunk size (``BLUEFOG_SHM_CHUNK_BYTES`` or the default)."""
    try:
        v = int(os.environ.get("BLUEFOG_SHM_CHUNK_BYTES", ""))
    except ValueError:
        return DEFAULT_CHUNK_BYTES
    return v if v > 0 else DEFAULT_CHUNK_BYTES


def pipeline_depth() -> int:
    """Ring depth for the pipelined self-edge probe
    (``BLUEFOG_SHM_PIPELINE_DEPTH`` or the default)."""
    try:
        v = int(os.environ.get("BLUEFOG_SHM_PIPELINE_DEPTH", ""))
    except ValueError:
        return DEFAULT_PIPELINE_DEPTH
    return v if v > 0 else DEFAULT_PIPELINE_DEPTH

#: bf_shm_job_barrier(): sense-reversing — the last arriver must reset
#: ``arrived`` BEFORE bumping ``generation``; the opposite order loses the
#: arrival of a rank that races into the next episode (model-checked
#: lost-wakeup).
BARRIER_RESET_BEFORE_RELEASE = True

#: slot_deposit() advances ``p``/``version`` only AFTER every chunk write,
#: under the slot lock.  This ordering is what makes the dead-writer drain
#: sound: a writer that dies mid-deposit has committed ZERO mass, so
#: bf_shm_win_force_drain() can discard the torn payload and store
#: ``drained = version`` without losing any deposited mass (model-checked:
#: dead_writer_drain_model — the commit-before-payload variant must lose
#: mass and is a seeded-bug fixture).
DEPOSIT_COMMITS_AFTER_PAYLOAD = True

#: bf_shm_win_force_drain() (dead-writer recovery): even-ize the torn
#: chunk seqlocks, store the drained marker, advance ``wseq`` past any
#: torn bracket, clear the lock LAST.  Only legal once the failure
#: detector has established the slot's (single) writer is gone.
DEAD_WRITER_DRAIN_STEPS = (
    "evenize_chunk_seqs",
    "mark_drained",
    "evenize_wseq",
    "clear_lock",
)


def seg_name(job: str, suffix: str) -> str:
    """Sanitized POSIX shm object name (leading slash, [A-Za-z0-9_.-])."""
    raw = f"bf_{job}_{suffix}"
    return "/" + re.sub(r"[^A-Za-z0-9_.-]", "_", raw)[:250]


def _as_contiguous(array, dtype) -> np.ndarray:
    a = np.asarray(array, dtype=dtype)
    return np.ascontiguousarray(a)


# ---------------------------------------------------------------------------
# native path
# ---------------------------------------------------------------------------


class NativeShmJob:
    """Job-scope segment: sense-reversing barrier + per-rank mutexes +
    per-rank heartbeat words (the shm leg of the failure detector)."""

    def __init__(self, job: str, rank: int, nranks: int):
        lib = get_lib()
        self._lib = lib
        self.rank = int(rank)
        self.nranks = int(nranks)
        self._name = seg_name(job, "job")
        self._h = lib.bf_shm_job_create(self._name.encode(), rank, nranks)
        if not self._h:
            raise RuntimeError(f"could not create shm job segment {self._name}")
        self._holders = _maybe_holder_board(job, nranks)
        #: holder rank observed at the start of the last mutex_acquire wait
        #: (None = lock was free / board off) — islands' deadline acquire
        #: reads this to blame the *holder* instead of the window owner.
        self.last_wait_holder = None

    def barrier(self, timeout: Optional[float] = None) -> None:
        """Sense-reversing barrier.  With ``timeout`` (seconds) the wait is
        bounded: on expiry the arrival is retracted (later episodes stay
        consistent) and TimeoutError is raised."""
        if timeout is None:
            self._lib.bf_shm_job_barrier(self._h)
            return
        rc = self._lib.bf_shm_job_barrier_timeout(
            self._h, int(timeout * 1000.0))
        if rc != 0:
            raise TimeoutError(
                f"shm barrier timed out after {timeout:.3f}s "
                f"(rank {self.rank} of {self.nranks})")

    def heartbeat(self) -> None:
        """Stamp my liveness word with CLOCK_MONOTONIC milliseconds."""
        self._lib.bf_shm_job_heartbeat(self._h, 0)

    def liveness(self, rank: int) -> float:
        """A rank's last heartbeat stamp in seconds on the same
        system-wide monotonic clock as :func:`time.monotonic` (0.0 if it
        never beat)."""
        return self._lib.bf_shm_job_liveness(self._h, int(rank)) / 1000.0

    def mutex_acquire(self, rank: int,
                      timeout: Optional[float] = None) -> None:
        self.last_wait_holder = _timed_mutex_acquire(
            self._mutex_acquire_raw, rank, timeout,
            holders=self._holders, me=self.rank)

    def _mutex_acquire_raw(self, rank: int,
                           timeout: Optional[float]) -> None:
        if timeout is None:
            self._lib.bf_shm_job_mutex_acquire(self._h, int(rank))
            return
        rc = self._lib.bf_shm_job_mutex_acquire_timeout(
            self._h, int(rank), int(timeout * 1000.0))
        if rc != 0:
            raise TimeoutError(
                f"shm mutex {rank} not acquired within {timeout:.3f}s")

    def mutex_break(self, rank: int) -> None:
        """Forcibly release a mutex whose holder the failure detector has
        declared dead."""
        if self._holders is not None:
            self._holders.clear(int(rank))  # unconditional: holder is dead
        self._lib.bf_shm_job_mutex_break(self._h, int(rank))

    def mutex_release(self, rank: int) -> None:
        if self._holders is not None:
            # clear BEFORE the release: once the lock is free a nonzero
            # word must never name us (conditional — a racing break wins)
            self._holders.clear(int(rank), self.rank)
        self._lib.bf_shm_job_mutex_release(self._h, int(rank))

    def mutex_holder(self, rank: int) -> Optional[int]:
        """Advisory current holder of a job mutex (None when free or the
        holder board is off)."""
        return None if self._holders is None else self._holders.holder(rank)

    def close(self, unlink: bool = False) -> None:
        if self._h:
            self._lib.bf_shm_job_destroy(self._h, 1 if unlink else 0)
            self._h = None
        if self._holders is not None:
            self._holders.close(unlink)
            self._holders = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeShmWindow:
    """One named window: exposed slots + per-in-neighbor mailbox slots.

    Protocol v2: payloads stream through per-chunk seqlocks (ascending
    commit order), ``write`` fuses a ``scale`` factor into the deposit
    pass, ``combine`` fuses the weighted read-side accumulation, and
    collect/reset drain via the O(1) ``drained`` marker.
    """

    #: islands.py keys off this to route scaled deposits / fused combines
    #: through the transport instead of staging temporaries.
    supports_scale = True

    CAPS = _caps.TransportCaps(
        name="shm-native",
        fused_accumulate=True,
        fused_scale=True,       # == supports_scale
        fused_combine=True,     # combine() / update_fused()
        zero_copy_collect=True,  # O(1) drained-marker drain
        chunked_streaming=True,  # per-chunk seqlock ring
        wire_quantization=False,  # same-host memcpy, nothing to quantize
        resume=False,            # shared memory has no sessions to resume
    )

    def __init__(self, job: str, name: str, rank: int, nranks: int,
                 maxd: int, shape: Tuple[int, ...], dtype,
                 chunk: Optional[int] = None):
        lib = get_lib()
        self._lib = lib
        self.rank = rank
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        self._code = _DTYPE_CODES.get(self.dtype, 0)
        self.chunk_bytes = int(chunk) if chunk else chunk_bytes()
        self.nchunks = max(1, -(-self.nbytes // self.chunk_bytes))
        self.pipeline_depth = min(pipeline_depth(), self.nchunks)
        self._name = seg_name(job, f"win_{name}")
        self._h = lib.bf_shm_win_create(
            self._name.encode(), rank, nranks, max(maxd, 1), self.nbytes,
            self._code, self.chunk_bytes,
        )
        if not self._h:
            raise RuntimeError(f"could not create shm window {self._name}")
        self._exposed_view: Optional[np.ndarray] = None
        self._trace = _maybe_trace_sidecar(job, name, rank, nranks,
                                           max(maxd, 1))

    def trace_stamp(self, dst: int, slot: int, word: int,
                    writer=None) -> None:
        del writer  # single-transport: routing is the RoutedWindow's job
        if self._trace is not None:
            self._trace.stamp(dst, slot, word)

    def trace_peek(self, slot: int, src=None) -> int:
        del src
        return self._trace.peek(slot) if self._trace is not None else 0

    def write(self, dst: int, slot: int, array, p: float = 1.0,
              accumulate: bool = False, writer=None,
              scale: float = 1.0) -> None:
        del writer  # single-transport: routing is the RoutedWindow's job
        if self._code == 0:
            if accumulate:
                raise TypeError(
                    f"accumulate unsupported for dtype {self.dtype}")
            if scale != 1.0:
                raise TypeError(f"scale unsupported for dtype {self.dtype}")
        a = _as_contiguous(array, self.dtype)
        if a.nbytes != self.nbytes:
            raise ValueError(
                f"win_put payload has {a.nbytes} bytes but window "
                f"{self._name} expects {self.nbytes} (shape {self.shape})"
            )
        self._lib.bf_shm_win_write(
            self._h, int(dst), int(slot),
            a.ctypes.data_as(ctypes.c_void_p), float(p),
            1 if accumulate else 0, float(scale),
        )
        reg = _telemetry.get_registry()
        if reg.enabled:
            _, dep, com = _deposit_counters(self, reg)
            dep.inc()
            com.add(self.nchunks)

    def read(self, slot: int, collect: bool = False, src=None, out=None):
        del src
        if out is None:
            out = np.empty(self.shape, dtype=self.dtype)
        elif (out.dtype != self.dtype or out.nbytes != self.nbytes
              or not out.flags["C_CONTIGUOUS"]):
            raise ValueError(
                f"read out= must be C-contiguous {self.dtype} of "
                f"{self.nbytes} bytes"
            )
        p = ctypes.c_double(0.0)
        version = self._lib.bf_shm_win_read(
            self._h, int(slot), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(p), 1 if collect else 0,
        )
        if collect:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("shm.marker_drains").inc()
        return out, p.value, int(version)

    def combine(self, slot: int, acc: np.ndarray, weight: float = 1.0,
                collect: bool = False, src=None):
        """Fused ``acc += weight * slot_payload`` in one native pass under
        the slot lock (a drained slot contributes nothing).  ``collect``
        drains in the same critical section — atomic with concurrent
        accumulating writers.  Returns ``(p, version)``."""
        del src
        if self._code == 0:
            raise TypeError(f"combine unsupported for dtype {self.dtype}")
        if (acc.dtype != self.dtype or acc.nbytes != self.nbytes
                or not acc.flags["C_CONTIGUOUS"]):
            raise ValueError(
                f"combine acc must be C-contiguous {self.dtype} of "
                f"{self.nbytes} bytes"
            )
        p = ctypes.c_double(0.0)
        version = self._lib.bf_shm_win_combine(
            self._h, int(slot), acc.ctypes.data_as(ctypes.c_void_p),
            float(weight), 1 if collect else 0, ctypes.byref(p),
        )
        if collect:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("shm.marker_drains").inc()
        return p.value, int(version)

    def put_dual(self, dst: int, slot: int, array, p: float = 1.0,
                 accumulate: bool = False, scale: float = 1.0,
                 expose_p: float = 1.0) -> None:
        """Fused expose + deposit: one read of ``array`` feeds both my
        exposed slot and the mailbox slot at ``(dst, slot)``,
        chunk-interleaved (the win_put fast path — replaces two full
        payload passes with one)."""
        if self._code == 0:
            raise TypeError(f"put_dual unsupported for dtype {self.dtype}")
        a = _as_contiguous(array, self.dtype)
        if a.nbytes != self.nbytes:
            raise ValueError(
                f"put_dual payload has {a.nbytes} bytes but window "
                f"{self._name} expects {self.nbytes}"
            )
        self._lib.bf_shm_win_put_dual(
            self._h, int(dst), int(slot),
            a.ctypes.data_as(ctypes.c_void_p), float(p),
            1 if accumulate else 0, float(scale), float(expose_p),
        )
        reg = _telemetry.get_registry()
        if reg.enabled:
            _, dep, com = _deposit_counters(self, reg)
            dep.inc()
            # both legs of the fused pass commit chunk-by-chunk
            com.add(2 * self.nchunks)

    def update_fused(self, slots, weights, self_data: np.ndarray,
                     self_weight: float, self_p: float,
                     out: Optional[np.ndarray],
                     collect: bool = False, expose: int = 0) -> float:
        """Whole win_update in one native sweep:
        ``out = self_weight * self_data + Σ weights[i] * slot_i`` with the
        per-chunk partial cache-resident across sub-passes, optional atomic
        drain of every slot, and optional chunk-interleaved republish of
        ``out`` as the exposed tensor (``expose``: 0 off, 1 with
        p = self_p, 2 with p = the combined mass).  ``out=None`` selects
        the in-place form: the destination is the exposed payload itself
        (read back through :meth:`exposed_view`), which drops the separate
        result buffer AND the republish copy — ``expose`` is then implied
        (forced to 1 if 0).  Returns the combined mass."""
        if self._code == 0:
            raise TypeError(
                f"update_fused unsupported for dtype {self.dtype}")
        checks = [("self_data", self_data)]
        if out is not None:
            checks.append(("out", out))
        for name, a in checks:
            if (a.dtype != self.dtype or a.nbytes != self.nbytes
                    or not a.flags["C_CONTIGUOUS"]):
                raise ValueError(
                    f"update_fused {name} must be C-contiguous "
                    f"{self.dtype} of {self.nbytes} bytes"
                )
        n = len(slots)
        if n != len(weights) or n > 64:
            raise ValueError("update_fused: bad slots/weights")
        c_slots = (ctypes.c_int64 * n)(*[int(s) for s in slots])
        c_w = (ctypes.c_double * n)(*[float(w) for w in weights])
        out_ptr = (None if out is None
                   else out.ctypes.data_as(ctypes.c_void_p))
        p_acc = float(self._lib.bf_shm_win_update_fused(
            self._h, n, c_slots, c_w,
            self_data.ctypes.data_as(ctypes.c_void_p), float(self_weight),
            float(self_p), out_ptr,
            1 if collect else 0, int(expose),
        ))
        if collect and n:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("shm.marker_drains").add(n)
        return p_acc

    def exposed_view(self) -> np.ndarray:
        """A numpy view of my exposed payload, backed by an INDEPENDENT
        ``mmap`` of the same shm pages (MAP_SHARED ⇒ coherent with the
        native mapping).  Because the view owns its own mapping, arrays
        returned to callers stay readable after :meth:`close` unmaps the
        native segment — the pages live until the last mapping drops.
        Combined with ``update_fused(out=None)`` this makes the island
        ``self_tensor`` the window buffer itself, the reference's
        win_update semantics, with zero extra copies."""
        if self._exposed_view is None:
            off = int(self._lib.bf_shm_win_exposed_offset(self._h))
            page = mmap.PAGESIZE
            base = off & ~(page - 1)
            delta = off - base
            fd = os.open("/dev/shm" + self._name, os.O_RDWR)
            try:
                mm = mmap.mmap(fd, delta + self.nbytes, offset=base)
            finally:
                os.close(fd)
            flat = np.frombuffer(
                mm, dtype=self.dtype,
                count=self.nbytes // self.dtype.itemsize, offset=delta)
            self._exposed_view = flat.reshape(self.shape)
        return self._exposed_view

    def probe(self, src: np.ndarray, dst: np.ndarray, slot: int = 0,
              ring_depth: Optional[int] = None) -> None:
        """Pipelined self-edge streaming pass: ``src`` flows to ``dst``
        through a bounded cache-resident ring of ``ring_depth`` chunk
        slots of my own mailbox ``slot``, with the full per-chunk seqlock
        protocol on both legs.  One call = one complete payload roundtrip
        (the protocol-ceiling benchmark primitive); the slot is left
        drained."""
        for a in (src, dst):
            if a.nbytes != self.nbytes or not a.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    f"probe buffers must be C-contiguous, {self.nbytes} bytes"
                )
        depth = int(ring_depth) if ring_depth else self.pipeline_depth
        rc = self._lib.bf_shm_win_probe(
            self._h, int(slot), src.ctypes.data_as(ctypes.c_void_p),
            dst.ctypes.data_as(ctypes.c_void_p), depth,
        )
        if rc != 0:
            raise RuntimeError("probe reader bracket failed")

    def read_version(self, slot: int, src=None) -> int:
        del src
        # metadata-only probe: NULL out pointer skips the payload copy
        return int(self._lib.bf_shm_win_read(self._h, int(slot), None, None, 0))

    def reset(self, slot: int, src=None) -> None:
        del src
        self._lib.bf_shm_win_reset(self._h, int(slot))

    def force_drain(self, slot: int, src=None) -> None:
        """Dead-writer recovery on my mailbox ``slot``: force a consistent
        drained state even if the writer died mid-deposit (lock held,
        odd seqlocks).  Only call after the failure detector has declared
        the slot's writer dead — see DEAD_WRITER_DRAIN_STEPS."""
        del src
        self._lib.bf_shm_win_force_drain(self._h, int(slot))
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("shm.force_drains").inc()

    def expose(self, array, p: float = 1.0) -> None:
        a = _as_contiguous(array, self.dtype)
        if a.nbytes != self.nbytes:
            raise ValueError(
                f"expose payload has {a.nbytes} bytes but window "
                f"{self._name} expects {self.nbytes} (shape {self.shape})"
            )
        self._lib.bf_shm_win_expose(
            self._h, a.ctypes.data_as(ctypes.c_void_p), float(p)
        )

    def read_exposed(self, src: int):
        out = np.empty(self.shape, dtype=self.dtype)
        p = ctypes.c_double(0.0)
        version = self._lib.bf_shm_win_read_exposed(
            self._h, int(src), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(p),
        )
        return out, p.value, int(version)

    def close(self, unlink: bool = False) -> None:
        if self._h:
            self._lib.bf_shm_win_destroy(self._h, 1 if unlink else 0)
            self._h = None
        if self._trace is not None:
            self._trace.close(unlink)
            self._trace = None

    def unlink_segments(self) -> None:
        """Name-based unlink by the designated (segment-rank-0) rank —
        the collective win_free teardown (call after close, between
        barriers)."""
        if self.rank == 0:
            _unlink_name(self._name)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _unlink_name(name: str) -> None:
    lib = loaded_lib()
    if lib is not None:
        try:
            lib.bf_shm_unlink(name.encode())
        except Exception:
            pass
    for d in {"/dev/shm", _FALLBACK_DIR}:
        try:
            os.unlink(os.path.join(d, name[1:]))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Python mirror of the chunk-ring slot protocol (tests / fault injection)
# ---------------------------------------------------------------------------


class ChunkRingMirror:
    """In-process mirror of one chunk-ring slot's state machine.

    Replays the exact v2 protocol steps (``CHUNK_WRITER_STEPS`` /
    ``CHUNK_READER_STEPS``) over numpy state so tests can freeze a writer
    MID-DEPOSIT — something the native path never exposes — and assert the
    reader-side retry discipline: a bracketed read must refuse to return
    while ``wseq`` is odd or changes across the copy.  Byte-level chunk
    math mirrors the native layout (last chunk may be short).
    """

    def __init__(self, nbytes: int, chunk: Optional[int] = None):
        self.nbytes = int(nbytes)
        self.chunk_bytes = int(chunk) if chunk else chunk_bytes()
        self.nchunks = max(1, -(-self.nbytes // self.chunk_bytes))
        self.payload = np.zeros(self.nbytes, dtype=np.uint8)
        self.chunk_seq = np.zeros(self.nchunks, dtype=np.uint64)
        self.wseq = 0
        self.version = 0
        self.drained = 0
        self.p = 0.0
        self._pending = None  # (data, p, next_chunk) of a frozen deposit

    def _chunk_slice(self, c: int) -> slice:
        lo = c * self.chunk_bytes
        return slice(lo, min(lo + self.chunk_bytes, self.nbytes))

    def _commit_chunk(self, data: bytes, c: int) -> None:
        sl = self._chunk_slice(c)
        self.chunk_seq[c] += 1  # odd: chunk in flux
        self.payload[sl] = np.frombuffer(data[sl], dtype=np.uint8)
        self.chunk_seq[c] += 1  # even: committed (release in native code)

    def write(self, data: bytes, p: float = 1.0) -> None:
        """Full deposit: ascending in-order chunk commits under odd wseq."""
        assert self._pending is None, "complete the torn write first"
        assert len(data) == self.nbytes
        self.wseq += 1
        for c in range(self.nchunks):
            self._commit_chunk(data, c)
        self.version += 1
        self.p = p
        self.wseq += 1

    def begin_torn_write(self, data: bytes, p: float = 1.0,
                         tear_at: int = 0) -> None:
        """Start a deposit and FREEZE it mid-protocol: chunks before
        ``tear_at`` are committed, chunk ``tear_at`` is left odd with only
        half its bytes stored, and ``wseq`` stays odd — the state a reader
        observes when a writer is preempted mid-copy."""
        assert self._pending is None
        assert len(data) == self.nbytes
        assert 0 <= tear_at < self.nchunks
        self.wseq += 1
        for c in range(tear_at):
            self._commit_chunk(data, c)
        sl = self._chunk_slice(tear_at)
        half = sl.start + max(1, (sl.stop - sl.start) // 2)
        self.chunk_seq[tear_at] += 1  # odd, and it stays odd
        self.payload[sl.start:half] = np.frombuffer(
            data[sl.start:half], dtype=np.uint8)
        self._pending = (data, p, tear_at)

    def complete_write(self) -> None:
        """Finish the frozen deposit (writer resumes and publishes)."""
        assert self._pending is not None
        data, p, tear_at = self._pending
        sl = self._chunk_slice(tear_at)
        self.payload[sl] = np.frombuffer(data[sl], dtype=np.uint8)
        self.chunk_seq[tear_at] += 1  # even
        for c in range(tear_at + 1, self.nchunks):
            self._commit_chunk(data, c)
        self.version += 1
        self.p = p
        self.wseq += 1
        self._pending = None

    def force_drain(self) -> None:
        """Dead-writer recovery (mirrors ``bf_shm_win_force_drain``):
        discard any frozen mid-deposit state, even-ize the torn chunk
        seqlocks and ``wseq``, and store the drained marker.  Because
        ``version``/``p`` only advance AFTER every chunk commit
        (DEPOSIT_COMMITS_AFTER_PAYLOAD), the torn deposit had committed
        zero mass — the post-drain slot reads as logical zero and the
        committed-mass ledger is conserved."""
        self._pending = None
        for c in range(self.nchunks):
            if int(self.chunk_seq[c]) & 1:
                self.chunk_seq[c] += 1
        self.drained = self.version
        self.p = 0.0
        if self.wseq & 1:
            self.wseq += 1

    def read(self, retries: int = 64):
        """Whole-slot bracketed read: retry while ``wseq`` is odd or moves
        across the copy.  Raises TimeoutError once the retry budget is
        exhausted (a frozen torn writer never publishes)."""
        for attempt in range(retries):
            before = self.wseq
            if before & 1:
                continue
            out = self.payload.copy()
            empty = self.drained == self.version
            p = 0.0 if empty else self.p
            if self.wseq == before:
                if empty:
                    out[:] = 0
                if attempt:
                    reg = _telemetry.get_registry()
                    if reg.enabled:
                        reg.counter("shm.seqlock_retries").add(attempt)
                return bytes(out), p, self.version
        raise TimeoutError("reader retry budget exhausted (torn writer)")

    def read_chunk(self, c: int, retries: int = 64) -> bytes:
        """Per-chunk bracketed read (the pipelined consumer's unit)."""
        sl = self._chunk_slice(c)
        for attempt in range(retries):
            before = int(self.chunk_seq[c])
            if before & 1:
                continue
            out = bytes(self.payload[sl])
            if int(self.chunk_seq[c]) == before:
                if attempt:
                    reg = _telemetry.get_registry()
                    if reg.enabled:
                        reg.counter("shm.seqlock_retries").add(attempt)
                return out
        raise TimeoutError(
            f"chunk {c} retry budget exhausted (torn writer)")


# ---------------------------------------------------------------------------
# pure-Python fallback (mmap + fcntl byte-range locks)
# ---------------------------------------------------------------------------

_FALLBACK_DIR = os.environ.get("BLUEFOG_SHM_DIR", "/dev/shm")


class _FallbackSegment:
    """mmap'd file; every slot guarded by an exclusive lockf range.

    Creation needs no handshake: all ranks ftruncate to the same size
    (idempotent, zero-fills) and zeros are a valid initial state.
    """

    def __init__(self, path: str, nbytes: int):
        self.path = path
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        os.ftruncate(self._fd, nbytes)
        self._mm = mmap.mmap(self._fd, nbytes)

    def lock(self, start: int, length: int):
        import fcntl

        fcntl.lockf(self._fd, fcntl.LOCK_EX, length, start)

    def unlock(self, start: int, length: int):
        import fcntl

        fcntl.lockf(self._fd, fcntl.LOCK_UN, length, start)

    def close(self, unlink: bool = False):
        if self._mm is not None:
            self._mm.close()
            os.close(self._fd)
            self._mm = None
            if unlink:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass


class TraceSidecar:
    """One aligned u64 trace-context word per (dst, mailbox-slot) pair,
    in an mmap segment that rides NEXT TO a window (``trace_<name>``)
    rather than inside it — the native chunk-ring C struct is not
    extensible without recompiling, and the fallback layout stays wire-
    compatible.  Writes are single 8-byte aligned ``pack_into`` calls
    (atomic in practice on x86/ARM64); the word is advisory — a torn or
    stale read costs one flow arrow in the merged trace, never
    correctness — so no locks are taken.  Created only when
    ``BFTPU_TRACING`` is on; the ``seg_name`` prefix means
    :func:`unlink_all` reclaims it with the window segments."""

    def __init__(self, job: str, name: str, rank: int, nranks: int,
                 maxd: int):
        self.rank = int(rank)
        self.maxd = int(maxd)
        path = os.path.join(_FALLBACK_DIR, seg_name(job, f"trace_{name}")[1:])
        self._seg = _FallbackSegment(path, nranks * self.maxd * 8)

    def stamp(self, dst: int, slot: int, word: int) -> None:
        struct.pack_into("<Q", self._seg._mm,
                         (int(dst) * self.maxd + int(slot)) * 8,
                         word & 0xFFFFFFFFFFFFFFFF)

    def peek(self, slot: int) -> int:
        return struct.unpack_from(
            "<Q", self._seg._mm, (self.rank * self.maxd + int(slot)) * 8)[0]

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)


def _maybe_trace_sidecar(job: str, name: str, rank: int, nranks: int,
                         maxd: int):
    """A window's trace sidecar when tracing is enabled, else None (the
    window's trace_stamp/trace_peek become no-ops).

    Also created (it is a tiny segment) when the introspection plane is
    on, so flipping ``BFTPU_TRACING`` at runtime via ``bftpu-top`` finds
    the flow-arrow words already wired — windows are built once at
    win_create and cannot grow a sidecar later."""
    from bluefog_tpu_torch.tracing.tracer import tracing_dir

    if tracing_dir() is None and not statuspage_enabled():
        return None
    try:
        return TraceSidecar(job, name, rank, nranks, maxd)
    except OSError:
        return None


def statuspage_enabled() -> bool:
    """Whether the live-introspection plane (per-rank status pages + the
    mutex holder board) is on.  Default ON — the point of the plane is
    that a job is attachable *before* anyone knew it would misbehave;
    ``BFTPU_STATUSPAGE=0`` opts out (bench.py gates the cost < 2%)."""
    return os.environ.get("BFTPU_STATUSPAGE", "1") not in ("0", "", "false")


class HolderBoard:
    """One aligned u64 *holder word* per job mutex, in a sidecar segment
    (``bf_<job>_holders``) next to the job segment — the native C struct
    is not extensible without recompiling shm_mailbox.cc.

    Word value is ``holder_rank + 1`` (0 = free), stamped by the winner
    right AFTER its raw acquire and cleared right BEFORE its release, so
    a nonzero word is only ever a rank that really holds (or held a
    heartbeat ago) the lock.  Like the trace sidecar the word is advisory
    and lock-free: a torn/stale read costs one wait mis-attribution,
    never correctness, so waiters sample it without synchronizing and
    ``bftpu-top`` mmaps it read-only from outside the job."""

    def __init__(self, job: str, nranks: int):
        self.nranks = int(nranks)
        path = os.path.join(_FALLBACK_DIR, seg_name(job, "holders")[1:])
        self._seg = _FallbackSegment(path, max(1, self.nranks) * 8)

    def set_holder(self, mutex_rank: int, holder_rank: int) -> None:
        if 0 <= int(mutex_rank) < self.nranks:
            struct.pack_into("<Q", self._seg._mm, int(mutex_rank) * 8,
                             (int(holder_rank) + 1) & 0xFFFFFFFFFFFFFFFF)

    def clear(self, mutex_rank: int,
              holder_rank: Optional[int] = None) -> None:
        """Zero a holder word; with ``holder_rank`` the clear is
        conditional (only if we are the recorded holder), so a release
        racing a ``mutex_break`` never erases the breaker's view."""
        if not 0 <= int(mutex_rank) < self.nranks:
            return
        off = int(mutex_rank) * 8
        if holder_rank is not None:
            cur = struct.unpack_from("<Q", self._seg._mm, off)[0]
            if cur != int(holder_rank) + 1:
                return
        struct.pack_into("<Q", self._seg._mm, off, 0)

    def holder(self, mutex_rank: int) -> Optional[int]:
        """Current holder rank of a mutex, or None when free/unknown."""
        if not 0 <= int(mutex_rank) < self.nranks:
            return None
        word = struct.unpack_from(
            "<Q", self._seg._mm, int(mutex_rank) * 8)[0]
        if word == 0 or word > self.nranks:
            return None
        return int(word) - 1

    def snapshot(self):
        """``{mutex_rank: holder_rank}`` for every currently-held word."""
        out = {}
        for r in range(self.nranks):
            h = self.holder(r)
            if h is not None:
                out[r] = h
        return out

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)


def _maybe_holder_board(job: str, nranks: int):
    """The job's holder board when introspection is on, else None (mutex
    waits fall back to owner-rank attribution)."""
    if not statuspage_enabled():
        return None
    try:
        return HolderBoard(job, nranks)
    except OSError:
        return None


class FallbackShmJob:
    """Barrier + mutexes + heartbeats over lockf.  Layout:
    [arrived u64][generation u64], one lock byte per rank (the mutex is
    the held lockf range), then one heartbeat u64 per rank."""

    def __init__(self, job: str, rank: int, nranks: int):
        self.rank = int(rank)
        self.nranks = nranks
        path = os.path.join(_FALLBACK_DIR, seg_name(job, "job")[1:])
        self._seg = _FallbackSegment(path, 16 + nranks + 8 * nranks)
        self._holders = _maybe_holder_board(job, nranks)
        self.last_wait_holder = None  # see NativeShmJob

    def _beat_off(self, rank: int) -> int:
        return 16 + self.nranks + 8 * rank

    def barrier(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        mm = self._seg._mm
        self._seg.lock(0, 16)
        gen = struct.unpack_from("<Q", mm, 8)[0]
        arrived = struct.unpack_from("<Q", mm, 0)[0] + 1
        if arrived == self.nranks:
            struct.pack_into("<Q", mm, 0, 0)
            struct.pack_into("<Q", mm, 8, gen + 1)
            self._seg.unlock(0, 16)
            return
        struct.pack_into("<Q", mm, 0, arrived)
        self._seg.unlock(0, 16)
        while True:
            self._seg.lock(8, 8)
            cur = struct.unpack_from("<Q", mm, 8)[0]
            self._seg.unlock(8, 8)
            if cur != gen:
                return
            if deadline is not None and time.monotonic() > deadline:
                # retract the arrival so later episodes stay consistent
                # (reset+bump are atomic under lock(0,16), so gen
                # unchanged here implies our arrival is still counted)
                self._seg.lock(0, 16)
                try:
                    if struct.unpack_from("<Q", mm, 8)[0] != gen:
                        return  # released while we were timing out
                    a = struct.unpack_from("<Q", mm, 0)[0]
                    struct.pack_into("<Q", mm, 0, max(0, a - 1))
                finally:
                    self._seg.unlock(0, 16)
                raise TimeoutError(
                    f"shm barrier timed out after {timeout:.3f}s "
                    f"(rank {self.rank} of {self.nranks})")
            time.sleep(0.0002)

    def heartbeat(self) -> None:
        struct.pack_into("<Q", self._seg._mm, self._beat_off(self.rank),
                         int(time.monotonic() * 1000.0))

    def liveness(self, rank: int) -> float:
        return struct.unpack_from(
            "<Q", self._seg._mm, self._beat_off(rank))[0] / 1000.0

    def mutex_acquire(self, rank: int,
                      timeout: Optional[float] = None) -> None:
        self.last_wait_holder = _timed_mutex_acquire(
            self._mutex_acquire_raw, rank, timeout,
            holders=self._holders, me=self.rank)

    def _mutex_acquire_raw(self, rank: int,
                           timeout: Optional[float]) -> None:
        if timeout is None:
            self._seg.lock(16 + rank, 1)
            return
        import fcntl

        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.lockf(self._seg._fd, fcntl.LOCK_EX | fcntl.LOCK_NB,
                            1, 16 + rank)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shm mutex {rank} not acquired within "
                        f"{timeout:.3f}s") from None
                time.sleep(0.0005)

    def mutex_break(self, rank: int) -> None:
        # lockf ranges die with their holder process — nothing to break,
        # but the advisory holder word outlives the holder and must go
        if self._holders is not None:
            self._holders.clear(int(rank))

    def mutex_release(self, rank: int) -> None:
        if self._holders is not None:
            self._holders.clear(int(rank), self.rank)
        self._seg.unlock(16 + rank, 1)

    def mutex_holder(self, rank: int) -> Optional[int]:
        return None if self._holders is None else self._holders.holder(rank)

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)
        if self._holders is not None:
            self._holders.close(unlink)
            self._holders = None


class FallbackShmWindow:
    """Same slot geometry and op surface as the native window (including
    scaled writes and fused ``combine``); every op takes the slot's
    exclusive lock (no seqlock or chunking — simplicity over throughput;
    the chunk attributes exist only so benchmark/metadata consumers see a
    uniform interface)."""

    _HDR = 16  # per-slot: [version u64][p f64]

    supports_scale = True

    CAPS = _caps.TransportCaps(
        name="shm-fallback",
        fused_accumulate=True,
        fused_scale=True,        # == supports_scale
        fused_combine=True,      # locked two-pass combine()
        zero_copy_collect=False,  # collect memsets the payload
        chunked_streaming=False,  # whole-slot lockf, no chunk ring
        wire_quantization=False,
        resume=False,
    )

    def __init__(self, job: str, name: str, rank: int, nranks: int,
                 maxd: int, shape: Tuple[int, ...], dtype,
                 chunk: Optional[int] = None):
        self.rank = rank
        self.nranks = nranks
        self.maxd = max(maxd, 1)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        self.chunk_bytes = int(chunk) if chunk else chunk_bytes()
        self.nchunks = max(1, -(-self.nbytes // self.chunk_bytes))
        self.pipeline_depth = min(pipeline_depth(), self.nchunks)
        self._stride = self._HDR + ((self.nbytes + 63) // 64) * 64
        nslots = nranks + nranks * self.maxd
        path = os.path.join(_FALLBACK_DIR, seg_name(job, f"win_{name}")[1:])
        self._seg = _FallbackSegment(path, nslots * self._stride)
        self._trace = _maybe_trace_sidecar(job, name, rank, nranks,
                                           self.maxd)

    def trace_stamp(self, dst: int, slot: int, word: int,
                    writer=None) -> None:
        del writer
        if self._trace is not None:
            self._trace.stamp(dst, slot, word)

    def trace_peek(self, slot: int, src=None) -> int:
        del src
        return self._trace.peek(slot) if self._trace is not None else 0

    def _off(self, index: int) -> int:
        return index * self._stride

    def _mail_index(self, d: int, k: int) -> int:
        return self.nranks + d * self.maxd + k

    def _read_slot(self, off: int):
        mm = self._seg._mm
        version, p = struct.unpack_from("<Qd", mm, off)
        a = np.frombuffer(
            mm, dtype=self.dtype,
            count=self.nbytes // self.dtype.itemsize,
            offset=off + self._HDR,
        ).reshape(self.shape).copy()
        return a, p, version

    def _locked(self, index: int):
        off = self._off(index)
        self._seg.lock(off, self._stride)
        return off

    def _unlock(self, index: int):
        self._seg.unlock(self._off(index), self._stride)

    def write(self, dst: int, slot: int, array, p: float = 1.0,
              accumulate: bool = False, writer=None,
              scale: float = 1.0) -> None:
        del writer
        if self.dtype not in _DTYPE_CODES:
            # same contract as the native path: accumulate/scale need a
            # float payload (raw dtypes are opaque bytes)
            if accumulate:
                raise TypeError(
                    f"accumulate unsupported for dtype {self.dtype}")
            if scale != 1.0:
                raise TypeError(f"scale unsupported for dtype {self.dtype}")
        a = _as_contiguous(array, self.dtype)
        if scale != 1.0:
            a = a * np.asarray(scale, dtype=self.dtype)
        idx = self._mail_index(dst, slot)
        off = self._locked(idx)
        try:
            mm = self._seg._mm
            version, cur_p = struct.unpack_from("<Qd", mm, off)
            if accumulate:
                cur, _, _ = self._read_slot(off)
                a = cur + a
                p = cur_p + p
            mm[off + self._HDR:off + self._HDR + self.nbytes] = a.tobytes()
            struct.pack_into("<Qd", mm, off, version + 1, p)
        finally:
            self._unlock(idx)
        reg = _telemetry.get_registry()
        if reg.enabled:
            _, dep, com = _deposit_counters(self, reg)
            dep.inc()
            com.inc()  # one whole-slot commit

    def read(self, slot: int, collect: bool = False, src=None, out=None):
        del src
        idx = self._mail_index(self.rank, slot)
        off = self._locked(idx)
        try:
            a, p, version = self._read_slot(off)
            if collect:
                mm = self._seg._mm
                mm[off + self._HDR:off + self._HDR + self.nbytes] = (
                    b"\x00" * self.nbytes
                )
                struct.pack_into("<Qd", mm, off, version, 0.0)
        finally:
            self._unlock(idx)
        if collect:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("shm.marker_drains").inc()
        if out is not None:
            np.copyto(out, a)
            a = out
        return a, p, version

    def combine(self, slot: int, acc: np.ndarray, weight: float = 1.0,
                collect: bool = False, src=None):
        """acc += weight * payload under the slot lock; returns (p,
        version).  Interface parity with the native fused combine (here it
        is two numpy passes over a view — no temporaries, but no fusion)."""
        del src
        if self.dtype not in _DTYPE_CODES:
            raise TypeError(f"combine unsupported for dtype {self.dtype}")
        idx = self._mail_index(self.rank, slot)
        off = self._locked(idx)
        try:
            mm = self._seg._mm
            version, p = struct.unpack_from("<Qd", mm, off)
            view = np.frombuffer(
                mm, dtype=self.dtype,
                count=self.nbytes // self.dtype.itemsize,
                offset=off + self._HDR,
            ).reshape(self.shape)
            flat_acc = acc.reshape(self.shape)
            flat_acc += np.asarray(weight, dtype=self.dtype) * view
            if collect:
                mm[off + self._HDR:off + self._HDR + self.nbytes] = (
                    b"\x00" * self.nbytes
                )
                struct.pack_into("<Qd", mm, off, version, 0.0)
        finally:
            self._unlock(idx)
        if collect:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("shm.marker_drains").inc()
        return p, version

    def put_dual(self, dst: int, slot: int, array, p: float = 1.0,
                 accumulate: bool = False, scale: float = 1.0,
                 expose_p: float = 1.0) -> None:
        """Interface parity with the native fused op: expose + deposit as
        two plain locked passes (nothing to fuse without chunking)."""
        if self.dtype not in _DTYPE_CODES:
            raise TypeError(f"put_dual unsupported for dtype {self.dtype}")
        self.expose(array, expose_p)
        self.write(dst, slot, array, p=p, accumulate=accumulate, scale=scale)

    def update_fused(self, slots, weights, self_data: np.ndarray,
                     self_weight: float, self_p: float, out: np.ndarray,
                     collect: bool = False, expose: int = 0) -> float:
        """Interface parity with the native fused sweep, composed from the
        per-slot combine (same drain atomicity per slot, no cross-slot
        fusion)."""
        if self.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"update_fused unsupported for dtype {self.dtype}")
        flat = out.reshape(-1)
        np.multiply(self_data.reshape(-1),
                    np.asarray(self_weight, dtype=self.dtype), out=flat)
        p_acc = self_weight * self_p
        for s, w in zip(slots, weights):
            p, _ = self.combine(s, out, w, collect=collect)
            p_acc += w * p
        if expose:
            self.expose(out, p_acc if expose == 2 else self_p)
        return float(p_acc)

    def probe(self, src: np.ndarray, dst: np.ndarray, slot: int = 0,
              ring_depth: Optional[int] = None) -> None:
        """Self-edge roundtrip for the protocol-ceiling benchmark: a plain
        locked write + read (the fallback has no chunk ring to pipeline)."""
        del ring_depth
        self.write(self.rank, slot, src)
        a, _, _ = self.read(slot, collect=True)
        np.copyto(dst.reshape(self.shape), a)

    def read_version(self, slot: int, src=None) -> int:
        del src
        idx = self._mail_index(self.rank, slot)
        off = self._locked(idx)
        try:
            return int(struct.unpack_from("<Q", self._seg._mm, off)[0])
        finally:
            self._unlock(idx)

    def reset(self, slot: int, src=None) -> None:
        del src
        idx = self._mail_index(self.rank, slot)
        off = self._locked(idx)
        try:
            mm = self._seg._mm
            version = struct.unpack_from("<Q", mm, off)[0]
            mm[off + self._HDR:off + self._HDR + self.nbytes] = (
                b"\x00" * self.nbytes
            )
            struct.pack_into("<Qd", mm, off, version, 0.0)
        finally:
            self._unlock(idx)

    def force_drain(self, slot: int, src=None) -> None:
        """Dead-writer recovery.  lockf ranges die with their holder, so
        a dead writer cannot leave this slot locked — reset suffices."""
        self.reset(slot, src=src)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("shm.force_drains").inc()

    def unlink_segments(self) -> None:
        if self.rank == 0:
            try:
                os.unlink(self._seg.path)
            except OSError:
                pass

    def expose(self, array, p: float = 1.0) -> None:
        a = _as_contiguous(array, self.dtype)
        off = self._locked(self.rank)
        try:
            mm = self._seg._mm
            version = struct.unpack_from("<Q", mm, off)[0]
            mm[off + self._HDR:off + self._HDR + self.nbytes] = a.tobytes()
            struct.pack_into("<Qd", mm, off, version + 1, p)
        finally:
            self._unlock(self.rank)

    def read_exposed(self, src: int):
        off = self._locked(src)
        try:
            return self._read_slot(off)
        finally:
            self._unlock(src)

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)
        if self._trace is not None:
            self._trace.close(unlink)
            self._trace = None


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def make_shm_job(job: str, rank: int, nranks: int):
    """Shared-memory job segment: native unless ``BLUEFOG_SHM_FALLBACK=1``
    asks for the lockf classes (no transport dispatch — used directly by the
    routed transport's intra-host leg).  A native library that cannot be
    built raises."""
    if transport_kind() == "native":
        return NativeShmJob(job, rank, nranks)
    return FallbackShmJob(job, rank, nranks)


def make_shm_window(job: str, name: str, rank: int, nranks: int, maxd: int,
                    shape, dtype, chunk: Optional[int] = None):
    if transport_kind() == "native":
        return NativeShmWindow(job, name, rank, nranks, maxd, shape, dtype,
                               chunk=chunk)
    return FallbackShmWindow(job, name, rank, nranks, maxd, shape, dtype,
                             chunk=chunk)


def make_job(job: str, rank: int, nranks: int):
    """Transport factory: hierarchical (shm intra-host + TCP inter-host)
    when a hostmap is configured, else TCP (cross-host/DCN) when selected,
    else pure shared memory."""
    hostmap = os.environ.get("BLUEFOG_ISLAND_HOSTMAP")
    if hostmap:
        from bluefog_tpu_torch.native.routed_transport import RoutedJob, parse_hostmap

        hosts = parse_hostmap(hostmap, nranks)
        return RoutedJob(job, rank, nranks, hosts, _derived_coord(job))
    coord = _tcp_coord(job)
    if coord is not None:
        from bluefog_tpu_torch.native.tcp_transport import TcpShmJob

        return TcpShmJob(job, rank, nranks, coord)
    return make_shm_job(job, rank, nranks)


def make_window(job: str, name: str, rank: int, nranks: int, maxd: int,
                shape, dtype):
    hostmap = os.environ.get("BLUEFOG_ISLAND_HOSTMAP")
    if hostmap:
        from bluefog_tpu_torch.native.routed_transport import (
            RoutedWindow, parse_hostmap,
        )

        hosts = parse_hostmap(hostmap, nranks)
        return RoutedWindow(job, name, rank, nranks, maxd, shape, dtype,
                            hosts, _derived_coord(job))
    coord = _tcp_coord(job)
    if coord is not None:
        from bluefog_tpu_torch.native.tcp_transport import TcpShmWindow

        return TcpShmWindow(job, name, rank, nranks, maxd, shape, dtype, coord)
    return make_shm_window(job, name, rank, nranks, maxd, shape, dtype)


def _force_fallback() -> bool:
    return os.environ.get("BLUEFOG_SHM_FALLBACK", "0") == "1"


def transport_kind() -> str:
    """Which shared-memory classes the factories build: ``"native"`` (the
    C++ mailbox, built from ``native/*.cc``) or ``"lockf"`` (the pure-Python
    mmap + ``fcntl.lockf`` classes), which run only when
    ``BLUEFOG_SHM_FALLBACK=1`` asks for them.  A run asserts this to know
    which transport it measured."""
    return "lockf" if _force_fallback() else "native"


def _derived_coord(job: str) -> str:
    """Explicit ``BLUEFOG_ISLAND_COORD`` or a job-deterministic localhost
    port, below the Linux ephemeral range (32768+) so a transient client
    socket never occupies it."""
    coord = os.environ.get("BLUEFOG_ISLAND_COORD")
    if coord:
        return coord
    import zlib

    port = 10000 + zlib.crc32(job.encode()) % 20000
    return f"127.0.0.1:{port}"


def island_transport() -> str:
    """The transport the island runtime will actually use for the current
    environment, mirroring ``make_job``/``make_window`` dispatch exactly:
    "routed" (hierarchical shm-intra/TCP-inter) when
    ``BLUEFOG_ISLAND_HOSTMAP`` is set, else "tcp" when
    ``BLUEFOG_ISLAND_COORD`` or ``BLUEFOG_ISLAND_TRANSPORT=tcp`` selects
    it, else "shm".  The single source of truth — benchmarks/labels must
    query this rather than re-reading the env vars."""
    if os.environ.get("BLUEFOG_ISLAND_HOSTMAP"):
        return "routed"
    if os.environ.get("BLUEFOG_ISLAND_COORD"):
        return "tcp"
    if os.environ.get("BLUEFOG_ISLAND_TRANSPORT", "").lower() == "tcp":
        return "tcp"
    return "shm"


def _tcp_coord(job: str) -> Optional[str]:
    """Coordinator address when the TCP (cross-host) transport is selected
    (see :func:`island_transport`): a job-deterministic localhost port for
    single-host testing, or derived from ``BLUEFOG_ISLAND_COORD``."""
    return _derived_coord(job) if island_transport() == "tcp" else None


def unlink_segment(job: str, suffix: str) -> None:
    """Best-effort unlink of one named segment (native object + fallback
    file); missing names are ignored."""
    _unlink_name(seg_name(job, suffix))


def poll_versions(win, pairs, seen):
    """Slots whose deposit count moved: ``[(slot, src, version)]`` for
    each ``(slot, src)`` in ``pairs`` whose ``read_version`` differs from
    ``seen[slot]``.  One lock-free word read per pair — the progress
    engine's idle prefetch uses this to re-read only edges with fresh
    deposits.  Transports without version words (or a slot torn down
    mid-poll) contribute nothing rather than raising."""
    moved = []
    for slot, src in pairs:
        try:
            ver = int(win.read_version(slot, src=src))
        except Exception:  # noqa: BLE001 - polling must never raise
            continue
        if ver != seen.get(slot):
            moved.append((slot, src, ver))
    return moved


# ---------------------------------------------------------------------------
# membership-epoch word (elastic membership; resilience/join.py)
# ---------------------------------------------------------------------------


def _epoch_word_path(job: str) -> str:
    # named like every other job segment ("bf_<job>_epoch"), so crashed-run
    # hygiene (unlink_all's prefix glob) reclaims it with the rest
    return os.path.join(_FALLBACK_DIR, seg_name(job, "epoch")[1:])


def membership_epoch(job: str) -> int:
    """The job's current membership-epoch word (0 = the launch view; a
    missing word reads as 0, so pre-elastic jobs are epoch 0 for free).

    One 8-byte little-endian file in the shm dir: readers see either the
    old or the new word (publish is an atomic rename), never a tear —
    the cheap "has membership moved?" probe incumbents poll at round
    barriers before touching the (heavier) membership board."""
    try:
        with open(_epoch_word_path(job), "rb") as f:
            raw = f.read(8)
    except OSError:
        return 0
    return struct.unpack("<Q", raw)[0] if len(raw) == 8 else 0


def publish_membership_epoch(job: str, epoch: int) -> None:
    """Atomically publish the membership-epoch word (monotone: a stale
    publish below the current word is dropped, mirroring the monotone
    dead-set contract on the shrink side)."""
    if int(epoch) <= membership_epoch(job):
        return
    path = _epoch_word_path(job)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", int(epoch)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def unlink_all(job: str, window_names=()) -> None:
    """Best-effort cleanup of ALL of a job's segments (crashed-run hygiene).

    Globs ``/dev/shm`` (where shm_open objects appear as files on Linux) and
    the fallback dir for the job prefix, so window segments are reclaimed
    even when the caller no longer knows their names (a crashed run); the
    explicit ``window_names`` are unlinked too for non-Linux portability.
    """
    import glob as _glob

    lib = loaded_lib()
    prefix = seg_name(job, "")  # "/bf_<job>_"
    names = {seg_name(job, "job")}
    names.update(seg_name(job, f"win_{n}") for n in window_names)
    for d in {"/dev/shm", _FALLBACK_DIR}:
        for path in _glob.glob(os.path.join(d, prefix[1:] + "*")):
            names.add("/" + os.path.basename(path))
    for n in names:
        if lib is not None:
            try:
                lib.bf_shm_unlink(n.encode())
            except Exception:
                pass
        for d in {"/dev/shm", _FALLBACK_DIR}:
            try:
                os.unlink(os.path.join(d, n[1:]))
            except OSError:
                pass
