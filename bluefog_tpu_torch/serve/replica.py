"""The inference replica: subscribe, hot-swap, never serve torn bytes.

A replica keeps exactly one in-memory snapshot (the A buffer in its own
address space) and polls the job's snapshot region; a newer committed
version is read to the side (B fills while A serves) and installed by a
single reference flip, so there is no serve-path downtime and no
intermediate state — a SIGKILL between the read and the flip (the chaos
hook drives exactly that) just means the next incarnation re-reads the
same committed version.

The served version is **strictly monotone per replica**: a region
re-read can only move the replica forward, and a publisher handoff
cannot regress it because the committed word itself is monotone
(:mod:`bluefog_tpu_torch.serve.snapshot`).

Degradation contract (docs/SERVING.md):

- transient trouble (region missing, torn bracket, `PeerTimeoutError`,
  `OrphanedError` from a quiesced publisher) → bounded full-jitter
  retry, then keep serving the current snapshot;
- lag beyond ``BFTPU_SERVE_MAX_LAG`` → policy-selectable via
  ``BFTPU_SERVE_STALE_POLICY``: ``warn`` serves stale and journals,
  ``refuse`` raises :class:`StaleSnapshotError` so the caller can shed
  load instead of serving ancient weights.

Counterpart of ``bluefog_tpu/serve/replica.py``.  The snapshot lives on a
torch device (``device``, the card unless the caller asks for the CPU;
``BFTPU_SERVE_DEVICE`` names it when the caller does not);
the replica keeps two device buffers, ``poll_swap`` reads the committed
bytes (the source checks their crc), copies them into the buffer that is
not serving, and flips one reference; ``serve_step`` computes on the
device.  A tensor that ``serve_step()`` hands out is the installed buffer
itself: it stays valid until the swap after next refills it.
"""

from __future__ import annotations

import os
import random
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import telemetry as _telemetry
from bluefog_tpu_torch.progress import staging as _staging
from bluefog_tpu_torch.serve import snapshot as _snap
from bluefog_tpu_torch.serve.snapshot import (SnapshotUnavailable,
                                        TornSnapshotError)

__all__ = [
    "Replica",
    "ShmSource",
    "StaleSnapshotError",
    "full_jitter",
    "serve_max_lag",
    "serve_stale_policy",
    "REPLICA_RANK_BASE",
]

#: replicas publish status pages as ranks >= this offset, so one
#: ``bftpu-top`` attach shows the training island and the serving fleet
#: side by side without rank collisions (islands are bounded well below)
REPLICA_RANK_BASE = 1000


def serve_max_lag() -> int:
    """``BFTPU_SERVE_MAX_LAG``: how many committed versions a replica
    may trail before the stale policy kicks in (0 = unbounded)."""
    try:
        return max(0, int(os.environ.get("BFTPU_SERVE_MAX_LAG", "0")))
    except ValueError:
        return 0


def serve_stale_policy() -> str:
    """``BFTPU_SERVE_STALE_POLICY``: ``warn`` (serve stale, journal) or
    ``refuse`` (raise so the caller sheds load)."""
    v = os.environ.get("BFTPU_SERVE_STALE_POLICY", "warn")
    return v if v in ("warn", "refuse") else "warn"


def serve_device() -> str:
    """``BFTPU_SERVE_DEVICE``: the device a replica installs snapshots on
    when its caller names none (default ``cuda``, the card)."""
    return os.environ.get("BFTPU_SERVE_DEVICE", "") or "cuda"


def serve_retries() -> int:
    try:
        return max(1, int(os.environ.get("BFTPU_SERVE_RETRIES", "5")))
    except ValueError:
        return 5


def serve_backoff_s() -> float:
    try:
        return float(os.environ.get("BFTPU_SERVE_BACKOFF_S", "0.05"))
    except ValueError:
        return 0.05


def full_jitter(attempt: int, base: float, cap: float = 2.0,
                rng: Optional[random.Random] = None) -> float:
    """Full-jitter backoff: ``uniform(0, min(cap, base * 2**attempt))``.

    The deterministic ``base * 2**attempt`` schedule resynchronizes a
    fleet (every replica that lost the publisher at the same instant
    retries at the same instant — a thundering herd); sampling the whole
    interval decorrelates them.  Same shape as the TCP reconnect
    backoff (``tcp_transport._backoff``)."""
    bound = min(float(cap), float(base) * (2 ** max(0, int(attempt))))
    r = rng if rng is not None else random
    return r.uniform(0.0, bound) if bound > 0 else 0.0


class StaleSnapshotError(RuntimeError):
    """Served lag exceeded ``BFTPU_SERVE_MAX_LAG`` under the ``refuse``
    policy."""

    def __init__(self, msg: str, lag: int = -1, max_lag: int = -1):
        super().__init__(msg)
        self.lag = int(lag)
        self.max_lag = int(max_lag)


def _kill_replica() -> int:
    """Chaos: replica id whose Nth swap is killed mid-flight (-1 off)."""
    try:
        return int(os.environ.get("BFTPU_CHAOS_SERVE_KILL_REPLICA", "-1"))
    except ValueError:
        return -1


def _kill_swap() -> int:
    """Chaos: the swap ordinal at which the kill fires (default 1)."""
    try:
        return int(os.environ.get("BFTPU_CHAOS_SERVE_KILL_SWAP", "1"))
    except ValueError:
        return 1


class ShmSource:
    """The single-host source: the job's seqlock'd snapshot region."""

    def __init__(self, job: str):
        self.job = str(job)

    def poll(self) -> Tuple[int, int, int, np.ndarray]:
        return _snap.read_committed(self.job)


#: exception classes the bounded-backoff retry treats as transient; the
#: TCP source's PeerTimeoutError and a quiesced publisher's
#: OrphanedError are appended lazily (keeps this module importable
#: without the native transport stack)
def _transient_errors() -> tuple:
    errs = [SnapshotUnavailable, TornSnapshotError, OSError]
    try:
        from bluefog_tpu_torch.native.tcp_transport import PeerTimeoutError
        errs.append(PeerTimeoutError)
    except Exception:
        pass
    try:
        from bluefog_tpu_torch.resilience.quorum import OrphanedError
        errs.append(OrphanedError)
    except Exception:
        pass
    return tuple(errs)


class _RequestStats:
    """Rolling-window request latencies for the statuspage.

    Keeps the last ``window_s`` of (done_mono, latency_ms) completions;
    the page publishes window QPS and p50/p99 so ``bftpu-top`` shows
    *current* traffic, not lifetime averages that smear a stall."""

    __slots__ = ("window_s", "_buf")

    def __init__(self, window_s: float = 5.0):
        self.window_s = float(window_s)
        self._buf: deque = deque()

    def note(self, done_mono: float, latency_ms: float) -> None:
        self._buf.append((float(done_mono), float(latency_ms)))
        cut = done_mono - self.window_s
        while self._buf and self._buf[0][0] < cut:
            self._buf.popleft()

    def snapshot(self, now: float) -> Tuple[float, float, float]:
        """(qps, p50_ms, p99_ms) over the window; (-1,-1,-1) when empty."""
        cut = now - self.window_s
        while self._buf and self._buf[0][0] < cut:
            self._buf.popleft()
        if not self._buf:
            return -1.0, -1.0, -1.0
        lat = sorted(l for _, l in self._buf)
        span = max(0.05, min(self.window_s, now - self._buf[0][0]))
        n = len(lat)

        def q(p: float) -> float:
            pos = p * (n - 1)
            lo = int(pos)
            hi = min(lo + 1, n - 1)
            return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)

        return n / span, q(0.50), q(0.99)


class Replica:
    """One serving process: poll → side-read → atomic flip → serve."""

    def __init__(self, job: str, replica_id: int = 0, *,
                 source=None, rng: Optional[random.Random] = None,
                 publish_page: bool = True, device=None):
        self.job = str(job)
        self.replica_id = int(replica_id)
        self.source = source if source is not None else ShmSource(job)
        self._rng = rng if rng is not None else random.Random()
        self.device = torch.device(serve_device() if device is None
                                   else device)
        # the two device buffers; the serving one is named by _current
        self._bufs = [None, None]
        self._active = 1
        # the A buffer: (version, epoch, step, tensor) flipped as one ref
        self._current: Optional[Tuple[int, int, int, torch.Tensor]] = None
        #: the last swaps: (version, read+crc ms, host-to-device ms)
        self.installs: deque = deque(maxlen=1024)
        #: newest committed version observed at the region, even when
        #: the swap was skipped — the lag denominator
        self.published_version = 0
        self.swaps = 0
        self.serve_steps = 0
        self.stale_served = 0
        self.retries = 0
        self._req_stats: Optional[_RequestStats] = None
        self._slo = None  # lazy loadgen.slo.SLOMonitor
        self._page_throttle_t = 0.0
        self._page = None
        if publish_page:
            from bluefog_tpu_torch.introspect.statuspage import StatusPage
            self._page = StatusPage(job, REPLICA_RANK_BASE + self.replica_id)
            self._publish_page("attach")

    # -- observability -----------------------------------------------------

    @property
    def version(self) -> int:
        """The version this replica is serving (0 = nothing yet)."""
        return self._current[0] if self._current is not None else 0

    @property
    def lag(self) -> int:
        return max(0, self.published_version - self.version)

    def _publish_page(self, op: str) -> None:
        if self._page is None:
            return
        cur = self._current
        # a distribution-tree source (serve.distrib.TcpSource) exposes
        # its slot/parent — surfaced on the page so bftpu-top draws
        # the tree (slot -1 = shm-attached, not in the tree)
        slot = getattr(self.source, "slot", None)
        parent = getattr(self.source, "parent_slot", -1)
        qps = p50 = p99 = -1.0
        if self._req_stats is not None:
            qps, p50, p99 = self._req_stats.snapshot(time.monotonic())
        self._page.publish(
            nranks=0, step=self.serve_steps,
            epoch=cur[1] if cur else 0, op_id=self.swaps,
            last_op=op, serve_version=self.version, serve_lag=self.lag,
            distrib_slot=-1 if slot is None else int(slot),
            distrib_parent=int(parent),
            qps=qps, p50_ms=p50, p99_ms=p99,
            slo_state=self._slo.state if self._slo is not None else -1)

    # -- subscribe / swap --------------------------------------------------

    def _poll_with_retry(self) -> Tuple[int, int, int, np.ndarray]:
        reg = _telemetry.get_registry()
        errs = _transient_errors()
        base, cap = serve_backoff_s(), 2.0
        last: Optional[Exception] = None
        for attempt in range(serve_retries()):
            try:
                return self.source.poll()
            except errs as e:
                last = e
                self.retries += 1
                delay = full_jitter(attempt, base, cap, self._rng)
                if reg.enabled:
                    reg.counter("serve.retries",
                                replica=str(self.replica_id)).inc()
                    reg.journal("serve_retry", replica=self.replica_id,
                                attempt=attempt + 1, backoff_s=delay,
                                error=type(e).__name__)
                time.sleep(delay)
        assert last is not None
        raise last

    def poll_swap(self) -> bool:
        """One subscribe cycle.  Reads the committed snapshot (bounded
        jittered retries on transient errors), and hot-swaps iff it is
        strictly newer than what we serve.  Returns True on a swap.

        Raises the last transient error only when we have NOTHING to
        serve yet; once a snapshot is installed, poll trouble degrades
        to serving the current version (the zero-downtime contract)."""
        reg = _telemetry.get_registry()
        t0 = time.monotonic()
        try:
            version, epoch, step, arr = self._poll_with_retry()
            t_read = time.monotonic()
        except _transient_errors():
            if self._current is None:
                raise
            return False
        self.published_version = max(self.published_version, version)
        if self._current is not None and version <= self._current[0]:
            return False  # monotone: never regress, never re-swap
        # B is filled (arr lives only in this frame); chaos kills the
        # replica exactly here — mid-swap, after the read, before the
        # flip — and the e2e asserts A kept serving until the kill
        if (self.replica_id == _kill_replica()
                and self.swaps + 1 == _kill_swap()):
            from bluefog_tpu_torch.resilience import chaos as _chaos
            _chaos.kill_self()
        t = self._fill_standby(arr)
        self._current = (version, epoch, step, t)  # the atomic flip
        self._active = 1 - self._active
        self.installs.append((version, (t_read - t0) * 1e3,
                              (time.monotonic() - t_read) * 1e3))
        self.swaps += 1
        if reg.enabled:
            reg.counter("serve.swaps", replica=str(self.replica_id)).inc()
            reg.gauge("serve.version",
                      replica=str(self.replica_id)).set(version)
            reg.gauge("serve.lag", replica=str(self.replica_id)).set(self.lag)
            reg.histogram("serve.swap_s").observe(time.monotonic() - t0)
            reg.journal("serve_swap", replica=self.replica_id,
                        version=version, epoch=epoch, step=step,
                        lag=self.lag)
        self._publish_page("swap")
        return True

    def _fill_standby(self, arr: np.ndarray) -> torch.Tensor:
        """Copy the committed bytes into the device buffer that is not
        serving; returns it once the copy is complete on the device."""
        i = 1 - self._active
        host = _staging.tensor_view(np.ascontiguousarray(arr))
        buf = self._bufs[i]
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = self._bufs[i] = torch.empty(host.shape, dtype=host.dtype,
                                              device=self.device)
        buf.copy_(host)
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        return buf

    # -- serve -------------------------------------------------------------

    def serve_step(self, x=None):
        """One inference step against the installed snapshot.

        Returns ``(version, y)`` where ``y`` is ``snapshot @ x``, a tensor
        on the replica's device computed there (``x``: an array or
        tensor, taken in the snapshot's dtype), or the installed snapshot
        itself when ``x`` is None — zero-copy.  Never reads
        the region: swap and serve are decoupled, which is what makes
        mid-swap death a non-event for in-flight requests."""
        cur = self._current
        if cur is None:
            raise SnapshotUnavailable(
                f"replica {self.replica_id}: nothing committed yet")
        version, _epoch, _step, arr = cur
        lag, max_lag = self.lag, serve_max_lag()
        reg = _telemetry.get_registry()
        if max_lag and lag > max_lag:
            if serve_stale_policy() == "refuse":
                if reg.enabled:
                    reg.counter("serve.refused",
                                replica=str(self.replica_id)).inc()
                raise StaleSnapshotError(
                    f"replica {self.replica_id} is {lag} versions behind "
                    f"(BFTPU_SERVE_MAX_LAG={max_lag}, policy=refuse)",
                    lag=lag, max_lag=max_lag)
            self.stale_served += 1
            if reg.enabled:
                reg.counter("serve.stale_served",
                            replica=str(self.replica_id)).inc()
                reg.journal("serve_stale", replica=self.replica_id,
                            version=version, lag=lag, max_lag=max_lag)
        self.serve_steps += 1
        if reg.enabled:
            reg.counter("serve.steps", replica=str(self.replica_id)).inc()
        if x is None:
            return version, arr
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(device=arr.device, dtype=arr.dtype)
        return version, arr.reshape(-1) @ x.reshape(-1)

    # -- request-level telemetry -------------------------------------------

    def note_request(self, send_mono: float, done_mono: float, *,
                     version: int = 0, outcome: str = "ok",
                     start_mono: Optional[float] = None) -> bool:
        """Record one completed request (open-loop latency basis).

        ``send_mono`` is the *scheduled* send time, so the latency
        charged here includes any queueing the request suffered before
        ``serve_step`` ran (the loadgen's coordinated-omission fix).
        Feeds the ``serve.request_latency`` histogram, the per-replica
        SLO monitor, and — throttled to ~4 Hz — the statuspage QPS /
        p50 / p99 / SLO columns.  Returns True iff the request violated
        an armed SLO."""
        from bluefog_tpu_torch.serve.loadgen.slo import SLOMonitor
        if self._req_stats is None:
            self._req_stats = _RequestStats()
        if self._slo is None:
            self._slo = SLOMonitor(self.replica_id)
        latency_ms = max(0.0, (float(done_mono) - float(send_mono)) * 1e3)
        self._req_stats.note(done_mono, latency_ms)
        violated = self._slo.note(send_mono, done_mono, lag=self.lag)
        reg = _telemetry.get_registry()
        if reg.enabled:
            rid = str(self.replica_id)
            reg.counter("serve.requests", replica=rid,
                        outcome=str(outcome)).inc()
            reg.histogram(
                "serve.request_latency",
                buckets=_telemetry.SERVE_LATENCY_BUCKETS_S,
                replica=rid).observe(latency_ms / 1e3)
            if violated:
                reg.counter("serve.slo_violations", replica=rid).inc()
            reg.journal(
                "serve_request", replica=self.replica_id,
                send_mono=float(send_mono),
                start_mono=float(send_mono if start_mono is None
                                 else start_mono),
                done_mono=float(done_mono), latency_ms=latency_ms,
                version=int(version), lag=self.lag, outcome=str(outcome))
        now = time.monotonic()
        if now - self._page_throttle_t >= 0.25:
            self._page_throttle_t = now
            if reg.enabled:
                qps, _, _ = self._req_stats.snapshot(now)
                if qps >= 0:
                    reg.gauge("serve.qps", replica=str(self.replica_id)
                              ).set(qps)
            self._publish_page("serve")
        return violated

    def close_slo(self) -> None:
        """Flush the SLO monitor's open violation window (teardown)."""
        if self._slo is not None:
            self._slo.close()
            self._publish_page("slo-flush")

    def close(self, unlink: bool = False) -> None:
        if self._slo is not None:
            self._slo.close()
            self._slo = None
        if self._page is not None:
            self._page.close(unlink)
            self._page = None
