"""The open-loop load generator: scheduled sends, latency charged from the
schedule, one timer thread per replica.

The one rule that makes this open-loop: a request's ``send_ts`` is the
*scheduled* arrival time, fixed before the run starts, and is never
re-anchored when the generator falls behind.  If a hot-swap (or the GIL,
or the replica itself) stalls the loop, the backlog of overdue
arrivals fires immediately and each one's latency is measured from
when it *should* have been sent — so a 500 ms stall at 100 Hz shows up
as ~50 requests with up to 500 ms of queueing delay, not as one slow
request and 49 that silently never happened (coordinated omission).

Per-request records go through ``Replica.note_request`` when the
target has one (the real replica: histogram + journal + SLO monitor +
statuspage), with a journal-only fallback for bare targets, so the sim
and the bench share one record schema.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from bluefog_tpu_torch import telemetry as _telemetry
from bluefog_tpu_torch.serve.loadgen import arrivals as _arrivals

__all__ = ["LoadGenerator", "LoadReport"]


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation quantile of a sorted list."""
    if not sorted_vals:
        return float("nan")
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclass
class LoadReport:
    """Aggregate of one load run (latencies in ms, open-loop basis)."""

    requests: int = 0
    duration_s: float = 0.0
    qps: float = 0.0
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    max_ms: float = float("nan")
    outcomes: Dict[str, int] = field(default_factory=dict)
    slo_violations: int = 0
    per_replica: Dict[int, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "requests": self.requests,
            "duration_s": self.duration_s,
            "qps": self.qps,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "max_ms": self.max_ms,
            "outcomes": dict(self.outcomes),
            "slo_violations": self.slo_violations,
            "per_replica": {k: dict(v) for k, v in
                            sorted(self.per_replica.items())},
        }


class _ReplicaStats:
    __slots__ = ("latencies_ms", "outcomes", "violations")

    def __init__(self):
        self.latencies_ms: List[float] = []
        self.outcomes: Dict[str, int] = {}
        self.violations = 0


class LoadGenerator:
    """Fire scheduled ``serve_step`` requests at K replicas.

    ``replicas`` is a sequence of targets exposing ``serve_step()``;
    real :class:`bluefog_tpu_torch.serve.Replica` objects additionally get
    their ``note_request`` called per completion (telemetry + SLO).
    All knobs default from the ``BFTPU_LOADGEN_*`` environment so a
    bench or an operator shell can steer a run without code.
    """

    def __init__(self, replicas: Sequence, *,
                 rate_hz: Optional[float] = None,
                 schedule: Optional[str] = None,
                 duration_s: Optional[float] = None,
                 seed: Optional[int] = None):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("loadgen needs at least one replica")
        self.rate_hz = (_arrivals.loadgen_rate_hz() if rate_hz is None
                        else float(rate_hz))
        self.schedule = (_arrivals.loadgen_schedule() if schedule is None
                         else str(schedule))
        self.duration_s = (_arrivals.loadgen_duration_s()
                           if duration_s is None else float(duration_s))
        self.seed = _arrivals.loadgen_seed() if seed is None else int(seed)
        self._stats = [_ReplicaStats() for _ in self.replicas]
        self._stop = threading.Event()

    def stop(self) -> None:
        """Abort the run early (remaining scheduled arrivals dropped)."""
        self._stop.set()

    # -- per-replica worker ------------------------------------------------

    def _fire(self, idx: int, rep, send_mono: float) -> None:
        st = self._stats[idx]
        start = time.monotonic()
        outcome, version = "ok", 0
        try:
            version, _ = rep.serve_step()
        except Exception as e:  # noqa: BLE001 — outcome-classified below
            outcome = ("stale" if type(e).__name__ == "StaleSnapshotError"
                       else "error")
        done = time.monotonic()
        # the open-loop latency: from the SCHEDULED send, so queueing
        # delay while this worker was behind schedule is charged here
        lat_ms = (done - send_mono) * 1e3
        st.latencies_ms.append(lat_ms)
        st.outcomes[outcome] = st.outcomes.get(outcome, 0) + 1
        note = getattr(rep, "note_request", None)
        if note is not None:
            if note(send_mono, done, version=version, outcome=outcome,
                    start_mono=start):
                st.violations += 1
        else:
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.journal("serve_request", replica=idx,
                            send_mono=send_mono, start_mono=start,
                            done_mono=done, latency_ms=lat_ms,
                            version=version, outcome=outcome)

    def _worker(self, idx: int, rep, offsets: List[float],
                t0: float) -> None:
        for off in offsets:
            target = t0 + off
            while not self._stop.is_set():
                delta = target - time.monotonic()
                if delta <= 0:
                    break
                time.sleep(min(delta, 0.05))
            if self._stop.is_set():
                return
            # NEVER re-anchor: if we are behind, fire immediately with
            # send_ts = target (the scheduled time), not "now"
            self._fire(idx, rep, target)

    # -- the run -----------------------------------------------------------

    def run(self) -> LoadReport:
        reg = _telemetry.get_registry()
        offsets = [
            _arrivals.arrival_times(self.schedule, self.rate_hz,
                                    self.duration_s, self.seed, stream=i)
            for i in range(len(self.replicas))
        ]
        if reg.enabled:
            reg.journal("loadgen_start", replicas=len(self.replicas),
                        schedule=self.schedule, rate_hz=self.rate_hz,
                        duration_s=self.duration_s, seed=self.seed,
                        planned=sum(len(o) for o in offsets))
        t0 = time.monotonic()
        threads = [
            threading.Thread(target=self._worker, name=f"loadgen-{i}",
                             args=(i, rep, offsets[i], t0), daemon=True)
            for i, rep in enumerate(self.replicas)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        for rep in self.replicas:
            close = getattr(rep, "close_slo", None)
            if close is not None:
                close()
        rep_out = self._report(wall)
        if reg.enabled:
            reg.journal("loadgen_done", requests=rep_out.requests,
                        qps=rep_out.qps, p50_ms=rep_out.p50_ms,
                        p99_ms=rep_out.p99_ms,
                        slo_violations=rep_out.slo_violations)
        return rep_out

    def _report(self, wall_s: float) -> LoadReport:
        out = LoadReport(duration_s=wall_s)
        all_lat: List[float] = []
        for i, (rep, st) in enumerate(zip(self.replicas, self._stats)):
            rid = getattr(rep, "replica_id", i)
            all_lat.extend(st.latencies_ms)
            out.requests += len(st.latencies_ms)
            out.slo_violations += st.violations
            for k, v in st.outcomes.items():
                out.outcomes[k] = out.outcomes.get(k, 0) + v
            lat = sorted(st.latencies_ms)
            out.per_replica[int(rid)] = {
                "requests": len(lat),
                "qps": len(lat) / wall_s if wall_s > 0 else 0.0,
                "p50_ms": _quantile(lat, 0.50),
                "p99_ms": _quantile(lat, 0.99),
                "violations": st.violations,
            }
        all_lat.sort()
        out.qps = out.requests / wall_s if wall_s > 0 else 0.0
        out.p50_ms = _quantile(all_lat, 0.50)
        out.p99_ms = _quantile(all_lat, 0.99)
        out.max_ms = all_lat[-1] if all_lat else float("nan")
        return out
