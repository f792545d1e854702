"""The serve SLO monitor: objectives, violation windows, attribution.

Two objectives, both env-armed and off by default:

- ``BFTPU_SERVE_SLO_MS`` — request latency objective in milliseconds
  (``done_ts - send_ts``, the open-loop definition that charges
  queueing delay); 0 disarms.
- ``BFTPU_SERVE_SLO_STALENESS`` — staleness objective in *versions*:
  a request served while the replica lags the committed version by
  more than this violates; 0 = unbounded.

Individual violating requests are noise; what an operator acts on is
the violation **window** — a maximal run of violations whose ends are
less than ``gap_s`` apart.  The monitor journals one ``slo_violation``
event per closed window carrying CLOCK_MONOTONIC bounds, which is what
lets ``python -m bluefog_tpu_torch.telemetry --slo-report`` join windows
against cause events (``serve_publish`` in flight, ``serve_respawn``,
``distrib_reparent``) from other processes' journals: on Linux the
monotonic clock is system-wide, so cross-process mono timestamps are
directly comparable.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from bluefog_tpu_torch import telemetry as _telemetry

__all__ = ["SLOMonitor", "serve_slo_ms", "serve_slo_staleness"]


def serve_slo_ms() -> float:
    """``BFTPU_SERVE_SLO_MS``: latency objective in ms (0 = disarmed)."""
    try:
        return max(0.0, float(os.environ.get("BFTPU_SERVE_SLO_MS", "0")))
    except ValueError:
        return 0.0


def serve_slo_staleness() -> int:
    """``BFTPU_SERVE_SLO_STALENESS``: max served lag in versions
    (0 = unbounded)."""
    try:
        return max(0, int(os.environ.get("BFTPU_SERVE_SLO_STALENESS", "0")))
    except ValueError:
        return 0


class SLOMonitor:
    """Fold per-request outcomes into gap-closed violation windows.

    One monitor per replica; feed it every completed request via
    :meth:`note` and :meth:`close` it at teardown to flush the open
    window.  Windows are kept in-process (``self.windows``) *and*
    journaled, so tests can assert without a journal and the merge CLI
    can attribute across processes with one.
    """

    def __init__(self, replica_id: int = 0, *,
                 slo_ms: Optional[float] = None,
                 staleness_slo: Optional[int] = None,
                 gap_s: float = 0.25):
        self.replica_id = int(replica_id)
        self.slo_s = (serve_slo_ms() if slo_ms is None
                      else max(0.0, float(slo_ms))) / 1e3
        self.staleness_slo = (serve_slo_staleness() if staleness_slo is None
                              else max(0, int(staleness_slo)))
        self.gap_s = float(gap_s)
        self.requests = 0
        self.violations = 0
        self.windows: List[dict] = []
        self._open: Optional[dict] = None

    @property
    def armed(self) -> bool:
        return self.slo_s > 0 or self.staleness_slo > 0

    @property
    def state(self) -> int:
        """Statuspage encoding: -1 = disarmed or no traffic yet,
        0 = inside the objective, 1 = in an open violation window."""
        if not self.armed or self.requests == 0:
            return -1
        return 1 if self._open is not None else 0

    def note(self, send_mono: float, done_mono: float,
             lag: int = 0) -> bool:
        """Record one completed request; returns True iff it violated."""
        self.requests += 1
        latency_s = max(0.0, float(done_mono) - float(send_mono))
        kinds = []
        if self.slo_s > 0 and latency_s > self.slo_s:
            kinds.append("latency")
        if self.staleness_slo > 0 and int(lag) > self.staleness_slo:
            kinds.append("staleness")
        if not kinds:
            # a compliant completion past the gap closes the window; a
            # compliant completion *inside* the gap does not — requests
            # overlap in flight, so strict alternation would shred one
            # stall into many windows
            if (self._open is not None
                    and done_mono - self._open["t1_mono"] > self.gap_s):
                self._flush()
            return False
        self.violations += 1
        # journal "mono" is registry-relative, so windows carry their
        # own absolute bounds: raw CLOCK_MONOTONIC (system-wide on
        # Linux) plus wall-clock twins — the merge CLI joins cause
        # events by their universal "ts" field
        off = time.time() - time.monotonic()
        w = self._open
        if w is not None and done_mono - w["t1_mono"] <= self.gap_s:
            w["t1_mono"] = max(w["t1_mono"], float(done_mono))
            w["t1_wall"] = w["t1_mono"] + off
            w["requests"] += 1
            w["worst_ms"] = max(w["worst_ms"], latency_s * 1e3)
            for k in kinds:
                if k not in w["kinds"]:
                    w["kinds"].append(k)
        else:
            if w is not None:
                self._flush()
            self._open = {
                "replica": self.replica_id,
                "t0_mono": float(send_mono),
                "t1_mono": float(done_mono),
                "t0_wall": float(send_mono) + off,
                "t1_wall": float(done_mono) + off,
                "requests": 1,
                "worst_ms": latency_s * 1e3,
                "kinds": list(kinds),
            }
        return True

    def _flush(self) -> None:
        w, self._open = self._open, None
        if w is None:
            return
        self.windows.append(w)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("serve.slo_windows",
                        replica=str(self.replica_id)).inc()
            reg.journal("slo_violation", **w)

    def close(self) -> None:
        """Flush the open window (call at loadgen/replica teardown)."""
        self._flush()
