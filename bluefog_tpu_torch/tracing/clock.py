"""Min-RTT clock-offset estimation over the TCP coordinator path.

Every rank's spans are stamped with its own ``CLOCK_MONOTONIC``; to merge
them, each rank estimates the offset of its clock from the coordinator's
(rank 0's) with the classic NTP two-point exchange: send local ``t0``,
receive the coordinator's ``remote`` reading, note local ``t1``.  Under
the symmetric-delay assumption the coordinator read the clock at local
time ``(t0 + t1) / 2``, so::

    offset = remote - (t0 + t1) / 2        # coordinator ≈ local + offset
    error  ≤ (t1 - t0) / 2                 # half the round-trip

Asymmetry only widens the error bound, never escapes it, so keeping the
**minimum-RTT** sample (the exchange least disturbed by queueing) gives
the tightest bound — the estimator below retains exactly that sample and
is re-fed once per heartbeat by the resilience detector.

Same-host shm ranks never probe: Linux ``CLOCK_MONOTONIC`` is
system-wide, so their offset is identically 0 with error 0 — the
estimator's initial state.
"""

from __future__ import annotations

from typing import Dict


class ClockEstimator:
    """Keeps the min-RTT offset sample from a stream of clock probes.

    All times are seconds on ``time.monotonic()``'s scale.  ``offset``
    is *coordinator minus local*: add it to a local timestamp to express
    it on the coordinator's clock.  ``err`` bounds ``|true - offset|``.
    """

    def __init__(self):
        self.offset = 0.0
        self.err = 0.0
        self.best_rtt = float("inf")
        self.samples = 0

    def add_sample(self, t0: float, remote: float, t1: float) -> bool:
        """Feed one probe; returns True when it tightened the estimate.
        Probes with non-positive RTT (clock weirdness, retried sockets)
        are discarded."""
        rtt = t1 - t0
        if rtt <= 0.0:
            return False
        self.samples += 1
        if rtt >= self.best_rtt:
            return False
        self.best_rtt = rtt
        self.offset = remote - (t0 + t1) / 2.0
        self.err = rtt / 2.0
        return True

    def as_dict(self) -> Dict:
        return {
            "offset_s": self.offset,
            "err_s": self.err,
            "best_rtt_s": (None if self.best_rtt == float("inf")
                           else self.best_rtt),
            "samples": self.samples,
        }
