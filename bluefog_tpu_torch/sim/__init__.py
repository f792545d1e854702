"""The clock seam of the fleet simulator (counterpart of
``bluefog_tpu/sim``): a tiny ``Clock`` abstraction (monotonic ``now`` /
``sleep`` / ``deadline``) that the resilience modules accept by injection
and default to wall time.  The simulator itself (event loop, fleet,
campaigns) is not in this package yet."""

from __future__ import annotations

from bluefog_tpu_torch.sim.clock import (  # noqa: F401
    Clock, FakeClock, RealClock, REAL_CLOCK, now_fn, resolve_clock)

__all__ = [
    "Clock",
    "RealClock",
    "FakeClock",
    "REAL_CLOCK",
    "now_fn",
    "resolve_clock",
]
