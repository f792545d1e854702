"""The clock seam of the fleet simulator (counterpart of
``bluefog_tpu/sim``): a tiny ``Clock`` abstraction (monotonic ``now`` /
``sleep`` / ``deadline``) that the resilience modules accept by injection
and default to wall time, and the seeded fault schedule
(:mod:`bluefog_tpu_torch.sim.schedule`, loaded on first attribute access).
The rest of the simulator (event loop, fleet, campaigns) is not in this
package yet."""

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
    "Fault",
    "FaultSchedule",
]

_LAZY = {
    "Fault": "bluefog_tpu_torch.sim.schedule",
    "FaultSchedule": "bluefog_tpu_torch.sim.schedule",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
