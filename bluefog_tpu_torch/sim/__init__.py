"""Deterministic fleet simulator: virtual-clock fault campaigns over
the REAL protocol state machines (counterpart of ``bluefog_tpu/sim``).

The package has two faces:

- the **clock seam** (:mod:`bluefog_tpu_torch.sim.clock`): a tiny ``Clock``
  abstraction (monotonic ``now`` / ``sleep`` / ``deadline``) that the
  resilience modules accept by injection and default to wall time —
  production behavior is bit-for-bit unchanged, but a
  :class:`~bluefog_tpu_torch.sim.events.VirtualClock` lets the same code run
  against an event-queue scheduler that advances time instantly;

- the **fleet lab** (:mod:`bluefog_tpu_torch.sim.fleet` /
  :mod:`bluefog_tpu_torch.sim.campaign`): a single-process ``SimTransport``
  implementing the mailbox/window contract (deposit, collect,
  versions, mutex, liveness words, membership board) against
  in-memory state, a fleet driver that runs the real
  ``FailureDetector`` / ``EdgeHealth`` / ``AdaptivePolicy`` /
  ``heal_topology`` / ``grow_topology`` / ``demote_topology`` /
  ``MembershipBoard`` code paths at 256+ ranks in seconds, and a
  campaign runner (``python -m bluefog_tpu_torch.sim``) that injects seeded
  fault schedules, checks the standing invariants after every
  protocol event, and shrinks violations delta-debugging-style to a
  minimal replayable repro.

Import is deliberately light: only the clock surface loads eagerly
(the resilience package imports it on every startup); the fleet lab
(numpy and the port's own digraph) loads on first attribute access.
"""

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
    "EventLoop",
    "VirtualClock",
    "Fault",
    "FaultSchedule",
    "SimTransport",
    "SimBoard",
    "SimFleet",
    "SimConfig",
    "CampaignResult",
    "run_campaign",
    "shrink_schedule",
]

_LAZY = {
    "EventLoop": "bluefog_tpu_torch.sim.events",
    "VirtualClock": "bluefog_tpu_torch.sim.events",
    "Fault": "bluefog_tpu_torch.sim.schedule",
    "FaultSchedule": "bluefog_tpu_torch.sim.schedule",
    "SimTransport": "bluefog_tpu_torch.sim.transport",
    "SimBoard": "bluefog_tpu_torch.sim.transport",
    "SimFleet": "bluefog_tpu_torch.sim.fleet",
    "SimConfig": "bluefog_tpu_torch.sim.campaign",
    "CampaignResult": "bluefog_tpu_torch.sim.campaign",
    "run_campaign": "bluefog_tpu_torch.sim.campaign",
    "shrink_schedule": "bluefog_tpu_torch.sim.campaign",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
