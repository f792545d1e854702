"""The clock seam: injectable monotonic time for the resilience stack.

Every time-dependent protocol decision in the repo — heartbeat
staleness, edge-deadline misses, hysteresis floors, join-lease
timeouts, retry backoff — reads ONE of two primitives: a monotonic
``now()`` and a ``sleep()``.  This module names that surface so it can
be swapped:

- :class:`RealClock` (the default everywhere) delegates to
  ``time.monotonic`` / ``time.sleep`` — production behavior is
  bit-for-bit what it was before the seam existed;
- :class:`FakeClock` is a manually-advanced clock for unit tests
  (deadlines fire at EXACT virtual instants, no wall sleeps);
- :class:`~bluefog_tpu.sim.events.VirtualClock` binds ``sleep`` to an
  event-queue scheduler, so real blocking poll loops
  (``MembershipBoard.wait_for_grant``, ``with_deadline`` backoff) run
  single-threaded inside the simulator while other ranks' events fire
  during the "sleep".

Two injection conventions coexist in the codebase and both are
honored here:

- modules that only ever READ time (``EdgeHealth``,
  ``AdaptivePolicy``) take a bare callable (``clock=time.monotonic``);
  :func:`now_fn` normalizes a ``Clock`` | callable | ``None`` into
  that callable;
- modules that also SLEEP (``join``, ``degraded``, ``chaos``) take a
  ``Clock``; :func:`resolve_clock` normalizes ``None`` → the shared
  :data:`REAL_CLOCK` and a bare callable → a read-only wrapper whose
  ``sleep`` still really sleeps (a now-only fake must not spin a poll
  loop into a busy-wait).
"""

from __future__ import annotations

import time

__all__ = [
    "Clock",
    "RealClock",
    "FakeClock",
    "REAL_CLOCK",
    "now_fn",
    "resolve_clock",
]


class Clock:
    """Monotonic now / sleep / deadline.  Subclasses override
    :meth:`now` and :meth:`sleep`; everything else derives."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def deadline(self, timeout_s: float) -> float:
        """The absolute instant ``timeout_s`` from now."""
        return self.now() + float(timeout_s)

    def expired(self, deadline: float) -> bool:
        return self.now() >= deadline


class RealClock(Clock):
    """Wall time: ``time.monotonic`` / ``time.sleep``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """A manually-advanced clock for deterministic unit tests.

    ``sleep`` advances time instantly (and remembers how long it was
    asked to sleep, so tests can assert the poll cadence); ``advance``
    moves time without a sleep.  No wall time is ever consumed.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self.slept: list = []

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.slept.append(float(seconds))
        self._t += max(0.0, float(seconds))

    def advance(self, seconds: float) -> float:
        self._t += max(0.0, float(seconds))
        return self._t


class _NowOnlyClock(Clock):
    """Wrap a bare ``now``-callable into a Clock whose ``sleep`` still
    really sleeps (see module docstring)."""

    def __init__(self, now_callable):
        self._now = now_callable

    def now(self) -> float:
        return float(self._now())

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


REAL_CLOCK = RealClock()


def now_fn(clock=None):
    """Normalize ``Clock`` | callable | ``None`` to a now-callable (the
    convention ``EdgeHealth`` / ``AdaptivePolicy`` already use)."""
    if clock is None:
        return time.monotonic
    if isinstance(clock, Clock):
        return clock.now
    return clock


def resolve_clock(clock=None) -> Clock:
    """Normalize ``Clock`` | callable | ``None`` to a ``Clock``."""
    if clock is None:
        return REAL_CLOCK
    if isinstance(clock, Clock):
        return clock
    return _NowOnlyClock(clock)
