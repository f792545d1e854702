"""Discrete-event scheduler + the virtual clock bound to it.

The loop is a plain ``heapq`` of ``(time, seq, callback)`` with a
monotone sequence tie-break, so two events at the same instant fire in
schedule order and a same-seed run replays the EXACT event sequence —
the determinism contract the campaign runner's bit-identical-replay
test rides on.

The one non-obvious design point is **re-entrancy**:
``VirtualClock.sleep(dt)`` does not suspend anything — it calls
``loop.run_until(now + dt)``, draining every event due in the window
and then landing time on the target.  A real blocking poll loop
(``MembershipBoard.wait_for_grant``: read board → sleep → read board)
therefore runs UNMODIFIED inside an event callback: each of its
"sleeps" gives every other rank scheduled in the window a turn, which
is exactly what the OS scheduler would have done with threads — minus
the nondeterminism.  ``run_until`` nests safely because the heap and
the ``now`` watermark are shared and time only moves forward; an
outer frame resuming after a nested drain simply finds fewer events
due.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

from bluefog_tpu_torch.sim.clock import Clock

__all__ = ["EventLoop", "VirtualClock"]


class EventLoop:
    """Virtual-time event queue (see module docstring)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.events_fired = 0

    @property
    def now(self) -> float:
        return self._now

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at absolute virtual time ``t`` (clamped to
        now — a late schedule fires immediately, never in the past)."""
        self._seq += 1
        heapq.heappush(self._heap, (max(float(t), self._now),
                                    self._seq, fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self._now + max(0.0, float(dt)), fn)

    def run_until(self, target: float) -> None:
        """Fire every event due at or before ``target``, then advance
        time to ``target``.  Re-entrant (see module docstring)."""
        while self._heap and self._heap[0][0] <= target:
            t, _, fn = heapq.heappop(self._heap)
            if t > self._now:
                self._now = t
            self.events_fired += 1
            fn()
        if target > self._now:
            self._now = target

    def run(self, until: Optional[float] = None,
            max_events: int = 50_000_000) -> None:
        """Drain the queue (optionally stopping once the next event
        lies past ``until``).  ``max_events`` is a runaway backstop —
        a self-rescheduling event that never stops would otherwise
        spin forever."""
        fired = 0
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            t, _, fn = heapq.heappop(self._heap)
            if t > self._now:
                self._now = t
            self.events_fired += 1
            fired += 1
            if fired > max_events:
                raise RuntimeError(
                    f"event loop exceeded {max_events} events — runaway "
                    "reschedule?")
            fn()
        if until is not None and until > self._now:
            self._now = until


class VirtualClock(Clock):
    """The :class:`~bluefog_tpu_torch.sim.clock.Clock` face of an
    :class:`EventLoop`: ``now`` reads the loop watermark, ``sleep``
    drains the loop through the window (re-entrant poll-loop trick)."""

    def __init__(self, loop: EventLoop):
        self.loop = loop

    def now(self) -> float:
        return self.loop.now

    def sleep(self, seconds: float) -> None:
        self.loop.run_until(self.loop.now + max(0.0, float(seconds)))
