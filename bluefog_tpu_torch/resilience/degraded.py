"""Degraded-step semantics: deadlines, retry/backoff, and mass-conserving
weight renormalization on neighbor loss.

Two primitives:

- :func:`with_deadline` — run a blocking transport op under a deadline
  with bounded retries and exponential backoff, raising
  :class:`DeadlineExceeded` (a ``TimeoutError``) instead of hanging.
  The island win ops wrap their barrier/mutex/peer waits in this so "no
  win-op blocks past its deadline" holds end to end.

- :func:`renormalize_weights` — given a combine's ``(self_weight,
  neighbor_weights)`` row and a dead-rank set, drop the dead neighbors
  and rescale the survivors so the row still sums to EXACTLY 1.  For
  plain gossip this keeps the step a convex average; for push-sum it is
  the mass-conserving fallback: the associated scalar ``p`` is combined
  with the SAME renormalized row, so the x/p ratio stays a consistent
  estimate and Σp over the survivors is conserved — the dead rank's
  in-flight mass was already excised by the force-drain (see
  DEPOSIT_COMMITS_AFTER_PAYLOAD in native/shm_native.py).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Tuple, TypeVar

from bluefog_tpu_torch.sim.clock import resolve_clock as _resolve_clock
from bluefog_tpu_torch.telemetry import registry as _telemetry

__all__ = [
    "DeadlineExceeded",
    "op_deadline_s",
    "with_deadline",
    "renormalize_weights",
]

T = TypeVar("T")


class DeadlineExceeded(TimeoutError):
    """A win op exhausted its deadline + retry budget."""


def op_deadline_s() -> float:
    """Per-attempt deadline for blocking win-op waits
    (``BFTPU_OP_DEADLINE_S``, default generous — legitimate barrier
    waits can be long)."""
    try:
        return float(os.environ.get("BFTPU_OP_DEADLINE_S", "30.0"))
    except ValueError:
        return 30.0


def with_deadline(fn: Callable[[float], T], describe: str,
                  deadline: float = None, retries: int = 2,
                  backoff: float = 0.05,
                  on_timeout: Callable[[], None] = None,
                  clock=None) -> T:
    """Call ``fn(remaining_seconds)`` under a total deadline.

    ``fn`` receives the per-attempt budget and must raise TimeoutError
    when it expires (the transports' timed waits do).  Between attempts
    ``on_timeout`` runs (the hook where the caller consults the failure
    detector and heals) and the backoff doubles.  After ``retries``
    failed attempts, DeadlineExceeded is raised naming the op.
    ``clock`` is the sim/clock.py seam for the backoff pause; ``None``
    is wall time.
    """
    clk = _resolve_clock(clock)
    total = op_deadline_s() if deadline is None else float(deadline)
    per_attempt = total / max(1, retries)
    pause = backoff
    last: Exception = None
    for attempt in range(max(1, retries)):
        try:
            return fn(per_attempt)
        except TimeoutError as e:
            last = e
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("resilience.deadline_retries").inc()
            if on_timeout is not None:
                on_timeout()
            if attempt + 1 < max(1, retries):
                clk.sleep(pause)
                pause *= 2
    reg = _telemetry.get_registry()
    if reg.enabled:
        reg.counter("resilience.deadline_exhausted").inc()
        reg.journal("deadline_exhausted", op=describe, deadline_s=total,
                    attempts=max(1, retries))
    raise DeadlineExceeded(
        f"{describe} exceeded its {total:.3f}s deadline "
        f"after {max(1, retries)} attempts: {last}")


def renormalize_weights(self_weight: float,
                        neighbor_weights: Dict[int, float],
                        dead: Iterable[int],
                        ) -> Tuple[float, Dict[int, float]]:
    """Drop dead neighbors from a combine row and rescale so it sums
    to exactly 1 (mass-conserving degraded combine).

    If every neighbor is dead the row degenerates to ``(1.0, {})`` —
    the rank keeps gossiping with itself until the healed topology
    reconnects it.
    """
    dead_set = set(int(r) for r in dead)
    alive = {int(r): float(w) for r, w in neighbor_weights.items()
             if int(r) not in dead_set}
    total = float(self_weight) + sum(alive.values())
    if not alive or total <= 0.0:
        return 1.0, {}
    scale = 1.0 / total
    return float(self_weight) * scale, {r: w * scale
                                        for r, w in alive.items()}
