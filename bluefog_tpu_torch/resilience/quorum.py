"""Quorum fencing for membership commits + the ORPHAN quiesce verdict.

Every earlier resilience layer treats a silent peer as a *crash*: the
detector declares it dead, :func:`~bluefog_tpu_torch.resilience.healing.
heal_topology` excises it, life goes on.  A network **partition**
breaks that model — both sides see the other silent, both heal, and
two live islands keep gossiping under one job name with divergent
membership epochs and a double-counted mass ledger (split-brain).

The fence is the classic quorum rule: a heal or demote may only
*commit* when the committer can still account for a **strict majority
of the current membership epoch** as live.  The minority side gets the
other verdict — it is the ORPHAN: it must stop healing, freeze its
windows, park its progress engine, and wait for connectivity to
return, at which point it re-enters through the join machinery
(:func:`bluefog_tpu_torch.islands.merge_orphan`) carrying its debiased
estimate.  At most one epoch lineage can therefore commit progress
during any partition — the invariant the simulator checks after every
event (:mod:`bluefog_tpu_torch.sim.invariants`).

``BFTPU_QUORUM=off`` restores the pre-quorum behavior (every side
heals; fine for fleets whose only failure mode really is crashes).
The default is ``majority``: when a strict majority is visible the
fence changes nothing — heals proceed exactly as before — so only
sub-majority splits behave differently, and those were split-brain
territory anyway.  See docs/RESILIENCE.md "Orphan quiesce".
"""

from __future__ import annotations

import os

__all__ = [
    "OrphanedError",
    "quorum_mode",
    "quorum_enabled",
    "quorum_met",
    "majority_floor",
]


class OrphanedError(RuntimeError):
    """This rank lost membership quorum and quiesced (ORPHAN state).

    Retriable by design: the rank's state is intact and frozen — the
    caller should back off, wait for connectivity, and either retry
    after :func:`bluefog_tpu_torch.islands.merge_orphan` re-admits the rank,
    or surface the stall to its own supervisor.  ``live``/``total``
    record the membership arithmetic behind the verdict.
    """

    def __init__(self, message: str, live: int = -1, total: int = -1,
                 epoch: int = -1):
        super().__init__(message)
        self.live = live
        self.total = total
        self.epoch = epoch


def quorum_mode() -> str:
    """``BFTPU_QUORUM``: ``majority`` (default) fences heal/demote
    commits on a strict-majority live set; ``off`` restores the
    unfenced behavior."""
    mode = os.environ.get("BFTPU_QUORUM", "majority").strip().lower()
    return mode if mode in ("majority", "off") else "majority"


def quorum_enabled() -> bool:
    return quorum_mode() != "off"


def majority_floor(total: int) -> int:
    """Minimum live count that constitutes a strict majority of a
    ``total``-member epoch: ``floor(total/2) + 1``.  A 1-member epoch
    trivially has quorum (itself)."""
    return max(1, int(total) // 2 + 1)


def quorum_met(live: int, total: int) -> bool:
    """Strict-majority test: can ``live`` members of a ``total``-member
    epoch commit a membership change?"""
    return int(live) >= majority_floor(total)
