"""The standing invariants the fleet simulator audits continuously.

These are the properties the resilience design ARGUES hold at every
point of every fault interleaving (docs/RESILIENCE.md); the simulator
turns the argument into a check that runs after every protocol event
of a campaign.  Each checker returns ``None`` when the invariant
holds, or a human-readable violation string — the campaign layer
records, never raises, so one violation cannot mask later ones and
the shrinker can count them.

The numeric core of the doubly-stochastic check
(:func:`stochastic_violations`) is shared with the static analysis
plane — ``analysis.plan_rules.check_mixing_stochastic`` wraps the same
function over compiled plans, so the property audited offline on a
plan and online on a campaign's healed/demoted/grown graphs is
literally the same code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "stochastic_violations",
    "check_doubly_stochastic",
    "check_mass_conservation",
    "check_epoch_monotone",
    "check_minority_demotion",
    "check_consensus",
    "check_single_lineage",
    "check_partition_merge_mass",
    "check_serve_version_monotone",
    "check_serve_snapshot_committed",
    "check_distrib_tree",
    "check_distrib_staleness",
    "check_request_slo",
    "check_request_staleness",
    "check_open_loop",
    "demotion_cap",
]

#: float-epsilon tolerance for stochasticity sums (matches the
#: analysis plan rules)
STOCHASTIC_TOL = 1e-6


def stochastic_violations(W: np.ndarray, expect_column: bool = True,
                          tol: float = STOCHASTIC_TOL) -> List[str]:
    """Row/column/negativity violations of a mixing matrix, as message
    strings (empty list = doubly stochastic within ``tol``)."""
    out: List[str] = []
    rows = W.sum(axis=1)
    bad_rows = np.flatnonzero(np.abs(rows - 1.0) > tol)
    if bad_rows.size:
        out.append(
            f"row(s) {bad_rows[:6].tolist()} sum to "
            f"{rows[bad_rows[:6]].tolist()} (expected 1±{tol}) — gossip "
            "would not converge to a consensus")
    if expect_column:
        cols = W.sum(axis=0)
        bad_cols = np.flatnonzero(np.abs(cols - 1.0) > tol)
        if bad_cols.size:
            out.append(
                f"column(s) {bad_cols[:6].tolist()} sum to "
                f"{cols[bad_cols[:6]].tolist()} (expected 1±{tol}) — the "
                "fixed point drifts away from the true average")
    if (W < -tol).any():
        neg = np.argwhere(W < -tol)[:6].tolist()
        out.append(f"negative mixing weight(s) at {neg}")
    return out


def check_doubly_stochastic(G, tol: float = STOCHASTIC_TOL
                            ) -> Optional[str]:
    """Every healed/demoted/grown topology a campaign installs must
    carry a doubly stochastic W (the property that makes push-sum
    converge to the true average on the member set)."""
    from bluefog_tpu_torch import topology_util

    W = topology_util.GetWeightMatrix(G)
    bad = stochastic_violations(np.asarray(W), expect_column=True,
                                tol=tol)
    return None if not bad else "; ".join(bad)


def check_mass_conservation(live_x: float, live_p: float, transport,
                            initial: Tuple[float, float],
                            joined: Tuple[float, float],
                            tol: float = 1e-8) -> Optional[str]:
    """Every unit of push-sum mass lives in exactly one bucket —
    ``live + slots + inflight + lost == initial + joined`` — after
    EVERY event (transfers are intra-event).  ``tol`` is absolute on
    the relative-to-scale residual."""
    sx, sp = transport.slot_mass()
    ix, ip = transport.inflight_mass()
    want_x = initial[0] + joined[0]
    want_p = initial[1] + joined[1]
    have_x = live_x + sx + ix + transport.lost_x
    have_p = live_p + sp + ip + transport.lost_p
    scale_x = max(1.0, abs(want_x))
    scale_p = max(1.0, abs(want_p))
    dx = abs(have_x - want_x) / scale_x
    dp = abs(have_p - want_p) / scale_p
    if dx > tol or dp > tol:
        return (f"mass off balance: x residual {have_x - want_x:.3e} "
                f"(live {live_x:.6g} + slots {sx:.6g} + inflight "
                f"{ix:.6g} + lost {transport.lost_x:.6g} != initial "
                f"{initial[0]:.6g} + joined {joined[0]:.6g}), p residual "
                f"{have_p - want_p:.3e}")
    return None


def check_epoch_monotone(prev: int, cur: int) -> Optional[str]:
    """The membership-epoch word only ever moves forward (a backward
    word would re-admit a retired epoch's mailboxes)."""
    if cur < prev:
        return (f"membership epoch word went backward: {prev} -> {cur}")
    return None


def demotion_cap(n_members: int) -> int:
    """The adaptive-topology minority cap: strictly fewer than half of
    the members may be demoted (``(n-1)//2``) — the healthy majority
    must keep carrying the gossip."""
    return max(0, (int(n_members) - 1) // 2)


def check_minority_demotion(n_members: int,
                            n_demoted: int) -> Optional[str]:
    if n_demoted > demotion_cap(n_members):
        return (f"{n_demoted} of {n_members} members demoted — over the "
                f"minority cap {demotion_cap(n_members)} (the healthy "
                "majority must keep carrying the gossip)")
    return None


def check_single_lineage(committed_groups) -> Optional[str]:
    """At most ONE side of an active partition may commit membership
    progress (heal, demote/promote, grant) — the split-brain fence.
    ``committed_groups`` is the set of partition-group ids that
    committed during the current window; two or more means both sides
    advanced their own epoch lineage, and their ledgers have already
    diverged."""
    gs = sorted({int(g) for g in committed_groups})
    if len(gs) > 1:
        return (f"split-brain: partition sides {gs} each committed "
                "membership progress during one partition window — at "
                "most one epoch lineage may advance (the minority must "
                "ORPHAN and quiesce)")
    return None


def check_partition_merge_mass(anchor: Tuple[float, float],
                               current: Tuple[float, float],
                               tol: float = 1e-8) -> Optional[str]:
    """Mass is conserved ACROSS a partition + merge: the conserved
    quantity ``live + slots + inflight + lost - joined`` snapshotted
    when the cut landed (``anchor``) must still hold after every event
    of the window and the merge-back — an orphan whose old mass is not
    written off when it re-enters with unit mass shows up here as a
    double count."""
    dx = abs(current[0] - anchor[0]) / max(1.0, abs(anchor[0]))
    dp = abs(current[1] - anchor[1]) / max(1.0, abs(anchor[1]))
    if dx > tol or dp > tol:
        return (f"mass not conserved across partition+merge: x residual "
                f"{current[0] - anchor[0]:.3e} vs the cut-time anchor "
                f"{anchor[0]:.6g}, p residual {current[1] - anchor[1]:.3e}"
                f" vs {anchor[1]:.6g}")
    return None


def check_serve_version_monotone(prev: int, cur: int) -> Optional[str]:
    """The serving plane's snapshot version is strictly monotone — at
    the publisher (the region header survives publisher death, so a
    successor must continue past the highest committed version, never
    restart at 1) and at every replica (a hot-swap only ever installs
    a NEWER version; flipping backward would serve stale weights to
    traffic that already saw the new ones)."""
    if cur <= prev:
        return (f"serve version went backward: {prev} -> {cur} — a "
                "publisher re-committed (or a replica flipped to) a "
                "stale snapshot version")
    return None


def check_serve_snapshot_committed(served: float,
                                   committed) -> Optional[str]:
    """Whatever a replica serves must be byte-identical to SOME
    committed snapshot — never a torn mix of two versions.  The
    double-buffer seqlock guarantees this in the real region (a reader
    that catches a mid-write buffer retries); ``committed`` is the
    campaign's list of ``(version, payload)`` commits."""
    if any(served == p for _, p in committed):
        return None
    vs = [v for v, _ in committed]
    return (f"served payload {served!r} matches NO committed snapshot "
            f"(committed versions {vs[:8]}{'...' if len(vs) > 8 else ''})"
            " — a torn read mixed two buffer generations")


def check_distrib_tree(parents: Dict[int, int],
                       fanout: int) -> Optional[str]:
    """The distribution fan-out tree must stay a tree: every replica
    reaches the publisher (connected, acyclic) and no relay feeds more
    than ``fanout`` children.  Delegates to the REAL repair code's
    validator (:func:`bluefog_tpu_torch.serve.distrib.tree.tree_valid`) so
    the property audited in the sim and enforced by the coordinator is
    literally the same function.  The publisher itself is uncapped —
    it is the root of last resort when every relay is saturated."""
    from bluefog_tpu_torch.serve.distrib import tree as _tree

    return _tree.tree_valid(dict(parents), int(fanout))


def check_distrib_staleness(replica: int, lag: int,
                            slo: int) -> Optional[str]:
    """A tree-fed replica may trail the publisher's committed version
    by at most ``slo`` versions (0 = unbounded).  A relay death whose
    subtree never re-parents shows up here: the orphaned children stop
    adopting new versions while the publisher keeps committing."""
    if slo > 0 and lag > slo:
        return (f"distrib replica {replica} is {lag} versions behind "
                f"the publisher (staleness SLO {slo}) — its feed path "
                "stalled (dead relay never re-parented?)")
    return None


def check_request_slo(replica: int, latency_s: float, slo_s: float,
                      attributed: bool) -> Optional[str]:
    """Every admitted serve request completes within the latency SLO
    *or* its violation overlaps an injected fault window (a replica
    kill, publisher death, tree re-parent).  ``attributed=True`` means
    the campaign found such a window — a violation with a cause is the
    system degrading as designed; one without is a silent SLO hole
    (e.g. a drain path that skips polls)."""
    if slo_s <= 0 or latency_s <= slo_s or attributed:
        return None
    return (f"replica {replica}: request latency {latency_s:.3f}s "
            f"exceeds the {slo_s:.3f}s SLO with NO fault window to "
            "attribute it to — a silent serve-path stall")


def check_request_staleness(replica: int, lag: int, slo: int,
                            attributed: bool) -> Optional[str]:
    """A request must be served within ``slo`` versions of the
    committed head (0 = unbounded) unless publish churn / a kill / a
    re-parent window explains the trail — the staleness-SLO twin of
    :func:`check_request_slo`, audited per served request under
    churn."""
    if slo <= 0 or lag <= slo or attributed:
        return None
    return (f"replica {replica} served a request {lag} versions stale "
            f"(staleness SLO {slo}) outside every fault window — the "
            "swap path fell behind with nothing to blame")


def check_open_loop(sched_t: float, charged_t: float,
                    tol: float = 1e-9) -> Optional[str]:
    """The open-loop contract: latency is charged from the SCHEDULED
    send instant, never re-anchored to when the server got around to
    it.  A drain that rewrites send times hides queueing delay —
    coordinated omission, the measurement bug the real load generator
    exists to avoid."""
    if charged_t <= sched_t + tol:
        return None
    return (f"request scheduled at t={sched_t:.3f} had latency charged "
            f"from t={charged_t:.3f} — the drain re-anchored the send "
            "time (coordinated omission: queueing delay vanished)")


def check_consensus(estimates: Dict[int, float], tol: float = 1e-6,
                    scale: float = 1.0) -> Optional[str]:
    """At quiesce every live rank's debiased estimate ``x/p`` must
    agree (push-sum consensus).  ``scale`` normalizes the spread (the
    caller passes the magnitude of the true average)."""
    if len(estimates) < 2:
        return None
    vals = [estimates[g] for g in sorted(estimates)]
    lo, hi = min(vals), max(vals)
    spread = (hi - lo) / max(1.0, abs(scale))
    if spread > tol:
        glo = min(estimates, key=lambda g: estimates[g])
        ghi = max(estimates, key=lambda g: estimates[g])
        return (f"no consensus at quiesce: spread {spread:.3e} > {tol:g} "
                f"(rank {glo} at {estimates[glo]:.9g}, rank {ghi} at "
                f"{estimates[ghi]:.9g})")
    return None
