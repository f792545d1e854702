"""Rule family 1: static verification of comm plans and topologies.

Verifies, entirely on the host and without touching a device, the
invariants the gossip runtime's correctness rests on:

- every ``CommPlan`` shift class is a valid permutation (each rank at
  most once as source and at most once as destination) — the precondition
  for lowering a class to one ``lax.ppermute``;
- the classes jointly cover the topology's (non-self) edge set exactly —
  a dropped edge silently biases the average toward the remaining
  neighbors, a duplicated one double-counts a neighbor;
- the reconstructed mixing matrix is row-stochastic (decentralized
  averaging's convergence condition, arXiv:2111.04287 §2) and — for
  every constructor in this library — column-stochastic, which is what
  preserves the global average exactly;
- the spectral gap ``1 - |λ₂(W)|`` is strictly positive (gossip actually
  mixes) and is reported per topology as a metric;
- the per-class slot/mask bookkeeping (``slot_index``, ``recv_mask``,
  ``send_mask``) is self-consistent with the in-neighbor lists that
  drive ``neighbor_allgather`` output placement.

The default corpus is every named constructor × every size in
``DEFAULT_SIZES`` (2..64), plus one step of each dynamic one-peer
generator — the shapes the HLO contracts and benchmarks deploy.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.core.plan import CommPlan, compile_plan, plan_from_neighbor_lists

from bluefog_tpu_torch.analysis.engine import Finding, Report, Severity, registry

__all__ = [
    "CORPUS_TOPOLOGIES",
    "DEFAULT_SIZES",
    "check_classes_are_permutations",
    "check_edge_cover",
    "check_slot_consistency",
    "check_mixing_stochastic",
    "check_spectral_gap",
    "check_plan",
    "spectral_gap",
]

_TOL = 1e-9

#: Named corpus: label -> constructor(size).  Every constructor here
#: produces a doubly stochastic mixing matrix (uniform weights on regular
#: graphs; Metropolis–Hastings on the irregular ones), so the column
#: check applies corpus-wide.
CORPUS_TOPOLOGIES = {
    "exp2": tu.ExponentialTwoGraph,
    "sym_exp4": tu.SymmetricExponentialGraph,
    "ring": tu.RingGraph,
    "ring_uni": lambda n: tu.RingGraph(n, connect_style=1),
    "star": tu.StarGraph,
    "mesh2d": tu.MeshGrid2DGraph,
    "full": tu.FullyConnectedGraph,
}

DEFAULT_SIZES: Tuple[int, ...] = tuple(range(2, 65))


# ---------------------------------------------------------------------------
# per-subject checks (pure; tests call these directly)
# ---------------------------------------------------------------------------


def check_classes_are_permutations(plan: CommPlan,
                                   label: str = "plan") -> List[Finding]:
    """Each shift class must be a permutation fragment: within one class a
    rank appears at most once as source and at most once as destination,
    and every rank index is in range.  (Self-edges are permitted — the
    loopback bench plan uses one — but must still be unique.)"""
    out: List[Finding] = []
    for c, cls in enumerate(plan.classes):
        srcs = [s for s, _ in cls.perm]
        dsts = [d for _, d in cls.perm]
        subject = f"{label} class {c}"
        for kind, ranks in (("source", srcs), ("destination", dsts)):
            dup = {r for r in ranks if ranks.count(r) > 1}
            if dup:
                out.append(Finding(
                    "plan.class-permutation", subject,
                    f"rank(s) {sorted(dup)} appear more than once as "
                    f"{kind} — the class cannot lower to one ppermute"))
        bad = [(s, d) for s, d in cls.perm
               if not (0 <= s < plan.size and 0 <= d < plan.size)]
        if bad:
            out.append(Finding(
                "plan.class-permutation", subject,
                f"edge(s) {bad} reference ranks outside 0..{plan.size - 1}"))
    return out


def _topology_edges(topo: tu.DiGraph) -> List[Tuple[int, int]]:
    return sorted((int(u), int(v)) for u, v in topo.edges if u != v)


def check_edge_cover(plan: CommPlan, topo: tu.DiGraph,
                     label: str = "plan") -> List[Finding]:
    """The union of class perms must equal the topology's non-self edge
    set exactly — each edge in exactly one class."""
    out: List[Finding] = []
    plan_edges: List[Tuple[int, int]] = []
    for cls in plan.classes:
        plan_edges.extend(cls.perm)
    plan_sorted = sorted(plan_edges)
    dup = sorted({e for e in plan_sorted if plan_edges.count(e) > 1})
    if dup:
        out.append(Finding(
            "plan.edge-cover", label,
            f"edge(s) {dup[:6]} appear in more than one class — the value "
            "would be combined twice"))
    topo_edges = _topology_edges(topo)
    missing = sorted(set(topo_edges) - set(plan_sorted))
    extra = sorted(set(plan_sorted) - set(topo_edges))
    if missing:
        out.append(Finding(
            "plan.edge-cover", label,
            f"{len(missing)} topology edge(s) not scheduled by any class "
            f"(first: {missing[:6]}) — those neighbors never transfer"))
    if extra:
        out.append(Finding(
            "plan.edge-cover", label,
            f"{len(extra)} scheduled edge(s) not in the topology "
            f"(first: {extra[:6]})"))
    return out


def check_slot_consistency(plan: CommPlan,
                           label: str = "plan") -> List[Finding]:
    """recv_mask/send_mask/slot_index must agree with the class perms and
    with the ascending in-neighbor slot convention."""
    out: List[Finding] = []
    for c, cls in enumerate(plan.classes):
        subject = f"{label} class {c}"
        recv_of = {d: s for s, d in cls.perm}
        send_set = {s for s, _ in cls.perm}
        for r in range(plan.size):
            recv_expected = 1 if r in recv_of else 0
            if cls.recv_mask[r] != recv_expected:
                out.append(Finding(
                    "plan.slot-consistency", subject,
                    f"recv_mask[{r}] = {cls.recv_mask[r]} but the class "
                    f"{'delivers' if recv_expected else 'does not deliver'} "
                    f"to rank {r}"))
            send_expected = 1.0 if r in send_set else 0.0
            if float(cls.send_mask[r]) != send_expected:
                out.append(Finding(
                    "plan.slot-consistency", subject,
                    f"send_mask[{r}] = {cls.send_mask[r]}, expected "
                    f"{send_expected}"))
            if r in recv_of:
                nbrs = plan.in_neighbors[r]
                src = recv_of[r]
                want = nbrs.index(src) if src in nbrs else None
                if want is None or cls.slot_index[r] != want:
                    out.append(Finding(
                        "plan.slot-consistency", subject,
                        f"slot_index[{r}] = {cls.slot_index[r]} but source "
                        f"{src} sits at position {want} of in-neighbors "
                        f"{nbrs} — allgather output placement would "
                        "scramble"))
            elif cls.slot_index[r] != -1:
                out.append(Finding(
                    "plan.slot-consistency", subject,
                    f"slot_index[{r}] = {cls.slot_index[r]} for a rank that "
                    "receives nothing (expected -1)"))
            if cls.recv_mask[r] == 0 and cls.recv_weights[r] != 0.0:
                out.append(Finding(
                    "plan.slot-consistency", subject,
                    f"recv_weights[{r}] = {cls.recv_weights[r]} but "
                    "recv_mask is 0 — a masked rank must carry zero weight"))
    for d in range(plan.size):
        if plan.in_degrees[d] != len(plan.in_neighbors[d]):
            out.append(Finding(
                "plan.slot-consistency", f"{label} rank {d}",
                f"in_degrees[{d}] = {plan.in_degrees[d]} != "
                f"len(in_neighbors) = {len(plan.in_neighbors[d])}"))
        if plan.out_degrees[d] != len(plan.out_neighbors[d]):
            out.append(Finding(
                "plan.slot-consistency", f"{label} rank {d}",
                f"out_degrees[{d}] = {plan.out_degrees[d]} != "
                f"len(out_neighbors) = {len(plan.out_neighbors[d])}"))
    return out


def check_mixing_stochastic(plan: CommPlan, label: str = "plan",
                            expect_column: bool = True,
                            tol: float = _TOL) -> List[Finding]:
    """Rows of the reconstructed W must sum to 1 (convergence to *a*
    consensus); columns too when the constructor promises it (convergence
    to the *average*); entries must be non-negative.

    The numeric core is shared with the fleet simulator's continuous
    invariant audit (``sim.invariants.stochastic_violations``) — one
    implementation of the property, checked offline on plans and online
    on campaign topologies."""
    from bluefog_tpu_torch.sim.invariants import stochastic_violations

    return [Finding("plan.mixing-stochastic", label, msg)
            for msg in stochastic_violations(
                plan.mixing_matrix(), expect_column=expect_column,
                tol=tol)]


def spectral_gap(W: np.ndarray) -> float:
    """``1 - |λ₂|`` of the mixing matrix: the per-step contraction rate of
    the consensus error for doubly stochastic W."""
    if W.shape[0] < 2:
        return 1.0
    mods = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
    return float(1.0 - mods[1])


def check_spectral_gap(plan: CommPlan, label: str = "plan",
                       min_gap: float = 1e-9) -> Tuple[List[Finding], float]:
    """Returns (findings, gap).  A zero gap on a connected topology means
    the chain does not mix (e.g. a periodic W) — an error; the gap value
    itself is the reported metric."""
    gap = spectral_gap(plan.mixing_matrix())
    out: List[Finding] = []
    if plan.size > 1 and gap <= min_gap:
        out.append(Finding(
            "plan.spectral-gap", label,
            f"spectral gap {gap:.3e} <= {min_gap:.0e} — gossip on this "
            "plan never contracts the consensus error"))
    return out, gap


def check_plan(plan: CommPlan, topo: Optional[tu.DiGraph] = None,
               label: str = "plan", expect_column: bool = True,
               report: Optional[Report] = None) -> Report:
    """Run every plan rule on one subject; returns the (shared) report."""
    report = report if report is not None else Report()
    report.subjects_checked += 1
    report.extend(check_classes_are_permutations(plan, label))
    if topo is not None:
        report.extend(check_edge_cover(plan, topo, label))
    report.extend(check_slot_consistency(plan, label))
    report.extend(check_mixing_stochastic(plan, label,
                                          expect_column=expect_column))
    findings, gap = check_spectral_gap(plan, label)
    report.extend(findings)
    report.metric(f"plan.spectral_gap/{label}", round(gap, 6))
    return report


# ---------------------------------------------------------------------------
# default corpus + registration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _corpus_subject(name: str, size: int):
    topo = CORPUS_TOPOLOGIES[name](size)
    return topo, compile_plan(topo)


def iter_corpus(sizes: Sequence[int] = DEFAULT_SIZES):
    for name in CORPUS_TOPOLOGIES:
        for n in sizes:
            topo, plan = _corpus_subject(name, n)
            yield f"{name}@{n}", topo, plan


@registry.rule("plan.corpus", "plan",
               "all plan/topology rules over every named constructor x "
               "sizes 2..64")
def _run_corpus(report: Report) -> None:
    worst: Dict[str, float] = {}
    for label, topo, plan in iter_corpus():
        report.subjects_checked += 1
        report.extend(check_classes_are_permutations(plan, label))
        report.extend(check_edge_cover(plan, topo, label))
        report.extend(check_slot_consistency(plan, label))
        report.extend(check_mixing_stochastic(plan, label))
        findings, gap = check_spectral_gap(plan, label)
        report.extend(findings)
        fam = label.split("@")[0]
        worst[fam] = min(worst.get(fam, 1.0), gap)
    for fam, gap in sorted(worst.items()):
        report.metric(f"plan.min_spectral_gap/{fam}", round(gap, 6))


@registry.rule("plan.dynamic-one-peer", "plan",
               "each dynamic one-peer generator step is a single "
               "permutation class")
def _run_dynamic(report: Report) -> None:
    for n in (2, 4, 8, 16, 32, 64):
        gens = [tu.GetDynamicOnePeerSendRecvRanks(n, r) for r in range(n)]
        for step in range(max(1, n.bit_length() - 1)):
            pairs = [next(g) for g in gens]
            src_ranks = [recv for _, recv in pairs]
            plan = plan_from_neighbor_lists(n, src_ranks)
            label = f"one_peer@{n} step {step}"
            report.subjects_checked += 1
            report.extend(check_classes_are_permutations(plan, label))
            report.extend(check_mixing_stochastic(plan, label))
            if len(plan.classes) != 1:
                report.add(Finding(
                    "plan.dynamic-one-peer", label,
                    f"{len(plan.classes)} shift classes (expected 1): a "
                    "one-peer step must lower to exactly one ppermute"))
