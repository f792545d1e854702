"""Rule family 5: static verification of healed (post-failure) topologies.

When ranks die, :func:`bluefog_tpu_torch.resilience.healing.heal_topology`
rebuilds the gossip over the survivors.  A healed topology is exactly as
load-bearing as a fresh one — every invariant the plan family checks on
the named corpus must hold on the healed artifacts too, or the surviving
job silently diverges:

- the dead ranks are fully EXCISED: no survivor, no node, no scheduled
  edge references them (a dead rank left in the plan deposits into a
  drained slot forever — its neighbors average in zeros);
- the survivor mixing matrix is doubly stochastic (row AND column sums
  1): Metropolis–Hastings over the symmetrized induced subgraph — the
  condition under which degraded gossip still converges to the exact
  survivor average;
- the spectral gap stays strictly positive: the ring-reconnect step must
  have restored connectivity whenever the excision cut the graph;
- the recompiled plan covers the healed edge set exactly, with valid
  permutation classes and consistent slot bookkeeping — the plan rules,
  re-run on the healed subject.

The corpus is every named topology x sizes 4..16 x a spread of dead-rank
sets (first rank, last rank, an interior pair, and — where it exists —
the star's center, the excision that forces a reconnect).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.topology_util import DiGraph, relabel_nodes
from bluefog_tpu_torch.resilience.healing import (
    HealedTopology, grow_topology, heal_topology)

from bluefog_tpu_torch.analysis import plan_rules
from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

__all__ = [
    "HEALED_SIZES",
    "dead_sets",
    "check_dead_excised",
    "check_healed",
    "check_grown",
    "check_membership_epochs",
    "iter_elastic_corpus",
]

HEALED_SIZES: Tuple[int, ...] = tuple(range(4, 17))


def dead_sets(size: int) -> List[Tuple[int, ...]]:
    """The dead-rank sets exercised per (topology, size): single deaths
    at both id extremes, an interior pair, and near-majority loss."""
    out = [(0,), (size - 1,)]
    if size > 3:
        out.append((1, 2))
    if size > 5:
        out.append(tuple(range(1, size - 2)))  # 3 survivors
    return out


def check_dead_excised(healed: HealedTopology,
                       label: str = "healed") -> List[Finding]:
    """Every trace of the dead ranks must be gone from the healed
    artifacts: survivors, topology nodes, and plan edges (mapped back to
    global ids via ``to_global``)."""
    out: List[Finding] = []
    dead = set(healed.dead)
    leaked = dead & set(healed.survivors)
    if leaked:
        out.append(Finding(
            "resilience.dead-excised", label,
            f"dead rank(s) {sorted(leaked)} still listed as survivors — "
            "the healed gossip would keep scheduling a corpse"))
    if healed.plan.size != len(healed.survivors):
        out.append(Finding(
            "resilience.dead-excised", label,
            f"healed plan has size {healed.plan.size} but there are "
            f"{len(healed.survivors)} survivors"))
    to_global = healed.to_global
    bad_edges = []
    for cls in healed.plan.classes:
        for s, d in cls.perm:
            for local in (s, d):
                if 0 <= local < len(to_global) \
                        and to_global[local] in dead:
                    bad_edges.append((s, d))
    if bad_edges:
        out.append(Finding(
            "resilience.dead-excised", label,
            f"scheduled edge(s) {sorted(set(bad_edges))[:6]} map to dead "
            "global rank(s) — survivors would win_put into force-drained "
            "slots forever"))
    mapped = {to_global[i] for i in range(len(to_global))}
    if mapped & dead:
        out.append(Finding(
            "resilience.dead-excised", label,
            f"to_global maps local ids onto dead rank(s) "
            f"{sorted(mapped & dead)}"))
    return out


def check_healed(healed: HealedTopology, label: str = "healed",
                 report: Optional[Report] = None) -> Report:
    """All resilience + plan rules on one healed topology; the healed W
    must be doubly stochastic and mixing, the plan valid over the healed
    edge set, the dead ranks fully excised."""
    report = report if report is not None else Report()
    report.subjects_checked += 1
    report.extend(check_dead_excised(healed, label))
    plan, topo = healed.plan, healed.topology
    report.extend(plan_rules.check_classes_are_permutations(plan, label))
    report.extend(plan_rules.check_edge_cover(plan, topo, label))
    report.extend(plan_rules.check_slot_consistency(plan, label))
    # expect_column=True: the healing contract is DOUBLY stochastic
    report.extend(plan_rules.check_mixing_stochastic(
        plan, label, expect_column=True))
    findings, gap = plan_rules.check_spectral_gap(plan, label)
    report.extend(findings)
    report.metric(f"resilience.spectral_gap/{label}", round(gap, 6))
    return report


def iter_healed_corpus(sizes: Sequence[int] = HEALED_SIZES
                       ) -> Iterable[Tuple[str, HealedTopology]]:
    for name, ctor in plan_rules.CORPUS_TOPOLOGIES.items():
        for n in sizes:
            topo = ctor(n)
            for dead in dead_sets(n):
                label = f"{name}@{n}-dead{list(dead)}"
                yield label, heal_topology(topo, dead)


@registry.rule("resilience.healed-corpus", "resilience",
               "every named topology x sizes 4..16 x dead-rank sets: the "
               "healed survivor topology is doubly stochastic, mixing, "
               "fully excises the dead, and recompiles to a valid plan")
def _run_healed_corpus(report: Report) -> None:
    worst = {}
    for label, healed in iter_healed_corpus():
        report.subjects_checked += 1
        report.extend(check_dead_excised(healed, label))
        plan, topo = healed.plan, healed.topology
        report.extend(plan_rules.check_classes_are_permutations(plan, label))
        report.extend(plan_rules.check_edge_cover(plan, topo, label))
        report.extend(plan_rules.check_slot_consistency(plan, label))
        report.extend(plan_rules.check_mixing_stochastic(
            plan, label, expect_column=True))
        findings, gap = plan_rules.check_spectral_gap(plan, label)
        report.extend(findings)
        fam = label.split("@")[0]
        worst[fam] = min(worst.get(fam, 1.0), gap)
    for fam, gap in sorted(worst.items()):
        report.metric(f"resilience.min_healed_spectral_gap/{fam}",
                      round(gap, 6))


# ---------------------------------------------------------------------------
# grow-side healing (elastic membership): the shrink/grow/shrink corpus
# ---------------------------------------------------------------------------


def check_grown(grown: HealedTopology, label: str = "grown",
                report: Optional[Report] = None) -> Report:
    """All plan + excision rules on one GROWN topology (the output of
    :func:`grow_topology`): the joiners are present under fresh global
    ranks, no dead rank reappears, and the grown W is doubly stochastic
    and mixing — admission must not cost the job its convergence
    guarantee."""
    report = report if report is not None else Report()
    report.subjects_checked += 1
    mapped = set(grown.to_global)
    missing = set(grown.joined) - mapped
    if missing:
        report.add(Finding(
            "resilience.grown-corpus", label,
            f"joiner(s) {sorted(missing)} granted but absent from the "
            "grown topology — the new rank would gossip with nobody"))
    revived = set(grown.dead) & mapped
    if revived:
        report.add(Finding(
            "resilience.grown-corpus", label,
            f"dead rank(s) {sorted(revived)} reappear in the grown view "
            "— a corpse's global rank must never be reissued (stale "
            "deposits would be double-counted under the new member)"))
    if grown.plan.size != len(grown.to_global):
        report.add(Finding(
            "resilience.grown-corpus", label,
            f"grown plan has size {grown.plan.size} but the view maps "
            f"{len(grown.to_global)} members"))
    plan, topo = grown.plan, grown.topology
    report.extend(plan_rules.check_classes_are_permutations(plan, label))
    report.extend(plan_rules.check_edge_cover(plan, topo, label))
    report.extend(plan_rules.check_slot_consistency(plan, label))
    report.extend(plan_rules.check_mixing_stochastic(
        plan, label, expect_column=True))
    findings, gap = plan_rules.check_spectral_gap(plan, label)
    report.extend(findings)
    report.metric(f"resilience.grown_spectral_gap/{label}", round(gap, 6))
    return report


def _global_graph(h: HealedTopology) -> DiGraph:
    """A healed/grown topology relabeled back to GLOBAL ranks — the form
    the next membership transition consumes."""
    return relabel_nodes(h.topology, dict(enumerate(h.to_global)),
                            copy=True)


def iter_elastic_corpus(sizes: Sequence[int] = HEALED_SIZES
                        ) -> Iterable[Tuple[str, str, HealedTopology]]:
    """The shrink -> grow -> shrink corpus: every named topology x sizes
    4..16 goes through a death (heal), an admission under fresh global
    ranks (grow), and a second death in the grown view (heal again) —
    the full elastic life cycle, yielding ``(label, stage, artifact)``
    with stage one of ``shrink``/``grow``/``reshrink``."""
    for name, ctor in plan_rules.CORPUS_TOPOLOGIES.items():
        for n in sizes:
            topo = ctor(n)
            for dead in ((0,), (1, 2)):
                label = f"{name}@{n}-dead{list(dead)}"
                healed = heal_topology(topo, dead)
                yield label, "shrink", healed
                fresh = (n, n + 1)
                grown = grow_topology(_global_graph(healed), fresh)
                yield f"{label}+join{list(fresh)}", "grow", grown
                # second shrink: kill one ORIGINAL survivor of the grown
                # view (never a joiner — their death is the same path)
                victim = grown.to_global[0]
                reshrunk = heal_topology(_global_graph(grown), [victim])
                yield (f"{label}+join{list(fresh)}-dead[{victim}]",
                       "reshrink", reshrunk)


@registry.rule("resilience.grown-corpus", "resilience",
               "shrink/grow/shrink over every named topology x sizes "
               "4..16: healed, grown (fresh joiners), and re-healed "
               "views all stay doubly stochastic, mixing, and free of "
               "revived corpses")
def _run_elastic_corpus(report: Report) -> None:
    worst = {}
    for label, stage, art in iter_elastic_corpus():
        if stage == "grow":
            check_grown(art, label, report)
        else:
            report.subjects_checked += 1
            report.extend(check_dead_excised(art, label))
            report.extend(plan_rules.check_mixing_stochastic(
                art.plan, label, expect_column=True))
        _, gap = plan_rules.check_spectral_gap(art.plan, label)
        fam = label.split("@")[0]
        worst[fam] = min(worst.get(fam, 1.0), gap)
    for fam, gap in sorted(worst.items()):
        report.metric(f"resilience.min_elastic_spectral_gap/{fam}",
                      round(gap, 6))


# ---------------------------------------------------------------------------
# membership epochs: the epoch_switch journal audit
# ---------------------------------------------------------------------------


def check_membership_epochs(events: Sequence[dict],
                            label: str = "journal") -> List[Finding]:
    """Audit ``epoch_switch`` journal events (one per member per switch,
    emitted AT the round barrier with the four cumulative mass-ledger
    counters):

    - per switch, the merged ledger balances — ``sum(deposits) ==
      sum(collected + drained + pending)`` across every member of the
      new view: no committed chunk from epoch ``e`` is consumed under
      view ``e+1`` without having been drained or retired as pending at
      the cut;
    - per member, epochs advance by exactly one (``old_epoch + 1 ==
      new_epoch``) — a skipped epoch means a member gossiped against a
      stale membership view;
    - a member entering from nowhere (``old_epoch is None``) must be in
      the record's ``joined`` list: only granted joiners materialize.
    """
    out: List[Finding] = []
    switches: dict = {}
    for ev in events:
        if ev.get("event") != "epoch_switch":
            continue
        switches.setdefault(int(ev["new_epoch"]), []).append(ev)
    for epoch, evs in sorted(switches.items()):
        dep = sum(float(e.get("deposits", 0)) for e in evs)
        acc = sum(float(e.get("collected", 0)) + float(e.get("drained", 0))
                  + float(e.get("pending", 0)) for e in evs)
        if abs(dep - acc) > 1e-9:
            out.append(Finding(
                "resilience.membership-epoch", f"{label}@epoch{epoch}",
                f"mass ledger does not balance at the epoch-{epoch} "
                f"switch: deposits={dep:g} != collected+drained+pending="
                f"{acc:g} — committed mass crossed the membership "
                "barrier unaccounted (lost, or double-counted under the "
                "new view)"))
        for e in evs:
            old = e.get("old_epoch")
            g = e.get("global_rank")
            if old is None:
                if g not in e.get("joined", []):
                    out.append(Finding(
                        "resilience.membership-epoch",
                        f"{label}@epoch{epoch}",
                        f"rank {g} entered epoch {epoch} from nowhere "
                        "but is not in the granted joiner list"))
            elif int(old) + 1 != epoch:
                out.append(Finding(
                    "resilience.membership-epoch", f"{label}@epoch{epoch}",
                    f"rank {g} switched {old} -> {epoch}: members must "
                    "step one epoch at a time (a skipped view means "
                    "gossip against a stale membership)"))
    return out


def _synthetic_epoch_journal() -> List[dict]:
    """A healthy two-switch journal: 3 members admit rank 4 (epoch 1),
    then all 4 admit rank 5 (epoch 2), every cut balanced."""
    events = []
    for r, (dep, col, drn, pnd) in zip(
            (0, 2, 3), ((40, 30, 6, 4), (38, 34, 2, 2), (22, 16, 4, 2))):
        events.append({"event": "epoch_switch", "old_epoch": 0,
                       "new_epoch": 1, "global_rank": r, "joined": [4],
                       "deposits": dep, "collected": col,
                       "drained": drn, "pending": pnd})
    events.append({"event": "epoch_switch", "old_epoch": None,
                   "new_epoch": 1, "global_rank": 4, "joined": [4],
                   "deposits": 0, "collected": 0, "drained": 0,
                   "pending": 0})
    for r in (0, 2, 3, 4):
        events.append({"event": "epoch_switch", "old_epoch": 1,
                       "new_epoch": 2, "global_rank": r, "joined": [5],
                       "deposits": 50 + r, "collected": 48 + r,
                       "drained": 1, "pending": 1})
    events.append({"event": "epoch_switch", "old_epoch": None,
                   "new_epoch": 2, "global_rank": 5, "joined": [5],
                   "deposits": 0, "collected": 0, "drained": 0,
                   "pending": 0})
    return events


@registry.rule("resilience.membership-epoch", "resilience",
               "epoch_switch journal audit: the merged mass ledger "
               "balances at every membership switch, members step one "
               "epoch at a time, and only granted joiners materialize")
def _run_membership_epochs(report: Report) -> None:
    events = _synthetic_epoch_journal()
    report.subjects_checked += len(
        {e["new_epoch"] for e in events})
    report.extend(check_membership_epochs(events, "synthetic"))


@registry.rule("resilience.degraded-weights", "resilience",
               "self-weight renormalization of combine rows: dropping "
               "dead neighbors conserves the row total for uniform, "
               "convex, and push-sum (all-ones) rows")
def _run_degraded_weights(report: Report) -> None:
    from bluefog_tpu_torch.resilience.degraded import renormalize_weights
    rng = np.random.default_rng(7)
    for n in (2, 4, 8):
        for trial in range(8):
            w = rng.dirichlet(np.ones(n + 1))
            sw, nw = float(w[0]), {i: float(w[i + 1]) for i in range(n)}
            dead = set(int(i) for i in
                       rng.choice(n, size=rng.integers(0, n + 1),
                                  replace=False))
            sw2, nw2 = renormalize_weights(sw, nw, dead)
            label = f"dirichlet@{n} trial {trial} dead={sorted(dead)}"
            report.subjects_checked += 1
            total = sw2 + sum(nw2.values())
            if abs(total - 1.0) > 1e-9:
                report.add(Finding(
                    "resilience.degraded-weights", label,
                    f"renormalized row sums to {total!r}, expected 1"))
            if set(nw2) & dead:
                report.add(Finding(
                    "resilience.degraded-weights", label,
                    f"dead neighbor(s) {sorted(set(nw2) & dead)} survive "
                    "renormalization"))
            if any(v < -1e-12 for v in nw2.values()) or sw2 < -1e-12:
                report.add(Finding(
                    "resilience.degraded-weights", label,
                    "negative weight after renormalization"))
