"""Rule family: adaptive topology (gray-failure demotion) artifacts.

The adaptive control loop (resilience/adaptive.py) swaps topologies at
runtime: a straggler is demoted to one anchor edge via
:func:`~bluefog_tpu_torch.resilience.healing.demote_topology`, and promoted
back when its edge turns clean.  Every W it can produce is exactly as
load-bearing as a fresh one, and the state machine that produces them
has its own invariant — hysteresis — that no runtime test can pin down
as tightly as a driven simulation.  Three rule groups:

- **demoted corpus** — every named topology x sizes 4..16 x straggler
  sets: the demoted W is doubly stochastic with a positive spectral
  gap, the straggler is STILL a member (demotion is not death — excising
  it would orphan its pending mass), its gossip degree is capped at one
  anchor edge, and the recompiled plan passes every plan rule;
- **restore round-trip** — demote then promote (empty remaining
  straggler set) reproduces the symmetrized original edge set, so a
  recovered rank returns to the exact pre-demotion gossip;
- **hysteresis** — drive the real :class:`~bluefog_tpu_torch.resilience.
  detector.EdgeHealth` machine through adversarial flapping schedules on
  a fake clock and audit the transition log: no two non-DEAD transitions
  for one peer closer than the configured floor (so no demote/promote
  cycle can be shorter), only legal arcs, DEAD absorbing.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.resilience.detector import (
    EDGE_ALIVE, EDGE_DEAD, EDGE_SUSPECT, EdgeHealth)
from bluefog_tpu_torch.resilience.healing import (
    HealedTopology, demote_topology, heal_topology)

from bluefog_tpu_torch.analysis import plan_rules
from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

__all__ = [
    "DEMOTED_SIZES",
    "straggler_sets",
    "check_straggler_member",
    "check_straggler_capped",
    "check_demoted",
    "check_hysteresis",
    "iter_demoted_corpus",
]

DEMOTED_SIZES: Tuple[int, ...] = tuple(range(4, 17))

_LEGAL_ARCS = {
    (EDGE_ALIVE, EDGE_SUSPECT),
    (EDGE_SUSPECT, EDGE_ALIVE),
    (EDGE_ALIVE, EDGE_DEAD),
    (EDGE_SUSPECT, EDGE_DEAD),
}


def straggler_sets(size: int) -> List[Tuple[int, ...]]:
    """The straggler sets exercised per (topology, size): single
    stragglers at both id extremes, an interior pair, and near-majority
    demotion (all but two — at least one healthy anchor must remain)."""
    out = [(0,), (size - 1,)]
    if size > 4:
        out.append((1, 2))
    if size > 5:
        out.append(tuple(range(1, size - 1)))  # 2 healthy members
    return out


def check_straggler_member(demoted: HealedTopology,
                           label: str = "demoted") -> List[Finding]:
    """Demotion is NOT death: every straggler must still be a member of
    the view (mapped, present in the topology, scheduled by the plan) —
    excising it would strand the mass pending in its slots."""
    out: List[Finding] = []
    strag = set(demoted.demoted)
    missing = strag - set(demoted.survivors)
    if missing:
        out.append(Finding(
            "adaptive.demoted-corpus", label,
            f"demoted rank(s) {sorted(missing)} dropped from the member "
            "set — demotion must keep the straggler in the view (its "
            "pending slot mass has nowhere to drain otherwise)"))
    mapped = set(demoted.to_global)
    if strag - mapped:
        out.append(Finding(
            "adaptive.demoted-corpus", label,
            f"demoted rank(s) {sorted(strag - mapped)} absent from "
            "to_global — the straggler has no local id to gossip under"))
    if demoted.dead:
        out.append(Finding(
            "adaptive.demoted-corpus", label,
            f"demotion declared rank(s) {sorted(demoted.dead)} dead — "
            "the whole point of the gray-failure path is that it never "
            "does"))
    tag = tuple(demoted.topology.graph.get("demoted_from", ()))
    if tag != tuple(sorted(strag)):
        out.append(Finding(
            "adaptive.demoted-corpus", label,
            f"topology demoted_from tag {tag} disagrees with the record "
            f"{tuple(sorted(strag))} — epoch observers would re-derive "
            "a different graph"))
    return out


def check_straggler_capped(demoted: HealedTopology,
                           label: str = "demoted") -> List[Finding]:
    """Each straggler's gossip degree is capped at ONE anchor edge
    (bidirectional), and the anchor is a healthy member wherever one is
    adjacent — the straggler must sit on nobody's critical path."""
    out: List[Finding] = []
    strag = set(demoted.demoted)
    to_local = demoted.to_local
    for s in sorted(strag):
        if s not in to_local:
            continue  # check_straggler_member already flagged it
        v = to_local[s]
        succ = {u for u in demoted.topology.successors(v) if u != v}
        pred = {u for u in demoted.topology.predecessors(v) if u != v}
        nbrs = succ | pred
        if len(nbrs) > 1:
            glb = sorted(demoted.to_global[u] for u in nbrs)
            out.append(Finding(
                "adaptive.demoted-corpus", label,
                f"straggler {s} keeps {len(nbrs)} neighbors {glb} — the "
                "demotion contract caps it to one anchor edge"))
        if succ != pred:
            out.append(Finding(
                "adaptive.demoted-corpus", label,
                f"straggler {s}'s anchor edge is one-directional "
                f"(out={sorted(succ)}, in={sorted(pred)}) — an "
                "asymmetric edge breaks the MH doubly-stochastic "
                "construction"))
        if len(nbrs) == 1:
            anchor = demoted.to_global[next(iter(nbrs))]
            if anchor in strag:
                healthy_adj = False  # anchored to a fellow straggler:
                # only legal when no healthy member was reachable, which
                # the construction never produces (it falls back to the
                # lowest healthy member) — flag unconditionally
                if not healthy_adj:
                    out.append(Finding(
                        "adaptive.demoted-corpus", label,
                        f"straggler {s} anchored to fellow straggler "
                        f"{anchor} — two demoted ranks gossiping only "
                        "with each other partition off the fleet"))
    return out


def check_demoted(demoted: HealedTopology, label: str = "demoted",
                  report: Optional[Report] = None) -> Report:
    """All adaptive + plan rules on one demoted topology: straggler
    retained and capped, W doubly stochastic, spectral gap positive,
    plan valid over the demoted edge set."""
    report = report if report is not None else Report()
    report.subjects_checked += 1
    report.extend(check_straggler_member(demoted, label))
    report.extend(check_straggler_capped(demoted, label))
    plan, topo = demoted.plan, demoted.topology
    report.extend(plan_rules.check_classes_are_permutations(plan, label))
    report.extend(plan_rules.check_edge_cover(plan, topo, label))
    report.extend(plan_rules.check_slot_consistency(plan, label))
    report.extend(plan_rules.check_mixing_stochastic(
        plan, label, expect_column=True))
    findings, gap = plan_rules.check_spectral_gap(plan, label)
    report.extend(findings)
    report.metric(f"adaptive.spectral_gap/{label}", round(gap, 6))
    return report


def iter_demoted_corpus(sizes: Sequence[int] = DEMOTED_SIZES
                        ) -> Iterable[Tuple[str, HealedTopology]]:
    for name, ctor in plan_rules.CORPUS_TOPOLOGIES.items():
        for n in sizes:
            topo = ctor(n)
            for strag in straggler_sets(n):
                label = f"{name}@{n}-slow{list(strag)}"
                yield label, demote_topology(topo, strag)


@registry.rule("adaptive.demoted-corpus", "adaptive",
               "every named topology x sizes 4..16 x straggler sets: "
               "the demoted W is doubly stochastic and mixing, the "
               "straggler stays a member with degree capped at one "
               "anchor edge, and the recompiled plan is valid")
def _run_demoted_corpus(report: Report) -> None:
    worst = {}
    for label, demoted in iter_demoted_corpus():
        report.subjects_checked += 1
        report.extend(check_straggler_member(demoted, label))
        report.extend(check_straggler_capped(demoted, label))
        plan, topo = demoted.plan, demoted.topology
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
        report.metric(f"adaptive.min_demoted_spectral_gap/{fam}",
                      round(gap, 6))


@registry.rule("adaptive.restore-roundtrip", "adaptive",
               "demote then promote reproduces the symmetrized original "
               "edge set and mixing matrix — a recovered straggler "
               "returns to the exact pre-demotion gossip")
def _run_restore_roundtrip(report: Report) -> None:
    for name, ctor in plan_rules.CORPUS_TOPOLOGIES.items():
        for n in (4, 8, 12):
            topo = ctor(n)
            label = f"{name}@{n}-roundtrip"
            report.subjects_checked += 1
            # the restore path the runtime takes: promote with an empty
            # remaining straggler set == heal with an empty dead set,
            # applied to the SAME base graph the demotion captured
            restored = heal_topology(topo, [])
            baseline = heal_topology(topo, [])
            if (set(restored.topology.edges)
                    != set(baseline.topology.edges)):
                report.add(Finding(
                    "adaptive.restore-roundtrip", label,
                    "restore is not deterministic: two restores of the "
                    "same base graph disagree on the edge set"))
            demoted = demote_topology(topo, [n - 1])
            v = baseline.to_local[n - 1]
            base_deg = len({u for u in baseline.topology.successors(v)
                            if u != v})
            if base_deg > 1 and set(demoted.topology.edges) \
                    == set(baseline.topology.edges):
                report.add(Finding(
                    "adaptive.restore-roundtrip", label,
                    "demotion was a no-op: the demoted edge set equals "
                    "the baseline (the straggler's degree was never "
                    "capped)"))
            W_r = restored.plan.mixing_matrix()
            W_b = baseline.plan.mixing_matrix()
            if not np.allclose(W_r, W_b, atol=1e-12):
                report.add(Finding(
                    "adaptive.restore-roundtrip", label,
                    "restored mixing matrix differs from the "
                    "pre-demotion W — promotion must fully undo the "
                    "demotion, not approximate it"))


def check_hysteresis(transitions: Sequence[dict], floor_s: float,
                     label: str = "edge-health") -> List[Finding]:
    """Audit an EdgeHealth transition log ``[{t, peer, frm, to}, ...]``:

    - per peer, consecutive transitions not involving DEAD are at least
      ``floor_s`` apart — the hysteresis guarantee that bounds how fast
      a flapping rank can thrash demote/promote epochs.  Transitions
      tagged ``adopted`` (a fleet promote verdict mirrored into a
      machine that was starved of observations) are exempt as the
      SECOND of a pair: their floor was paid at the anchor whose
      evidence produced the verdict, and absolving restarts the local
      floor clock, so the NEXT local transition is still gated;
    - only legal arcs (ALIVE<->SUSPECT, anything->DEAD);
    - DEAD is absorbing: nothing transitions out of it.
    """
    out: List[Finding] = []
    by_peer: dict = {}
    for ev in transitions:
        by_peer.setdefault(ev["peer"], []).append(ev)
    for peer, evs in sorted(by_peer.items()):
        evs = sorted(evs, key=lambda e: float(e["t"]))
        prev = None
        for ev in evs:
            frm, to = ev["frm"], ev["to"]
            if (frm, to) not in _LEGAL_ARCS:
                out.append(Finding(
                    "adaptive.hysteresis", label,
                    f"peer {peer}: illegal transition {frm} -> {to} at "
                    f"t={ev['t']:g}"
                    + (" (DEAD must be absorbing)"
                       if frm == EDGE_DEAD else "")))
            if (prev is not None and to != EDGE_DEAD
                    and prev["to"] != EDGE_DEAD
                    and not ev.get("adopted")):
                gap = float(ev["t"]) - float(prev["t"])
                if gap < floor_s - 1e-12:
                    out.append(Finding(
                        "adaptive.hysteresis", label,
                        f"peer {peer}: transitions {gap:g}s apart "
                        f"({prev['frm']}->{prev['to']} then {frm}->{to})"
                        f" — under the {floor_s:g}s hysteresis floor, a "
                        "flapping rank could thrash membership epochs"))
            prev = ev
    return out


def _drive_flapping(misses: int, clean: int, floor_s: float,
                    tick_s: float, rounds: int) -> EdgeHealth:
    """Adversarial schedule: alternate bursts of misses and cleans as
    fast as the observation cadence allows, for several peers at
    staggered phases — the workload most likely to violate the floor."""
    now = [0.0]
    eh = EdgeHealth(misses=misses, clean=clean, floor_s=floor_s,
                    clock=lambda: now[0])
    for step in range(rounds):
        for peer in (1, 2, 3):
            phase = (step + peer) % (2 * misses)
            if phase < misses:
                eh.note_miss(peer)
            else:
                eh.note_clean(peer)
        now[0] += tick_s
    eh.note_dead(3)
    # post-death observations must not resurrect peer 3
    for _ in range(clean + 1):
        eh.note_clean(3)
        now[0] += tick_s
    return eh


@registry.rule("adaptive.hysteresis", "adaptive",
               "the EdgeHealth machine, driven through adversarial "
               "flapping schedules on a fake clock, admits no "
               "demote/promote cycle shorter than the configured floor, "
               "takes only legal arcs, and keeps DEAD absorbing")
def _run_hysteresis(report: Report) -> None:
    for misses, clean, floor_s, tick_s in (
            (3, 5, 1.0, 0.05),   # defaults, fast flapping
            (1, 1, 0.5, 0.01),   # hair-trigger thresholds
            (2, 3, 2.0, 0.3),    # slow cadence, long floor
    ):
        label = (f"flap[m={misses},c={clean},floor={floor_s:g},"
                 f"tick={tick_s:g}]")
        report.subjects_checked += 1
        eh = _drive_flapping(misses, clean, floor_s, tick_s, rounds=400)
        log = eh.transitions()
        report.extend(check_hysteresis(log, floor_s, label))
        if not any(e["to"] == EDGE_SUSPECT for e in log):
            report.add(Finding(
                "adaptive.hysteresis", label,
                "the adversarial schedule never tripped ALIVE->SUSPECT "
                "— the machine under test is not reacting to misses, "
                "so the floor was never actually exercised"))
        if eh.state(3) != EDGE_DEAD:
            report.add(Finding(
                "adaptive.hysteresis", label,
                f"peer 3 is {eh.state(3)!r} after a death declaration "
                "followed by clean observations — DEAD must absorb"))
