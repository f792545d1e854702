"""Rule family: partition tolerance as a verifier.

The quorum fence (:mod:`bluefog_tpu_torch.resilience.quorum`) argues that a
network partition can never fork the membership-epoch lineage: the
side that cannot account for a strict majority of the current epoch
ORPHANs — parks its rounds, touches neither the board nor the shared
ledgers — and merges back through the join machinery when the cut
heals.  These rules turn that argument into checks, on the same
no-subprocess seeded-campaign plan as :mod:`.sim_rules`:

- **quorum-floor** — the strict-majority arithmetic is pinned against
  the production :func:`~bluefog_tpu_torch.resilience.quorum.majority_floor`
  /``quorum_met`` pair: exact floors for small fleets, the even-split
  property (neither half of an even fleet has quorum), and the
  1-member trivial quorum;
- **campaign-clean** — pinned-seed partition campaigns finish with
  zero violations AND actually exercised the path (orphans entered and
  merged — a partition window shorter than the failure timeout would
  pass vacuously);
- **split-brain-caught** — with the ``split_brain`` seeded bug (the
  fence skipped), both sides heal and the ``single-lineage`` standing
  invariant fires, and ddmin shrinks the schedule to the partition
  fault alone.

The partition acceptance campaigns (N=64/128) ride the CLI's
``--self-test`` arm via :func:`selftest_partition_campaigns`.
"""

from __future__ import annotations

from typing import List, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

__all__ = [
    "partition_campaign",
    "selftest_partition_campaigns",
    "PARTITION_PINS",
]

#: ``--self-test`` pinned partition campaigns:
#: (ranks, rounds, seed, minority) — the acceptance sizes.
PARTITION_PINS: Tuple[Tuple[int, int, int, Tuple[int, ...]], ...] = (
    (64, 40, 7, (9, 23, 55)),
    (128, 40, 11, (3, 64, 77, 101)),
)

#: pinned strict-majority floors: total members -> minimum live count
#: that may commit a heal/demote (floor(n/2) + 1; 1-member epochs have
#: trivial quorum)
_FLOORS = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4, 7: 4, 8: 5, 9: 5,
           64: 33, 128: 65}


def partition_campaign(ranks: int, rounds: int, seed: int,
                       minority, start: int = 5, stop: int = 14,
                       **kw):
    """One partition campaign: ``minority`` cut from the rest between
    rounds ``start`` and ``stop`` (long enough to span the sim's 1 s
    failure timeout at the 0.2 s round period)."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    kw.setdefault("quiesce_rounds", max(20, rounds))
    cfg = SimConfig(ranks=ranks, rounds=rounds, seed=seed,
                    faults=("partition",), **kw)
    sched = FaultSchedule([Fault.partition([minority], start, stop)],
                          seed=seed)
    return cfg, sched, run_campaign(cfg, sched)


def _path_findings(res, label: str, minority_n: int) -> List[Finding]:
    """Non-vacuity: the campaign must have actually orphaned the
    minority and merged every orphan back."""
    out: List[Finding] = []
    kinds = [e[1] for e in res.event_log]
    orphans = kinds.count("orphan")
    merged = kinds.count("merge_enter")
    if orphans != minority_n:
        out.append(Finding(
            "partition.campaign-clean", label,
            f"{orphans} rank(s) ORPHANed, expected the full minority "
            f"of {minority_n} — the quorum fence did not engage"))
    if merged != orphans:
        out.append(Finding(
            "partition.campaign-clean", label,
            f"{merged} of {orphans} orphan(s) merged back after the "
            "heal — the merge path stranded a rank"))
    led = res.final.get("ledger") or {}
    if not led.get("balanced"):
        out.append(Finding("partition.campaign-clean", label,
                           f"count ledger unbalanced after merge: {led}"))
    return out


@registry.rule("partition.quorum-floor", "partition",
               "the strict-majority floor and quorum verdicts of the "
               "production quorum module match the pinned arithmetic "
               "(even splits have NO quorum on either side)")
def _run_quorum_floor(report: Report) -> None:
    from bluefog_tpu_torch.resilience.quorum import majority_floor, quorum_met

    report.subjects_checked += 1
    for total, floor in sorted(_FLOORS.items()):
        got = majority_floor(total)
        if got != floor:
            report.add(Finding(
                "partition.quorum-floor", f"total={total}",
                f"majority_floor({total}) = {got}, pinned {floor}"))
        if not quorum_met(floor, total) or quorum_met(floor - 1, total):
            report.add(Finding(
                "partition.quorum-floor", f"total={total}",
                f"quorum_met is not a strict threshold at the floor "
                f"({floor} of {total})"))
    for even in (2, 4, 8, 64):
        if quorum_met(even // 2, even):
            report.add(Finding(
                "partition.quorum-floor", f"total={even}",
                f"an even {even}-member fleet grants quorum to a "
                f"half of {even // 2} — both sides of an even split "
                "would heal"))


@registry.rule("partition.campaign-clean", "partition",
               "a pinned-seed partition campaign ORPHANs exactly the "
               "minority, keeps a single epoch lineage, merges every "
               "orphan back on heal, and quiesces to consensus with a "
               "balanced ledger")
def _run_partition_clean(report: Report) -> None:
    for ranks, rounds, seed, minority in ((16, 30, 3, (6, 11)),):
        _cfg, _sched, res = partition_campaign(ranks, rounds, seed,
                                               minority)
        label = f"partition[n={ranks},seed={seed},cut={len(minority)}]"
        report.subjects_checked += 1
        report.extend(campaign_findings(res, label))
        report.extend(_path_findings(res, label, len(minority)))
        report.metrics[f"partition.events/{label}"] = float(res.events)


@registry.rule("partition.split-brain-caught", "partition",
               "with the quorum fence seeded out (split_brain), both "
               "partition sides heal and the single-lineage standing "
               "invariant fires, shrinking to the partition fault alone")
def _run_split_brain_caught(report: Report) -> None:
    from bluefog_tpu_torch.sim.campaign import run_campaign, shrink_schedule
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    label = "partition[n=16,seed=3,bug=split_brain]"
    report.subjects_checked += 1
    cfg, sched, res = partition_campaign(
        16, 30, 3, (6, 11), debug_bugs=("split_brain",))
    names = {v["name"] for v in res.violations}
    if "single-lineage" not in names:
        report.add(Finding(
            "partition.split-brain-caught", label,
            f"the seeded split_brain bug was NOT caught (violations: "
            f"{sorted(names)}) — the single-lineage invariant is not "
            "auditing"))
        return
    noisy = FaultSchedule(
        list(sched.faults)
        + [Fault(kind="kill", step=3, rank=1),
           Fault(kind="slow", step=4, rank=2, duration_s=0.9, stop=12)],
        seed=cfg.seed)
    minimal, viol, _runs = shrink_schedule(cfg, noisy,
                                           target="single-lineage")
    if viol is None or viol["name"] != "single-lineage":
        report.add(Finding(
            "partition.split-brain-caught", label,
            f"shrinker lost the violation (got {viol!r})"))
        return
    kinds = [f.kind for f in minimal]
    if kinds != ["partition"]:
        report.add(Finding(
            "partition.split-brain-caught", label,
            f"minimal schedule is {kinds}, expected the partition "
            "fault alone — the violation needs no other fault"))


def selftest_partition_campaigns():
    """The ``--self-test`` arm: acceptance-size partition campaigns
    (N=64/128) must come back clean, non-vacuous, and bit-identical on
    a second run.  Returns ``(label, result, findings)`` triples."""
    from bluefog_tpu_torch.sim.campaign import run_campaign

    out = []
    for ranks, rounds, seed, minority in PARTITION_PINS:
        # merged orphans re-enter with fresh unit weight and need a
        # full mixing time at acceptance scale — quiesce longer than
        # the small-campaign default
        cfg, sched, res = partition_campaign(ranks, rounds, seed,
                                             minority,
                                             quiesce_rounds=60)
        label = f"partition[n={ranks},rounds={rounds},seed={seed}]"
        findings = campaign_findings(res, label)
        findings.extend(_path_findings(res, label, len(minority)))
        again = run_campaign(cfg, sched)
        if again.digest != res.digest:
            findings.append(Finding(
                "partition.campaign-clean", label,
                f"same-seed partition campaign diverged: "
                f"{res.digest[:16]} != {again.digest[:16]}"))
        out.append((label, res, findings))
    return out
