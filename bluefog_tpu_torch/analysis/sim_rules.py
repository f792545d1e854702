"""Rule family: the deterministic fleet simulator as a verifier.

The sim (bluefog_tpu_torch/sim/) runs the REAL protocol state machines —
``FailureDetector``, ``EdgeHealth``/``AdaptivePolicy``, the healing
planners, ``MembershipBoard.grant``/``commit_reweight`` — against an
in-memory transport on a virtual clock, auditing the standing
invariants after every protocol event (mass conservation, doubly
stochastic plans, monotone epochs, no majority demotion, push-sum
consensus at quiesce).  That makes a seeded campaign itself a static
check: no subprocesses, no wall-clock, same seed → same event log bit
for bit.  Three rule groups:

- **campaign-clean** — pinned-seed fault campaigns (kills, slowdowns,
  suspensions, joins over exp2) finish with zero violations, a
  balanced count ledger, and consensus within tolerance;
- **determinism** — the same seed run twice yields the identical
  event-log digest (the property every repro file leans on);
- **shrink-minimal** — a seeded invariant bug (``mass_leak``) is
  caught, and the ddmin shrinker reduces its schedule to the true
  minimum (the empty schedule: a code bug needs no faults to fire).

The heavyweight pinned campaigns (N=64/128/256, the acceptance sizes)
run under the CLI's ``--self-test`` arm via
:func:`selftest_campaigns`, not in the default corpus — the CI gate
stays fast.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

__all__ = [
    "campaign_findings",
    "iter_pinned_campaigns",
    "selftest_campaigns",
    "SELFTEST_PINS",
]

#: The --self-test pinned campaigns: (ranks, rounds, seed).  These are
#: the acceptance sizes — a 256-rank seeded campaign must finish clean
#: in well under a minute single-process.
SELFTEST_PINS: Tuple[Tuple[int, int, int], ...] = (
    (64, 50, 42),
    (128, 50, 7),
    (256, 50, 7),
)


def _config(ranks: int, rounds: int, seed: int, **kw):
    from bluefog_tpu_torch.sim.campaign import SimConfig

    kw.setdefault("quiesce_rounds", max(20, rounds * 4 // 5))
    return SimConfig(ranks=ranks, rounds=rounds, seed=seed, **kw)


def campaign_findings(result, label: str) -> List[Finding]:
    """Map a :class:`CampaignResult`'s violations onto findings (one
    per distinct violation name, with the first occurrence's detail —
    a broken invariant fires on every subsequent event, and one
    finding per event would drown the report)."""
    out: List[Finding] = []
    seen = set()
    for v in result.violations:
        if v["name"] in seen:
            continue
        seen.add(v["name"])
        out.append(Finding(f"sim.{v['name']}", label,
                           f"t={v['t']:.3f} rank {v['rank']}: "
                           f"{v['detail']}"))
    return out


def iter_pinned_campaigns() -> Iterable[Tuple[str, object]]:
    """The default-corpus campaigns: small enough for the CI gate,
    still exercising kill→heal, slow→demote→promote, suspend→fence,
    and join→grant→enter."""
    from bluefog_tpu_torch.sim.campaign import run_campaign

    for ranks, rounds, seed in ((32, 30, 0), (32, 30, 7)):
        cfg = _config(ranks, rounds, seed,
                      faults=("kill", "suspend", "slow", "join"))
        label = f"campaign[n={ranks},rounds={rounds},seed={seed}]"
        yield label, run_campaign(cfg)


@registry.rule("sim.campaign-clean", "sim",
               "pinned-seed fault campaigns over the real protocol "
               "state machines finish with zero invariant violations, "
               "a balanced count ledger, and push-sum consensus")
def _run_campaign_clean(report: Report) -> None:
    for label, res in iter_pinned_campaigns():
        report.subjects_checked += 1
        report.extend(campaign_findings(res, label))
        led = res.final.get("ledger") or {}
        if not led.get("balanced"):
            report.add(Finding("sim.campaign-clean", label,
                               f"count ledger unbalanced: {led}"))
        report.metrics[f"sim.events/{label}"] = float(res.events)


@registry.rule("sim.determinism", "sim",
               "the same (seed, config) campaign run twice yields the "
               "identical event-log digest — the property every "
               "shrink-to-seed repro file leans on")
def _run_determinism(report: Report) -> None:
    from bluefog_tpu_torch.sim.campaign import run_campaign

    cfg = _config(32, 30, 3)
    report.subjects_checked += 1
    a = run_campaign(cfg)
    b = run_campaign(cfg)
    if a.digest != b.digest:
        report.add(Finding(
            "sim.determinism", "campaign[n=32,seed=3]",
            f"two same-seed runs diverged: {a.digest[:16]} != "
            f"{b.digest[:16]} — replay and repro files are broken"))


@registry.rule("sim.shrink-minimal", "sim",
               "a seeded mass-leak bug is caught by the continuous "
               "mass audit and ddmin-shrinks to the empty schedule "
               "(a code bug needs no faults to reproduce)")
def _run_shrink_minimal(report: Report) -> None:
    from bluefog_tpu_torch.sim.campaign import run_campaign, shrink_schedule

    cfg = _config(8, 15, 3, quiesce_rounds=5,
                  debug_bugs=("mass_leak",))
    label = "campaign[n=8,seed=3,bug=mass_leak]"
    report.subjects_checked += 1
    res = run_campaign(cfg)
    if res.ok:
        report.add(Finding(
            "sim.shrink-minimal", label,
            "the seeded mass_leak bug was NOT caught — the continuous "
            "mass audit is not actually auditing"))
        return
    minimal, viol, _runs = shrink_schedule(cfg, res.schedule)
    if viol is None or viol["name"] != "mass-conservation":
        report.add(Finding(
            "sim.shrink-minimal", label,
            f"shrinker lost the violation (got {viol!r})"))
    if len(minimal) != 0:
        report.add(Finding(
            "sim.shrink-minimal", label,
            f"shrunk schedule still holds {len(minimal)} fault(s); a "
            "pure code bug must shrink to the empty schedule"))


def selftest_campaigns() -> List[Tuple[str, object, List[Finding]]]:
    """The ``--self-test`` arm: the acceptance-size pinned campaigns
    (N=64/128/256, seeded kills+slowdowns+joins) each run once and
    must come back clean.  Returns ``(label, result, findings)``."""
    from bluefog_tpu_torch.sim.campaign import run_campaign

    out = []
    for ranks, rounds, seed in SELFTEST_PINS:
        cfg = _config(ranks, rounds, seed, quiesce_rounds=40)
        label = f"campaign[n={ranks},rounds={rounds},seed={seed}]"
        res = run_campaign(cfg)
        findings = campaign_findings(res, label)
        led = res.final.get("ledger") or {}
        if not led.get("balanced"):
            findings.append(Finding("sim.campaign-clean", label,
                                    f"count ledger unbalanced: {led}"))
        out.append((label, res, findings))
    return out
