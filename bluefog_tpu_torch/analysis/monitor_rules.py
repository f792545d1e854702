"""Rule family: the fleet monitor's sim twin as a verifier.

The live monitor (:mod:`bluefog_tpu_torch.monitor`) is a passive scraper over
the shm status pages feeding a declarative alert engine.  Its sim twin
(``SimConfig(monitor=True)``) samples the SAME rule engine on the
virtual clock — same series, same gap-closed windows — so the alerting
contract can be checked deterministically, campaign after campaign:

1. **alert completeness** — every seeded-bug campaign raises exactly
   the matching alert: ``mass_leak`` -> ``mass_imbalance``,
   ``cap_bypass`` -> ``demote_storm``, ``split_brain`` ->
   ``epoch_fork``, ``slo_silent_violation`` -> ``request_slo`` — and
   nothing else (an alert plane that also fires on the wrong rule is
   noise, not signal);
2. **false-alarm freedom** — the clean twins of those campaigns (same
   faults, kills, heals, partitions and Poisson load, no seeded bug)
   raise ZERO alerts: a kill/heal transient, an orphaned minority that
   merges back, or served-on-time traffic must never alarm;
3. **window coalescing** — a sustained breach produces ONE gap-closed
   alert window (not one per sample), separated breaches produce one
   window each, and every closed window carries its accounting
   (samples, worst, t0/t1) — flapping alerts are a seeded defect the
   corpus proves we catch.

Arming the monitor never perturbs the campaign: alert windows ride the
final dict, NOT the event log, so the digest is bit-identical with the
twin on or off — ``selftest_monitor_campaigns`` pins that identity at
the acceptance sizes (N=64/128/256).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.sim_rules import SELFTEST_PINS, campaign_findings

__all__ = [
    "monitor_findings",
    "monitored_campaign",
    "selftest_monitor_campaigns",
    "MONITOR_PINS",
]

#: ``--self-test`` pinned clean campaigns (ranks, rounds, seed) — the
#: acceptance sizes, monitored; must raise zero alerts bit-identically.
MONITOR_PINS: Tuple[Tuple[int, int, int], ...] = SELFTEST_PINS


def monitored_campaign(ranks: int, rounds: int, seed: int,
                       schedule=None, **kw):
    """One monitored campaign: the sim twin armed, everything else per
    the sim family's defaults (``schedule=None`` = the canonical
    kill/heal schedule for the seed — the clean twins must see real
    churn and stay quiet)."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    kw.setdefault("quiesce_rounds", max(10, rounds // 2))
    kw["monitor"] = True
    cfg = SimConfig(ranks=ranks, rounds=rounds, seed=seed, **kw)
    res = run_campaign(cfg, schedule)
    return cfg, res.schedule, res


def monitor_findings(res, label: str, expect: Sequence[str] = (),
                     max_windows_per_rule: int = 3) -> List[Finding]:
    """Audit a monitored campaign's alert windows against the expected
    alert set: every expected rule fired, nothing unexpected fired, no
    rule flapped (more than ``max_windows_per_rule`` windows), and the
    twin actually sampled (non-vacuity)."""
    out: List[Finding] = []
    mon = res.final.get("monitor")
    if mon is None:
        out.append(Finding(
            "monitor.alert-completeness", label,
            "no monitor accounting in the campaign result — the sim "
            "twin never armed"))
        return out
    if not mon["samples"]:
        out.append(Finding(
            "monitor.alert-completeness", label,
            "the monitor twin took ZERO samples — every alert check "
            "below would pass vacuously"))
    fired = {}
    per_subject = {}
    for w in mon["alerts"]:
        fired[w["rule"]] = fired.get(w["rule"], 0) + 1
        k = (w["rule"], w["subject"])
        per_subject[k] = per_subject.get(k, 0) + 1
    for want in expect:
        if want not in fired:
            out.append(Finding(
                "monitor.alert-completeness", label,
                f"seeded defect raised no {want!r} alert "
                f"(got {sorted(fired)}) — the monitor is silent on "
                "the incident it exists to catch"))
    extra = sorted(set(fired) - set(expect))
    if extra:
        out.append(Finding(
            "monitor.false-alarm-free", label,
            f"unexpected alert(s) {extra} fired "
            f"({sum(fired[r] for r in extra)} window(s)) — a monitor "
            "that alarms on healthy behavior trains operators to "
            "ignore it"))
    # flapping is per (rule, subject): N replicas each opening one
    # window is attribution, one replica opening N is noise
    flapping = sorted(k for k, n in per_subject.items()
                      if n > max_windows_per_rule)
    if flapping:
        out.append(Finding(
            "monitor.window-coalescing", label,
            f"rule/subject pair(s) {flapping} opened "
            f"{[per_subject[k] for k in flapping]} windows — a "
            f"sustained breach must coalesce into one gap-closed "
            f"window, not flap once per sample"))
    return out


@registry.rule("monitor.alert-completeness", "monitor",
               "every seeded-bug campaign raises exactly its matching "
               "alert — mass_leak->mass_imbalance, "
               "cap_bypass->demote_storm, split_brain->epoch_fork, "
               "slo_silent_violation->request_slo — and nothing else")
def _run_alert_completeness(report: Report) -> None:
    from bluefog_tpu_torch.analysis import partition_rules, slo_rules
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    # mass_leak: a 1e-3 multiplicative combine leak -> mass_imbalance
    label = "monitor[mass_leak]"
    report.subjects_checked += 1
    _c, _s, res = monitored_campaign(16, 20, 3,
                                     debug_bugs=("mass_leak",))
    report.extend(monitor_findings(res, label,
                                   expect=("mass_imbalance",)))
    # cap_bypass: the adaptive step demotes a majority -> demote_storm
    label = "monitor[cap_bypass]"
    report.subjects_checked += 1
    sched = FaultSchedule(
        [Fault(kind="slow", step=3 + i, rank=i, duration_s=1.0, stop=35)
         for i in range(5)], seed=5)
    _c, _s, res = monitored_campaign(
        8, 40, 5, schedule=sched, quiesce_rounds=20, faults=("slow",),
        debug_bugs=("cap_bypass",))
    report.extend(monitor_findings(res, label,
                                   expect=("demote_storm",)))
    # split_brain: the quorum fence seeded out -> epoch_fork
    label = "monitor[split_brain]"
    report.subjects_checked += 1
    _c, _s, res = partition_rules.partition_campaign(
        16, 30, 3, (6, 11), debug_bugs=("split_brain",), monitor=True)
    report.extend(monitor_findings(res, label, expect=("epoch_fork",)))
    # slo_silent_violation: a drain that skips polls -> request_slo
    label = "monitor[slo_silent_violation]"
    report.subjects_checked += 1
    _c, _s, res = slo_rules.slo_campaign(
        16, 24, 3, debug_bugs=("slo_silent_violation",), monitor=True)
    report.extend(monitor_findings(res, label, expect=("request_slo",)))


@registry.rule("monitor.false-alarm-free", "monitor",
               "the clean twins of the seeded-bug campaigns — kills, "
               "heals, partitions, Poisson load, no bug — raise zero "
               "alerts, and arming the twin leaves the campaign digest "
               "bit-identical")
def _run_false_alarm_free(report: Report) -> None:
    from bluefog_tpu_torch.analysis import partition_rules, slo_rules
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    # clean base campaign (kills + heals happen; nothing may alarm)
    label = "monitor[clean]"
    report.subjects_checked += 1
    cfg, _s, res = monitored_campaign(16, 20, 3)
    report.extend(campaign_findings(res, label))
    report.extend(monitor_findings(res, label, expect=()))
    # the digest must not know the monitor exists
    off = run_campaign(
        SimConfig.from_dict({**cfg.to_dict(), "monitor": False}))
    if off.digest != res.digest:
        report.add(Finding(
            "monitor.false-alarm-free", label,
            f"arming the monitor twin changed the campaign digest: "
            f"{res.digest[:16]} != {off.digest[:16]} — the observer "
            "is perturbing the observed"))
    # clean partition: minority orphans and merges back, no alarm
    label = "monitor[clean-partition]"
    report.subjects_checked += 1
    _c, _s, res = partition_rules.partition_campaign(
        16, 30, 3, (6, 11), monitor=True)
    report.extend(campaign_findings(res, label))
    report.extend(monitor_findings(res, label, expect=()))
    # clean traffic: every request served inside the SLO, no alarm
    label = "monitor[clean-slo]"
    report.subjects_checked += 1
    _c, _s, res = slo_rules.slo_campaign(16, 24, 3, monitor=True)
    report.extend(campaign_findings(res, label))
    report.extend(monitor_findings(res, label, expect=()))


@registry.rule("monitor.window-coalescing", "monitor",
               "the alert engine's gap-closing: a sustained breach is "
               "ONE window with full accounting, separated breaches "
               "are one window each, recovery closes the lamp")
def _run_window_coalescing(report: Report) -> None:
    from bluefog_tpu_torch.monitor.rules import (ALERT_STATE_FIRING,
                                           ALERT_STATE_OK, AlertEngine,
                                           AlertRule)

    label = "engine[sustained+separated]"
    report.subjects_checked += 1
    rule = AlertRule("hot", "temp", "gt", 1.0, "synthetic")
    eng = AlertEngine(rules=(rule,), gap_s=2.5)
    # 10 samples at cadence 1.0: breach over t=2..6, clean elsewhere
    for t in range(10):
        v = 5.0 if 2 <= t <= 6 else 0.0
        eng.feed(float(t), [("temp", "fleet", v)], wall=100.0 + t)
        if t == 4 and eng.state != ALERT_STATE_FIRING:
            report.add(Finding(
                "monitor.window-coalescing", label,
                f"engine state {eng.state} mid-breach — the lamp "
                "never lit"))
    eng.close()
    if eng.state != ALERT_STATE_OK:
        report.add(Finding(
            "monitor.window-coalescing", label,
            f"engine state {eng.state} after recovery + close — the "
            "lamp never cleared"))
    if len(eng.windows) != 1:
        report.add(Finding(
            "monitor.window-coalescing", label,
            f"one sustained 5-sample breach produced "
            f"{len(eng.windows)} window(s), want exactly 1"))
    else:
        w = eng.windows[0]
        if (w["samples"] != 5 or w["worst"] != 5.0
                or w["t0_mono"] != 2.0 or w["t1_mono"] != 6.0
                or w["t0_wall"] != 102.0 or w["t1_wall"] != 106.0):
            report.add(Finding(
                "monitor.window-coalescing", label,
                f"window accounting wrong: {w} (want samples=5, "
                "worst=5.0, t0/t1 mono 2..6, wall 102..106)"))
    # two breaches separated by more than the gap -> two windows
    eng2 = AlertEngine(rules=(rule,), gap_s=2.5)
    for t in range(12):
        v = 5.0 if t in (1, 2, 9, 10) else 0.0
        eng2.feed(float(t), [("temp", "fleet", v)])
    eng2.close()
    if len(eng2.windows) != 2:
        report.add(Finding(
            "monitor.window-coalescing", label,
            f"two breaches 7 s apart (gap 2.5 s) produced "
            f"{len(eng2.windows)} window(s), want exactly 2"))


def selftest_monitor_campaigns():
    """The ``--self-test`` arm: the acceptance-size clean campaigns
    (N=64/128/256), monitored — zero alerts, and both the digest and
    the alert list bit-identical on a second run.  Returns ``(label,
    result, findings)`` triples."""
    from bluefog_tpu_torch.analysis.sim_rules import _config
    from bluefog_tpu_torch.sim.campaign import run_campaign

    out = []
    for ranks, rounds, seed in MONITOR_PINS:
        cfg = _config(ranks, rounds, seed, quiesce_rounds=40,
                      monitor=True)
        res = run_campaign(cfg)
        label = f"monitor[n={ranks},seed={seed}]"
        findings = campaign_findings(res, label)
        findings.extend(monitor_findings(res, label, expect=()))
        again = run_campaign(cfg)
        if again.digest != res.digest:
            findings.append(Finding(
                "monitor.false-alarm-free", label,
                f"same-seed monitored campaign diverged: "
                f"{res.digest[:16]} != {again.digest[:16]}"))
        a1 = res.final.get("monitor", {}).get("alerts")
        a2 = again.final.get("monitor", {}).get("alerts")
        if a1 != a2:
            findings.append(Finding(
                "monitor.false-alarm-free", label,
                f"same-seed alert windows diverged: {a1} != {a2}"))
        out.append((label, res, findings))
    return out
