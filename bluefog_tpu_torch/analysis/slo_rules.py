"""Rule family: request-level SLO attribution as a verifier.

The serve traffic observatory (:mod:`bluefog_tpu_torch.serve.loadgen`)
argues two request-level properties hold under arbitrary serving-plane
chaos:

1. **every SLO violation has a cause** — an admitted request that
   misses the latency SLO (or is served beyond the staleness SLO)
   always overlaps an injected fault window (replica kill, publisher
   death, publish churn, tree re-parent); a violation with no window
   is a silent serve-path stall;
2. **latency is charged open-loop** — from the SCHEDULED send instant
   of the arrival process, never re-anchored to when the server got
   around to the request (coordinated omission, the measurement bug
   the real load generator exists to avoid).

These rules run the sim's traffic model (``SimConfig(arrivals=...)``)
against pinned chaos campaigns and check the claims non-vacuously:

- **request-attributed** — clean, replica-kill and publisher-kill
  campaigns under Poisson load finish with zero request violations,
  requests actually flowed, and the kill campaigns excused a nonzero
  number of requests via their fault windows (the attribution path is
  exercised, not just silent);
- **omission-sensitivity** — the two seeded traffic bugs are CAUGHT:
  a drain that skips polls (``slo_silent_violation``) trips the
  request-SLO invariant and a drain that re-anchors send times
  (``loadgen_omission``) trips the open-loop invariant — a campaign
  that stays clean with either bug armed is not checking anything;
- **trace-latency** — the empirical per-edge latency sampler
  (:mod:`bluefog_tpu_torch.sim.latency`) honors its anchors: quantiles are
  monotone, the median and p99 round-trip from a synthesized
  critical-path report, and arming the table leaves the campaign
  digest deterministic.
"""

from __future__ import annotations

from typing import List, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

__all__ = [
    "slo_campaign",
    "selftest_slo_campaigns",
    "SLO_PINS",
]

#: ``--self-test`` pinned traffic campaigns: (ranks, rounds, seed,
#: fault kind or None) — Poisson load over >= 64 virtual replicas
#: (the acceptance size), with relay kills and publish churn.
SLO_PINS: Tuple[Tuple[int, int, int, object], ...] = (
    (16, 40, 7, None),
    (16, 40, 7, "serve_kill"),
    (16, 40, 11, "serve_pub_kill"),
)


def slo_campaign(ranks: int, rounds: int, seed: int,
                 schedule=None, **kw):
    """One traffic-enabled campaign: publisher analog every 4 rounds,
    Poisson arrivals at every replica, request SLO armed at its
    default (2x the round period)."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    kw.setdefault("quiesce_rounds", max(10, rounds // 2))
    kw.setdefault("serve_every", 4)
    kw.setdefault("serve_replicas", 4)
    kw.setdefault("arrivals", "poisson")
    kw.setdefault("arrival_rate", 3.0)
    cfg = SimConfig(ranks=ranks, rounds=rounds, seed=seed, **kw)
    sched = schedule if schedule is not None else FaultSchedule()
    return cfg, sched, run_campaign(cfg, sched)


def _slo_path_findings(res, label: str,
                       expect_attributed: bool = False
                       ) -> List[Finding]:
    """Non-vacuity over the campaign's arrivals accounting."""
    out: List[Finding] = []
    arr = res.final.get("arrivals")
    if not arr:
        out.append(Finding(
            "slo.request-attributed", label,
            "no arrivals accounting in the campaign result — the "
            "traffic model never armed"))
        return out
    if not arr["admitted"]:
        out.append(Finding(
            "slo.request-attributed", label,
            "zero requests admitted — the arrival process is not "
            "running"))
    if arr["violations"]:
        out.append(Finding(
            "slo.request-attributed", label,
            f"{arr['violations']} request(s) violated an SLO with no "
            "fault window to attribute them to"))
    if expect_attributed and not arr["attributed"]:
        out.append(Finding(
            "slo.request-attributed", label,
            "a chaos campaign excused ZERO requests — the fault "
            "windows never overlapped any traffic, so the "
            "attribution path passed vacuously"))
    if not any(e[1] == "serve_requests" for e in res.event_log):
        out.append(Finding(
            "slo.request-attributed", label,
            "no serve_requests event in the log — replicas never "
            "drained their arrival queues"))
    return out


@registry.rule("slo.request-attributed", "slo",
               "pinned Poisson-load campaigns — clean, replica killed "
               "mid-load and respawned, publisher killed mid-publish — "
               "serve every admitted request within the SLO or excuse "
               "it with an overlapping fault window; the kill "
               "campaigns must actually excuse traffic")
def _run_request_attributed(report: Report) -> None:
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    cases = [
        ("clean", None, False),
        ("replica-kill",
         FaultSchedule([Fault(kind="serve_kill", step=2, rank=0,
                              stop=16)]), True),
        ("pub-kill-flip",
         FaultSchedule([Fault(kind="serve_pub_kill", step=2, rank=-1,
                              group="flip")]), False),
    ]
    for name, sched, expect_att in cases:
        label = f"slo[n=16,seed=3,{name}]"
        report.subjects_checked += 1
        _cfg, _sched, res = slo_campaign(
            16, 24, 3, schedule=sched, request_staleness_slo=3)
        report.extend(campaign_findings(res, label))
        report.extend(_slo_path_findings(res, label,
                                         expect_attributed=expect_att))
        arr = res.final.get("arrivals") or {}
        report.metrics[f"slo.requests/{label}"] = float(
            arr.get("served", 0))


@registry.rule("slo.omission-sensitivity", "slo",
               "the two seeded traffic bugs are caught: a drain that "
               "skips polls trips the request SLO, a drain that "
               "re-anchors send times trips the open-loop invariant — "
               "the attribution machinery is sensitive to what it "
               "verifies")
def _run_omission_sensitivity(report: Report) -> None:
    for bug, want in (("slo_silent_violation", "request-slo"),
                      ("loadgen_omission", "open-loop")):
        label = f"slo[n=16,seed=3,bug={bug}]"
        report.subjects_checked += 1
        _cfg, _sched, res = slo_campaign(16, 24, 3, debug_bugs=(bug,))
        names = {v["name"] for v in res.violations}
        if want not in names:
            report.add(Finding(
                "slo.omission-sensitivity", label,
                f"seeded bug {bug!r} produced no {want!r} violation "
                f"(got {sorted(names)}) — the invariant is not "
                "sensitive to the defect it exists to catch"))


@registry.rule("slo.trace-latency", "slo",
               "the trace-fitted per-edge latency sampler honors its "
               "anchors: quantiles monotone, median and p99 "
               "round-trip from a critical-path report, campaign "
               "digest deterministic with the table armed")
def _run_trace_latency(report: Report) -> None:
    import json
    import os
    import tempfile

    from bluefog_tpu_torch.sim.latency import EmpiricalLatency, \
        load_trace_latency

    label = "trace-latency[2 edges]"
    report.subjects_checked += 1
    doc = {"rounds": 4, "stragglers": {"edge_latency": {
        "0->1": {"n": 40, "p50_us": 3000.0, "p99_us": 15000.0},
        "1->2": {"n": 38, "p50_us": 5000.0, "p99_us": 30000.0}}}}
    fd, path = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        table = load_trace_latency(path)
    finally:
        os.unlink(path)
    model = EmpiricalLatency(table)
    if len(model) != 2:
        report.add(Finding("slo.trace-latency", label,
                           f"loaded {len(model)} edge(s), expected 2"))
    for (u, v), (p50, p99) in (((0, 1), (0.003, 0.015)),
                               ((1, 2), (0.005, 0.030))):
        got50 = model.quantile(u, v, 0.5)
        got99 = model.quantile(u, v, 0.99)
        if abs(got50 - p50) > 1e-12 or abs(got99 - p99) > 1e-12:
            report.add(Finding(
                "slo.trace-latency", label,
                f"edge {u}->{v} anchors did not round-trip: "
                f"quantile(0.5)={got50} want {p50}, "
                f"quantile(0.99)={got99} want {p99}"))
        qs = [model.quantile(u, v, q / 20.0) for q in range(21)]
        if any(b < a for a, b in zip(qs, qs[1:])):
            report.add(Finding(
                "slo.trace-latency", label,
                f"edge {u}->{v} quantile function is not monotone: "
                f"{qs}"))
    # digest determinism with the table armed
    _cfg, _sched, r1 = slo_campaign(8, 16, 5, latency_table=table)
    _cfg, _sched, r2 = slo_campaign(8, 16, 5, latency_table=table)
    if r1.digest != r2.digest:
        report.add(Finding(
            "slo.trace-latency", label,
            f"same-seed campaign with the latency table armed "
            f"diverged: {r1.digest[:16]} != {r2.digest[:16]}"))


def selftest_slo_campaigns():
    """The ``--self-test`` arm: Poisson load over >= 64 virtual
    replicas under relay kills and publish churn — zero unattributed
    violations, nonzero excused traffic on the chaos pins, and
    bit-identical on a second run.  Returns ``(label, result,
    findings)`` triples."""
    from bluefog_tpu_torch.sim.campaign import run_campaign
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    out = []
    for ranks, rounds, seed, kind in SLO_PINS:
        kw = {"serve_replicas": 64, "distrib_fanout": 4,
              "request_staleness_slo": 4, "arrival_rate": 1.5}
        if kind == "serve_kill":
            # rank 0 is a relay in the fanout-4 tree: its death
            # orphans a subtree mid-load
            sched = FaultSchedule([Fault(kind="serve_kill", step=2,
                                         rank=0, stop=rounds - 10)],
                                  seed=seed)
        elif kind == "serve_pub_kill":
            sched = FaultSchedule([Fault(kind="serve_pub_kill", step=2,
                                         rank=-1, group="flip")],
                                  seed=seed)
        else:
            sched = FaultSchedule(seed=seed)
        cfg, sched, res = slo_campaign(ranks, rounds, seed,
                                       schedule=sched, **kw)
        label = f"slo[n={ranks},seed={seed},{kind or 'clean'}]"
        findings = campaign_findings(res, label)
        findings.extend(_slo_path_findings(
            res, label, expect_attributed=(kind == "serve_kill")))
        again = run_campaign(cfg, sched)
        if again.digest != res.digest:
            findings.append(Finding(
                "slo.request-attributed", label,
                f"same-seed traffic campaign diverged: "
                f"{res.digest[:16]} != {again.digest[:16]}"))
        out.append((label, res, findings))
    return out
