"""CLI: ``python -m bluefog_tpu_torch.analysis`` — exit 0 iff no errors.

Modes:

- default: run every registered rule family over the default corpus and
  print a summary with each family's seconds (``--families plan
  protocol`` to subset, ``--no-hlo`` to skip the collective family, the
  reference's hlo family — the fast CI gate);
- ``--fixture NAME``: lint one seeded-bug fixture; exits NONZERO when it
  (correctly) fires — CI uses this to prove the verifier catches what it
  claims to catch;
- ``--self-test``: run every fixture and fail unless each yields at
  least one finding;
- ``--family NAME``: run exactly one rule family (``--list-families``
  shows every family with its documented runtime);
- ``--changed-only FILE [FILE ...]``: map touched source files to the
  rule families that gate them (``conformance.FAMILY_MAP``) and run only
  those — the pre-commit mode;
- ``--list``: enumerate rules and fixtures;
- ``--json``: machine-readable report (plus ``family_seconds``);
- ``--device``: where the collective family runs its programs (default
  ``cuda``, the card; ``--device cpu`` checks on the host).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.analysis",
        description="static verifier: plans, topologies, collective "
                    "contracts, shm-mailbox protocol")
    p.add_argument("--families", nargs="*", default=None,
                   help="rule families to run (default: all)")
    p.add_argument("--family", default=None,
                   help="run exactly one rule family (see --list-families)")
    p.add_argument("--list-families", action="store_true",
                   dest="list_families",
                   help="list rule families with rule counts and the "
                        "documented runtime of each")
    p.add_argument("--changed-only", nargs="+", default=None,
                   metavar="FILE",
                   help="run only the families gating these touched "
                        "source files (the pre-commit mode)")
    p.add_argument("--no-hlo", action="store_true",
                   help="skip the collective family, the reference's hlo "
                        "family (fast CI gate)")
    p.add_argument("--device", default="cuda",
                   help="device the collective family runs its programs "
                        "on (default: cuda, the card)")
    p.add_argument("--fixture", default=None,
                   help="lint one seeded-bug fixture; exits nonzero when "
                        "the rule fires (it must)")
    p.add_argument("--self-test", action="store_true",
                   help="check every fixture yields >= 1 finding")
    p.add_argument("--list", action="store_true", dest="list_rules",
                   help="list registered rules and fixtures")
    p.add_argument("--json", action="store_true", help="emit a JSON report")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from bluefog_tpu_torch import analysis
    from bluefog_tpu_torch.analysis import collective_corpus, fixtures

    collective_corpus.set_device(args.device)

    if args.list_rules:
        for rule in analysis.registry.select():
            print(f"{rule.name:<36s} [{rule.family}] {rule.doc}")
        print()
        for name in fixtures.FIXTURES:
            print(f"fixture: {name}")
        return 0

    if args.list_families:
        # rough wall-clock on the CI container, measured once and kept
        # honest by the CLI timing test in tests/test_analysis.py
        runtime = {
            "plan": "~5 s (topology sweeps 2..64)",
            "collective": "~2 s (the gossip corpus under the collective "
                          "inventory)",
            "protocol": "~2 s (exhaustive interleavings, small bounds)",
            "resilience": "~5 s (healed-topology sweeps + drain model)",
            "telemetry": "~1 s", "trace": "~1 s", "adaptive": "~5 s",
            "epoch": "<1 s", "progress": "~2 s",
            "wire": "~3 s (chunk-stream + credit-window models)",
            "introspect": "~2 s", "sim": "~10 s (pinned fault campaigns)",
            "partition": "~10 s (pinned partition campaigns)",
            "serve": "~10 s (pinned serve campaigns + buffer model)",
            "slo": "~10 s (pinned traffic campaigns + latency "
                   "sampler pins)",
            "monitor": "~15 s (monitored seeded-bug + clean-twin "
                       "campaigns)",
            "distrib": "~15 s (pinned tree campaigns + exhaustive "
                       "kill/delta models)",
            "lab": "~5 s (frozen sweep artifact re-derivation)",
            "transport": "<1 s (spec table pins + capability lint)",
            "conformance": "~5 s (differential transports vs reference; "
                           "includes two live TCP rank pairs)",
            "interleave": "~2 s (unified explorer + race scan)",
        }
        rules_by_family = {}
        for rule in analysis.registry.select():
            rules_by_family.setdefault(rule.family, []).append(rule.name)
        for fam in sorted(rules_by_family):
            n = len(rules_by_family[fam])
            print(f"{fam:<12s} {n:>2d} rule(s)  "
                  f"{runtime.get(fam, '(unmeasured)')}")
        return 0

    if args.fixture is not None:
        if args.fixture not in fixtures.FIXTURES:
            p.error(f"unknown fixture {args.fixture!r}; see --list")
        findings = fixtures.run_fixture(args.fixture)
        for f in findings:
            print(f)
        print(f"{args.fixture}: {len(findings)} finding(s)")
        # a seeded bug MUST be caught: nonzero exit = the rule fired
        return 1 if findings else 0

    if args.self_test:
        dead = []
        for name in fixtures.FIXTURES:
            findings = fixtures.run_fixture(name)
            status = f"fires ({len(findings)})" if findings else "SILENT"
            print(f"  {name:<36s} {status}")
            if not findings:
                dead.append(name)
        if dead:
            print(f"self-test FAILED: rule(s) never fired for {dead}")
            return 1
        # sim arm: the acceptance-size pinned campaigns must run clean
        # (the default corpus only runs the small ones)
        from bluefog_tpu_torch.analysis import sim_rules

        dirty = []
        for label, res, findings in sim_rules.selftest_campaigns():
            ok = not findings
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(events={res.events}, digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                dirty.append(label)
        if dirty:
            print(f"self-test FAILED: campaign(s) violated invariants "
                  f"{dirty}")
            return 1
        # partition arm: acceptance-size partition campaigns must
        # orphan the minority, merge it back, and replay bit-identically
        from bluefog_tpu_torch.analysis import partition_rules

        torn = []
        for label, res, findings in (
                partition_rules.selftest_partition_campaigns()):
            ok = not findings
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(events={res.events}, digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                torn.append(label)
        if torn:
            print(f"self-test FAILED: partition campaign(s) failed "
                  f"{torn}")
            return 1
        # serve arm: acceptance-size serve campaigns under chaos must
        # publish monotone, converge replicas, and replay bit-identically
        from bluefog_tpu_torch.analysis import serve_rules

        stale = []
        for label, res, findings in (
                serve_rules.selftest_serve_campaigns()):
            ok = not findings
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(events={res.events}, digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                stale.append(label)
        if stale:
            print(f"self-test FAILED: serve campaign(s) failed {stale}")
            return 1
        # slo arm: Poisson load over >= 64 virtual replicas under
        # relay kills and publish churn — zero unattributed request
        # violations, nonzero excused traffic, bit-identical replays
        from bluefog_tpu_torch.analysis import slo_rules

        unattributed = []
        for label, res, findings in (
                slo_rules.selftest_slo_campaigns()):
            ok = not findings
            arr = res.final.get("arrivals") or {}
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(served={arr.get('served')}, "
                  f"attributed={arr.get('attributed')}, "
                  f"digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                unattributed.append(label)
        if unattributed:
            print(f"self-test FAILED: traffic campaign(s) failed "
                  f"{unattributed}")
            return 1
        # monitor arm: the acceptance-size clean campaigns, monitored —
        # zero alerts, digest and alert list bit-identical on replay
        from bluefog_tpu_torch.analysis import monitor_rules

        alarmed = []
        for label, res, findings in (
                monitor_rules.selftest_monitor_campaigns()):
            ok = not findings
            mon = res.final.get("monitor") or {}
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(samples={mon.get('samples')}, "
                  f"alerts={len(mon.get('alerts', ()))}, "
                  f"digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                alarmed.append(label)
        if alarmed:
            print(f"self-test FAILED: monitored campaign(s) failed "
                  f"{alarmed}")
            return 1
        # distrib arm: acceptance-size distribution-tree campaigns
        # (relay kills + join storm mid-rollout at >= 64 ranks) must
        # re-parent cleanly, converge, and replay bit-identically
        from bluefog_tpu_torch.analysis import distrib_rules

        stalled = []
        for label, res, findings in (
                distrib_rules.selftest_distrib_campaigns()):
            ok = not findings
            print(f"  {label:<36s} "
                  f"{'clean' if ok else 'VIOLATED'} "
                  f"(events={res.events}, digest={res.digest[:12]})")
            for f in findings:
                print(f"    {f}")
            if not ok:
                stalled.append(label)
        if stalled:
            print(f"self-test FAILED: distrib campaign(s) failed "
                  f"{stalled}")
            return 1
        # lab arm: every claim the frozen sweep artifact makes must
        # re-derive from its own raw data (python -m bluefog_tpu_torch.lab
        # --check runs the same checks standalone)
        from bluefog_tpu_torch.analysis.engine import Severity
        from bluefog_tpu_torch.analysis.lab_rules import check_artifact
        from bluefog_tpu_torch.lab.recommend import (default_artifact_path,
                                               load_artifact)

        try:
            art = load_artifact()
        except (OSError, ValueError) as e:
            print(f"self-test FAILED: frozen lab artifact unreadable "
                  f"({default_artifact_path()}): {e}")
            return 1
        lab_findings = check_artifact(
            art, label="LAB_" + str(art.get("version")))
        lab_errors = [f for f in lab_findings
                      if f.severity == Severity.ERROR]
        ncells = len(art.get("cells") or ())
        print(f"  {'lab artifact LAB_' + str(art.get('version')):<36s} "
              f"{'clean' if not lab_errors else 'VIOLATED'} "
              f"(cells={ncells}, "
              f"spearman={art.get('spearman_rate_vs_gap'):.3f})")
        for f in lab_errors:
            print(f"    {f}")
        if lab_errors:
            print("self-test FAILED: frozen lab artifact fails its own "
                  "checks")
            return 1
        # conformance arm: the live differential corpus must run clean
        # and every seeded transport mutant must be caught
        from bluefog_tpu_torch.analysis import conformance

        broken = []
        for label, ok, detail in conformance.selftest_conformance():
            print(f"  {label:<36s} {'ok' if ok else 'FAILED'} ({detail})")
            if not ok:
                broken.append(label)
        if broken:
            print(f"self-test FAILED: conformance arm(s) failed {broken}")
            return 1
        # interleave arm: the unified explorer must agree with the
        # legacy models and catch every seeded protocol bug
        from bluefog_tpu_torch.analysis import interleave

        split = []
        for label, ok, detail in interleave.selftest_interleave():
            print(f"  {label:<40s} {'ok' if ok else 'FAILED'} ({detail})")
            if not ok:
                split.append(label)
        if split:
            print(f"self-test FAILED: interleave arm(s) failed {split}")
            return 1
        print(f"self-test OK: all {len(fixtures.FIXTURES)} seeded bugs "
              f"caught, {len(sim_rules.SELFTEST_PINS)} pinned campaigns "
              f"+ {len(partition_rules.PARTITION_PINS)} partition "
              f"+ {len(serve_rules.SERVE_PINS)} serve "
              f"+ {len(slo_rules.SLO_PINS)} traffic "
              f"+ {len(monitor_rules.MONITOR_PINS)} monitored "
              f"+ {len(distrib_rules.DISTRIB_PINS)} distrib campaigns "
              f"clean, "
              f"lab artifact verified ({ncells} cells), transports "
              f"conformant, unified explorer subsumes the legacy models")
        return 0

    families = args.families
    if args.family is not None:
        if args.family not in analysis.registry.families():
            p.error(f"unknown family {args.family!r}; see --list-families")
        families = [args.family]
    if args.changed_only is not None:
        from bluefog_tpu_torch.analysis.conformance import families_for_paths

        families = families_for_paths(args.changed_only)
        print(f"changed-only: {len(args.changed_only)} file(s) -> "
              f"families {families}")
    if args.no_hlo:
        families = [f for f in (families or analysis.registry.families())
                    if f != "collective"]
    report = analysis.Report()
    seconds = {}
    for fam in (families if families is not None
                else analysis.registry.families()):
        t0 = time.perf_counter()
        analysis.registry.run(families=[fam], report=report,
                              verbose=args.verbose)
        seconds[fam] = time.perf_counter() - t0
    if args.json:
        print(json.dumps(dict(report.to_dict(), family_seconds=seconds),
                         indent=2, sort_keys=True))
    else:
        for f in report.findings:
            print(f)
        for name, value in sorted(report.metrics.items()):
            print(f"  metric {name} = {value}")
        for fam, sec in seconds.items():
            print(f"  seconds {fam} = {sec:.3f}")
        print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
