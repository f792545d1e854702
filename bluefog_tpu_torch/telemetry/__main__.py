"""CLI: merge per-rank telemetry snapshots into one cross-rank summary.

    python -m bluefog_tpu_torch.telemetry SNAP_OR_DIR [...] [--format json|prom|both]
                                    [--out PATH] [--check]
                                    [--slo-report] [--slo-margin-s S]

Positional arguments are snapshot files or directories (directories are
globbed for ``telemetry-*.json``; previously merged summaries are
skipped by schema tag).  With no arguments the default telemetry dir
(``$BFTPU_TELEMETRY`` when it names a dir, else bftpu_telemetry in the temporary directory)
is scanned.

``--check`` runs the telemetry analysis rules (snapshot schema +
conservation invariant) over the corpus, plus the ``serve_request``
journal-record schema when event journals sit alongside the snapshots,
and exits non-zero on findings.

``--slo-report`` switches to the request-level journals instead: SLO
violation windows (journaled by the per-replica monitor) are joined to
the cause events that explain them (publishes, swaps, staleness
retries, tree churn) on the shared wall clock.  Exits non-zero when any
window has no overlapping cause — an *unexplained* violation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from bluefog_tpu_torch.telemetry.merge import (
    check_request_records,
    find_snapshots,
    load_snapshot,
    merge_snapshots,
    slo_report,
    to_prometheus,
)
from bluefog_tpu_torch.telemetry.registry import _DEFAULT_DIR, telemetry_dir
from bluefog_tpu_torch.telemetry.rules import check_snapshot_corpus


def _default_paths() -> List[str]:
    d = telemetry_dir() or _DEFAULT_DIR
    return [d] if os.path.isdir(d) else []


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.telemetry",
        description="Merge per-rank telemetry snapshots into one summary.")
    ap.add_argument("paths", nargs="*",
                    help="snapshot files or directories "
                         "(default: the telemetry dir)")
    ap.add_argument("--format", choices=("json", "prom", "both"),
                    default="json", help="output format (default: json)")
    ap.add_argument("--out", default=None,
                    help="write output to PATH instead of stdout "
                         "(with --format both, PATH and PATH.prom)")
    ap.add_argument("--check", action="store_true",
                    help="run telemetry analysis rules over the corpus "
                         "(snapshots + serve_request journal schema); "
                         "exit non-zero on findings")
    ap.add_argument("--slo-report", action="store_true",
                    help="join SLO violation windows in the event "
                         "journals to their cause events; exit non-zero "
                         "on unattributed windows")
    ap.add_argument("--slo-margin-s", type=float, default=2.0,
                    help="cause-join slack around each violation window "
                         "(seconds, default: 2.0)")
    args = ap.parse_args(argv)

    if args.slo_report:
        report = slo_report(args.paths or _default_paths(),
                            margin_s=args.slo_margin_s)
        text = json.dumps(report, indent=2)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        else:
            print(text)
        if not report["journals"]:
            print("error: no event journals found (run with "
                  "BFTPU_TELEMETRY=1, or pass journal paths)",
                  file=sys.stderr)
            return 2
        print(f"slo report: {report['total_windows']} violation "
              f"window(s) over {report['requests']} request(s) in "
              f"{len(report['journals'])} journal(s), "
              f"{report['unattributed']} unattributed",
              file=sys.stderr)
        return 1 if report["unattributed"] else 0

    paths = find_snapshots(args.paths or _default_paths())
    snaps = []
    skipped = []
    for p in paths:
        try:
            snap = load_snapshot(p)
        except (OSError, ValueError) as e:
            # a SIGKILLed rank leaves a truncated/partial snapshot:
            # merge what the survivors wrote instead of dying mid-merge
            print(f"warning: skipping {p}: {e}", file=sys.stderr)
            skipped.append(p)
            continue
        if snap is not None:
            snaps.append(snap)
    if not snaps:
        print("error: no telemetry snapshots found "
              "(run with BFTPU_TELEMETRY=1, or pass snapshot paths)",
              file=sys.stderr)
        return 2

    merged = merge_snapshots(snaps)
    json_text = json.dumps(merged, indent=2)
    prom_text = to_prometheus(merged)

    if args.out:
        if args.format in ("json", "both"):
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(json_text + "\n")
        if args.format == "prom":
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(prom_text)
        elif args.format == "both":
            with open(args.out + ".prom", "w", encoding="utf-8") as f:
                f.write(prom_text)
        print(f"merged {len(snaps)} snapshot(s) "
              f"(ranks {merged['ranks']}) -> {args.out}", file=sys.stderr)
    else:
        if args.format in ("json", "both"):
            print(json_text)
        if args.format in ("prom", "both"):
            print(prom_text, end="")

    rc = 0
    if args.check:
        findings = check_snapshot_corpus(snaps)
        for f in findings:
            print(f"CHECK {f.severity}: [{f.rule}] {f.subject}: {f.message}",
                  file=sys.stderr)
        req_errors = check_request_records(args.paths or _default_paths())
        for msg in req_errors:
            print(f"CHECK error: [telemetry.request-journal] {msg}",
                  file=sys.stderr)
        if skipped:
            # an unreadable rank means the corpus (and thus the ledger
            # verdict) is incomplete — note it and fail the check
            print(f"CHECK warning: [telemetry.merge-skipped] "
                  f"{len(skipped)} snapshot(s) unreadable/truncated: "
                  f"{', '.join(skipped)}", file=sys.stderr)
        if findings or req_errors or skipped:
            rc = 1
        else:
            led = merged["ledger"]
            print(f"check ok: {len(snaps)} snapshots, ledger balanced "
                  f"(deposits={led['deposits']:.0f} = "
                  f"collected={led['collected']:.0f} + "
                  f"drained={led['drained']:.0f} + "
                  f"pending={led['pending']:.0f})", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
