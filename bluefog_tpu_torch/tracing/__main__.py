"""CLI: stitch per-rank trace buffers into one Chrome trace.

    python -m bluefog_tpu_torch.tracing [PATHS...] [--out merged.json]
                                  [--critical-path] [--journals] [--check]

Positional arguments are per-rank ``trace-*.json`` files or directories
(directories are globbed; merged outputs and flight dumps are skipped by
schema tag).  With no arguments the default tracing dir
(``$BFTPU_TRACING`` when it names a dir, else /tmp/bftpu_tracing) is
scanned.

``--out`` writes the merged Chrome trace (default
``<dir>/merged-trace.json``; load it in ``chrome://tracing`` or
Perfetto).  ``--critical-path`` additionally prints the per-round
critical-path / straggler-attribution report to stdout.  ``--journals``
folds telemetry event journals from the same directories into the trace
as instant events.  ``--check`` runs the analysis trace rules over the
loaded buffers and exits non-zero on findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from bluefog_tpu_torch.tracing.merge import (
    critical_path,
    find_flights,
    find_traces,
    load_trace,
    merge_traces,
)
from bluefog_tpu_torch.tracing.tracer import _DEFAULT_DIR, tracing_dir


def _default_paths() -> List[str]:
    d = tracing_dir() or _DEFAULT_DIR
    return [d] if os.path.isdir(d) else []


def _load_journals(paths: List[str]):
    """Rank → telemetry journal events found beside the trace buffers."""
    import glob
    import re

    from bluefog_tpu_torch.telemetry import read_journal
    from bluefog_tpu_torch.telemetry.registry import journal_paths

    journals = {}
    for p in paths:
        d = p if os.path.isdir(p) else os.path.dirname(p) or "."
        for jp in sorted(glob.glob(
                os.path.join(d, "telemetry-*.events.jsonl"))):
            m = re.search(r"-r(\d+)\.events\.jsonl$", jp)
            if not m:
                continue
            # journal_paths folds in the rotated generation (<path>.1,
            # BFTPU_JOURNAL_MAX_MB) ahead of the live file
            for part in journal_paths(jp):
                events, _bad = read_journal(part)
                journals.setdefault(int(m.group(1)), []).extend(events)
    return journals


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.tracing",
        description="Merge per-rank trace buffers into one Chrome trace "
                    "with cross-rank flow events.")
    ap.add_argument("paths", nargs="*",
                    help="trace-buffer files or directories "
                         "(default: the tracing dir)")
    ap.add_argument("--out", default=None,
                    help="merged Chrome-trace path "
                         "(default: <dir>/merged-trace.json)")
    ap.add_argument("--critical-path", action="store_true",
                    help="print the per-round critical-path / straggler "
                         "report to stdout")
    ap.add_argument("--journals", action="store_true",
                    help="fold telemetry event journals into the trace")
    ap.add_argument("--check", action="store_true",
                    help="run analysis trace rules over the buffers; "
                         "exit non-zero on findings")
    args = ap.parse_args(argv)

    roots = args.paths or _default_paths()
    paths = find_traces(roots)
    traces = []
    for p in paths:
        try:
            tr = load_trace(p)
        except (OSError, ValueError) as e:
            print(f"warning: skipping {p}: {e}", file=sys.stderr)
            continue
        if tr is not None:
            traces.append(tr)
    if not traces:
        print("error: no trace buffers found "
              "(run with BFTPU_TRACING=1, or pass trace paths)",
              file=sys.stderr)
        return 2

    journals = _load_journals(roots) if args.journals else None
    merged = merge_traces(traces, journals=journals)

    out = args.out
    if out is None:
        d = roots[0] if os.path.isdir(roots[0]) else (
            os.path.dirname(paths[0]) or ".")
        out = os.path.join(d, "merged-trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(merged, f)
        f.write("\n")
    n_flow = sum(1 for e in merged["traceEvents"] if e.get("ph") == "s")
    print(f"merged {len(traces)} rank buffer(s) "
          f"(ranks {merged['otherData']['ranks']}, {n_flow} flows) -> {out}",
          file=sys.stderr)

    flights = find_flights(roots)
    if flights:
        print(f"flight dumps present: {', '.join(flights)}", file=sys.stderr)

    if args.critical_path:
        report = critical_path(traces)
        print(json.dumps(report, indent=2))

    rc = 0
    if args.check:
        from bluefog_tpu_torch.analysis import trace_rules

        findings = trace_rules.check_trace_corpus(traces)
        for f in findings:
            print(f"CHECK {f.severity}: [{f.rule}] {f.subject}: {f.message}",
                  file=sys.stderr)
        if findings:
            rc = 1
        else:
            print(f"check ok: {len(traces)} buffers", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
