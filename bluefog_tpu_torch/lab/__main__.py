"""CLI for the convergence observatory.

    python -m bluefog_tpu_torch.lab sweep --topologies exp2,ring,star \\
        --sizes 4,8,16 --rounds 25 --out benchmarks/LAB_r01.json
    python -m bluefog_tpu_torch.lab check [--artifact PATH] [--json]
    python -m bluefog_tpu_torch.lab recommend -n 16 --payload-bytes 1048576
    python -m bluefog_tpu_torch.lab --check        # alias used by CI

``sweep`` launches real fleets (see :mod:`bluefog_tpu_torch.lab.sweep`) and
writes the versioned artifact.  ``check`` re-derives every claim the
artifact makes (the ``lab`` analysis rule family) and exits nonzero on
any error — ``bftpu-analysis --self-test`` runs it as its lab arm.
``recommend`` answers the deployment question from the frozen laws.
"""

from __future__ import annotations

import argparse
import json
import sys


def _csv(s: str):
    return tuple(x.strip() for x in s.split(",") if x.strip())


def _cmd_sweep(args) -> int:
    from bluefog_tpu_torch.lab import sweep as _sweep

    art = _sweep.run_sweep(
        topologies=_csv(args.topologies),
        sizes=tuple(int(x) for x in _csv(args.sizes)),
        rounds=args.rounds,
        payload_bytes=args.payload_bytes,
        seed=args.seed,
        tol=args.tol,
        out_path=args.out,
        timeout=args.timeout,
        log=lambda m: print(m, file=sys.stderr),
    )
    if not args.out:
        print(json.dumps(art, indent=2, sort_keys=True))
    return 0 if art["oracle_clean"] else 1


def _cmd_check(args) -> int:
    from bluefog_tpu_torch.analysis.engine import Severity
    from bluefog_tpu_torch.analysis.lab_rules import check_artifact
    from bluefog_tpu_torch.lab.recommend import (default_artifact_path,
                                           load_artifact)

    path = args.artifact or default_artifact_path()
    try:
        art = load_artifact(path)
    except (OSError, ValueError) as e:
        print(f"lab check: cannot load {path}: {e}", file=sys.stderr)
        return 2
    findings = check_artifact(art, label=path)
    errors = [f for f in findings if f.severity == Severity.ERROR]
    if args.json:
        print(json.dumps({
            "ok": not errors,
            "artifact": path,
            "cells": len(art.get("cells") or ()),
            "findings": [{"rule": f.rule, "subject": f.subject,
                          "message": f.message, "severity": f.severity}
                         for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(str(f))
        verdict = "OK" if not errors else "FAIL"
        print(f"lab check {verdict}: {len(art.get('cells') or ())} cells, "
              f"{len(errors)} errors")
    return 0 if not errors else 1


def _cmd_recommend(args) -> int:
    from bluefog_tpu_torch.lab.recommend import load_artifact, recommend

    art = load_artifact(args.artifact) if args.artifact else None
    rec = recommend(args.n, args.payload_bytes, artifact=art)
    print(json.dumps(rec, indent=2, sort_keys=True))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # CI alias: ``python -m bluefog_tpu_torch.lab --check`` == ``... check``
    if argv and argv[0] == "--check":
        argv[0] = "check"
    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.lab",
        description="Convergence observatory: measured scaling laws, "
                    "sim-as-oracle diffing, topology recommendation.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sweep", help="measure real fleets and emit the "
                                     "versioned artifact")
    p.add_argument("--topologies", default="exp2,ring,star",
                   help="comma list of corpus topologies")
    p.add_argument("--sizes", default="4,8,16",
                   help="comma list of fleet sizes")
    p.add_argument("--rounds", type=int, default=25)
    p.add_argument("--payload-bytes", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol", type=float, default=0.15,
                   help="max |measured - sim| rate before a cell is "
                        "flagged divergent")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-cell fleet timeout (seconds)")
    p.add_argument("--out", default=None,
                   help="artifact path (stdout JSON when omitted)")
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("check", help="re-derive every claim a lab "
                                     "artifact makes")
    p.add_argument("--artifact", default=None,
                   help="artifact path (default: BFTPU_LAB_ARTIFACT or "
                        "the frozen package artifact)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("recommend", help="pick a topology from the "
                                         "frozen scaling laws")
    p.add_argument("-n", type=int, required=True, help="fleet size")
    p.add_argument("--payload-bytes", type=int, default=1 << 20)
    p.add_argument("--artifact", default=None)
    p.set_defaults(fn=_cmd_recommend)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
