"""Campaign CLI: ``python -m bluefog_tpu_torch.sim``.

Runs one seeded fault campaign over the real protocol state machines
and exits 0 on a clean run, 1 on any invariant violation — the shape
a CI job wants.  On violation with ``--shrink`` (the default), the
schedule is delta-debugged down to the minimal sub-schedule that
still reproduces the violation and written as a repro file that
``--replay`` re-runs from nothing but the file.

Flags default from the sim env family — ``BFTPU_SIM_RANKS``,
``BFTPU_SIM_ROUNDS``, ``BFTPU_SIM_SEED``, ``BFTPU_SIM_TOPOLOGY``,
``BFTPU_SIM_FAULTS``, ``BFTPU_SIM_QUIESCE_ROUNDS``,
``BFTPU_SIM_LATENCY_MS``, ``BFTPU_SIM_SCHEDULE``,
``BFTPU_SIM_REPRO_DIR``, ``BFTPU_SIM_QUORUM`` (all documented in
docs/OBSERVABILITY.md) —
so a chaos-style harness can parameterize a campaign the same way it
parameterizes a fault schedule; explicit flags always win.

Examples::

    python -m bluefog_tpu_torch.sim --ranks 256 --rounds 50 --seed 7 \\
        --faults kill,slow,join
    python -m bluefog_tpu_torch.sim --replay repro-mass-conservation.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from bluefog_tpu_torch.sim.campaign import (
    SimConfig, run_campaign, shrink_schedule, write_repro, replay,
    load_repro)
from bluefog_tpu_torch.sim.schedule import FAULT_KINDS, FaultSchedule

_TOPOLOGIES = ("exp2", "exp", "sym_exp4", "ring", "ring_uni", "star",
               "mesh2d", "full")


def _env(key: str, default=None):
    v = os.environ.get(key)
    return default if v is None or v == "" else v


def _parse_faults(spec: str) -> tuple:
    kinds = tuple(k.strip() for k in spec.split(",") if k.strip())
    bad = [k for k in kinds if k not in FAULT_KINDS]
    if bad:
        raise SystemExit(f"bftpu-sim: unknown fault kind(s) {bad} "
                         f"(one of {list(FAULT_KINDS)})")
    return kinds


def _parse_latency_ms(spec: str) -> tuple:
    try:
        lo, hi = (float(p) for p in spec.split(","))
    except ValueError:
        raise SystemExit("bftpu-sim: --latency-ms wants 'LO,HI' "
                         f"(got {spec!r})")
    return (lo / 1000.0, hi / 1000.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.sim",
        description=__doc__.split("\n\n")[1],
    )
    ap.add_argument("--ranks", type=int,
                    default=int(_env("BFTPU_SIM_RANKS", 64)))
    ap.add_argument("--rounds", type=int,
                    default=int(_env("BFTPU_SIM_ROUNDS", 50)))
    ap.add_argument("--seed", type=int,
                    default=int(_env("BFTPU_SIM_SEED", 0)))
    ap.add_argument("--topology", choices=_TOPOLOGIES,
                    default=str(_env("BFTPU_SIM_TOPOLOGY", "exp2")))
    ap.add_argument("--faults", type=_parse_faults,
                    default=_parse_faults(
                        str(_env("BFTPU_SIM_FAULTS", "kill,slow,join"))),
                    help="comma list of fault kinds to draw from "
                         f"(subset of {','.join(FAULT_KINDS)})")
    ap.add_argument("--quiesce-rounds", type=int,
                    default=int(_env("BFTPU_SIM_QUIESCE_ROUNDS", 40)),
                    help="fault-free rounds appended so push-sum can "
                         "re-converge before the consensus audit")
    ap.add_argument("--latency-ms", type=_parse_latency_ms,
                    default=_parse_latency_ms(
                        str(_env("BFTPU_SIM_LATENCY_MS", "2,20"))),
                    metavar="LO,HI",
                    help="per-edge virtual wire latency range")
    ap.add_argument("--schedule", metavar="PATH",
                    default=_env("BFTPU_SIM_SCHEDULE"),
                    help="run an explicit fault-schedule JSON file "
                         "instead of generating one from the seed")
    ap.add_argument("--replay", metavar="REPRO",
                    help="re-run a repro file (config + schedule come "
                         "from the file; other flags are ignored)")
    ap.add_argument("--shrink", dest="shrink", action="store_true",
                    default=True,
                    help="on violation, ddmin the schedule to a "
                         "minimal repro (default)")
    ap.add_argument("--no-shrink", dest="shrink", action="store_false")
    ap.add_argument("--repro-dir", metavar="DIR",
                    default=_env("BFTPU_SIM_REPRO_DIR", "."),
                    help="where repro files are written")
    ap.add_argument("--journal-dir", metavar="DIR",
                    help="emit per-rank telemetry journals + snapshots "
                         "(validate with python -m bluefog_tpu_torch.telemetry)")
    ap.add_argument("--debug-bug", action="append", default=[],
                    metavar="NAME",
                    help="seed an intentional bug (mass_leak, "
                         "cap_bypass, split_brain) — the campaign "
                         "should CATCH it")
    ap.add_argument("--serve-every", type=int, default=0,
                    metavar="N",
                    help="arm the serving plane: the publisher commits "
                         "a snapshot every N rounds (0 = off)")
    ap.add_argument("--serve-replicas", type=int, default=0,
                    metavar="K",
                    help="hot-swap replica models polling the "
                         "committed head (0 = off)")
    ap.add_argument("--arrivals", choices=("poisson", "fixed"),
                    default="",
                    help="replay an open-loop request process against "
                         "the serving replicas (needs --serve-every "
                         "and --serve-replicas); arms the request-SLO "
                         "and staleness-SLO standing invariants")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    metavar="HZ",
                    help="requests per virtual second per replica")
    ap.add_argument("--request-slo-ms", type=float, default=0.0,
                    metavar="MS",
                    help="per-request latency SLO on the virtual "
                         "clock (0 = 2x the round period)")
    ap.add_argument("--request-staleness-slo", type=int, default=0,
                    metavar="V",
                    help="max versions behind the committed head a "
                         "served request may be (0 = unbounded)")
    ap.add_argument("--latency-from-trace", metavar="FILE",
                    help="fit the per-edge gossip latency to a merged "
                         "trace's critical-path report (replaces the "
                         "uniform --latency-ms draw with empirical "
                         "per-edge quantile samplers)")
    ap.add_argument("--quorum", choices=("majority", "off"),
                    default=str(_env("BFTPU_SIM_QUORUM", "majority")),
                    help="membership-commit quorum fence (mirrors "
                         "BFTPU_QUORUM; explicit in the config so "
                         "repro files replay identically)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary on stdout")
    return ap


def _print(summary: dict, as_json: bool, violations: List[dict]) -> None:
    if as_json:
        print(json.dumps(summary, indent=2, sort_keys=True))
        return
    print(f"bftpu-sim: {'OK' if summary['ok'] else 'VIOLATED'} "
          f"digest={summary['digest']} members={summary['members']} "
          f"events={summary['events']} faults={summary['faults']} "
          f"spread={summary['estimate_spread']:.3e}")
    arr = summary.get("arrivals")
    if arr:
        print(f"bftpu-sim: arrivals {arr['process']}@{arr['rate']:g}/s "
              f"admitted={arr['admitted']} served={arr['served']} "
              f"attributed={arr['attributed']} "
              f"violations={arr['violations']}")
    led = summary.get("ledger") or {}
    print(f"bftpu-sim: ledger deposits={led.get('deposits')} "
          f"collected={led.get('collected')} "
          f"drained={led.get('drained')} pending={led.get('pending')} "
          f"balanced={led.get('balanced')}")
    for v in violations[:5]:
        print(f"bftpu-sim: violation {v['name']} @rank {v['rank']}: "
              f"{v['detail']}")
    if len(violations) > 5:
        print(f"bftpu-sim: ... and {len(violations) - 5} more")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.replay:
        cfg, schedule, doc = load_repro(args.replay)
        res = run_campaign(cfg, schedule)
        summary = res.summary()
        want = doc.get("violation")
        if want is not None:
            names = {v["name"] for v in res.violations}
            summary["reproduced"] = want["name"] in names
            if not args.json:
                print(f"bftpu-sim: replay {'REPRODUCED' if summary['reproduced'] else 'DID NOT reproduce'} "
                      f"{want['name']} (schedule of {len(schedule)})")
        _print(summary, args.json, res.violations)
        # a replay FAILS when it can't reproduce the recorded bug —
        # that means the repro went stale
        if want is not None:
            return 0 if summary["reproduced"] else 1
        return 0 if res.ok else 1

    latency_table = ()
    if args.latency_from_trace:
        from bluefog_tpu_torch.sim.latency import load_trace_latency
        try:
            latency_table = load_trace_latency(args.latency_from_trace)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise SystemExit(f"bftpu-sim: --latency-from-trace: {e}")
        if not args.json:
            print(f"bftpu-sim: latency fitted to "
                  f"{len(latency_table)} traced edge(s) from "
                  f"{args.latency_from_trace}")
    cfg = SimConfig(
        ranks=args.ranks, rounds=args.rounds, seed=args.seed,
        topology=args.topology, faults=tuple(args.faults),
        quiesce_rounds=args.quiesce_rounds,
        latency_s=tuple(args.latency_ms),
        journal_dir=args.journal_dir,
        debug_bugs=tuple(args.debug_bug),
        quorum=args.quorum,
        serve_every=args.serve_every,
        serve_replicas=args.serve_replicas,
        arrivals=args.arrivals,
        arrival_rate=args.arrival_rate,
        request_slo_s=args.request_slo_ms / 1000.0,
        request_staleness_slo=args.request_staleness_slo,
        latency_table=latency_table,
    )
    schedule = None
    if args.schedule:
        with open(args.schedule, "r", encoding="utf-8") as f:
            schedule = FaultSchedule.from_json(f.read())
    res = run_campaign(cfg, schedule)
    summary = res.summary()

    if not res.ok and args.shrink:
        full = res.schedule
        minimal, viol, runs = shrink_schedule(cfg, full)
        os.makedirs(args.repro_dir, exist_ok=True)
        name = (viol or {"name": "unknown"})["name"].replace("/", "-")
        path = os.path.join(
            args.repro_dir,
            f"repro-{name}-seed{cfg.seed}-n{cfg.ranks}.json")
        write_repro(path, cfg, minimal, viol, digest=res.digest)
        summary["shrunk"] = {
            "from": len(full), "to": len(minimal),
            "campaigns": runs, "repro": path,
            "violation": (viol or {}).get("name"),
        }
        if not args.json:
            print(f"bftpu-sim: shrunk {len(full)} -> {len(minimal)} "
                  f"fault(s) in {runs} campaign(s); repro: {path}")
    _print(summary, args.json, res.violations)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
