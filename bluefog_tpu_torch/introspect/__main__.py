"""``bftpu-top``: live fleet view over the shm status pages.

    python -m bluefog_tpu_torch.introspect --job JOB            # refreshing view
    python -m bluefog_tpu_torch.introspect --job JOB --once --json
    python -m bluefog_tpu_torch.introspect --job JOB --trace on
    bftpu-run --attach JOB top [--once --json]            # same thing

Reads are passive (seqlock readers over the per-rank pages + the holder
board): attaching never blocks or perturbs the run.  The launcher
control socket, when present, contributes supervisor state (live pids,
pending scale); the pages alone are enough for jobs spawned in-process.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from typing import Dict, Optional

from bluefog_tpu_torch.introspect import statuspage as sp

_EDGE_CHAR = {"alive": ".", "suspect": "S", "dead": "D", "demoted": "d"}


def _launcher_state(job: str) -> Optional[dict]:
    """Best-effort ``top`` query against the launcher control socket."""
    from bluefog_tpu_torch.run.launcher import control_sock_path

    path = control_sock_path(job)
    if not os.path.exists(path):
        return None
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(1.0)
        s.connect(path)
        s.sendall((json.dumps({"cmd": "top"}) + "\n").encode())
        line = s.makefile("r").readline()
        s.close()
        rep = json.loads(line)
        return rep if rep.get("ok") else None
    except (OSError, ValueError):
        return None


def snapshot(job: str) -> dict:
    """One merged fleet snapshot: status pages + holders + launcher."""
    snap = sp.collect(job)
    launcher = _launcher_state(job)
    if launcher is not None:
        snap["launcher"] = {k: launcher[k] for k in
                            ("live", "joiners", "pending_scale")
                            if k in launcher}
    return snap


def _rates(prev: Dict[int, tuple], snap: dict) -> Dict[int, float]:
    """Per-rank step/s between two snapshots (NaN-free: absent = 0)."""
    rates: Dict[int, float] = {}
    for rs, page in snap["ranks"].items():
        if "error" in page:
            continue
        r = int(rs)
        cur = (page["step"], page["mono_ts"])
        if r in prev:
            dstep = cur[0] - prev[r][0]
            dt = cur[1] - prev[r][1]
            if dt > 0:
                rates[r] = dstep / dt
        prev[r] = cur
    return rates


def render(snap: dict, rates: Dict[int, float]) -> str:
    """The fleet view as plain text (one frame of the live display)."""
    lines = []
    ranks = sorted(int(r) for r in snap["ranks"])
    holders = {int(m): h for m, h in snap.get("holders", {}).items()}
    held_by = {}  # holder rank -> [mutexes]
    for m, h in holders.items():
        held_by.setdefault(h, []).append(m)
    lines.append(f"bftpu-top — job {snap['job']}  epoch {snap['epoch']}  "
                 f"{time.strftime('%H:%M:%S', time.localtime(snap['wall_ts']))}")
    la = snap.get("launcher")
    if la:
        lines.append(f"launcher: live={len(la.get('live', []))} "
                     f"joiners={la.get('joiners', 0)} "
                     f"pending_scale={la.get('pending_scale', 0)}")
    lines.append("")
    lines.append(f"{'RANK':>4} {'STEP':>8} {'STEP/S':>7} {'EPOCH':>5} "
                 f"{'LAST OP':<12} {'BALANCE':>10} {'CONV':>9} "
                 f"{'SERVE':>9} {'QPS':>7} {'P99MS':>7} {'SLO':>4} "
                 f"{'QUEUE':<14} {'HOLDS':<8} EDGES")
    for r in ranks:
        page = snap["ranks"][str(r)]
        if "error" in page:
            lines.append(f"{r:>4} {'—':>8} {page['error']}")
            continue
        rate = rates.get(r)
        edges = " ".join(
            f"{e['peer']}:{_EDGE_CHAR.get(e['state'], '?')}"
            for e in page["edges"])
        holds = ",".join(f"m{m}" for m in sorted(held_by.get(r, []))) or "-"
        # the progress-engine view (statuspage v2): queue depth plus the
        # op the worker is landing right now; "-" = no engine running
        prog = page.get("progress", {})
        qd = prog.get("qdepth", -1)
        queue = "-" if qd < 0 else (
            f"{qd}" + (f">{prog['inflight']}" if prog.get("inflight")
                       else ""))
        # convergence probe (statuspage v3): debiased consensus-error
        # sample; "—" = probe off (or pre-v3 writer / first round)
        conv = page.get("conv", {})
        cerr, cround = conv.get("err", -1.0), conv.get("round", -1)
        conv_s = f"{cerr:.1e}" if cround >= 0 and cerr >= 0.0 else "—"
        # serving plane (statuspage v5): the snapshot version this rank
        # publishes/serves; replicas append their lag ("v3+2" = serving
        # v3, 2 committed versions behind); "—" = not a serve rank.
        # A distribution-tree replica (v6) appends its slot and feed
        # edge: "v3 s4<1" = slot 4 fed by slot 1, "<P" = publisher-fed
        sv = page.get("serve", {})
        sver, slag = sv.get("version", -1), sv.get("lag", -1)
        serve_s = "—" if sver < 0 else (
            f"v{sver}" + (f"+{slag}" if slag > 0 else ""))
        dv = page.get("distrib", {})
        if sver >= 0 and dv.get("slot", -1) >= 0:
            par = dv.get("parent", -1)
            serve_s += f" s{dv['slot']}<" + (
                "P" if par < 0 else str(par))
        # request plane (statuspage v7): rolling-window QPS + p99 and
        # the SLO lamp (— = no SLO armed / no traffic, ok = inside the
        # objective, VIOL = in an open violation window)
        qps, p99 = sv.get("qps", -1.0), sv.get("p99_ms", -1.0)
        qps_s = f"{qps:.1f}" if qps >= 0 else "—"
        p99_s = f"{p99:.2f}" if p99 >= 0 else "—"
        slo_s = {0: "ok", 1: "VIOL"}.get(sv.get("slo_state", -1), "—")
        # an ORPHAN rank quiesced on quorum loss — the page freezes at
        # the denial, so the state outranks whatever op came last
        last_op = "ORPHAN" if page.get("orphan") else page["last_op"]
        lines.append(
            f"{r:>4} {page['step']:>8} "
            f"{('%.1f' % rate) if rate is not None else '—':>7} "
            f"{page['epoch']:>5} {last_op:<12} "
            f"{page['ledger']['balance']:>10.3g} {conv_s:>9} "
            f"{serve_s:>9} {qps_s:>7} {p99_s:>7} {slo_s:>4} "
            f"{queue:<14} {holds:<8} {edges}")
    if snap.get("serve"):
        lines.append("")
        # tree replicas append "slot<parent" ("<P" = publisher-fed),
        # so one line shows the whole distribution fan-out
        lines.append(
            f"serving: committed v{snap.get('serve_published', -1)}; " +
            ", ".join(
                f"r{r} v{v['version']} lag {max(0, v['lag'])}" + (
                    f" s{v['slot']}<" + ("P" if v.get("parent", -1) < 0
                                         else str(v["parent"]))
                    if v.get("slot", -1) >= 0 else "") + (
                    f" {v['qps']:.0f}/s p99 {v['p99_ms']:.1f}ms"
                    if v.get("qps", -1.0) >= 0 else "")
                for r, v in sorted(snap["serve"].items(),
                                   key=lambda kv: int(kv[0]))))
    if snap.get("monitor"):
        lines.append("")
        # the fleet-monitor lamp (statuspage v8): quiet/FIRING plus the
        # last alert's rule name — one glance answers "is it alarming?"
        lines.append("monitor: " + ", ".join(
            (f"r{r} FIRING [{m['last']}]" if m["state"] == 1 else
             f"r{r} quiet" + (f" (last {m['last']})" if m["last"] else ""))
            + f" scrapes {m['scrapes']} firings {m['firings']}"
            for r, m in sorted(snap["monitor"].items(),
                               key=lambda kv: int(kv[0]))))
    if snap.get("orphans"):
        lines.append("")
        lines.append(f"ORPHANED (quorum lost, quiesced): "
                     f"{', '.join(str(o) for o in snap['orphans'])}")
    if snap.get("suspects"):
        lines.append("")
        lines.append(f"straggler suspects: "
                     f"{', '.join(str(s) for s in snap['suspects'])}")
    if holders:
        lines.append(f"lock holders: " + ", ".join(
            f"mutex {m} held by rank {h}" for m, h in sorted(holders.items())))
    lines.append("")
    lines.append("edges: .=alive S=suspect D=dead d=demoted "
                 "(as seen by the row's rank)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bftpu-top",
        description="Live fleet view of a running islands job "
        "(status pages + lock holders + straggler suspects).")
    parser.add_argument("--job", required=True,
                        help="island job name (BLUEFOG_ISLAND_JOB)")
    parser.add_argument("--once", action="store_true",
                        help="print one snapshot and exit")
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON instead of the "
                        "table (schema bftpu-top/1)")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="refresh interval in seconds (live mode)")
    parser.add_argument("--trace", choices=("on", "off", "default"),
                        default=None,
                        help="publish the runtime trace-control word "
                        "(flips BFTPU_TRACING in running ranks) and exit")
    args = parser.parse_args(argv)

    if args.trace is not None:
        mode = {"on": sp.TRACE_ON, "off": sp.TRACE_OFF,
                "default": sp.TRACE_DEFAULT}[args.trace]
        gen = sp.publish_trace_control(args.job, mode)
        print(json.dumps({"ok": True, "job": args.job, "mode": args.trace,
                          "generation": gen}))
        return 0

    snap = snapshot(args.job)
    if not snap["ranks"]:
        print(f"bftpu-top: no status pages for job {args.job!r} — is the "
              f"run up (and BFTPU_STATUSPAGE not 0)?", file=sys.stderr)
        if args.once and args.json:
            print(json.dumps(snap, indent=2))
        return 1

    if args.once:
        print(json.dumps(snap, indent=2) if args.json
              else render(snap, {}))
        return 0

    prev: Dict[int, tuple] = {}
    _rates(prev, snap)  # seed the rate baseline
    try:
        while True:
            time.sleep(max(0.1, args.interval))
            snap = snapshot(args.job)
            rates = _rates(prev, snap)
            if args.json:
                print(json.dumps(snap))
            else:
                # clear + home, then one frame — plain ANSI, no curses dep
                sys.stdout.write("\x1b[2J\x1b[H" + render(snap, rates) + "\n")
                sys.stdout.flush()
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
