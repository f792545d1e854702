"""Clock-aligned cross-rank trace merge, flow events, and critical paths.

Input: per-rank ``trace-<job>-r<rank>.json`` buffers written by
:mod:`bluefog_tpu_torch.tracing.tracer` (plus, optionally, telemetry
journals).  Output: one Chrome-trace JSON where

* each rank is a distinct ``pid`` (with a ``process_name`` metadata
  event),
* every span is a ``ph:"X"`` complete event on the **coordinator's
  clock** — each rank's monotonic timestamps are shifted by its min-RTT
  clock offset (:mod:`bluefog_tpu_torch.tracing.clock`),
* every (producer ``emit``, consumer ``consume``) pair that shares a
  trace-context identity ``(origin, op_id)`` becomes a flow arrow
  (``ph:"s"`` at the producing span, ``ph:"f"`` at the consuming span),
* telemetry journal events ride along as ``ph:"i"`` instants, mapped
  from wall clock to the span timeline via each buffer's recorded
  wall↔monotonic anchor.

:func:`critical_path` walks the merged causal graph backwards from each
round's last-finishing ``win_update`` — predecessor = the latest of
(the producer of the latest-arriving consumed flow, the previous span on
the same rank) — yielding the longest causal chain per gossip round and
a straggler-attribution report (per-edge p50/p99 flow latency, which
rank lengthened each round).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.tracing.tracer import FLIGHT_SCHEMA, TRACE_SCHEMA

MERGED_TRACE_SCHEMA = "bftpu-merged-trace-v1"

# spans that close a gossip round (critical-path roots), in preference
# order: the combine is the canonical round boundary
_ROUND_CLOSERS = ("win_update", "win_update_then_collect")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def find_traces(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into per-rank trace-buffer paths."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "trace-*.json"))))
        else:
            out.append(p)
    # dedupe, preserve order
    seen = set()
    uniq = []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def find_flights(paths: Sequence[str]) -> List[str]:
    """Flight-recorder JSON dumps next to the trace buffers."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "flight-*.json"))))
        elif os.path.basename(p).startswith("flight-"):
            out.append(p)
    return out


def load_trace(path: str) -> Optional[Dict]:
    """Load one per-rank buffer; None when the schema doesn't match
    (merged outputs and flight dumps are silently skipped)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != TRACE_SCHEMA:
        return None
    return doc


def load_flight(path: str) -> Optional[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != FLIGHT_SCHEMA:
        return None
    return doc


# ---------------------------------------------------------------------------
# alignment + flow index
# ---------------------------------------------------------------------------


def _aligned_spans(traces: Sequence[Dict]) -> Tuple[List[Dict], float]:
    """Flatten all buffers into span dicts with coordinator-clock
    microsecond timestamps (``t0_us``/``t1_us``), plus the global origin
    subtracted from every timestamp."""
    spans: List[Dict] = []
    for tr in traces:
        rank = int(tr.get("rank", -1))
        off_us = float(tr.get("clock", {}).get("offset_s", 0.0)) * 1e6
        err_us = float(tr.get("clock", {}).get("err_s", 0.0)) * 1e6
        for i, s in enumerate(tr.get("spans", ())):
            spans.append({
                "rank": rank,
                "idx": i,
                "name": s.get("name", "?"),
                "round": int(s.get("round", 0)),
                "t0_us": s.get("t0", 0) / 1e3 + off_us,
                "t1_us": s.get("t1", 0) / 1e3 + off_us,
                "err_us": err_us,
                "ph": s.get("ph", "X"),
                "win": s.get("win"),
                "emit": s.get("emit") or (),
                "consume": s.get("consume") or (),
            })
    t_min = min((s["t0_us"] for s in spans), default=0.0)
    for s in spans:
        s["t0_us"] -= t_min
        s["t1_us"] -= t_min
    return spans, t_min


def flow_index(spans: Sequence[Dict]) -> Tuple[Dict, List[Dict]]:
    """``(producers, flows)``: producers maps flow identity
    ``(origin, op_id)`` to the emitting span; flows lists every consume
    with its resolved producer (or ``None`` when the emitting span was
    lost — e.g. the producer died before writing its buffer)."""
    producers: Dict[Tuple[int, int], Dict] = {}
    for s in spans:
        for e in s["emit"]:
            producers[(s["rank"], int(e["op_id"]))] = s
    flows: List[Dict] = []
    for s in spans:
        for c in s["consume"]:
            key = (int(c.get("origin", -1)), int(c.get("op_id", 0)))
            flows.append({
                "origin": key[0],
                "op_id": key[1],
                "round": int(c.get("round", s["round"])),
                "src": int(c.get("src", key[0])),
                "dst": s["rank"],
                "producer": producers.get(key),
                "consumer": s,
            })
    return producers, flows


# ---------------------------------------------------------------------------
# merge → Chrome trace
# ---------------------------------------------------------------------------


def merge_traces(traces: Sequence[Dict],
                 journals: Optional[Dict[int, List[Dict]]] = None) -> Dict:
    """Merge per-rank buffers into one Chrome-trace dict.

    ``journals`` optionally maps rank → telemetry journal events (as
    returned by :func:`bluefog_tpu_torch.telemetry.read_journal`); they are
    attached as instant events via each rank's wall↔monotonic anchor.
    """
    traces = [t for t in traces if t]
    spans, t_min = _aligned_spans(traces)
    _, flows = flow_index(spans)

    events: List[Dict] = []
    ranks = sorted({int(t.get("rank", -1)) for t in traces})
    clock_by_rank: Dict[str, Dict] = {}
    for t in traces:
        r = int(t.get("rank", -1))
        clock_by_rank[str(r)] = t.get("clock", {})
        events.append({"ph": "M", "pid": r, "tid": 0, "name": "process_name",
                       "args": {"name": f"rank {r} ({t.get('job', '')})"}})

    for s in spans:
        if s["ph"] == "i":
            events.append({"ph": "i", "pid": s["rank"], "tid": 0, "s": "t",
                           "name": s["name"], "ts": s["t0_us"],
                           "args": {"round": s["round"]}})
            continue
        args: Dict = {"round": s["round"]}
        if s["win"]:
            args["win"] = s["win"]
        events.append({"ph": "X", "pid": s["rank"], "tid": 0,
                       "name": s["name"], "ts": s["t0_us"],
                       "dur": max(0.0, s["t1_us"] - s["t0_us"]),
                       "cat": "gossip", "args": args})

    # flow arrows along gossip edges: "s" binds inside the producing
    # span, "f" (bp:"e") inside the consuming span
    for fl in flows:
        p, c = fl["producer"], fl["consumer"]
        if p is None:
            continue  # dangling consume (producer buffer lost)
        fid = f"{fl['origin']}:{fl['op_id']}"
        events.append({"ph": "s", "pid": p["rank"], "tid": 0, "id": fid,
                       "cat": "gossip-flow", "name": "deposit",
                       "ts": max(p["t0_us"], p["t1_us"] - 0.001)})
        events.append({"ph": "f", "bp": "e", "pid": c["rank"], "tid": 0,
                       "id": fid, "cat": "gossip-flow", "name": "deposit",
                       "ts": min(c["t1_us"], c["t0_us"] + 0.001)})

    # telemetry journal instants, wall clock → span timeline per rank
    for t in traces:
        r = int(t.get("rank", -1))
        anchor = t.get("anchor") or {}
        evs = (journals or {}).get(r) or ()
        if not evs or "wall_s" not in anchor:
            continue
        off_us = float(t.get("clock", {}).get("offset_s", 0.0)) * 1e6
        base_us = anchor["mono_ns"] / 1e3 + off_us - t_min
        for ev in evs:
            ts = ev.get("ts")
            if ts is None:
                continue
            events.append({
                "ph": "i", "pid": r, "tid": 1, "s": "t",
                "name": str(ev.get("event", "journal")),
                "cat": "journal",
                "ts": base_us + (float(ts) - anchor["wall_s"]) * 1e6,
                "args": {k: v for k, v in ev.items()
                         if k not in ("event", "ts", "mono")},
            })

    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": MERGED_TRACE_SCHEMA,
            "ranks": ranks,
            "clock": clock_by_rank,
            "flows": len(flows),
        },
    }


# ---------------------------------------------------------------------------
# critical path + straggler attribution
# ---------------------------------------------------------------------------


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def critical_path(traces: Sequence[Dict], max_depth: int = 64) -> Dict:
    """Per-round longest causal chain + straggler attribution.

    For each gossip round, start from the last-finishing round-closing
    span (``win_update``) and walk predecessors: the producer of the
    latest-arriving consumed flow, or the previous span on the same
    rank — whichever completed later.  Completion times are
    non-decreasing along every returned path (up to clock error, which
    the walk clamps)."""
    traces = [t for t in traces if t]
    spans, _ = _aligned_spans(traces)
    producers, flows = flow_index(spans)

    by_rank: Dict[int, List[Dict]] = {}
    for s in spans:
        if s["ph"] != "i":
            by_rank.setdefault(s["rank"], []).append(s)
    for lst in by_rank.values():
        lst.sort(key=lambda s: s["t0_us"])
        for i, s in enumerate(lst):
            s["_pos"] = i

    def _prev_on_rank(s: Dict) -> Optional[Dict]:
        lst = by_rank.get(s["rank"], ())
        i = s.get("_pos", 0) - 1
        # skip overlapping spans (nested timeline contexts): predecessor
        # must have completed before this span began
        while i >= 0:
            if lst[i]["t1_us"] <= s["t0_us"] + s["err_us"]:
                return lst[i]
            i -= 1
        return None

    def _pred(s: Dict) -> Optional[Dict]:
        best = _prev_on_rank(s)
        slack = s["err_us"] + 1.0
        for c in s["consume"]:
            p = producers.get((int(c.get("origin", -1)), int(c.get("op_id", 0))))
            if p is None or p is s:
                continue
            if p["t1_us"] > s["t1_us"] + slack:
                continue  # clock skew beyond bound: refuse the edge
            if best is None or p["t1_us"] > best["t1_us"]:
                best = p
        return best

    nrounds = max((s["round"] for s in spans), default=-1) + 1
    rounds_out: List[Dict] = []
    lengthened: Dict[int, int] = {}
    for r in range(nrounds):
        closers = [s for s in spans
                   if s["round"] == r and s["name"] in _ROUND_CLOSERS]
        if not closers:
            continue
        last = max(closers, key=lambda s: s["t1_us"])
        path: List[Dict] = []
        cur: Optional[Dict] = last
        seen = set()
        while cur is not None and len(path) < max_depth:
            key = (cur["rank"], cur.get("_pos", -1), cur["name"])
            if key in seen:
                break
            seen.add(key)
            path.append(cur)
            cur = _pred(cur)
        path.reverse()
        rounds_out.append({
            "round": r,
            "end_rank": last["rank"],
            "t_end_us": last["t1_us"],
            "path": [{"rank": s["rank"], "name": s["name"],
                      "round": s["round"], "t0_us": s["t0_us"],
                      "t_end_us": s["t1_us"]} for s in path],
        })
        lengthened[last["rank"]] = lengthened.get(last["rank"], 0) + 1

    # per-edge flow latency: deposit START → collect completion.  Not
    # end-to-end: on an acked transport the producer span ends at ack
    # receipt, routinely AFTER the remote consumer already collected —
    # measured from t0 the latency is nonnegative up to clock error, so
    # a negative here really does mean the offsets are wrong.
    edge_lat: Dict[str, List[float]] = {}
    negative_flows = 0
    for fl in flows:
        p, c = fl["producer"], fl["consumer"]
        if p is None:
            continue
        lat = c["t1_us"] - p["t0_us"]
        if lat < 0:
            negative_flows += 1
            lat = 0.0
        edge_lat.setdefault(f"{p['rank']}->{c['rank']}", []).append(lat)

    edges = {
        edge: {"n": len(v), "p50_us": _percentile(v, 0.50),
               "p99_us": _percentile(v, 0.99)}
        for edge, v in sorted(edge_lat.items())
    }
    return {
        "rounds": rounds_out,
        "stragglers": {
            "rounds_lengthened_by_rank": {
                str(r): n for r, n in sorted(lengthened.items())},
            "edge_latency": edges,
            "negative_latency_flows": negative_flows,
        },
    }
