"""Cross-rank snapshot aggregation + Prometheus text exposition.

Per-rank snapshot files (``telemetry-<job>-r<rank>.json``, written by
:class:`bluefog_tpu_torch.telemetry.Registry` at exit) merge into ONE summary:
counters sum, gauges aggregate (sum/min/max), histograms add bucket-wise.
The merged dict also carries a ``ledger`` section evaluating the mailbox
mass-conservation identity (deposits == collected + drained + pending on
a quiescent job) — the same identity the analysis
``telemetry.conservation`` rule verifies.

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from bluefog_tpu_torch.telemetry.registry import (
    LEDGER_COLLECTED,
    LEDGER_DEPOSITS,
    LEDGER_DRAINED,
    LEDGER_PENDING,
    SNAPSHOT_SCHEMA,
    _safe_name,
    quantile_from_buckets,
)

__all__ = [
    "MERGED_SCHEMA",
    "SLO_REPORT_SCHEMA",
    "SLO_CAUSE_KINDS",
    "find_snapshots",
    "find_journals",
    "load_snapshot",
    "read_journal",
    "merge_snapshots",
    "ledger_balance",
    "to_prometheus",
    "merge_job_snapshots",
    "slo_report",
    "check_request_records",
]

MERGED_SCHEMA = "bftpu-telemetry-merged/1"
SLO_REPORT_SCHEMA = "bftpu-slo-report/1"

#: Journal event kinds that can *explain* an SLO violation window: weight
#: publication and swap activity, staleness rejections and their retries,
#: distribution-tree churn, and the start of a load phase (warm-up).  A
#: chaos harness that SIGKILLs replicas journals ``serve_respawn`` from
#: the parent; it joins here too.
SLO_CAUSE_KINDS = (
    "serve_publish",
    "serve_swap",
    "serve_retry",
    "serve_stale",
    "serve_respawn",
    "distrib_publish",
    "distrib_reparent",
    "distrib_resync",
    "loadgen_start",
)


def find_snapshots(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into snapshot paths.  A directory yields
    every ``telemetry-*.json`` in it (merged outputs are filtered out at
    load time by their schema tag)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "telemetry-*.json"))))
        else:
            out.append(p)
    return out


def load_snapshot(path: str) -> Optional[dict]:
    """One snapshot dict, or None when the file is not a per-rank
    snapshot (wrong schema — e.g. a previous merged summary)."""
    with open(path, "r", encoding="utf-8") as f:
        snap = json.load(f)
    if not isinstance(snap, dict) or snap.get("schema") != SNAPSHOT_SCHEMA:
        return None
    return snap


def _key(entry: dict) -> Tuple:
    labels = entry.get("labels") or {}
    return (entry["name"], tuple(sorted((k, str(v))
                                        for k, v in labels.items())))


def merge_snapshots(snaps: List[dict]) -> dict:
    """Aggregate per-rank snapshots into one cross-rank summary."""
    counters: Dict[Tuple, dict] = {}
    gauges: Dict[Tuple, dict] = {}
    hists: Dict[Tuple, dict] = {}
    ranks, jobs = [], []
    for snap in snaps:
        ranks.append(snap.get("rank", -1))
        job = snap.get("job")
        if job and job not in jobs:
            jobs.append(job)
        for c in snap.get("counters", []):
            k = _key(c)
            cur = counters.get(k)
            if cur is None:
                counters[k] = {"name": c["name"],
                               "labels": dict(c.get("labels") or {}),
                               "value": c["value"]}
            else:
                cur["value"] += c["value"]
        for g in snap.get("gauges", []):
            k = _key(g)
            v = float(g["value"])
            cur = gauges.get(k)
            if cur is None:
                gauges[k] = {"name": g["name"],
                             "labels": dict(g.get("labels") or {}),
                             "sum": v, "min": v,
                             "max": float(g.get("max", v)), "n": 1}
            else:
                cur["sum"] += v
                cur["min"] = min(cur["min"], v)
                cur["max"] = max(cur["max"], float(g.get("max", v)))
                cur["n"] += 1
        for h in snap.get("histograms", []):
            k = _key(h)
            cur = hists.get(k)
            if cur is None:
                hists[k] = {"name": h["name"],
                            "labels": dict(h.get("labels") or {}),
                            "buckets": list(h["buckets"]),
                            "counts": list(h["counts"]),
                            "sum": float(h["sum"])}
            elif list(h["buckets"]) == cur["buckets"]:
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], h["counts"])]
                cur["sum"] += float(h["sum"])
            # mismatched bucket layouts are skipped (schema rule flags them)
    for h in hists.values():
        # cross-rank latency quantiles ride the merged buckets — the
        # same estimator the adaptive edge-health policy runs per rank
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            v = quantile_from_buckets(h["buckets"], h["counts"], q)
            h[key] = None if v != v else v  # NaN -> null for JSON
    merged = {
        "schema": MERGED_SCHEMA,
        "ranks": sorted(ranks),
        "jobs": jobs,
        "counters": [counters[k] for k in sorted(counters)],
        "gauges": [gauges[k] for k in sorted(gauges)],
        "histograms": [hists[k] for k in sorted(hists)],
    }
    merged["ledger"] = ledger_balance(merged)
    return merged


def _counter_total(merged: dict, name: str) -> float:
    return sum(c["value"] for c in merged.get("counters", [])
               if c["name"] == name)


def ledger_balance(merged: dict) -> dict:
    """Evaluate the mailbox conservation identity over a merged summary."""
    deposits = _counter_total(merged, LEDGER_DEPOSITS)
    collected = _counter_total(merged, LEDGER_COLLECTED)
    drained = _counter_total(merged, LEDGER_DRAINED)
    pending = _counter_total(merged, LEDGER_PENDING)
    return {
        "deposits": deposits,
        "collected": collected,
        "drained": drained,
        "pending": pending,
        "balanced": deposits == collected + drained + pending,
    }


def _prom_name(name: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    return f"bftpu_{out}"


def _prom_labels(labels: Dict[str, object], extra: str = "") -> str:
    items = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        items.append(extra)
    return "{" + ",".join(items) + "}" if items else ""


def to_prometheus(merged: dict) -> str:
    """Prometheus text exposition (0.0.4) of a merged summary."""
    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for c in merged.get("counters", []):
        n = _prom_name(c["name"])
        _type(n, "counter")
        lines.append(f"{n}{_prom_labels(c['labels'])} {c['value']}")
    for g in merged.get("gauges", []):
        n = _prom_name(g["name"])
        _type(n, "gauge")
        base = dict(g["labels"])
        for agg in ("sum", "min", "max"):
            extra = 'agg="%s"' % agg
            lines.append(f"{n}{_prom_labels(base, extra)} {g[agg]}")
    for h in merged.get("histograms", []):
        n = _prom_name(h["name"])
        _type(n, "histogram")
        cum = 0
        for le, cnt in zip(h["buckets"], h["counts"]):
            cum += cnt
            extra = 'le="%s"' % le
            lines.append(f"{n}_bucket{_prom_labels(h['labels'], extra)} {cum}")
        cum += h["counts"][-1]
        inf = 'le="+Inf"'
        lines.append(f"{n}_bucket{_prom_labels(h['labels'], inf)} {cum}")
        lines.append(f"{n}_sum{_prom_labels(h['labels'])} {h['sum']}")
        lines.append(f"{n}_count{_prom_labels(h['labels'])} {cum}")
    return "\n".join(lines) + "\n"


def merge_job_snapshots(dir_value: Optional[str], job: str) -> Optional[str]:
    """Launcher-side collection: merge ``telemetry-<job>-r*.json`` under
    the telemetry dir into ``telemetry-<job>-merged.json`` (plus a
    ``.prom`` text exposition next to it).  Returns the merged path, or
    None when telemetry was off or no rank wrote a snapshot."""
    if not dir_value or dir_value == "0":
        return None
    from bluefog_tpu_torch.telemetry.registry import _DEFAULT_DIR

    d = _DEFAULT_DIR if dir_value == "1" else dir_value
    pattern = os.path.join(d, f"telemetry-{_safe_name(job)}-r*.json")
    snaps = []
    for p in sorted(glob.glob(pattern)):
        try:
            snap = load_snapshot(p)
        except (OSError, ValueError):
            continue
        if snap is not None:
            snaps.append(snap)
    if not snaps:
        return None
    merged = merge_snapshots(snaps)
    out = os.path.join(d, f"telemetry-{_safe_name(job)}-merged.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2)
    with open(out[:-len(".json")] + ".prom", "w", encoding="utf-8") as f:
        f.write(to_prometheus(merged))
    return out


# -- request-level journals: SLO windows joined to causes -------------------

def find_journals(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into event-journal paths.  A directory
    yields every ``telemetry-*.events.jsonl`` in it plus rotated ``.1``
    generations; explicit files pass through when they look like
    journals."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                glob.glob(os.path.join(p, "telemetry-*.events.jsonl"))))
            out.extend(sorted(
                glob.glob(os.path.join(p, "telemetry-*.events.jsonl.1"))))
        elif ".events.jsonl" in os.path.basename(p):
            out.append(p)
    return out


def read_journal(path: str) -> List[dict]:
    """Parsed event records from one journal.  Corrupt lines are skipped
    (a SIGKILLed rank tears at most the line in flight), as is an
    unreadable file — survivors' journals still merge."""
    events: List[dict] = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return events
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                events.append(rec)
    return events


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    return f if f == f and f not in (float("inf"), float("-inf")) else None


def slo_report(paths: Iterable[str], margin_s: float = 2.0) -> dict:
    """Join SLO violation windows to the cause events that explain them.

    Reads every journal under ``paths``, collects ``slo_violation``
    windows (written by the per-replica SLO monitor with wall-clock
    bounds) and :data:`SLO_CAUSE_KINDS` events, and attributes each
    window to every cause whose universal ``ts`` falls within
    ``[t0_wall - margin_s, t1_wall + margin_s]`` — wall clock is the one
    timebase journals from different processes share.  A window no cause
    overlaps counts as *unattributed*: in a chaos run those are the
    unexplained violations the acceptance gate requires to be zero.
    """
    journals = find_journals(paths)
    windows: List[dict] = []
    causes: List[dict] = []
    requests = 0
    for path in journals:
        name = os.path.basename(path)
        for rec in read_journal(path):
            kind = rec.get("event")
            if kind == "slo_violation":
                w = dict(rec)
                w["_journal"] = name
                windows.append(w)
            elif kind in SLO_CAUSE_KINDS:
                causes.append(rec)
            elif kind == "serve_request":
                requests += 1
    causes.sort(key=lambda r: _num(r.get("ts")) or 0.0)
    out_windows: List[dict] = []
    unattributed = 0
    for w in sorted(windows, key=lambda r: _num(r.get("t0_wall")) or 0.0):
        t0 = _num(w.get("t0_wall"))
        t1 = _num(w.get("t1_wall"))
        joined = []
        if t0 is not None:
            lo, hi = t0 - margin_s, (t1 if t1 is not None else t0) + margin_s
            for c in causes:
                ts = _num(c.get("ts"))
                if ts is None or not (lo <= ts <= hi):
                    continue
                cause = {"kind": c.get("event"), "ts": ts,
                         "rank": c.get("rank"), "dt_s": ts - t0}
                for k in ("replica", "win", "version", "group"):
                    if k in c:
                        cause[k] = c[k]
                joined.append(cause)
        if not joined:
            unattributed += 1
        out_windows.append({
            "replica": w.get("replica"),
            "t0_wall": w.get("t0_wall"),
            "t1_wall": w.get("t1_wall"),
            "duration_s": (t1 - t0 if t0 is not None and t1 is not None
                           else None),
            "requests": w.get("requests"),
            "worst_ms": w.get("worst_ms"),
            "kinds": w.get("kinds"),
            "journal": w.get("_journal"),
            "causes": joined,
        })
    return {
        "schema": SLO_REPORT_SCHEMA,
        "journals": [os.path.basename(p) for p in journals],
        "margin_s": float(margin_s),
        "requests": requests,
        "windows": out_windows,
        "total_windows": len(out_windows),
        "unattributed": unattributed,
    }


#: serve_request fields every writer (Replica.note_request and the
#: loadgen's registry fallback) must journal as finite numbers.
_REQUEST_NUM_FIELDS = ("send_mono", "start_mono", "done_mono", "latency_ms")


def check_request_records(paths: Iterable[str]) -> List[str]:
    """Validate ``serve_request`` journal records; one error string per
    malformed record.  The schema is what downstream joins rely on:
    finite monotonic timestamps ordered send <= done, a latency
    consistent with them on the open-loop basis (charged from the
    *scheduled* send), and a non-empty outcome label."""
    errors: List[str] = []
    for path in find_journals(paths):
        name = os.path.basename(path)
        for i, rec in enumerate(read_journal(path)):
            if rec.get("event") != "serve_request":
                continue
            where = f"{name}: serve_request #{i}"
            nums = {}
            bad = False
            for fld in _REQUEST_NUM_FIELDS:
                v = _num(rec.get(fld))
                if v is None:
                    errors.append(f"{where}: field {fld!r} missing or "
                                  f"not a finite number: "
                                  f"{rec.get(fld)!r}")
                    bad = True
                nums[fld] = v
            if not bad:
                if nums["done_mono"] < nums["send_mono"]:
                    errors.append(f"{where}: done_mono precedes send_mono "
                                  f"({nums['done_mono']} < "
                                  f"{nums['send_mono']})")
                else:
                    want = (nums["done_mono"] - nums["send_mono"]) * 1e3
                    if abs(nums["latency_ms"] - want) > 0.5:
                        errors.append(
                            f"{where}: latency_ms={nums['latency_ms']:.3f} "
                            f"inconsistent with done-send="
                            f"{want:.3f} ms (open-loop basis)")
            out = rec.get("outcome")
            if not isinstance(out, str) or not out:
                errors.append(f"{where}: outcome missing or not a "
                              f"non-empty string: {out!r}")
            if "replica" not in rec:
                errors.append(f"{where}: replica missing")
    return errors
