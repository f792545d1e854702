"""Incident attribution: alert windows joined to their cause events.

This generalizes the serve plane's ``--slo-report`` join
(:func:`bluefog_tpu_torch.telemetry.merge.slo_report`) to *every* alert kind
the monitor raises.  The scraper journals one ``alert`` event per
gap-closed window with wall-clock bounds; every other process journals
the things that *happen* — kills declared, heals, epoch switches,
demotions, joins, snapshot publishes, tree reparents, resyncs.  Wall
time is the one timebase those journals share, so the join is the same
interval overlap: a cause explains a window when its ``ts`` lands in
``[t0_wall - margin, t1_wall + margin]``.

A window no cause overlaps is **unattributed** — in a chaos run those
are the unexplained incidents, and ``python -m bluefog_tpu_torch.monitor
--report`` exits nonzero when any exist (the acceptance gate for the
np=4 kill/respawn e2e is a report with every window attributed).
"""

from __future__ import annotations

import os
from typing import Iterable, List

from bluefog_tpu_torch.telemetry.merge import (
    SLO_CAUSE_KINDS,
    _num,
    find_journals,
    read_journal,
)

__all__ = ["MON_CAUSE_KINDS", "MON_REPORT_SCHEMA", "monitor_report",
           "format_report"]

MON_REPORT_SCHEMA = "bftpu-monitor-report/1"

#: Everything that can explain an alert window: the serve-plane causes
#: the SLO report already joins, plus the resilience plane (failure
#: detection, heal, membership churn, orphan quiesce, demotion votes)
#: and the progress engine's quiesce/resume brackets.
MON_CAUSE_KINDS = SLO_CAUSE_KINDS + (
    "death_declared",
    "heal",
    "epoch_switch",
    "edge_state",
    "peer_timeout",
    "deadline_exhausted",
    "orphan_entered",
    "orphan_merged",
    "quorum_denied",
    "join_requested_seen",
    "join_granted",
    "join_admitted",
    "join_mass_admitted",
    "distrib_join",
    "progress_quiesce",
    "progress_resume",
)


def monitor_report(paths: Iterable[str], margin_s: float = 2.0) -> dict:
    """Join every journaled ``alert`` window to its overlapping cause
    events; count the windows nothing explains."""
    journals = find_journals(paths)
    windows: List[dict] = []
    causes: List[dict] = []
    for path in journals:
        name = os.path.basename(path)
        for rec in read_journal(path):
            kind = rec.get("event")
            if kind == "alert":
                w = dict(rec)
                w["_journal"] = name
                windows.append(w)
            elif kind in MON_CAUSE_KINDS:
                causes.append(rec)
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
                for k in ("replica", "peer", "state", "epoch", "version",
                          "slot", "group", "win"):
                    if k in c:
                        cause[k] = c[k]
                joined.append(cause)
        if not joined:
            unattributed += 1
        out_windows.append({
            "rule": w.get("rule"),
            "subject": w.get("subject"),
            "series": w.get("series"),
            "t0_wall": w.get("t0_wall"),
            "t1_wall": w.get("t1_wall"),
            "duration_s": (t1 - t0 if t0 is not None and t1 is not None
                           else None),
            "samples": w.get("samples"),
            "worst": w.get("worst"),
            "journal": w.get("_journal"),
            "causes": joined,
        })
    return {
        "schema": MON_REPORT_SCHEMA,
        "journals": [os.path.basename(p) for p in journals],
        "margin_s": float(margin_s),
        "windows": out_windows,
        "total_windows": len(out_windows),
        "unattributed": unattributed,
    }


def format_report(report: dict) -> str:
    """Human-readable one-window-per-block rendering (the JSON is the
    machine interface; this is what lands on an operator's terminal)."""
    lines = [f"monitor report: {report['total_windows']} alert window(s), "
             f"{report['unattributed']} unattributed "
             f"(margin {report['margin_s']:.1f}s, "
             f"{len(report['journals'])} journal(s))"]
    for w in report["windows"]:
        dur = w.get("duration_s")
        lines.append(
            f"  [{w.get('rule')}] subject={w.get('subject')} "
            f"dur={dur:.2f}s worst={w.get('worst')}"
            if dur is not None else
            f"  [{w.get('rule')}] subject={w.get('subject')} "
            f"worst={w.get('worst')}")
        if w["causes"]:
            for c in w["causes"][:8]:
                extra = "".join(
                    f" {k}={c[k]}" for k in ("peer", "state", "epoch",
                                             "replica", "version", "slot")
                    if k in c)
                lines.append(f"      <- {c['kind']} rank={c.get('rank')} "
                             f"dt={c['dt_s']:+.2f}s{extra}")
            if len(w["causes"]) > 8:
                lines.append(f"      ... {len(w['causes']) - 8} more")
        else:
            lines.append("      <- UNATTRIBUTED")
    return "\n".join(lines)
