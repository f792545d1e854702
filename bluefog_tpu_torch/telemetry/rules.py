"""The snapshot-corpus checks of ``python -m bluefog_tpu_torch.telemetry
--check``: per-rank snapshot schema, counters that never decrease across a
rank's snapshot sequence, and the mailbox ledger's conservation
(``deposits == collected + drained + pending``) over a job's corpus.

A copy of those rules of ``bluefog_tpu/analysis/telemetry_rules.py``; the
rest of the analysis package is not ported yet, so :class:`Finding` is the
small record the CLI prints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from bluefog_tpu_torch.telemetry.merge import ledger_balance, merge_snapshots
from bluefog_tpu_torch.telemetry.registry import SNAPSHOT_SCHEMA

__all__ = [
    "Finding",
    "check_snapshot_schema",
    "check_counters_monotone",
    "check_conservation",
    "check_snapshot_corpus",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule firing on one subject."""

    rule: str
    subject: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} ({self.subject}): {self.message}"


def _entry_errors(entry: object, kind: str) -> List[str]:
    if not isinstance(entry, dict):
        return [f"{kind} entry is not an object: {entry!r}"]
    errs = []
    if not isinstance(entry.get("name"), str) or not entry.get("name"):
        errs.append(f"{kind} entry missing a name: {entry!r}")
    labels = entry.get("labels")
    if labels is not None and not isinstance(labels, dict):
        errs.append(f"{kind} {entry.get('name')!r} labels not a mapping")
    if kind in ("counter", "gauge"):
        v = entry.get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            errs.append(f"{kind} {entry.get('name')!r} value not numeric")
        elif kind == "counter" and v < 0:
            errs.append(f"counter {entry.get('name')!r} is negative ({v}) "
                        "— counters only accumulate")
    if kind == "histogram":
        buckets = entry.get("buckets")
        counts = entry.get("counts")
        if not isinstance(buckets, list) or not isinstance(counts, list):
            errs.append(f"histogram {entry.get('name')!r} missing "
                        "buckets/counts arrays")
        elif len(counts) != len(buckets) + 1:
            errs.append(
                f"histogram {entry.get('name')!r} has {len(counts)} counts "
                f"for {len(buckets)} bucket edges (want edges+1: the last "
                "count is the overflow bucket)")
        if not isinstance(entry.get("sum"), (int, float)):
            errs.append(f"histogram {entry.get('name')!r} missing sum")
    return errs


def check_snapshot_schema(snap: dict, label: str = "snapshot"
                          ) -> List[Finding]:
    """One per-rank snapshot dict against the v1 schema."""
    out: List[Finding] = []

    def err(msg: str):
        out.append(Finding("telemetry.snapshot-schema", label, msg))

    if not isinstance(snap, dict):
        err(f"snapshot is not an object: {type(snap).__name__}")
        return out
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        err(f"schema tag is {snap.get('schema')!r}, want "
            f"{SNAPSHOT_SCHEMA!r} — the merge CLI would skip this file")
    if not isinstance(snap.get("rank"), int):
        err(f"rank is {snap.get('rank')!r}, want an int")
    for kind, key in (("counter", "counters"), ("gauge", "gauges"),
                      ("histogram", "histograms")):
        entries = snap.get(key, [])
        if not isinstance(entries, list):
            err(f"{key} is not a list")
            continue
        for entry in entries:
            for msg in _entry_errors(entry, kind):
                err(msg)
    return out


# ---------------------------------------------------------------------------
# counter monotonicity across a snapshot sequence
# ---------------------------------------------------------------------------


def _counter_map(snap: dict) -> Dict[Tuple, float]:
    out: Dict[Tuple, float] = {}
    for c in snap.get("counters", []):
        labels = c.get("labels") or {}
        key = (c["name"], tuple(sorted((k, str(v))
                                       for k, v in labels.items())))
        out[key] = float(c["value"])
    return out


def check_counters_monotone(snaps: Sequence[dict],
                            label: str = "snapshot-sequence"
                            ) -> List[Finding]:
    """Time-ordered snapshots from ONE rank: no counter may decrease."""
    out: List[Finding] = []
    prev: Dict[Tuple, float] = {}
    for i, snap in enumerate(snaps):
        cur = _counter_map(snap)
        for key, v in cur.items():
            was = prev.get(key)
            if was is not None and v < was:
                name, labels = key
                out.append(Finding(
                    "telemetry.counter-monotone", label,
                    f"counter {name!r} {dict(labels)} regressed "
                    f"{was} -> {v} between snapshots {i - 1} and {i} — "
                    "some code path overwrote instead of accumulating"))
        prev = cur
    return out


# ---------------------------------------------------------------------------
# mailbox-ledger conservation
# ---------------------------------------------------------------------------


def check_conservation(snaps: Sequence[dict], label: str = "job"
                       ) -> List[Finding]:
    """Merged ledger identity over a quiescent job's snapshot corpus:
    ``deposits == collected + drained + pending``.  Only meaningful when
    the corpus carries ledger counters at all (a job with telemetry on
    but no window traffic trivially balances at 0 == 0)."""
    merged = merge_snapshots(list(snaps))
    bal = ledger_balance(merged)
    if bal["balanced"]:
        return []
    return [Finding(
        "telemetry.conservation", label,
        f"mailbox ledger does not balance: deposits={bal['deposits']:g} "
        f"!= collected={bal['collected']:g} + drained={bal['drained']:g} "
        f"+ pending={bal['pending']:g} — a deposit was lost or retired "
        "twice between win_put and collect/drain")]


def check_snapshot_corpus(snaps: Sequence[dict]) -> List[Finding]:
    """Everything the merge CLI's ``--check`` verifies on a corpus:
    per-snapshot schema + cross-rank conservation."""
    out: List[Finding] = []
    for snap in snaps:
        r = snap.get("rank", "?") if isinstance(snap, dict) else "?"
        out.extend(check_snapshot_schema(snap, label=f"rank {r}"))
    if not out:  # schema-broken snapshots would make the merge nonsense
        out.extend(check_conservation(snaps))
    return out
