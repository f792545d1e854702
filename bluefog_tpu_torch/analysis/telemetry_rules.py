"""Rule family 6: telemetry snapshots, counter laws, and env-var lint.

The telemetry layer (:mod:`bluefog_tpu_torch.telemetry`) is itself an artifact
worth verifying: a snapshot that drifts off schema breaks the merge CLI,
a counter that ever DECREASES means some code path overwrote instead of
accumulated, and an unbalanced mailbox ledger means deposits were lost
(or double-counted) somewhere between a writer's ``win_put`` and a
reader's collect/drain.  Three laws, one lint:

- **schema** — every per-rank snapshot carries the
  ``bftpu-telemetry-snapshot/1`` tag and well-formed counter / gauge /
  histogram entries (counts array one longer than the bucket edges,
  non-negative counter values);
- **monotone** — across a time-ordered snapshot sequence from one rank,
  no counter value decreases (counters only ``inc``/``add``; a
  regression means a reset or a raced overwrite);
- **conservation** — over a quiescent job's merged corpus,
  ``deposits == collected + drained + pending`` (the mailbox mass
  ledger telescopes: every slot's monotone version count is retired
  exactly once, into exactly one of the three sinks);
- **env lint** — every ``BFTPU_*`` / ``BLUEFOG_*`` env var referenced
  anywhere under ``bluefog_tpu_torch/`` is documented in README.md or
  ``docs/*.md`` (an undocumented knob is an unfindable knob).

The registered rules drive a synthetic in-memory corpus (no files, no
jax); the ``check_*`` helpers are pure and are what the fixtures and
the merge CLI's ``--check`` call directly.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from bluefog_tpu_torch.telemetry.registry import (
    LEDGER_COLLECTED,
    LEDGER_DEPOSITS,
    LEDGER_DRAINED,
    LEDGER_PENDING,
    SNAPSHOT_SCHEMA,
    Registry as TelemetryRegistry,
)
from bluefog_tpu_torch.telemetry.merge import ledger_balance, merge_snapshots

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

__all__ = [
    "ENV_VAR_RE",
    "check_snapshot_schema",
    "check_counters_monotone",
    "check_conservation",
    "check_snapshot_corpus",
    "scan_env_vars",
    "documented_vars",
    "check_env_documented",
]

#: The namespaced env-var shape this repo uses for all its knobs.
ENV_VAR_RE = re.compile(r"\b(?:BFTPU|BLUEFOG)_[A-Z][A-Z0-9_]*")


# ---------------------------------------------------------------------------
# snapshot schema
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# env-var lint
# ---------------------------------------------------------------------------


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))  # .../bluefog_tpu_torch/analysis
    return os.path.dirname(os.path.dirname(here))


def scan_env_vars(root: str = None) -> Dict[str, List[str]]:
    """Every ``BFTPU_*``/``BLUEFOG_*`` name referenced in the package
    sources, mapped to the files that mention it."""
    root = _repo_root() if root is None else root
    pkg = os.path.join(root, "bluefog_tpu_torch")
    out: Dict[str, List[str]] = {}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            rel = os.path.relpath(path, root)
            for var in set(ENV_VAR_RE.findall(text)):
                out.setdefault(var, []).append(rel)
    return out


def documented_vars(root: str = None) -> Set[str]:
    """Env vars mentioned anywhere in README.md or docs/*.md."""
    root = _repo_root() if root is None else root
    docs = [os.path.join(root, "README.md")]
    docdir = os.path.join(root, "docs")
    if os.path.isdir(docdir):
        docs.extend(os.path.join(docdir, f) for f in sorted(os.listdir(docdir))
                    if f.endswith(".md"))
    seen: Set[str] = set()
    for path in docs:
        try:
            with open(path, "r", encoding="utf-8") as f:
                seen.update(ENV_VAR_RE.findall(f.read()))
        except OSError:
            continue
    return seen


#: Names the regex matches that are not actually env knobs (prefixes of
#: messages, identifiers in comments about the naming scheme itself).
_ENV_LINT_ALLOW: Set[str] = set()


def check_env_documented(used: Dict[str, List[str]], documented: Set[str],
                         label: str = "bluefog_tpu_torch") -> List[Finding]:
    """Every referenced env var must appear in the docs."""
    out: List[Finding] = []
    for var in sorted(used):
        if var in documented or var in _ENV_LINT_ALLOW:
            continue
        files = ", ".join(sorted(set(used[var]))[:3])
        out.append(Finding(
            "telemetry.env-documented", label,
            f"env var {var} is referenced ({files}) but documented "
            "nowhere in README.md or docs/*.md — every knob needs a "
            "findable description (docs/OBSERVABILITY.md keeps the "
            "index)"))
    return out


# ---------------------------------------------------------------------------
# registered rules: synthetic in-memory corpus + the real source tree
# ---------------------------------------------------------------------------


def _synthetic_corpus(nranks: int = 4) -> List[dict]:
    """An in-memory 4-rank ring-gossip job: every rank deposits into its
    two neighbors each of 3 rounds; the last round's deposits are still
    un-collected at "teardown" and get probed into the pending sink."""
    snaps = []
    for r in range(nranks):
        reg = TelemetryRegistry(out_dir=None, rank=r, job="synthetic")
        rounds, degree = 3, 2
        reg.counter(LEDGER_DEPOSITS).add(rounds * degree)
        reg.counter(LEDGER_COLLECTED).add((rounds - 1) * degree)
        reg.counter(LEDGER_PENDING).add(degree)
        reg.counter("win.edge_ops", op="win_put",
                    src=r, dst=(r + 1) % nranks).add(rounds)
        reg.gauge("optim.k").set(2)
        h = reg.histogram("win.op_s", op="win_put")
        for v in (1e-5, 2e-5, 1e-4):
            h.observe(v)
        snaps.append(reg.snapshot())
    return snaps


@registry.rule("telemetry.snapshot-schema", family="telemetry",
               doc="per-rank snapshots conform to the v1 schema")
def _rule_snapshot_schema(report: Report) -> None:
    for snap in _synthetic_corpus():
        report.subjects_checked += 1
        report.extend(check_snapshot_schema(
            snap, label=f"synthetic rank {snap['rank']}"))


@registry.rule("telemetry.counter-monotone", family="telemetry",
               doc="counters never decrease across a snapshot sequence")
def _rule_counter_monotone(report: Report) -> None:
    reg = TelemetryRegistry(out_dir=None, rank=0, job="synthetic")
    seq = []
    for _ in range(4):
        reg.counter("tcp.round_trips").add(5)
        reg.counter(LEDGER_DEPOSITS).inc()
        seq.append(reg.snapshot())
    report.subjects_checked += 1
    report.extend(check_counters_monotone(seq, label="synthetic rank 0"))


@registry.rule("telemetry.conservation", family="telemetry",
               doc="merged mailbox ledger balances on a quiescent corpus")
def _rule_conservation(report: Report) -> None:
    report.subjects_checked += 1
    report.extend(check_conservation(_synthetic_corpus(),
                                     label="synthetic 4-rank job"))


@registry.rule("telemetry.env-documented", family="telemetry",
               doc="every BFTPU_*/BLUEFOG_* env var referenced in the "
                   "package is documented in README.md or docs/*.md")
def _rule_env_documented(report: Report) -> None:
    used = scan_env_vars()
    report.subjects_checked += len(used)
    report.metric("telemetry.env_vars_referenced", float(len(used)))
    report.extend(check_env_documented(used, documented_vars()))
