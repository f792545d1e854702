"""Metrics registry: counters, gauges, fixed-bucket histograms, and a
per-rank JSONL event journal.

Design constraints (docs/OBSERVABILITY.md):

- **stdlib-only** — island workers import this before (or instead of)
  jax/numpy; a heavy import here would tax every spawned rank;
- **near-zero cost when off** — ``BFTPU_TELEMETRY`` unset returns the
  shared :class:`NullRegistry`, whose metric handles are one shared
  no-op object; hot paths additionally guard clock reads behind
  ``reg.enabled`` so a disabled run pays one attribute load per op;
- **lock-light when on** — each metric owns one small lock held for a
  single ``+=``; the registry lock is only taken on metric *creation*
  (call sites cache handles or hit a dict lookup);
- **crash-tolerant journal** — every event is one flushed JSON line, so
  a rank SIGKILLed mid-write corrupts at most the final line, which the
  reader (:func:`read_journal`) skips and counts.

Snapshots: each enabled rank writes
``<dir>/telemetry-<job>-r<rank>.json`` at exit (atexit) or on an
explicit :meth:`Registry.write_snapshot`.  The launcher and
``python -m bluefog_tpu_torch.telemetry`` merge these per-rank files into one
cross-rank summary (see :mod:`bluefog_tpu_torch.telemetry.merge`).

Chrome-trace integration: when ``BLUEFOG_TIMELINE`` is also set, counter
values are sampled into the timeline as chrome ``"ph": "C"`` counter
events (rate-limited per counter; final values emitted at snapshot), so
metrics and spans land in one profile.
"""

from __future__ import annotations

import atexit
import bisect
import json
import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "SNAPSHOT_SCHEMA",
    "LEDGER_DEPOSITS",
    "LEDGER_COLLECTED",
    "LEDGER_DRAINED",
    "LEDGER_PENDING",
    "MASS_JOIN_ADMITTED",
    "DEFAULT_LATENCY_BUCKETS_S",
    "SERVE_LATENCY_BUCKETS_S",
    "quantile_from_buckets",
    "telemetry_dir",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "NullRegistry",
    "get_registry",
    "reset",
    "read_journal",
    "journal_paths",
    "journal_max_bytes",
    "note_op",
    "add_op_listener",
    "remove_op_listener",
]

#: Snapshot file schema tag (analysis `telemetry.snapshot-schema` pins it).
SNAPSHOT_SCHEMA = "bftpu-telemetry-snapshot/1"

#: Mailbox mass-ledger counters.  The islands layer counts every
#: post-creation mailbox deposit on the WRITER rank and every version it
#: retires (atomic collect, force-drain, or left pending at free) on the
#: READER rank; summed across ranks on a quiescent job,
#: deposits == collected + drained + pending EXACTLY — the conservation
#: invariant the analysis `telemetry.conservation` rule checks.
LEDGER_DEPOSITS = "shm.ledger.deposits"
LEDGER_COLLECTED = "shm.ledger.collected"
LEDGER_DRAINED = "shm.ledger.drained"
LEDGER_PENDING = "shm.ledger.pending"

#: Elastic-membership extension of the mass ledger: push-sum mass a
#: joiner brings INTO the network (p = 1.0 per window, carried at the
#: sponsor's debiased estimate, so Σx/Σp is preserved at consensus).
#: Every admission also journals an ``epoch_switch`` event holding the
#: four ledger counters at the switch barrier — the per-epoch balance
#: the analysis ``resilience.membership-epoch`` rule checks (no
#: committed deposit from epoch e is consumed under view e+1 without
#: appearing as collected/drained/pending at the switch).
MASS_JOIN_ADMITTED = "resilience.join_mass_admitted"

#: Default histogram bucket upper bounds for op latencies, in seconds
#: (1 µs .. 10 s, roughly half-decade steps; +Inf bucket is implicit).
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3,
    1e-2, 5e-2, 1e-1, 5e-1, 1.0, 5.0, 10.0,
)

#: Log-spaced buckets for request-level serve latency (0.1 ms .. ~2.2 s
#: in 30 steps of 10^0.15 ≈ 1.41x).  The half-decade DEFAULT buckets
#: give the tail quantile only 2 edges per decade — a p99 interpolated
#: between 0.5 s and 1.0 s is useless for an SLO at 250 ms; constant
#: RELATIVE resolution (~41% per bucket, ~6.7 edges/decade) keeps the
#: p99 estimate within one bucket ratio anywhere in the 0.1 ms–2 s
#: open-loop tail the load generator charges queueing delay into.
SERVE_LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    round(10.0 ** (-4 + 0.15 * i), 10) for i in range(30))

_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "bftpu_telemetry")

#: minimum seconds between chrome-trace counter samples per counter
_TIMELINE_SAMPLE_S = 0.05


def telemetry_dir() -> Optional[str]:
    """The telemetry output directory, or None when telemetry is off.
    ``BFTPU_TELEMETRY`` semantics: unset/empty/"0" = off; "1" = on with
    the default directory; anything else = on, value IS the directory."""
    v = os.environ.get("BFTPU_TELEMETRY", "")
    if not v or v == "0":
        return None
    return _DEFAULT_DIR if v == "1" else v


def _resolve_rank() -> int:
    for var in ("BLUEFOG_ISLAND_RANK", "JAX_PROCESS_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _resolve_job() -> str:
    return os.environ.get("BLUEFOG_ISLAND_JOB", "local")


def _safe_name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s)


def _labels_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _NullMetric:
    """Shared no-op metric handle (the disabled path)."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    add = inc

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return float("nan")


_NULL = _NullMetric()


class Counter:
    """Monotone counter (int or float increments)."""

    __slots__ = ("name", "labels", "value", "_lock", "_sampler", "_last_ts")

    def __init__(self, name: str, labels: Dict[str, object],
                 sampler: Optional[Callable] = None):
        self.name = name
        self.labels = dict(labels)
        self.value = 0
        self._lock = threading.Lock()
        self._sampler = sampler
        self._last_ts = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} decremented by {n}")
        with self._lock:
            self.value += n
        if self._sampler is not None:
            self._sampler(self)

    add = inc

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels, "value": self.value}


class Gauge:
    """Last-value gauge (also tracks the max ever set)."""

    __slots__ = ("name", "labels", "value", "max", "_lock")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        v = float(v)
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def add(self, v):
        """Signed delta on the last value (e.g. queue depth up/down from
        two threads) — a read-modify-write ``set`` would race."""
        v = float(v)
        with self._lock:
            self.value += v
            if self.value > self.max:
                self.max = self.value

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "value": self.value, "max": self.max}


def quantile_from_buckets(buckets, counts, q: float) -> float:
    """Prometheus-style interpolated quantile from fixed buckets.

    ``buckets`` are the finite upper edges, ``counts`` the per-bucket
    tallies (len(buckets)+1, with the implicit +Inf bucket last).  The
    q-th observation is located by cumulative count and linearly
    interpolated within its bucket (lower edge 0 for the first bucket);
    observations in the +Inf bucket clamp to the last finite edge — the
    estimate is conservative there, never invented.  NaN on an empty
    histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    total = sum(counts)
    if total == 0:
        return float("nan")
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts[:-1]):
        if cum + c >= target and c > 0:
            lo = 0.0 if i == 0 else float(buckets[i - 1])
            hi = float(buckets[i])
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return float(buckets[-1])


class Histogram:
    """Fixed-bucket histogram with prometheus ``le`` semantics: a value
    lands in the FIRST bucket whose upper bound is >= the value (exact
    bucket-edge values count into that edge's bucket); values above the
    last edge land in the implicit +Inf bucket (``counts[-1]``)."""

    __slots__ = ("name", "labels", "buckets", "counts", "sum", "_lock")

    def __init__(self, name: str, labels: Dict[str, object],
                 buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S):
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {b}")
        self.name = name
        self.labels = dict(labels)
        self.buckets = b
        self.counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v

    @property
    def count(self) -> int:
        return sum(self.counts)

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1) of the observations —
        p50/p99 for the adaptive edge-health policy and the merge CLI.
        NaN while empty; +Inf-bucket hits clamp to the last finite
        edge (see :func:`quantile_from_buckets`)."""
        with self._lock:
            counts = list(self.counts)
        return quantile_from_buckets(self.buckets, counts, q)

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum}


class Registry:
    """One process's metric store + event journal.

    ``out_dir=None`` builds an in-memory registry (tests and the analysis
    rule corpus drive these directly); the process-wide instance from
    :func:`get_registry` always has a directory.
    """

    enabled = True

    def __init__(self, out_dir: Optional[str] = None,
                 rank: Optional[int] = None, job: Optional[str] = None,
                 timeline_sampling: Optional[bool] = None):
        self.out_dir = out_dir
        self.rank = _resolve_rank() if rank is None else int(rank)
        self.job = _resolve_job() if job is None else str(job)
        self._metrics: Dict[Tuple, object] = {}
        # memo for note_op's per-op counter: handle lookup by labels costs
        # ~2µs (kwargs + sorted label key); op notes ride every window op
        self._op_counters: Dict[str, Counter] = {}
        self._lock = threading.Lock()
        self._journal_fh = None
        self._journal_lock = threading.Lock()
        self._journal_bytes = 0
        self._journal_max_bytes = journal_max_bytes()
        self._mono0 = time.monotonic()
        if timeline_sampling is None:
            timeline_sampling = bool(os.environ.get("BLUEFOG_TIMELINE"))
        self._timeline_sampling = timeline_sampling

    # -- metric handles ----------------------------------------------------
    def _get(self, kind, name: str, labels: Dict[str, object], factory):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = factory()
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        sampler = self._sample_counter if self._timeline_sampling else None
        return self._get("c", name, labels,
                         lambda: Counter(name, labels, sampler))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("g", name, labels, lambda: Gauge(name, labels))

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get("h", name, labels,
                         lambda: Histogram(name, labels, buckets))

    # -- chrome-trace counter events ---------------------------------------
    def _timeline_writer(self):
        # lazy: bluefog_tpu_torch.timeline imports torch — only touch it
        # when BLUEFOG_TIMELINE is actually set (then torch is loaded anyway)
        try:
            from bluefog_tpu_torch.timeline import _get_writer

            return _get_writer()
        except Exception:
            return None

    def _sample_counter(self, c: Counter, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - c._last_ts < _TIMELINE_SAMPLE_S:
            return
        w = self._timeline_writer()
        if w is None:
            return
        c._last_ts = now
        label = c.name if not c.labels else (
            c.name + "{" + ",".join(f"{k}={v}" for k, v in
                                    sorted(c.labels.items())) + "}")
        w.record_counter(label, w.now_us(), float(c.value))

    # -- event journal -----------------------------------------------------
    @property
    def journal_path(self) -> Optional[str]:
        if self.out_dir is None:
            return None
        return os.path.join(
            self.out_dir,
            f"telemetry-{_safe_name(self.job)}-r{self.rank}.events.jsonl")

    @property
    def snapshot_path(self) -> Optional[str]:
        if self.out_dir is None:
            return None
        return os.path.join(
            self.out_dir,
            f"telemetry-{_safe_name(self.job)}-r{self.rank}.json")

    def journal(self, event: str, **fields) -> None:
        """Append one event line (flushed immediately: a SIGKILL tears at
        most the line in flight)."""
        path = self.journal_path
        if path is None:
            return
        rec = {"event": event, "ts": time.time(),
               "mono": time.monotonic() - self._mono0,
               "rank": self.rank, "job": self.job, "pid": os.getpid()}
        rec.update(fields)
        try:
            line = json.dumps(rec) + "\n"
        except (TypeError, ValueError):
            rec = {k: repr(v) for k, v in rec.items()}
            line = json.dumps(rec) + "\n"
        with self._journal_lock:
            if self._journal_fh is None:
                os.makedirs(self.out_dir, exist_ok=True)
                self._journal_fh = open(path, "a", encoding="utf-8")
                try:
                    self._journal_bytes = os.path.getsize(path)
                except OSError:
                    self._journal_bytes = 0
            if (self._journal_max_bytes > 0
                    and self._journal_bytes + len(line)
                    > self._journal_max_bytes
                    and self._journal_bytes > 0):
                # size-capped rotation (BFTPU_JOURNAL_MAX_MB): the
                # current file becomes <path>.1 (one generation — high-N
                # fleets bound disk at ~2x the cap per rank) and the
                # write lands in a fresh file.  Readers consult
                # journal_paths() so rotated events still merge.
                self._journal_fh.close()
                try:
                    os.replace(path, path + ".1")
                except OSError:
                    pass
                self._journal_fh = open(path, "a", encoding="utf-8")
                self._journal_bytes = 0
            self._journal_fh.write(line)
            self._journal_fh.flush()
            self._journal_bytes += len(line)

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.items())
        counters, gauges, hists = [], [], []
        for (kind, _, _), m in sorted(metrics, key=lambda kv: kv[0][:2]):
            if kind == "c":
                counters.append(m.to_dict())
            elif kind == "g":
                gauges.append(m.to_dict())
            else:
                hists.append(m.to_dict())
        return {
            "schema": SNAPSHOT_SCHEMA,
            "job": self.job,
            "rank": self.rank,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }

    def write_snapshot(self, path: Optional[str] = None) -> Optional[str]:
        """Write the snapshot atomically (tmp + rename); final counter
        values also ride into the chrome trace when sampling is on."""
        path = self.snapshot_path if path is None else path
        if path is None:
            return None
        if self._timeline_sampling:
            with self._lock:
                counters = [m for (k, _, _), m in self._metrics.items()
                            if k == "c"]
            for c in counters:
                self._sample_counter(c, force=True)
        snap = self.snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        with self._journal_lock:
            if self._journal_fh is not None:
                try:
                    self._journal_fh.close()
                except OSError:
                    pass
                self._journal_fh = None


class NullRegistry:
    """The disabled registry: every handle is the shared no-op metric."""

    enabled = False
    out_dir = None
    rank = 0
    job = "off"

    def counter(self, name, **labels):
        return _NULL

    def gauge(self, name, **labels):
        return _NULL

    def histogram(self, name, buckets=None, **labels):
        return _NULL

    def journal(self, event, **fields):
        pass

    def snapshot(self):
        return {}

    def write_snapshot(self, path=None):
        return None

    def close(self):
        pass

    def close(self):
        pass


_NULL_REGISTRY = NullRegistry()
_global: Optional[Registry] = None
_global_lock = threading.Lock()


def _atexit_snapshot() -> None:
    reg = _global
    if reg is not None:
        try:
            reg.write_snapshot()
        except Exception:
            pass
        reg.close()


def get_registry():
    """The process-wide registry: a live :class:`Registry` when
    ``BFTPU_TELEMETRY`` is set (snapshot registered atexit), else the
    shared :class:`NullRegistry`.  Cached after first resolution — tests
    toggling the env var mid-process must call :func:`reset`."""
    global _global
    reg = _global
    if reg is not None:
        return reg
    d = telemetry_dir()
    if d is None:
        # cache the off verdict too — hot paths (detector sweeps) call
        # this per poll, and the env lookup dominates when disabled
        with _global_lock:
            if _global is None:
                _global = _NULL_REGISTRY
            return _global
    with _global_lock:
        if _global is None:
            _global = Registry(out_dir=d)
            atexit.register(_atexit_snapshot)
        return _global


def reset() -> None:
    """Drop the cached process-wide registry (tests only)."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = None


def journal_max_bytes() -> int:
    """Per-rank journal size cap in bytes (``BFTPU_JOURNAL_MAX_MB``;
    unset/0 = unlimited).  Past the cap the live file rotates to
    ``<path>.1`` — see :meth:`Registry.journal`."""
    try:
        mb = float(os.environ.get("BFTPU_JOURNAL_MAX_MB", "0"))
    except ValueError:
        return 0
    return int(mb * 1024 * 1024) if mb > 0 else 0


def journal_paths(path: str) -> List[str]:
    """All existing files of one rank's journal, oldest first — the
    rotated generation (``<path>.1``) before the live file, so a
    chronological reader just concatenates."""
    return [p for p in (path + ".1", path) if os.path.exists(p)]


def read_journal(path: str) -> Tuple[List[dict], int]:
    """Parse a JSONL journal, skipping torn/invalid lines.  Returns
    ``(events, n_bad)`` — a rank killed mid-write leaves at most its
    final line torn, so ``n_bad`` should be 0 or 1."""
    events: List[dict] = []
    bad = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(rec, dict):
                events.append(rec)
            else:
                bad += 1
    return events, bad


# ---------------------------------------------------------------------------
# win-op event stream (the single bookkeeping path for window traffic)
# ---------------------------------------------------------------------------

_op_listeners: List[Callable[[str, str], None]] = []
_op_listeners_lock = threading.Lock()


def add_op_listener(fn: Callable[[str, str], None]) -> None:
    """Subscribe to ``(op, window_name)`` win-op events.
    ``windows.record_win_ops()`` is the canonical consumer."""
    with _op_listeners_lock:
        _op_listeners.append(fn)


def remove_op_listener(fn: Callable[[str, str], None]) -> None:
    with _op_listeners_lock:
        try:
            _op_listeners.remove(fn)
        except ValueError:
            pass


def note_op(op: str, name: Optional[str]) -> None:
    """Record one window op: bumps the ``win_ops.total`` counter (when
    telemetry is on) and fans out to the registered listeners.  Both the
    window emulation (:mod:`bluefog_tpu_torch.windows`) publishes through
    this single path."""
    reg = get_registry()
    if reg.enabled:
        c = reg._op_counters.get(op)
        if c is None:
            c = reg._op_counters[op] = reg.counter("win_ops.total", op=op)
        c.inc()
    if _op_listeners:
        n = "*" if name is None else name
        for fn in list(_op_listeners):
            fn(op, n)
