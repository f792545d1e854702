"""Per-rank live status pages + the job trace-control word.

The status page is the read side of the live introspection plane
(docs/OBSERVABILITY.md "Live introspection"): every island rank keeps one
small versioned mmap struct next to its shm segments
(``bf_<job>_status_r<rank>``) and republishes it once per window op —
current step/round, membership epoch, last op + op_id, per-edge
:mod:`EdgeHealth <bluefog_tpu_torch.resilience.detector>` state and deadline,
and the mass-ledger totals.  The page is seqlock'd exactly like the
mailbox slots (seq → odd, payload, seq → even), so an external reader
(``bftpu-top``) NEVER blocks or perturbs the writer: it just retries a
torn bracket.  Pages ride the ``seg_name`` prefix, so
:func:`bluefog_tpu_torch.native.shm_native.unlink_all` reclaims them.

The trace-control word (``bf_<job>_tracectl``) is the write side: a
(generation, mode) pair published by atomic rename — the same idiom as
the membership-epoch word — that lets ``bftpu-top trace on|off`` flip
``BFTPU_TRACING`` inside running ranks without a restart.
"""

from __future__ import annotations

import glob
import math
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.native import shm_native

STATUS_SCHEMA = "bftpu-statuspage/8"
STATUS_MAGIC = 0x42465350  # "BFSP"
STATUS_VERSION = 8

#: Page layout: header (magic u32, version u32, seq u64), fixed block,
#: then up to MAX_EDGES edge records; the whole page is padded to
#: PAGE_BYTES so the file size is stable across republishes.
#: v2 appends the progress-engine view (queue depth + in-flight op) to
#: the fixed block; v3 appends the convergence-probe word (consensus
#: error + probe round); v4 appends the flags word (bit 0 = ORPHAN:
#: this rank lost membership quorum and quiesced — see
#: docs/RESILIENCE.md "Orphan quiesce"); v5 appends the serving plane
#: (serve_version + serve_lag — the snapshot version a publisher last
#: committed / a replica currently serves, and how many committed
#: versions the replica trails; -1/-1 = not part of the serve plane,
#: see docs/SERVING.md); v6 appends the distribution tree
#: (distrib_slot + distrib_parent — this replica's slot in the fan-out
#: tree and the slot it feeds from, -1 parent = the publisher itself;
#: slot -1 = not attached through the distribution plane, see
#: docs/SERVING.md "Cross-host distribution"); v7 appends the
#: request-level serve telemetry (qps + p50_ms + p99_ms over the
#: replica's rolling request window, and slo_state: -1 = no SLO armed
#: or no traffic yet, 0 = inside the BFTPU_SERVE_SLO_MS objective,
#: 1 = currently violating — see docs/SERVING.md "Measuring serve
#: latency under churn"); v8 appends the fleet-monitor alert lamp
#: (alert_state: -1 = no monitor attached / no samples yet, 0 =
#: sampled and quiet, 1 = an alert window is open, plus the 16-byte
#: last-alert rule name — written only by the monitor's own page at
#: MONITOR_RANK, every worker page reads -1/"" — see
#: docs/OBSERVABILITY.md "Fleet monitor").  Readers still decode
#: v1..v7 pages from live older writers.
_HEAD = struct.Struct("<IIQ")                 # magic, version, seq
_FIXED_V1 = struct.Struct("<iiiiQQQdd16sdddd")  # rank, nranks, pid, n_edges,
#                                                 step, epoch, op_id,
#                                                 wall_ts, mono_ts, last_op,
#                                                 ledger dep/col/drn/pend
_FIXED_V2 = struct.Struct("<iiiiQQQdd16sddddi16s")  # ... + qdepth, inflight
_FIXED_V3 = struct.Struct("<iiiiQQQdd16sddddi16sdq")  # ... + conv_err,
#                                                         conv_round
_FIXED_V4 = struct.Struct("<iiiiQQQdd16sddddi16sdqi")  # ... + flags
_FIXED_V5 = struct.Struct("<iiiiQQQdd16sddddi16sdqiqq")  # ... +
#                                               serve_version, serve_lag
_FIXED_V6 = struct.Struct("<iiiiQQQdd16sddddi16sdqiqqii")  # ... +
#                                               distrib_slot, distrib_parent
_FIXED_V7 = struct.Struct("<iiiiQQQdd16sddddi16sdqiqqiidddi")  # ... +
#                                               qps, p50_ms, p99_ms,
#                                               slo_state
_FIXED = struct.Struct("<iiiiQQQdd16sddddi16sdqiqqiidddii16s")  # ... +
#                                               alert_state, last_alert
_EDGE = struct.Struct("<iid")                 # peer_global, state, deadline_s
MAX_EDGES = 32
PAGE_BYTES = 1024
#: flags-word bits (v4)
FLAG_ORPHAN = 1
assert _HEAD.size + _FIXED.size + MAX_EDGES * _EDGE.size <= PAGE_BYTES

#: EdgeHealth state codes as written into edge records (3 = demoted is
#: an islands-level overlay the detector itself does not track).
EDGE_STATE_NAMES = {0: "alive", 1: "suspect", 2: "dead", 3: "demoted"}

_LEDGER_KEYS = ("deposits", "collected", "drained", "pending")


class TornPageError(RuntimeError):
    """A status page stayed torn (odd/moving seq) across every retry."""


def status_page_path(job: str, rank: int) -> str:
    return os.path.join(
        shm_native._FALLBACK_DIR,
        shm_native.seg_name(job, f"status_r{int(rank)}")[1:])


class StatusPage:
    """The writer: owned by one rank, republished once per window op.

    ``publish`` is a few ``pack_into`` calls on an mmap — no locks, no
    syscalls — which is what keeps the always-on plane under the < 2%
    ``statuspage_overhead_pct`` bench gate."""

    def __init__(self, job: str, rank: int):
        self.job = str(job)
        self.rank = int(rank)
        self._seg = shm_native._FallbackSegment(
            status_page_path(job, rank), PAGE_BYTES)
        self._seq = 0
        _HEAD.pack_into(self._seg._mm, 0, STATUS_MAGIC, STATUS_VERSION, 0)

    def publish(self, *, nranks: int, step: int, epoch: int, op_id: int,
                last_op: str = "", ledger: Optional[Dict[str, float]] = None,
                edges=(), qdepth: int = -1, inflight: str = "",
                conv_err: float = -1.0, conv_round: int = -1,
                flags: int = 0, serve_version: int = -1,
                serve_lag: int = -1, distrib_slot: int = -1,
                distrib_parent: int = -1, qps: float = -1.0,
                p50_ms: float = -1.0, p99_ms: float = -1.0,
                slo_state: int = -1, alert_state: int = -1,
                last_alert: str = "") -> None:
        """Seqlocked single-writer update of the whole page.

        ``edges`` is an iterable of ``(peer_global, state_code,
        deadline_s)`` tuples (truncated at MAX_EDGES); ``ledger`` maps
        the ``_LEDGER_KEYS`` to mass totals (missing keys read 0.0);
        ``qdepth``/``inflight`` mirror the rank's progress engine
        (-1 = no engine running); ``conv_err``/``conv_round`` mirror
        the convergence probe (round -1 = probe off); ``flags`` is the
        v4 bit set (``FLAG_ORPHAN`` = quorum lost, rank quiesced);
        ``serve_version``/``serve_lag`` are the v5 serving plane
        (-1 = this rank neither publishes nor serves snapshots);
        ``distrib_slot``/``distrib_parent`` are the v6 distribution
        tree (slot -1 = not attached through the distribution plane,
        parent -1 = fed straight by the publisher);
        ``qps``/``p50_ms``/``p99_ms``/``slo_state`` are the v7
        request-level serve telemetry (-1 = no request traffic
        observed; slo_state 0 = within the latency SLO, 1 =
        violating); ``alert_state``/``last_alert`` are the v8 fleet-
        monitor lamp (-1 = this page is not a monitor / no samples
        yet; only the monitor daemon's page at MONITOR_RANK writes
        them)."""
        mm = self._seg._mm
        led = ledger or {}
        ed = list(edges)[:MAX_EDGES]
        self._seq += 1  # -> odd: readers retry from here on
        struct.pack_into("<Q", mm, 8, self._seq)
        _FIXED.pack_into(
            mm, _HEAD.size,
            self.rank, int(nranks), os.getpid(), len(ed),
            int(step) & 0xFFFFFFFFFFFFFFFF,
            int(epoch) & 0xFFFFFFFFFFFFFFFF,
            int(op_id) & 0xFFFFFFFFFFFFFFFF,
            time.time(), time.monotonic(),
            str(last_op).encode("utf-8", "replace")[:16],
            float(led.get("deposits", 0.0)), float(led.get("collected", 0.0)),
            float(led.get("drained", 0.0)), float(led.get("pending", 0.0)),
            int(qdepth),
            str(inflight).encode("utf-8", "replace")[:16],
            float(conv_err), int(conv_round), int(flags),
            int(serve_version), int(serve_lag),
            int(distrib_slot), int(distrib_parent),
            float(qps), float(p50_ms), float(p99_ms), int(slo_state),
            int(alert_state),
            str(last_alert).encode("utf-8", "replace")[:16])
        off = _HEAD.size + _FIXED.size
        for peer, state, deadline in ed:
            _EDGE.pack_into(mm, off, int(peer), int(state), float(deadline))
            off += _EDGE.size
        self._seq += 1  # -> even: page consistent again
        struct.pack_into("<Q", mm, 8, self._seq)

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)


def _decode(buf: bytes) -> Dict[str, object]:
    magic, version, seq = _HEAD.unpack_from(buf, 0)
    if magic != STATUS_MAGIC:
        raise ValueError(f"not a status page (magic 0x{magic:08x})")
    if version not in (1, 2, 3, 4, 5, 6, 7, STATUS_VERSION):
        raise ValueError(f"unsupported status-page version {version}")
    if version == 1:
        # a live v1 writer (mid-upgrade fleet): no progress-engine block
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend) = _FIXED_V1.unpack_from(
            buf, _HEAD.size)
        qdepth, inflight = -1, b""
        conv_err, conv_round = -1.0, -1
        flags = 0
        serve_version, serve_lag = -1, -1
        distrib_slot, distrib_parent = -1, -1
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V1.size
    elif version == 2:
        # a live v2 writer: progress block, no convergence word
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight) = \
            _FIXED_V2.unpack_from(buf, _HEAD.size)
        conv_err, conv_round = -1.0, -1
        flags = 0
        serve_version, serve_lag = -1, -1
        distrib_slot, distrib_parent = -1, -1
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V2.size
    elif version == 3:
        # a live v3 writer: convergence word, no flags word
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round) = _FIXED_V3.unpack_from(buf, _HEAD.size)
        flags = 0
        serve_version, serve_lag = -1, -1
        distrib_slot, distrib_parent = -1, -1
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V3.size
    elif version == 4:
        # a live v4 writer: flags word, no serving plane
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round, flags) = _FIXED_V4.unpack_from(
            buf, _HEAD.size)
        serve_version, serve_lag = -1, -1
        distrib_slot, distrib_parent = -1, -1
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V4.size
    elif version == 5:
        # a live v5 writer: serving plane, no distribution tree
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round, flags,
         serve_version, serve_lag) = _FIXED_V5.unpack_from(
            buf, _HEAD.size)
        distrib_slot, distrib_parent = -1, -1
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V5.size
    elif version == 6:
        # a live v6 writer: distribution tree, no request telemetry
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round, flags,
         serve_version, serve_lag,
         distrib_slot, distrib_parent) = _FIXED_V6.unpack_from(
            buf, _HEAD.size)
        qps, p50_ms, p99_ms, slo_state = -1.0, -1.0, -1.0, -1
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V6.size
    elif version == 7:
        # a live v7 writer: request telemetry, no alert lamp
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round, flags,
         serve_version, serve_lag,
         distrib_slot, distrib_parent,
         qps, p50_ms, p99_ms, slo_state) = _FIXED_V7.unpack_from(
            buf, _HEAD.size)
        alert_state, last_alert = -1, b""
        fixed_size = _FIXED_V7.size
    else:
        (rank, nranks, pid, n_edges, step, epoch, op_id, wall_ts, mono_ts,
         last_op, dep, col, drn, pend, qdepth, inflight,
         conv_err, conv_round, flags,
         serve_version, serve_lag,
         distrib_slot, distrib_parent,
         qps, p50_ms, p99_ms, slo_state,
         alert_state, last_alert) = _FIXED.unpack_from(buf, _HEAD.size)
        fixed_size = _FIXED.size
    edges: List[Dict[str, object]] = []
    off = _HEAD.size + fixed_size
    for _ in range(max(0, min(n_edges, MAX_EDGES))):
        peer, state, deadline = _EDGE.unpack_from(buf, off)
        off += _EDGE.size
        edges.append({
            "peer": peer,
            "state": EDGE_STATE_NAMES.get(state, str(state)),
            "deadline_s": deadline,
        })
    return {
        "schema": STATUS_SCHEMA,
        "version": version,
        "seq": seq,
        "rank": rank,
        "nranks": nranks,
        "pid": pid,
        "step": step,
        "epoch": epoch,
        "op_id": op_id,
        "last_op": last_op.split(b"\0", 1)[0].decode("utf-8", "replace"),
        "wall_ts": wall_ts,
        "mono_ts": mono_ts,
        "ledger": {
            "deposits": dep, "collected": col,
            "drained": drn, "pending": pend,
            "balance": dep - col - drn,
        },
        "progress": {
            "qdepth": int(qdepth),
            "inflight": inflight.split(b"\0", 1)[0].decode(
                "utf-8", "replace"),
        },
        # the convergence probe's word (bluefog_tpu.lab): err is the
        # debiased consensus-error sample at probe round `round`;
        # round < 0 = probe off (or a pre-v3 writer), err NaN = the
        # probe's first round (a difference needs a predecessor)
        "conv": {
            # non-finite (a NaN first-round sample) sanitized to -1.0 so
            # collect()'s payload stays strict-JSON serializable
            "err": float(conv_err) if math.isfinite(conv_err) else -1.0,
            "round": int(conv_round),
        },
        "flags": int(flags),
        # quorum-lost quiesce (docs/RESILIENCE.md "Orphan quiesce")
        "orphan": bool(int(flags) & FLAG_ORPHAN),
        # the serving plane (docs/SERVING.md): a publisher's last
        # committed version (lag 0) or a replica's served version and
        # trail; version < 0 = this rank is not part of the serve plane
        "serve": {
            "version": int(serve_version),
            "lag": int(serve_lag),
            # v7 request telemetry over the replica's rolling window:
            # qps/p50/p99 read -1.0 while no request traffic has been
            # observed; slo_state -1 = no SLO armed (or no traffic),
            # 0 = within BFTPU_SERVE_SLO_MS, 1 = currently violating.
            # Non-finite values sanitized so collect() stays strict-JSON.
            "qps": float(qps) if math.isfinite(qps) else -1.0,
            "p50_ms": float(p50_ms) if math.isfinite(p50_ms) else -1.0,
            "p99_ms": float(p99_ms) if math.isfinite(p99_ms) else -1.0,
            "slo_state": int(slo_state),
        },
        # the distribution tree (docs/SERVING.md "Cross-host
        # distribution"): slot -1 = not attached through the distrib
        # plane; parent -1 = fed straight by the publisher
        "distrib": {
            "slot": int(distrib_slot),
            "parent": int(distrib_parent),
        },
        # the fleet-monitor lamp (v8, docs/OBSERVABILITY.md "Fleet
        # monitor"): only the monitor daemon's own page (MONITOR_RANK)
        # writes it; state -1 = not a monitor page (or a pre-v8
        # writer), 0 = sampled and quiet, 1 = an alert window is open,
        # last = the most recent alert's rule name
        "alert": {
            "state": int(alert_state),
            "last": last_alert.split(b"\0", 1)[0].decode(
                "utf-8", "replace"),
        },
        "edges": edges,
    }


def read_status_page(path: str, retries: int = 8) -> Dict[str, object]:
    """Seqlock reader: two whole-page reads bracketing one seq — accept
    the first buffer iff both seqs are the same even number; otherwise a
    write was in flight, so retry.  Raises :class:`TornPageError` when
    the page never settles (a stuck mid-write writer) and ``ValueError``
    on a bad magic/version."""
    last = None
    for _ in range(max(1, retries)):
        with open(path, "rb") as f:
            buf1 = f.read(PAGE_BYTES)
        if len(buf1) < _HEAD.size + _FIXED.size:
            raise ValueError(f"truncated status page {path}")
        seq1 = struct.unpack_from("<Q", buf1, 8)[0]
        if seq1 % 2 == 0:
            with open(path, "rb") as f:
                buf2 = f.read(PAGE_BYTES)
            seq2 = struct.unpack_from("<Q", buf2, 8)[0]
            if seq1 == seq2:
                return _decode(buf1)
        last = seq1
        time.sleep(0.001)
    raise TornPageError(f"status page {path} torn across retries "
                        f"(last seq {last})")


def find_status_pages(job: str) -> Dict[int, str]:
    """``{rank: path}`` of every status page the job has published (both
    the shm dir and any configured fallback dir are searched)."""
    prefix = shm_native.seg_name(job, "status_r")[1:]
    out: Dict[int, str] = {}
    for d in {"/dev/shm", shm_native._FALLBACK_DIR}:
        for path in glob.glob(os.path.join(d, prefix + "*")):
            tail = os.path.basename(path)[len(prefix):]
            if tail.isdigit():
                out[int(tail)] = path
    return out


def read_fleet(job: str) -> Dict[int, Dict[str, object]]:
    """Every readable status page of the job; unreadable/torn pages map
    to ``{"error": ...}`` instead of failing the whole attach."""
    fleet: Dict[int, Dict[str, object]] = {}
    for rank, path in sorted(find_status_pages(job).items()):
        try:
            fleet[rank] = read_status_page(path)
        except (OSError, ValueError, TornPageError) as e:
            fleet[rank] = {"error": f"{type(e).__name__}: {e}"}
    return fleet


def _read_holder_words(job: str) -> Dict[int, int]:
    """``{mutex_rank: holder_rank}`` straight from the job's holder-board
    segment, read-only (no segment is created when none exists)."""
    path = os.path.join(shm_native._FALLBACK_DIR,
                        shm_native.seg_name(job, "holders")[1:])
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    n = len(raw) // 8
    out: Dict[int, int] = {}
    for r in range(n):
        word = struct.unpack_from("<Q", raw, r * 8)[0]
        if 0 < word <= n:
            out[r] = int(word) - 1
    return out


def collect(job: str) -> Dict[str, object]:
    """One schema-valid fleet snapshot: the merged status pages plus the
    current epoch's lock holders and the suspect summary — the payload
    behind ``bftpu-top --once --json``."""
    from bluefog_tpu_torch.resilience.join import epoch_job

    fleet = read_fleet(job)
    epoch = max((int(p.get("epoch", 0)) for p in fleet.values()
                 if "error" not in p), default=0)
    # mutexes live in the CURRENT epoch's job segment; ranks mid-switch
    # may still hold base-epoch locks, so merge both boards (epoch wins)
    holders = _read_holder_words(job)
    holders.update(_read_holder_words(epoch_job(job, epoch)))
    suspects = sorted({e["peer"] for p in fleet.values()
                       for e in p.get("edges", ())
                       if e.get("state") == "suspect"})
    orphans = sorted(r for r, p in fleet.items() if p.get("orphan"))
    # the serving plane: every rank that publishes/serves snapshots
    # (training publishers report lag 0; replicas their actual trail)
    serve = {}
    for r, p in sorted(fleet.items()):
        if "error" in p or p.get("serve", {}).get("version", -1) < 0:
            continue
        ent = dict(p["serve"])
        d = p.get("distrib", {})
        if d.get("slot", -1) >= 0:
            # attached through the distribution tree: report its slot
            # and the slot it feeds from (-1 = the publisher)
            ent["slot"] = int(d["slot"])
            ent["parent"] = int(d["parent"])
        serve[str(r)] = ent
    # the fleet-monitor lamp (v8): a page with alert_state >= 0 IS a
    # monitor page (worker pages always read -1); step counts scrapes
    # and op_id counts rule firings on the monitor's own page
    monitor = {}
    for r, p in sorted(fleet.items()):
        if "error" in p or p.get("alert", {}).get("state", -1) < 0:
            continue
        monitor[str(r)] = {
            "state": int(p["alert"]["state"]),
            "last": p["alert"]["last"],
            "scrapes": int(p.get("step", 0)),
            "firings": int(p.get("op_id", 0)),
        }
    return {
        "schema": "bftpu-top/1",
        "job": job,
        "wall_ts": time.time(),
        "epoch": epoch,
        "ranks": {str(r): p for r, p in fleet.items()},
        "holders": {str(m): h for m, h in sorted(holders.items())},
        "suspects": suspects,
        "orphans": orphans,
        "serve": serve,
        "serve_published": max(
            (int(v["version"]) for v in serve.values()), default=-1),
        "monitor": monitor,
    }


# ---------------------------------------------------------------------------
# runtime trace toggle: the tracectl word
# ---------------------------------------------------------------------------

TRACE_DEFAULT = 0  # whatever BFTPU_TRACING said at launch
TRACE_OFF = 1
TRACE_ON = 2
_CTL = struct.Struct("<QQ")  # generation, mode


def _tracectl_path(job: str) -> str:
    return os.path.join(shm_native._FALLBACK_DIR,
                        shm_native.seg_name(job, "tracectl")[1:])


def read_trace_control(job: str) -> Tuple[int, int]:
    """``(generation, mode)`` of the job's trace-control word (``(0,
    TRACE_DEFAULT)`` when never published)."""
    try:
        with open(_tracectl_path(job), "rb") as f:
            raw = f.read(_CTL.size)
    except OSError:
        return (0, TRACE_DEFAULT)
    if len(raw) != _CTL.size:
        return (0, TRACE_DEFAULT)
    return _CTL.unpack(raw)


def publish_trace_control(job: str, mode: int) -> int:
    """Atomically publish a new trace mode (generation bump makes the
    publish observable even when the mode repeats); returns the new
    generation."""
    gen = read_trace_control(job)[0] + 1
    path = _tracectl_path(job)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_CTL.pack(gen, int(mode)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return gen


class TraceControl:
    """Worker-side poller: each rank checks the word at most every
    ``interval`` seconds (amortized to ~nothing against a window op) and
    applies a generation change by rebuilding the process tracer —
    ``bftpu-top trace on`` therefore takes effect within one gossip
    round, no restart."""

    def __init__(self, job: str, rank: int, nranks: int,
                 interval: float = 0.2):
        self.job = str(job)
        self.rank = int(rank)
        self.nranks = int(nranks)
        self._interval = float(interval)
        # attach-time state is history, not a command: only generations
        # published AFTER we start polling are applied
        self._gen = read_trace_control(job)[0]
        self._next_poll = 0.0

    def poll(self) -> None:
        now = time.monotonic()
        if now < self._next_poll:
            return
        self._next_poll = now + self._interval
        gen, mode = read_trace_control(self.job)
        if gen == self._gen:
            return
        self._gen = gen
        self._apply(mode)

    def _apply(self, mode: int) -> None:
        from bluefog_tpu_torch.tracing import tracer as _tracing

        if mode == TRACE_ON:
            if _tracing.tracing_dir() is None:
                os.environ["BFTPU_TRACING"] = "1"
            _tracing.reset()
            _tracing.get_tracer().set_identity(
                self.rank, self.nranks, self.job)
        elif mode == TRACE_OFF:
            t = _tracing.get_tracer()
            if t.enabled:
                t.write_buffer()  # don't lose spans gathered while on
            os.environ["BFTPU_TRACING"] = "0"
            _tracing.reset()
