"""Per-rank tracer: causal spans, trace-context words, and a flight ring.

Three cooperating pieces, all stdlib-only (importable without jax or the
native library, like :mod:`bluefog_tpu_torch.telemetry`):

* **Trace-context words** — :func:`pack_ctx` packs ``(round, op_id,
  origin_rank)`` into one u64 that rides the transports (an 8-byte
  sidecar word per shm mailbox slot, a u64 field in the TCP frame).  The
  producing span records the word it *emitted*; the consuming span
  records the word it *collected* — :mod:`bluefog_tpu.tracing.merge`
  joins the two into a Chrome-trace flow arrow.

* **Span buffer** — ``tr.begin(...)`` / ``tr.end(tok, ...)`` append
  closed spans (monotonic ns timestamps) to an in-memory list, written
  as ``trace-<job>-r<rank>.json`` at shutdown/atexit (atomic tmp +
  rename, the telemetry snapshot idiom).

* **Flight ring** — a fixed-size mmap-backed ring of recent begin/end
  records (``trace-<job>-r<rank>.flight.bin``).  mmap writes land in the
  page cache, so the ring survives SIGKILL; the spawner converts a dead
  rank's ring to ``flight-<job>-r<rank>.json`` post-mortem, and the
  tracer itself dumps it in-process on SIGTERM, fatal worker errors and
  ``PeerTimeoutError``.  A ``'B'`` record with no matching ``'E'`` names
  the op that was in flight when the rank died.

Enable with ``BFTPU_TRACING=1`` (or ``=<dir>``); when unset,
:func:`get_tracer` returns a shared ``NullTracer`` whose methods are
no-ops — instrumented call sites cost one attribute load and a falsy
branch, the same contract ``BFTPU_TELEMETRY`` has.
"""

from __future__ import annotations

import atexit
import glob
import json
import mmap
import os
import re
import signal
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from bluefog_tpu_torch.telemetry.registry import (
    _resolve_job,
    _resolve_rank,
    _safe_name,
)
from bluefog_tpu_torch.tracing.clock import ClockEstimator

TRACE_SCHEMA = "bftpu-trace-v1"
FLIGHT_SCHEMA = "bftpu-flight-v1"

_DEFAULT_DIR = "/tmp/bftpu_tracing"

# span-buffer hard cap: ~100 bytes/span keeps worst case ~10 MB/rank;
# overflow increments ``dropped`` instead of growing without bound
_MAX_SPANS = 100_000


def tracing_dir() -> Optional[str]:
    """Directory for trace buffers, or None when tracing is off.

    ``BFTPU_TRACING`` semantics mirror ``BFTPU_TELEMETRY``: unset, empty
    or ``"0"`` → off; ``"1"`` → the default dir; anything else IS the
    directory."""
    v = os.environ.get("BFTPU_TRACING", "")
    if v in ("", "0"):
        return None
    if v == "1":
        return _DEFAULT_DIR
    return v


# ---------------------------------------------------------------------------
# trace-context word: (round, op_id, origin) in one u64
# ---------------------------------------------------------------------------
#
#   bits 32..63  op_id   (per-rank monotone counter, one per op×target)
#   bits 16..31  round   (gossip round mod 2**16 — disambiguation only)
#   bits  0..15  origin  (the producing rank)
#
# Flow identity in the merged trace is (origin, op_id): op_id alone is
# only rank-unique.  The word 0 means "no context" on the wire.


def pack_ctx(round_: int, op_id: int, origin: int) -> int:
    """Pack (round, op_id, origin_rank) into the u64 wire word."""
    return (((op_id & 0xFFFFFFFF) << 32)
            | ((round_ & 0xFFFF) << 16)
            | (origin & 0xFFFF))


def unpack_ctx(word: int) -> Tuple[int, int, int]:
    """Inverse of :func:`pack_ctx`: returns ``(round, op_id, origin)``."""
    return ((word >> 16) & 0xFFFF, (word >> 32) & 0xFFFFFFFF, word & 0xFFFF)


# ---------------------------------------------------------------------------
# flight ring: fixed-size mmap ring of recent begin/end records
# ---------------------------------------------------------------------------

_RING_MAGIC = 0x42465452  # "BFTR"
_RING_VERSION = 1
_RING_HDR = struct.Struct("<IIIIQ")  # magic, version, cap, recsize, seq-hint
_RING_HDR_SIZE = 64  # header padded to one record boundary
# record: seq, t_ns, kind, round, op_id, origin, aux, name — exactly 64 B
_RING_REC = struct.Struct("<QQIIIiI28s")

KIND_B, KIND_E, KIND_I = 1, 2, 3
_KIND_NAMES = {KIND_B: "B", KIND_E: "E", KIND_I: "I"}


def _ring_capacity() -> int:
    """Ring capacity in records (``BFTPU_TRACE_RING``, default 256)."""
    try:
        cap = int(os.environ.get("BFTPU_TRACE_RING", "") or 256)
    except ValueError:
        cap = 256
    return max(16, cap)


class FlightRing:
    """mmap-backed ring of fixed 64-byte records; SIGKILL-durable."""

    def __init__(self, path: str, cap: int):
        self.path = path
        self.cap = int(cap)
        size = _RING_HDR_SIZE + self.cap * _RING_REC.size
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._seq = 0
        _RING_HDR.pack_into(self._mm, 0, _RING_MAGIC, _RING_VERSION,
                            self.cap, _RING_REC.size, 0)

    def append(self, kind: int, name: str, round_: int = 0, op_id: int = 0,
               origin: int = -1, aux: int = 0) -> int:
        """Write one record; returns its sequence number (1-based)."""
        self._seq += 1
        s = self._seq
        off = _RING_HDR_SIZE + ((s - 1) % self.cap) * _RING_REC.size
        _RING_REC.pack_into(
            self._mm, off, s, time.monotonic_ns(), kind,
            round_ & 0xFFFFFFFF, op_id & 0xFFFFFFFF, origin,
            aux & 0xFFFFFFFF, name.encode("utf-8", "replace")[:28])
        struct.pack_into("<Q", self._mm, 16, s)  # header hint for readers
        return s

    def close(self) -> None:
        try:
            self._mm.flush()
            self._mm.close()
        except (ValueError, OSError):
            pass


def read_flight_ring(data_or_path) -> Tuple[List[Dict], List[Dict]]:
    """Decode a flight ring (bytes or path) into ``(records, in_flight)``.

    ``records`` are sorted by sequence; ``in_flight`` is the subset of
    'B' records whose matching 'E' (linked by ``aux`` = B's seq) never
    landed — the ops that were open when the rank died."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        buf = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            buf = f.read()
    if len(buf) < _RING_HDR_SIZE:
        raise ValueError("flight ring truncated")
    magic, ver, cap, recsize, _hint = _RING_HDR.unpack_from(buf, 0)
    if magic != _RING_MAGIC:
        raise ValueError(f"bad flight-ring magic 0x{magic:08x}")
    if recsize != _RING_REC.size:
        raise ValueError(f"flight-ring record size {recsize} != "
                         f"{_RING_REC.size} (version {ver})")
    records: List[Dict] = []
    for k in range(cap):
        off = _RING_HDR_SIZE + k * recsize
        if off + recsize > len(buf):
            break
        seq, t_ns, kind, rnd, op_id, origin, aux, name = (
            _RING_REC.unpack_from(buf, off))
        if seq == 0 or kind not in _KIND_NAMES:
            continue  # never written (or torn mid-write)
        records.append({
            "seq": seq, "t_ns": t_ns, "kind": _KIND_NAMES[kind],
            "round": rnd, "op_id": op_id, "origin": origin, "aux": aux,
            "name": name.rstrip(b"\x00").decode("utf-8", "replace"),
        })
    records.sort(key=lambda r: r["seq"])
    ended = {r["aux"] for r in records if r["kind"] == "E"}
    in_flight = [r for r in records
                 if r["kind"] == "B" and (r["seq"] & 0xFFFFFFFF) not in ended]
    return records, in_flight


def _atomic_write_json(path: str, doc: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Active tracer: span buffer + flight ring + clock estimator."""

    enabled = True

    def __init__(self, dirpath: str, rank: Optional[int] = None,
                 job: Optional[str] = None):
        self.dir = dirpath
        self.rank = _resolve_rank() if rank is None else int(rank)
        self.job = _resolve_job() if job is None else str(job)
        self.nranks = 0
        self.round = 0
        self.spans: List[Dict] = []
        self.dropped = 0
        self.clock = ClockEstimator()
        self._op_id = 0
        self._ring: Optional[FlightRing] = None
        self._lock = threading.Lock()
        self._sigterm_installed = False
        os.makedirs(dirpath, exist_ok=True)

    # -- identity -------------------------------------------------------

    def set_identity(self, rank: int, nranks: int, job: str) -> None:
        """Bind rank/job after :func:`islands.init` knows them.  Reopens
        the flight ring at the per-rank path and installs the SIGTERM
        dump handler (main thread only)."""
        self.rank, self.nranks, self.job = int(rank), int(nranks), str(job)
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        self._ensure_ring()
        self.install_sigterm()

    def _base(self) -> str:
        return f"{_safe_name(self.job)}-r{self.rank}"

    def ring_path(self) -> str:
        return os.path.join(self.dir, f"trace-{self._base()}.flight.bin")

    def buffer_path(self) -> str:
        return os.path.join(self.dir, f"trace-{self._base()}.json")

    def flight_json_path(self) -> str:
        return os.path.join(self.dir, f"flight-{self._base()}.json")

    def _ensure_ring(self) -> Optional[FlightRing]:
        if self._ring is None:
            try:
                self._ring = FlightRing(self.ring_path(), _ring_capacity())
            except OSError:
                return None
        return self._ring

    # -- hot path -------------------------------------------------------

    def next_op_id(self) -> int:
        self._op_id += 1
        return self._op_id

    def begin(self, name: str, window: Optional[str] = None) -> Tuple:
        ring = self._ensure_ring()
        seq = ring.append(KIND_B, name, self.round, 0, self.rank) if ring else 0
        return (name, time.monotonic_ns(), seq, window)

    def end(self, tok: Tuple, emit: Optional[List[Dict]] = None,
            consume: Optional[List[Dict]] = None, op_id: int = 0) -> None:
        name, t0, seq, window = tok
        t1 = time.monotonic_ns()
        if self._ring is not None:
            self._ring.append(KIND_E, name, self.round, op_id, self.rank,
                              aux=seq)
        if len(self.spans) >= _MAX_SPANS:
            self.dropped += 1
            return
        span: Dict[str, Any] = {"name": name, "t0": t0, "t1": t1,
                                "round": self.round}
        if window:
            span["win"] = window
        if emit:
            span["emit"] = emit
        if consume:
            span["consume"] = consume
        cur = threading.current_thread()
        if cur is not threading.main_thread():
            # off-main-thread spans (the progress-engine worker) carry
            # their lane so the merged view separates background
            # communication from the training step it overlaps
            span["lane"] = cur.name
        self.spans.append(span)

    def instant(self, name: str, aux: int = 0) -> None:
        ring = self._ensure_ring()
        if ring:
            ring.append(KIND_I, name, self.round, 0, self.rank, aux=aux)
        t = time.monotonic_ns()
        if len(self.spans) < _MAX_SPANS:
            self.spans.append({"name": name, "t0": t, "t1": t,
                               "round": self.round, "ph": "i"})
        else:
            self.dropped += 1

    def advance_round(self) -> int:
        self.round += 1
        return self.round

    # -- clock ----------------------------------------------------------

    def resample_clock(self, job) -> None:
        """Feed one coordinator clock probe into the offset estimator.
        Jobs without a coordinator path (same-host shm: the Linux
        monotonic clock is already shared) simply keep offset 0."""
        probe = getattr(job, "clock_probe", None)
        if probe is None:
            return
        try:
            t0, remote, t1 = probe()
        except Exception:  # noqa: BLE001 - peer death mid-probe is fine
            return
        self.clock.add_sample(t0, remote, t1)

    # -- dumps ----------------------------------------------------------

    def write_buffer(self) -> Optional[str]:
        """Atomically write the span buffer (telemetry-snapshot idiom)."""
        path = self.buffer_path()
        doc = {
            "schema": TRACE_SCHEMA,
            "job": self.job,
            "rank": self.rank,
            "nranks": self.nranks,
            "rounds": self.round,
            "clock": self.clock.as_dict(),
            # wall↔monotonic anchor: lets the merger place wall-clock
            # telemetry journal events on the monotonic span timeline
            "anchor": {"wall_s": time.time(),
                       "mono_ns": time.monotonic_ns()},
            "dropped": self.dropped,
            "spans": self.spans,
        }
        try:
            _atomic_write_json(path, doc)
        except OSError:
            return None
        return path

    def dump_flight(self, reason: str) -> Optional[str]:
        """Write the flight-ring JSON in-process (SIGTERM / fatal error /
        PeerTimeoutError).  SIGKILLed ranks skip this; the spawner
        recovers their ring file instead."""
        ring = self._ensure_ring()
        if ring is None:
            return None
        with self._lock:
            try:
                records, in_flight = read_flight_ring(bytes(ring._mm))
            except (ValueError, OSError):
                return None
            doc = {
                "schema": FLIGHT_SCHEMA,
                "job": self.job,
                "rank": self.rank,
                "reason": reason,
                "records": records,
                "in_flight": in_flight,
            }
            path = self.flight_json_path()
            try:
                _atomic_write_json(path, doc)
            except OSError:
                return None
            return path

    # -- SIGTERM --------------------------------------------------------

    def install_sigterm(self) -> None:
        """Chain a SIGTERM handler that dumps flight + buffer, then
        defers to whatever handler was installed before us."""
        if self._sigterm_installed:
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_sigterm(signum, frame):
                try:
                    self.dump_flight("SIGTERM")
                    self.write_buffer()
                finally:
                    if callable(prev):
                        prev(signum, frame)
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_sigterm)
            self._sigterm_installed = True
        except ValueError:
            pass  # not the main thread — atexit still covers clean exits

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()
            self._ring = None


class NullTracer:
    """Shared no-op tracer returned when ``BFTPU_TRACING`` is unset."""

    enabled = False
    rank = -1
    job = ""
    round = 0

    def set_identity(self, rank, nranks, job):  # noqa: D102
        pass

    def next_op_id(self):  # noqa: D102
        return 0

    def begin(self, name, window=None):  # noqa: D102
        return None

    def end(self, tok, emit=None, consume=None, op_id=0):  # noqa: D102
        pass

    def instant(self, name, aux=0):  # noqa: D102
        pass

    def advance_round(self):  # noqa: D102
        return 0

    def resample_clock(self, job):  # noqa: D102
        pass

    def write_buffer(self):  # noqa: D102
        return None

    def dump_flight(self, reason):  # noqa: D102
        return None

    def install_sigterm(self):  # noqa: D102
        pass

    def close(self):  # noqa: D102
        pass


NULL_TRACER = NullTracer()

_tracer: Optional[object] = None
_tracer_lock = threading.Lock()


def _atexit_write() -> None:
    t = _tracer
    if t is not None and t.enabled:
        t.write_buffer()
        t.close()


atexit.register(_atexit_write)


def get_tracer():
    """The process tracer: a :class:`Tracer` when ``BFTPU_TRACING`` is
    set, else the shared :class:`NullTracer` (cached either way)."""
    global _tracer
    t = _tracer
    if t is not None:
        return t
    with _tracer_lock:
        if _tracer is None:
            d = tracing_dir()
            _tracer = Tracer(d) if d else NULL_TRACER
        return _tracer


def reset() -> None:
    """Drop the cached tracer so the next :func:`get_tracer` re-reads the
    environment (tests toggle ``BFTPU_TRACING`` around this)."""
    global _tracer
    with _tracer_lock:
        t = _tracer
        _tracer = None
    if t is not None and t is not NULL_TRACER:
        t.close()


# ---------------------------------------------------------------------------
# post-mortem: recover rings of ranks that died without dumping
# ---------------------------------------------------------------------------


def convert_flight_rings(job: str, dirpath: Optional[str] = None,
                         reason: str = "post-mortem") -> List[str]:
    """Convert every flight ring of ``job`` that has no in-process JSON
    dump into ``flight-<job>-r<rank>.json``.  The spawner calls this
    after reaping children so SIGKILLed ranks still get a causal
    postmortem; ranks that dumped on SIGTERM/fatal are left alone."""
    d = dirpath or tracing_dir()
    if not d:
        return []
    out: List[str] = []
    pat = os.path.join(d, f"trace-{_safe_name(job)}-r*.flight.bin")
    for ring_path in sorted(glob.glob(pat)):
        m = re.search(r"-r(\d+)\.flight\.bin$", ring_path)
        if not m:
            continue
        rank = int(m.group(1))
        json_path = os.path.join(
            d, f"flight-{_safe_name(job)}-r{rank}.json")
        if os.path.exists(json_path):
            continue  # the rank dumped itself before dying
        try:
            records, in_flight = read_flight_ring(ring_path)
        except (OSError, ValueError):
            continue
        doc = {
            "schema": FLIGHT_SCHEMA,
            "job": job,
            "rank": rank,
            "reason": reason,
            "records": records,
            "in_flight": in_flight,
        }
        try:
            _atomic_write_json(json_path, doc)
        except OSError:
            continue
        out.append(json_path)
    return out
