"""mmap'd time-series store: per-(series, subject) ring buffers with
downsampling tiers.

The scraper is a separate process that can die (or be killed) without
taking history with it, so the store lives in an mmap'd segment under
the job's shm namespace (``bf_<job>_monitor``) — the same fallback-
segment machinery the status pages use.  Anyone can re-attach later
(``python -m bluefog_tpu_torch.monitor --export``) and read what the dead
monitor retained; :func:`bluefog_tpu_torch.native.shm_native.unlink_all`
reclaims it with the rest of the job's segments because it rides the
``seg_name`` prefix.

Layout (little-endian, all offsets fixed by the header so readers of a
different build can still walk it):

* header — magic ``BFMN``, layout version, one global u64 seqlock,
  slot count and the three tier capacities;
* slot directory — ``nslots`` entries of (48-byte key, three u64
  append counters), key = ``"<series>|<subject>"``, zero key = free;
* data — per slot, three contiguous rings of ``(t_wall, value)`` f64
  pairs: **raw** (every sample), **mid** (mean of every 10 raw), and
  **coarse** (mean of every 10 mid) — so with a 1 s scrape cadence the
  default 240/120/60 rings retain 4 minutes at full rate, 20 minutes
  at 10×, and 100 minutes at 100×.

Downsample accumulators are writer-process state, not persisted: a
monitor death loses at most one partial mean bucket per tier, never a
committed point.  Writers bump the seqlock odd around every append;
readers double-read and retry, exactly the status-page discipline —
one writer, any number of passive readers, no locks held while a
reader is looking.

Sizing comes from ``BFTPU_MON_SLOTS`` (distinct (series, subject)
pairs, default 256) and ``BFTPU_MON_RING`` (raw ring capacity, default
240; mid/coarse derive as /2 and /4).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.native import shm_native

__all__ = ["MonitorStore", "STORE_MAGIC", "STORE_VERSION", "STORE_SCHEMA"]

STORE_MAGIC = 0x42464D4E  # "BFMN"
STORE_VERSION = 1
STORE_SCHEMA = "bftpu-monitor/1"

_HEAD = struct.Struct("<IIQIIII")  # magic, version, seq, nslots, caps x3
_DIR = struct.Struct("<48sQQQ")    # key, append counters raw/mid/coarse
_POINT = struct.Struct("<dd")      # (t_wall, value)

TIERS = ("raw", "mid", "coarse")
_BUCKET = 10  # raw→mid and mid→coarse downsample factor


def _env_int(key: str, default: int, lo: int, hi: int) -> int:
    try:
        v = int(os.environ.get(key, "") or default)
    except ValueError:
        v = default
    return max(lo, min(hi, v))


def store_path(job: str) -> str:
    return os.path.join(shm_native._FALLBACK_DIR,
                        shm_native.seg_name(job, "monitor")[1:])


class MonitorStore:
    """One writer (the scraper / sim twin), many passive readers.

    ``create=True`` initializes the header (idempotent: an existing
    compatible segment is adopted, counters intact, so a respawned
    monitor continues the same history).  ``create=False`` attaches
    read-only semantics — raises ``FileNotFoundError`` when no monitor
    ever ran for the job.
    """

    def __init__(self, job: str, *, create: bool = False,
                 nslots: Optional[int] = None,
                 cap_raw: Optional[int] = None):
        self.job = job
        self.path = store_path(job)
        if not create and not os.path.exists(self.path):
            raise FileNotFoundError(
                f"no monitor store for job {job!r} ({self.path})")
        nslots = (_env_int("BFTPU_MON_SLOTS", 256, 8, 65536)
                  if nslots is None else int(nslots))
        cap_raw = (_env_int("BFTPU_MON_RING", 240, 8, 1 << 20)
                   if cap_raw is None else int(cap_raw))
        caps = (cap_raw, max(4, cap_raw // 2), max(2, cap_raw // 4))
        size = (_HEAD.size + nslots * _DIR.size
                + nslots * sum(caps) * _POINT.size)
        self._seg = shm_native._FallbackSegment(self.path, max(
            size, os.path.getsize(self.path) if os.path.exists(self.path)
            else 0))
        magic, version, _, n, c0, c1, c2 = _HEAD.unpack_from(self._seg._mm, 0)
        if magic == STORE_MAGIC and version == STORE_VERSION:
            # Adopt the existing geometry — it wins over env/args.
            self.nslots, self.caps = n, (c0, c1, c2)
        elif create and magic == 0:
            self.nslots, self.caps = nslots, caps
            _HEAD.pack_into(self._seg._mm, 0, STORE_MAGIC, STORE_VERSION,
                            0, nslots, *caps)
        else:
            self._seg.close()
            raise ValueError(
                f"monitor store {self.path} has foreign magic/version "
                f"{magic:#x}/{version}")
        self._dir_off = _HEAD.size
        self._data_off = self._dir_off + self.nslots * _DIR.size
        self._slot_bytes = sum(self.caps) * _POINT.size
        self._slots: Dict[str, int] = {}
        self._accum: Dict[Tuple[int, int], List[float]] = {}
        for i in range(self.nslots):
            key = self._key_at(i)
            if key:
                self._slots[key] = i

    # -- geometry ---------------------------------------------------------

    def _key_at(self, slot: int) -> str:
        raw = _DIR.unpack_from(self._seg._mm,
                               self._dir_off + slot * _DIR.size)[0]
        return raw.rstrip(b"\x00").decode("utf-8", "replace")

    def _counts_at(self, slot: int) -> Tuple[int, int, int]:
        e = _DIR.unpack_from(self._seg._mm, self._dir_off + slot * _DIR.size)
        return e[1], e[2], e[3]

    def _ring_off(self, slot: int, tier: int) -> int:
        return (self._data_off + slot * self._slot_bytes
                + sum(self.caps[:tier]) * _POINT.size)

    # -- seqlock ----------------------------------------------------------

    def _seq(self) -> int:
        return struct.unpack_from("<Q", self._seg._mm, 8)[0]

    def _bump(self) -> None:
        struct.pack_into("<Q", self._seg._mm, 8, self._seq() + 1)

    # -- writer -----------------------------------------------------------

    def append(self, series: str, subject, t_wall: float,
               value: float) -> None:
        """Append one raw point (and any downsampled means it completes)
        under a single odd/even seqlock bump."""
        key = f"{series}|{subject}"[:47]
        slot = self._slots.get(key)
        self._bump()  # odd: writers in flight
        try:
            if slot is None:
                slot = self._alloc(key)
                if slot is None:
                    return  # directory full: drop newest series, keep run
            self._push(slot, 0, float(t_wall), float(value))
            self._downsample(slot, 0, float(t_wall), float(value))
        finally:
            self._bump()  # even: quiescent

    def _alloc(self, key: str) -> Optional[int]:
        for i in range(self.nslots):
            if not self._key_at(i):
                _DIR.pack_into(self._seg._mm,
                               self._dir_off + i * _DIR.size,
                               key.encode("utf-8")[:48], 0, 0, 0)
                self._slots[key] = i
                return i
        return None

    def _push(self, slot: int, tier: int, t: float, v: float) -> None:
        off = self._dir_off + slot * _DIR.size
        entry = list(_DIR.unpack_from(self._seg._mm, off))
        count = entry[1 + tier]
        idx = count % self.caps[tier]
        _POINT.pack_into(self._seg._mm,
                         self._ring_off(slot, tier) + idx * _POINT.size,
                         t, v)
        entry[1 + tier] = count + 1
        _DIR.pack_into(self._seg._mm, off, *entry)

    def _downsample(self, slot: int, tier: int, t: float, v: float) -> None:
        if tier + 1 >= len(self.caps):
            return
        acc = self._accum.setdefault((slot, tier), [0.0, 0.0, 0.0])
        acc[0] += t
        acc[1] += v
        acc[2] += 1.0
        if acc[2] >= _BUCKET:
            mt, mv = acc[0] / acc[2], acc[1] / acc[2]
            self._accum[(slot, tier)] = [0.0, 0.0, 0.0]
            self._push(slot, tier + 1, mt, mv)
            self._downsample(slot, tier + 1, mt, mv)

    # -- reader -----------------------------------------------------------

    def _read_ring(self, slot: int, tier: int, count: int) -> List[
            Tuple[float, float]]:
        cap = self.caps[tier]
        n = min(count, cap)
        start = count - n
        out = []
        base = self._ring_off(slot, tier)
        for k in range(start, count):
            t, v = _POINT.unpack_from(self._seg._mm,
                                      base + (k % cap) * _POINT.size)
            out.append((t, v))
        return out

    def snapshot(self, retries: int = 8) -> Dict[str, Dict[str, list]]:
        """Consistent read of every slot: ``{key: {tier: [(t, v), ...]}}``.
        Retries on seqlock motion; a persistently-busy writer degrades
        to a best-effort read rather than raising (monitoring must not
        wedge on monitoring)."""
        out: Dict[str, Dict[str, list]] = {}
        for _ in range(max(1, retries)):
            s0 = self._seq()
            if s0 & 1:
                continue
            out = {}
            for i in range(self.nslots):
                key = self._key_at(i)
                if not key:
                    continue
                counts = self._counts_at(i)
                out[key] = {tier: self._read_ring(i, t, counts[t])
                            for t, tier in enumerate(TIERS)}
            if self._seq() == s0:
                return out
        return out

    # -- export -----------------------------------------------------------

    def to_json(self) -> dict:
        snap = self.snapshot()
        series = []
        for key in sorted(snap):
            name, _, subject = key.partition("|")
            series.append({"series": name, "subject": subject,
                           "tiers": snap[key]})
        return {"schema": STORE_SCHEMA, "job": self.job,
                "nslots": self.nslots, "caps": list(self.caps),
                "series": series}

    def to_prometheus(self) -> str:
        """Prometheus text exposition: latest raw point per slot as a
        gauge, plus the sample count as a counter."""
        snap = self.snapshot()
        lines: List[str] = []
        seen_help = set()
        for key in sorted(snap):
            name, _, subject = key.partition("|")
            metric = "bftpu_mon_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in name)
            raw = snap[key]["raw"]
            if not raw:
                continue
            if metric not in seen_help:
                lines.append(f"# TYPE {metric} gauge")
                seen_help.add(metric)
            t, v = raw[-1]
            label = subject.replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f'{metric}{{subject="{label}"}} {v:.17g} '
                         f"{int(t * 1000)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink=unlink)


def export_json(job: str) -> dict:
    store = MonitorStore(job)
    try:
        return store.to_json()
    finally:
        store.close()


def export_prometheus(job: str) -> str:
    store = MonitorStore(job)
    try:
        return store.to_prometheus()
    finally:
        store.close()
