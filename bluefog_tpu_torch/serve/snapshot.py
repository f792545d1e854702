"""The double-buffered seqlock'd snapshot region (docs/SERVING.md).

One mmap file per job (``bf_<job>_serve``) carries the publication
plane between a training island and its inference replicas:

- a **header** — seqlock'd (seq → odd, fields, seq → even, the status
  page idiom) holding the active buffer index and the committed
  ``(version, epoch, step)`` triple;
- **two payload buffers** — each with its own seqlock, a payload crc32,
  and the version it was filled for.

The publish protocol writes the INACTIVE buffer under its buffer
seqlock, then flips the header to point at it.  The two writes are
ordered, so every possible publisher death leaves the region serving
the previous committed snapshot:

- death mid-payload: the standby buffer's seq stays odd, the header
  still names the old buffer — readers never see the torn bytes;
- death after the payload but before the flip: the standby buffer is
  whole but uncommitted — same observable;
- death mid-flip: the header seq stays odd; readers retry, give up,
  and keep serving from their in-memory copy, and the NEXT publisher's
  :meth:`SnapshotRegion.attach` repairs the header from the newest
  whole buffer (rollback to A).

The committed version is persisted in the header, so a successor
publisher (the next-lowest live rank after a heal) continues the
version sequence — **strictly monotone across publisher death**, the
invariant replicas and the sim audit.

Chaos hooks (`BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH` /
``_PHASE``) SIGKILL the publisher at the exact protocol point the
death matrix above names — the np=4 e2e drives both.

Counterpart of ``bluefog_tpu/serve/snapshot.py`` with the same layout and
schema, so either package reads what the other publishes.  ``publish``
also takes a torch tensor: a CPU tensor is read in place, a tensor on
the card is staged to the host through
:mod:`bluefog_tpu_torch.progress.staging` (the one device-to-host route
of the island runtime).  bf16 payloads carry the dtype name
``bfloat16``, as the JAX package's ml_dtypes arrays do, and are read back
as :data:`~bluefog_tpu_torch.progress.staging.BF16` bytes.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.progress import staging as _staging

__all__ = [
    "SnapshotRegion",
    "read_committed",
    "region_path",
    "SnapshotUnavailable",
    "TornSnapshotError",
    "SERVE_SCHEMA",
]

SERVE_SCHEMA = "bftpu-serve-region/1"
SERVE_MAGIC = 0x42465356  # "BFSV"
SERVE_LAYOUT = 1

#: header: magic u32, layout u32, seq u64, active u32, pad u32,
#: version u64, epoch u64, step u64, payload_cap u64
_HEAD = struct.Struct("<IIQIIQQQQ")
#: per-buffer meta: seq u64, version u64, nbytes u64, crc32 u32,
#: ndim u32, dims 4*u32, dtype 8s
_BUF = struct.Struct("<QQQII4I8s")
_MAX_DIMS = 4
_HEAD_OFF = 0
_BUF0_OFF = 64
assert _HEAD.size <= _BUF0_OFF


class SnapshotUnavailable(RuntimeError):
    """No snapshot region (or no committed version) yet — retriable."""


class TornSnapshotError(RuntimeError):
    """The region never settled across retries (writer mid-publish or
    dead mid-flip) — the caller keeps its current snapshot."""


def region_path(job: str) -> str:
    return os.path.join(
        shm_native._FALLBACK_DIR,
        shm_native.seg_name(job, "serve")[1:])


def _buf_stride(payload_cap: int) -> int:
    # buffer meta padded to 64, then the payload, padded to 8
    return 64 + ((int(payload_cap) + 7) & ~7)


def _dtype_name(dtype: np.dtype) -> bytes:
    return b"bfloat16" if dtype == _staging.BF16 else str(dtype).encode()[:8]


def _dtype_of(name: bytes) -> np.dtype:
    name = name.split(b"\0", 1)[0].decode() or "float64"
    return _staging.BF16 if name == "bfloat16" else np.dtype(name)


def _pub_kill_publish() -> int:
    """Chaos: the publish ordinal at which the publisher SIGKILLs
    itself mid-publish (-1 = unarmed)."""
    try:
        return int(os.environ.get("BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH",
                                  "-1"))
    except ValueError:
        return -1


def _pub_kill_phase() -> str:
    """``payload`` (die with the standby buffer torn) or ``flip`` (die
    with the payload whole but the header not yet flipped)."""
    v = os.environ.get("BFTPU_CHAOS_SERVE_PUB_KILL_PHASE", "payload")
    return v if v in ("payload", "flip") else "payload"


class SnapshotRegion:
    """The writer side: owned by exactly one publisher at a time.

    ``attach`` opens (or creates) the region and repairs a header left
    odd by a publisher that died mid-flip; ``publish`` runs the
    double-buffer protocol and returns the committed version."""

    def __init__(self, job: str, payload_cap: int):
        self.job = str(job)
        self.payload_cap = int(payload_cap)
        stride = _buf_stride(self.payload_cap)
        self._stride = stride
        self._seg = shm_native._FallbackSegment(
            region_path(job), _BUF0_OFF + 2 * stride)
        self._publishes = 0  # this process's publish ordinal (chaos)
        self._attach()

    # -- attach / repair ---------------------------------------------------

    def _attach(self) -> None:
        mm = self._seg._mm
        magic, layout = struct.unpack_from("<II", mm, 0)
        if magic != SERVE_MAGIC:
            # fresh region: no committed version yet
            _HEAD.pack_into(mm, 0, SERVE_MAGIC, SERVE_LAYOUT, 0,
                            0, 0, 0, 0, 0, self.payload_cap)
            return
        if layout != SERVE_LAYOUT:
            raise ValueError(f"serve region layout {layout} "
                             f"(want {SERVE_LAYOUT})")
        cap = struct.unpack_from("<Q", mm, 48)[0]
        if cap != self.payload_cap:
            raise ValueError(
                f"serve region payload capacity {cap} != {self.payload_cap}"
                " (one region, one tensor shape — recreate the job)")
        head_seq = struct.unpack_from("<Q", mm, 8)[0]
        if head_seq % 2 == 1:
            self._repair()

    def _repair(self) -> None:
        """A predecessor died mid-flip: rebuild the header from the
        newest WHOLE buffer (rollback) and make the seq even again."""
        mm = self._seg._mm
        best = None  # (version, index, epoch, step)
        for b in (0, 1):
            off = _BUF0_OFF + b * self._stride
            (seq, ver, nbytes, crc, ndim, d0, d1, d2, d3,
             dt) = _BUF.unpack_from(mm, off)
            if seq % 2 == 1 or ver == 0:
                continue
            if best is None or ver > best[0]:
                best = (ver, b)
        head_seq = struct.unpack_from("<Q", mm, 8)[0] + 1  # -> even
        if best is None:
            _HEAD.pack_into(mm, 0, SERVE_MAGIC, SERVE_LAYOUT, head_seq,
                            0, 0, 0, 0, 0, self.payload_cap)
            return
        ver, b = best
        epoch, step = struct.unpack_from("<QQ", mm, 32)
        struct.pack_into("<Q", mm, 8, head_seq - 1)  # stay odd while...
        struct.pack_into("<IIQ", mm, 16, b, 0, ver)  # ...fields rewrite
        struct.pack_into("<QQ", mm, 32, epoch, step)
        struct.pack_into("<Q", mm, 8, head_seq)

    # -- the committed word ------------------------------------------------

    @property
    def version(self) -> int:
        """The committed version word (0 = nothing published yet)."""
        return struct.unpack_from("<Q", self._seg._mm, 16 + 8)[0]

    # -- publish -----------------------------------------------------------

    def publish(self, tensor, *, version: Optional[int] = None,
                epoch: int = 0, step: int = 0) -> int:
        """Double-buffered seqlock'd publish of an ndarray or a torch
        tensor; returns the committed version.  ``version=None`` continues
        the persisted sequence (strictly monotone across publisher
        restarts)."""
        from bluefog_tpu_torch.resilience import chaos as _chaos

        mm = self._seg._mm
        arr = np.ascontiguousarray(_staging.stage(tensor, "#serve"))
        raw = arr.tobytes()
        if len(raw) > self.payload_cap:
            raise ValueError(f"snapshot {len(raw)} B over the region's "
                             f"payload capacity {self.payload_cap} B")
        if arr.ndim > _MAX_DIMS:
            raise ValueError(f"snapshot ndim {arr.ndim} > {_MAX_DIMS}")
        cur = self.version
        if version is None:
            version = cur + 1
        elif version <= cur:
            raise ValueError(f"version {version} not past the committed "
                             f"{cur} (the word is strictly monotone)")
        self._publishes += 1
        chaos_publish = self._publishes == _pub_kill_publish()
        active = struct.unpack_from("<I", mm, 16)[0]
        b = 1 - (active & 1)
        off = _BUF0_OFF + b * self._stride
        # standby buffer seqlock: odd (a predecessor may have left it
        # odd already — both parities land on odd here)
        bseq = struct.unpack_from("<Q", mm, off)[0]
        bseq += 1 if bseq % 2 == 0 else 2
        struct.pack_into("<Q", mm, off, bseq)
        dims = list(arr.shape) + [0] * (_MAX_DIMS - arr.ndim)
        if chaos_publish and _pub_kill_phase() == "payload":
            # die with the standby buffer torn: half the payload bytes
            # landed, the seq is odd, the header still names the old
            # buffer — every reader stays on the committed version
            mm[off + 64:off + 64 + max(1, len(raw) // 2)] = \
                raw[:max(1, len(raw) // 2)]
            _chaos.kill_self()
        mm[off + 64:off + 64 + len(raw)] = raw
        _BUF.pack_into(mm, off, bseq, version, len(raw),
                       zlib.crc32(raw) & 0xFFFFFFFF, arr.ndim,
                       *dims, _dtype_name(arr.dtype))
        struct.pack_into("<Q", mm, off, bseq + 1)  # buffer whole
        if chaos_publish and _pub_kill_phase() == "flip":
            # die between the payload commit and the header flip: the
            # standby buffer is whole but UNCOMMITTED — rollback to A
            _chaos.kill_self()
        hseq = struct.unpack_from("<Q", mm, 8)[0]
        hseq += 1 if hseq % 2 == 0 else 2
        struct.pack_into("<Q", mm, 8, hseq)           # header odd
        struct.pack_into("<IIQ", mm, 16, b, 0, version)
        struct.pack_into("<QQ", mm, 32, int(epoch), int(step))
        struct.pack_into("<Q", mm, 8, hseq + 1)       # header even
        return int(version)

    def close(self, unlink: bool = False) -> None:
        self._seg.close(unlink)


def _decode_buffer(buf: bytes, off: int, want_version: int
                   ) -> Tuple[np.ndarray, Dict[str, int]]:
    (seq, ver, nbytes, crc, ndim, d0, d1, d2, d3,
     dt) = _BUF.unpack_from(buf, off)
    if seq % 2 == 1:
        raise TornSnapshotError("buffer seq odd (write in flight)")
    if ver != want_version:
        raise TornSnapshotError(
            f"buffer version {ver} != committed {want_version}")
    raw = buf[off + 64:off + 64 + nbytes]
    if len(raw) < nbytes:
        raise TornSnapshotError("buffer payload truncated")
    if zlib.crc32(raw) & 0xFFFFFFFF != crc:
        raise TornSnapshotError("payload crc mismatch (torn mix)")
    dtype = _dtype_of(dt)
    dims = [d0, d1, d2, d3][:ndim]
    arr = np.frombuffer(raw, dtype=dtype).reshape(dims).copy()
    return arr, {"seq": seq, "nbytes": nbytes}


def read_committed(job: str, retries: int = 8
                   ) -> Tuple[int, int, int, np.ndarray]:
    """Seqlock reader: returns ``(version, epoch, step, tensor)`` of
    the committed snapshot.  Two whole-region reads bracket the header
    and active-buffer seqs — accept iff both are even and identical
    across the bracket (the status-page protocol, double-buffered).

    Raises :class:`SnapshotUnavailable` when the region does not exist
    or nothing is committed yet, :class:`TornSnapshotError` when it
    never settles (publisher mid-publish — the caller keeps serving
    its in-memory copy)."""
    path = region_path(job)
    err: Optional[Exception] = None
    for _ in range(max(1, retries)):
        try:
            with open(path, "rb") as f:
                buf1 = f.read()
        except OSError:
            raise SnapshotUnavailable(f"no serve region for job {job!r}")
        if len(buf1) < _BUF0_OFF:
            raise SnapshotUnavailable(f"serve region {path} truncated")
        (magic, layout, hseq, active, _pad, version, epoch, step,
         cap) = _HEAD.unpack_from(buf1, 0)
        if magic != SERVE_MAGIC:
            raise SnapshotUnavailable(
                f"not a serve region (magic 0x{magic:08x})")
        if version == 0:
            raise SnapshotUnavailable(
                f"serve region {path}: nothing committed yet")
        if hseq % 2 == 0:
            try:
                stride = _buf_stride(cap)
                off = _BUF0_OFF + (active & 1) * stride
                arr, meta = _decode_buffer(buf1, off, version)
                with open(path, "rb") as f:
                    buf2 = f.read(off + 8)
                hseq2 = struct.unpack_from("<Q", buf2, 8)[0]
                bseq2 = struct.unpack_from("<Q", buf2, off)[0]
                if hseq2 == hseq and bseq2 == meta["seq"]:
                    return int(version), int(epoch), int(step), arr
                err = TornSnapshotError("seq moved across the bracket")
            except TornSnapshotError as e:
                err = e
        else:
            err = TornSnapshotError(f"header seq odd ({hseq})")
        time.sleep(0.001)
    raise TornSnapshotError(
        f"serve region {path} torn across retries: {err}")
