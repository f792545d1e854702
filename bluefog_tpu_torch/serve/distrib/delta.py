"""Delta publication: per-chunk dirty tracking over the wire codec.

The publisher chunks the committed snapshot, encodes every chunk with
the PR-11 wire codec (``BFTPU_WIRE_DTYPE``: f32 | bf16 | int8) and
keeps, per chunk, the version that last changed its **decoded** bytes
— the dirty map.  A subscriber at version ``v`` receives only chunks
whose last-modified version exceeds ``v``; one whose lag exceeds the
dirty-map horizon (``BFTPU_DISTRIB_HORIZON``) degrades to a
full-buffer resync instead of a near-total delta.

Lossy codecs stay honest the same way the gossip path does: the
quantization error folds into the next publish (the error-feedback
residual, held per chunk on the publisher), so repeated deltas are
lossless-in-the-limit.  What the fleet distributes is therefore the
**canonical wire-state** ``W = decode(encode(x + residual))`` — every
node that applies a delta holds bit-identical decoded bytes, and the
commit frame carries a CRC32 of the full canonical buffer so a
subscriber proves bit-identity before flipping.  Relays never
re-encode: they store and forward the encoded chunk payloads, so the
canonical bytes are decided exactly once, at the publisher.

``ChunkStore`` is the one datastructure every node holds — publisher,
relay, leaf.  Its state is a single atomically-swapped reference
(meta + chunk map), so a relay's feed threads serve a committed
generation while the subscriber side stages the next one.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.native import wire_codec as _wc

__all__ = [
    "ChunkMeta",
    "ChunkStore",
    "DeltaEncoder",
    "distrib_fanout",
    "distrib_horizon",
    "distrib_chunk_kb",
    "distrib_timeout_s",
    "distrib_retries",
]


def distrib_fanout() -> int:
    """``BFTPU_DISTRIB_FANOUT``: max children per tree node (>=1)."""
    try:
        return max(1, int(os.environ.get("BFTPU_DISTRIB_FANOUT", "4")))
    except ValueError:
        return 4


def distrib_horizon() -> int:
    """``BFTPU_DISTRIB_HORIZON``: max versions of lag served as a
    delta; beyond it the subscriber gets a full-buffer resync."""
    try:
        return max(1, int(os.environ.get("BFTPU_DISTRIB_HORIZON", "8")))
    except ValueError:
        return 8


def distrib_chunk_kb() -> int:
    """``BFTPU_DISTRIB_CHUNK_KB``: dirty-tracking granularity."""
    try:
        return max(1, int(os.environ.get("BFTPU_DISTRIB_CHUNK_KB", "64")))
    except ValueError:
        return 64


def distrib_timeout_s() -> float:
    """``BFTPU_DISTRIB_TIMEOUT_S``: per-socket-op timeout on feed
    edges (parent death is detected as timeouts, then re-parented)."""
    try:
        return float(os.environ.get("BFTPU_DISTRIB_TIMEOUT_S", "5.0"))
    except ValueError:
        return 5.0


def distrib_retries() -> int:
    """``BFTPU_DISTRIB_RETRIES``: full-jitter attempts against the
    current parent before requesting a re-parent."""
    try:
        return max(1, int(os.environ.get("BFTPU_DISTRIB_RETRIES", "3")))
    except ValueError:
        return 3


class ChunkMeta(tuple):
    """Immutable commit metadata: one committed generation of the
    store.  A plain tuple subclass so it hashes/compares structurally
    and rides queues without pickling surprises."""

    __slots__ = ()

    def __new__(cls, version: int, epoch: int, step: int, nchunks: int,
                shape: Tuple[int, ...], dtype: str, crc: int):
        return tuple.__new__(cls, (int(version), int(epoch), int(step),
                                   int(nchunks), tuple(shape),
                                   str(dtype), int(crc)))

    def __getnewargs__(self):
        return (self[0], self[1], self[2], self[3], self[4], self[5],
                self[6])

    version = property(lambda s: s[0])
    epoch = property(lambda s: s[1])
    step = property(lambda s: s[2])
    nchunks = property(lambda s: s[3])
    shape = property(lambda s: s[4])
    dtype = property(lambda s: s[5])
    crc = property(lambda s: s[6])


#: one stored chunk: (lastmod version, wire code, payload bytes, scale)
Chunk = Tuple[int, int, bytes, float]


class ChunkStore:
    """Every node's copy of the canonical wire-state, one atomically
    swapped ``(meta, chunks)`` reference — feed threads snapshot it,
    the subscriber installs a fully staged generation on top."""

    def __init__(self):
        self._snap: Tuple[Optional[ChunkMeta], Dict[int, Chunk]] = \
            (None, {})
        self._decoded: Tuple[int, Optional[np.ndarray]] = (0, None)

    # -- readers (feed threads, replica) ------------------------------------

    def snap(self) -> Tuple[Optional[ChunkMeta], Dict[int, Chunk]]:
        return self._snap

    @property
    def version(self) -> int:
        meta, _ = self._snap
        return meta.version if meta is not None else 0

    def delta_since(self, have: int, horizon: Optional[int] = None
                    ) -> Tuple[bool, List[Tuple[int, Chunk]], ChunkMeta]:
        """What a subscriber at version ``have`` needs to reach the
        head: ``(full, [(idx, chunk)...], meta)``.  ``full`` is True
        on the resync path — subscriber at 0, ahead of us (a previous
        publisher incarnation's head), or lagging past the horizon."""
        meta, chunks = self._snap
        if meta is None:
            raise ValueError("store holds no committed generation")
        h = distrib_horizon() if horizon is None else max(1, int(horizon))
        full = (have <= 0 or have > meta.version
                or meta.version - have > h)
        if not full and have == meta.version:
            return False, [], meta
        items = sorted(chunks.items())
        if not full:
            items = [(i, c) for i, c in items if c[0] > have]
        return full, items, meta

    def decode(self) -> Tuple[ChunkMeta, np.ndarray]:
        """The canonical array for the committed generation (cached
        per version — decode is deterministic, so every node's bytes
        for a version are identical by construction)."""
        meta, chunks = self._snap
        if meta is None:
            raise ValueError("store holds no committed generation")
        ver, arr = self._decoded
        if arr is not None and ver == meta.version:
            return meta, arr
        arr = decode_store(meta, chunks)
        self._decoded = (meta.version, arr)
        return meta, arr

    # -- writer (subscriber / publisher) ------------------------------------

    def install(self, meta: ChunkMeta, chunks: Dict[int, Chunk], *,
                full: bool, verify: bool = True) -> np.ndarray:
        """Stage + flip one generation.  ``chunks`` is the delta (or
        the whole buffer when ``full``); the staged map is checked
        against ``meta`` (chunk count and canonical CRC) BEFORE the
        flip, so a bad generation never becomes servable."""
        _, cur = self._snap
        staged = dict(chunks) if full else {**cur, **chunks}
        if len(staged) != meta.nchunks:
            raise ValueError(
                f"staged generation v{meta.version} has {len(staged)} "
                f"chunks, commit says {meta.nchunks} — "
                f"{'full' if full else 'delta'} stream incomplete")
        arr = decode_store(meta, staged)
        if verify:
            crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if crc != meta.crc:
                raise ValueError(
                    f"canonical CRC mismatch at v{meta.version}: "
                    f"got {crc:#010x}, commit says {meta.crc:#010x}")
        self._snap = (meta, staged)
        self._decoded = (meta.version, arr)
        return arr


def _payload_elems(code: int, payload: bytes, dtype: np.dtype) -> int:
    """Element count a chunk's encoded payload carries."""
    if code == _wc.WIRE_BF16:
        return len(payload) // 2
    if code == _wc.WIRE_INT8:
        return len(payload)
    return len(payload) // max(1, dtype.itemsize)


def decode_store(meta: ChunkMeta, chunks: Dict[int, Chunk]) -> np.ndarray:
    """Concatenate-decode a full chunk map back to the canonical
    array (deterministic: payload + code + scale decide every byte).

    The chunk granularity is derived from chunk 0's own payload, NOT
    from this host's ``BFTPU_DISTRIB_CHUNK_KB`` — the publisher
    decides the geometry, and a subscriber with a drifted env must
    still decode the stream it was sent."""
    dtype = np.dtype(meta.dtype)
    total = int(np.prod(meta.shape)) if meta.shape else 1
    per = total
    if meta.nchunks > 1:
        _, code0, payload0, _ = chunks[0]
        per = max(1, _payload_elems(code0, payload0, dtype))
    parts = []
    for i in range(meta.nchunks):
        lastmod, code, payload, scale = chunks[i]
        count = min(per, total - i * per)
        parts.append(_wc.decode_chunk(payload, code, scale, dtype, count))
    flat = np.concatenate(parts) if parts else np.empty(0, dtype)
    return flat.reshape(meta.shape)


def _chunk_elems(dtype: np.dtype) -> int:
    return max(1, (distrib_chunk_kb() * 1024) // max(1, dtype.itemsize))


class DeltaEncoder:
    """Publisher-side: snapshot in, dirty-tracked canonical chunks out.

    Holds the per-chunk error-feedback residuals (sender-side, exactly
    like the gossip edges) and the previous canonical bytes per chunk
    so an unchanged chunk keeps its last-modified version — the dirty
    map.  ``publish()`` installs the new generation into ``store``."""

    def __init__(self, store: Optional[ChunkStore] = None):
        self.store = store if store is not None else ChunkStore()
        self._residual: Dict[int, np.ndarray] = {}
        self.published = 0

    def publish(self, version: int, epoch: int, step: int,
                arr: np.ndarray) -> ChunkMeta:
        x = np.ascontiguousarray(arr)
        flat = x.reshape(-1)
        dtype = flat.dtype
        per = _chunk_elems(dtype)
        n = max(1, -(-flat.size // per)) if flat.size else 1
        code = _wc.wire_code()
        _, prev = self.store.snap()
        chunks: Dict[int, Chunk] = {}
        dirty = 0
        for i in range(n):
            seg = flat[i * per:(i + 1) * per]
            if dtype.kind == "f" and code != _wc.WIRE_RAW:
                r = self._residual.get(i)
                buf = seg + r if r is not None else seg.copy()
            else:
                buf = seg
            used, payload, scale = _wc.encode_chunk(buf, code)
            payload = bytes(payload)
            if dtype.kind == "f" and code != _wc.WIRE_RAW:
                dec = _wc.decode_chunk(payload, used, scale, dtype,
                                       seg.size)
                self._residual[i] = buf - dec
            old = prev.get(i)
            if (old is not None and old[1] == used and old[3] == scale
                    and old[2] == payload):
                chunks[i] = old  # clean: keep its lastmod version
            else:
                chunks[i] = (int(version), used, payload, float(scale))
                dirty += 1
        for i in list(self._residual):
            if i >= n:
                del self._residual[i]
        crc_arr = decode_store(
            ChunkMeta(version, epoch, step, n, x.shape, dtype.str, 0),
            chunks)
        crc = zlib.crc32(crc_arr.tobytes()) & 0xFFFFFFFF
        meta = ChunkMeta(version, epoch, step, n, x.shape, dtype.str,
                         crc)
        self.store.install(meta, chunks, full=True, verify=False)
        self.published += 1
        self.last_dirty = dirty
        return meta
