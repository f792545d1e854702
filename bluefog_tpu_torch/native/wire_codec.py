"""Quantized wire codec for the chunked transport framing.

The classic decentralized-SGD bandwidth lever (Deep Gradient
Compression / EF-SGD; the upstream BlueFog paper's DCN story): gossip
tolerates aggressive per-edge quantization of the *values* as long as
(a) the quantization error is fed back into the next deposit (the
error-feedback residual, held per edge on the SENDER) and (b) the
push-sum mass ``p`` rides exact — only payload bytes are compressed,
so the telemetry mass ledger stays balanced by construction.

Wire dtypes (``BFTPU_WIRE_DTYPE``):

- ``f32`` (default) — raw window-dtype bytes, no compression (the name
  is historical: for f64 windows the raw path ships f64);
- ``bf16`` — round-to-nearest-even truncation of the f32 view to the
  high 16 bits (2 bytes/element; exact for bf16-representable values);
- ``int8`` — per-chunk max-abs scaling to [-127, 127] (1 byte/element;
  the scale rides the chunk frame header as an f64, computed in f64 so
  denormal and near-``FLT_MAX`` chunks neither overflow nor divide by
  zero).

A chunk whose values are not all finite is shipped RAW regardless of
the configured dtype (bf16 truncation can turn a NaN into an Inf and
an int8 max-abs scale of Inf would poison every element) — the
per-chunk wire code in the frame header makes mixed streams legal.

Conservation contract (model-checked by ``analysis/wire_rules.py``,
unit-tested in ``tests/test_wire.py``)::

    sum(inputs) == sum(delivered) + residual      -- at every step

which is exactly ``fold``/``settle`` below: ``buf = x + r`` is encoded,
and ``r' = buf - decode(encode(buf))``.  The residual must survive edge
demotion (a paused edge flushes it on the next deposit); it is dropped
only when the peer is declared dead (the edge no longer exists).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

__all__ = [
    "WIRE_RAW",
    "WIRE_BF16",
    "WIRE_INT8",
    "WIRE_CODES",
    "WIRE_NAMES",
    "wire_dtype",
    "wire_code",
    "encode_chunk",
    "decode_chunk",
]

# per-chunk wire codes, carried in the chunk frame header so every
# chunk of a stream may pick its own representation
WIRE_RAW = 0    # window-dtype bytes, scale unused
WIRE_BF16 = 1   # u16 high half of the f32 bits, scale unused
WIRE_INT8 = 2   # int8 with per-chunk f64 scale in the header

WIRE_CODES = {"f32": WIRE_RAW, "bf16": WIRE_BF16, "int8": WIRE_INT8}
WIRE_NAMES = {v: k for k, v in WIRE_CODES.items()}


def wire_dtype() -> str:
    """Configured wire dtype (``BFTPU_WIRE_DTYPE``: f32 | bf16 | int8;
    unknown values fall back to f32 so a typo degrades to correctness,
    not corruption)."""
    v = os.environ.get("BFTPU_WIRE_DTYPE", "f32").strip().lower()
    return v if v in WIRE_CODES else "f32"


def wire_code() -> int:
    return WIRE_CODES[wire_dtype()]


def _bf16_pack(xf: np.ndarray) -> np.ndarray:
    """f32 -> u16 high halves, round-to-nearest-even (the +0x7FFF + lsb
    carry trick; uint32 addition wraps are impossible for finite inputs
    because the exponent field never carries past the sign bit for
    |x| < 2**128 after rounding — non-finite chunks never reach here)."""
    u = np.ascontiguousarray(xf, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_unpack(payload, count: int) -> np.ndarray:
    u = np.frombuffer(payload, np.uint16, count=count).astype(np.uint32)
    return (u << 16).view(np.float32)


def encode_chunk(x: np.ndarray, code: int) -> Tuple[int, bytes, float]:
    """Encode ONE contiguous 1-D chunk of window-dtype values.

    Returns ``(code_used, payload, scale)``; ``code_used`` may downgrade
    to :data:`WIRE_RAW` (non-float window dtype, or a non-finite chunk).
    """
    if code != WIRE_RAW and x.dtype.kind == "f":
        xf = x.astype(np.float32, copy=False)
        if np.isfinite(xf).all():
            if code == WIRE_BF16:
                return WIRE_BF16, _bf16_pack(xf).tobytes(), 1.0
            # int8: max-abs scale in f64 — a denormal-f32 max would
            # round to zero as f32 and divide-by-zero; a near-FLT_MAX
            # max stays finite in f64
            m = float(np.max(np.abs(x)))
            if m == 0.0:
                return WIRE_INT8, b"\x00" * x.size, 0.0
            scale = m / 127.0
            q = np.clip(np.rint(x.astype(np.float64) / scale), -127, 127)
            return WIRE_INT8, q.astype(np.int8).tobytes(), scale
    return WIRE_RAW, _raw_bytes(x), 1.0


def _raw_bytes(x: np.ndarray):
    try:
        # zero-copy byte view (covers ml_dtypes arrays whose native
        # buffers can't export — same trick as the legacy write path)
        return np.ascontiguousarray(x).view(np.uint8).data
    except (TypeError, ValueError):
        return x.tobytes()


def decode_chunk(payload, code: int, scale: float, dtype,
                 count: int) -> np.ndarray:
    """Decode one chunk back to ``count`` window-dtype elements."""
    dtype = np.dtype(dtype)
    if code == WIRE_RAW:
        return np.frombuffer(payload, dtype, count=count)
    if code == WIRE_BF16:
        return _bf16_unpack(payload, count).astype(dtype, copy=False)
    if code == WIRE_INT8:
        q = np.frombuffer(payload, np.int8, count=count)
        return (q.astype(np.float64) * scale).astype(dtype, copy=False)
    raise ValueError(f"bad wire code {code}")
