"""Flash attention: hand-written CUDA kernels for Hopper, with plain versions.

Counterpart of ``bluefog_tpu/kernels/flash_attention.py``.  The TPU package
has three Pallas kernels, which serve bf16 and f32 inputs; each has two CUDA
C++ instances here, built by :mod:`._build`: a bf16 one
(``csrc/flash_attention.cu``) and an f32 one (``csrc/flash_attention_f32.cu``):

=============  =======================================  ===================
wrapper        replaces                                 plain version
=============  =======================================  ===================
``flash_fwd``  ``_fwd_kernel`` (:246)                   ``flash_fwd_plain``
``flash_dkv``  ``_bwd_dkv_kernel`` (:490)               ``flash_dkv_plain``
``flash_dq``   ``_bwd_dq_kernel`` (:575)                ``flash_dq_plain``
=============  =======================================  ===================

The bf16 kernels are built for Hopper (``wgmma`` products, TMA-fed tile
rings, 128-row blocks of two consumer warpgroups, launched longest chain
first); :func:`launch_order` says which 64 x 64 tiles each block of a
launch computes, in the order the card is handed the blocks.  The three
f32 kernels run f32-accurate products on the tensor cores: every operand
is split into a TF32 part and the rest (:func:`split_tf32` is the split in
plain torch, for the tests), and a.b is three TF32 products (small.big +
big.small + big.big, the dropped small.small below 2^-22 |a||b|), on
``mma.sync`` with TMA-fed tile rings, one warp a 16-row slab.  No f32
kernel rounds p or dS to a narrower type, as the reference does not for
f32 inputs.

Every wrapper takes ``[BH, T, D]`` tensors (``lse``/``corr`` ``[BH, Tq]``
f32).  On a CUDA tensor it checks device, dtype (q, k, v and dO all bf16 or
all f32), shape and contiguity, launches the kernel of that dtype on the
current stream and adds one to its count in :data:`launches` (bf16) or
:data:`launches_f32` (f32).  The kernels are built for D = 64 and 128; a
head dim up to 128 runs zero-padded to the next of those
(:func:`pad_head_dim`), and a larger one raises.  On a CPU tensor it runs
its plain version, the blockwise recompute of the JAX package's XLA routes
(``_blockwise_fwd_xla`` :411 and ``_blockwise_bwd`` :729, split into dK/dV
and dQ) with the kernels' rounding points.  There is no fallback from one to the other.

Causal masking uses global positions (``q_start``/``k_start``), so one call
serves plain attention and one ring-attention hop; rows with no visible key
return o = 0 and lse = -1e30.  The lse output is differentiable: its
cotangent folds into dS through ``corr = g_lse - rowsum(o * dO)``, computed
here in plain torch, as the JAX package computes it outside its kernels.

The public functions take the reference's ``impl``: ``"auto"``,
``"pallas"`` and ``"cuda"`` select the kernels above (their plain versions
on CPU tensors); ``"xla"`` selects the blockwise route, the twin of the
reference's ``_blockwise_fwd_xla`` and ``_blockwise_bwd`` in plain torch ops
on any device (:func:`blockwise_fwd`, :func:`blockwise_bwd`), blocked over
``block_k`` by the reference's rules.  The blockwise route is never a
default and never a fallback, and launches no kernel.  On the kernel route
the tile is fixed when the kernels are built, so ``block_q`` / ``block_k``
other than that tile raise (``bluefog_tpu_torch.benchmarks.flash_variants``
times other builds); ``interpret=True`` raises: the tensors' device picks
the CPU route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, Tuple

import torch

from bluefog_tpu_torch.kernels import _build

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "make_flash_attention_fn",
    "flash_fwd",
    "flash_dkv",
    "flash_dq",
    "flash_fwd_plain",
    "flash_dkv_plain",
    "flash_dq_plain",
    "blockwise_fwd",
    "blockwise_bwd",
    "blockwise_route",
    "key_blocks",
    "fit_block",
    "launches",
    "launches_f32",
    "reset_launches",
    "occupancy",
    "launch_order",
    "pad_head_dim",
    "split_tf32",
]

_NEG_INF = -1e30  # finite mask sentinel (real scores can never reach it)
_MASK_THRESH = -0.5e30
_BLOCK = 64  # the kernels' tile; the plain versions step over keys likewise
_HEAD_DIMS = (64, 128)  # the head dims the kernels are built for
_BLOCK_ROWS = 128  # rows a block owns: two consumer warpgroups of 64
_KERNEL_IMPLS = ("auto", "pallas", "cuda")  # the kernel route's names
_MAX_UNROLL = 64  # the blockwise route's triangular branch unrolls at most this many blocks

# Kernel launches per wrapper since the last reset_launches(), of the bf16
# kernels and of the f32 kernels.  Only a launch of a CUDA kernel counts; a
# plain-version call does not.
launches: Dict[str, int] = {"fwd": 0, "dkv": 0, "dq": 0}
launches_f32: Dict[str, int] = {"fwd": 0, "dkv": 0, "dq": 0}


def reset_launches() -> None:
    for counts in (launches, launches_f32):
        for name in counts:
            counts[name] = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions (f32 math on the given inputs)
# --------------------------------------------------------------------------


def _mask(s, q_start, k_start, j0, causal):
    """Apply the global-position causal mask to a [BH, Tq, bk] score block
    whose first key is local index j0."""
    if not causal:
        return s
    tq, bk = s.shape[1], s.shape[2]
    qpos = q_start + torch.arange(tq, device=s.device)
    kpos = k_start + j0 + torch.arange(bk, device=s.device)
    return s.masked_fill(kpos[None, None, :] > qpos[None, :, None], _NEG_INF)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` of f32 ``x`` as the f32 kernels split an operand:
    ``big`` is ``x`` rounded to nearest, ties away from zero, at TF32's 10
    mantissa bits (``cvt.rna.tf32.f32``), ``small = x - big``, exact in
    f32.  Used by the tests, which emulate the kernels'
    products with it; the kernels split on the card."""
    bits = x.float().contiguous().view(torch.int32)
    # adding half a TF32 step to the sign-magnitude pattern rounds the
    # magnitude, ties away from zero; the mask drops the 13 low bits
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, x.float() - big


def flash_fwd_plain(q, k, v, q_start: int = 0, k_start: int = 0, *,
                    scale: float, causal: bool,
                    bmm: Callable = torch.bmm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax blockwise forward: ``(o [BH,Tq,D] in q.dtype,
    lse [BH,Tq] f32)``.  ``bmm`` computes every product (the tests pass an
    emulation of the kernels' TF32 split)."""
    bh, tq, d = q.shape
    qf = q.float()
    o = torch.zeros(bh, tq, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, tq, 1, dtype=torch.float32, device=q.device)
    for j0 in range(0, k.shape[1], _BLOCK):
        kb, vb = k[:, j0:j0 + _BLOCK], v[:, j0:j0 + _BLOCK]
        s = _mask(bmm(qf, kb.float().transpose(1, 2)) * scale,
                  q_start, k_start, j0, causal)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # fully-masked rows: m_new is the sentinel and exp(0) would be 1
        p = torch.where(s > _MASK_THRESH, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + bmm(p.to(v.dtype).float(), vb.float())
        m = m_new
    out = (o / l.clamp_min(1e-30)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse


def _recompute(q, k, v, g, lse, corr, q_start, k_start, j0, *, scale, causal,
               bmm=torch.bmm):
    """(p, ds) for the key block starting at j0: p = exp(s - lse) with
    masked entries 0, ds = p * (g.v^T + corr) rounded to q's dtype."""
    kb, vb = k[:, j0:j0 + _BLOCK], v[:, j0:j0 + _BLOCK]
    s = _mask(bmm(q.float(), kb.float().transpose(1, 2)) * scale,
              q_start, k_start, j0, causal)
    p = torch.exp(torch.where(s > _MASK_THRESH, s - lse[..., None], _NEG_INF))
    dp = bmm(g.float(), vb.float().transpose(1, 2))
    ds = (p * (dp + corr[..., None])).to(q.dtype)
    return p, ds


def flash_dkv_plain(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0,
                    *, scale: float, causal: bool,
                    bmm: Callable = torch.bmm) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` by per-key-block recompute from lse; ``bmm`` as in
    :func:`flash_fwd_plain`."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for j0 in range(0, k.shape[1], _BLOCK):
        p, ds = _recompute(q, k, v, g, lse, corr, q_start, k_start, j0,
                           scale=scale, causal=causal, bmm=bmm)
        dv[:, j0:j0 + _BLOCK] = bmm(
            p.to(g.dtype).float().transpose(1, 2), g.float()).to(v.dtype)
        dk[:, j0:j0 + _BLOCK] = (bmm(
            ds.float().transpose(1, 2), q.float()) * scale).to(k.dtype)
    return dk, dv


def flash_dq_plain(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0,
                   *, scale: float, causal: bool,
                   bmm: Callable = torch.bmm) -> torch.Tensor:
    """``dQ`` by per-key-block recompute from lse; ``bmm`` as in
    :func:`flash_fwd_plain`."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, k.shape[1], _BLOCK):
        _, ds = _recompute(q, k, v, g, lse, corr, q_start, k_start, j0,
                           scale=scale, causal=causal, bmm=bmm)
        acc += bmm(ds.float(), k[:, j0:j0 + _BLOCK].float())
    return (acc * scale).to(q.dtype)


# --------------------------------------------------------------------------
# The blockwise route (impl="xla"): the reference's XLA twin in plain torch
# --------------------------------------------------------------------------


def fit_block(t: int, b: int) -> int:
    """The reference's ``_fit_block``: the largest power-of-two shrink of
    ``b`` (capped at ``t``) that divides ``t``; below 8 (and not ``t``
    itself) raises."""
    b = min(b, t)
    while t % b and b > 1:
        b = max(b // 2, 1)
    if b < 8 and b < t:
        raise ValueError(f"no block size >= 8 divides sequence length {t} (best fit {b}); "
                         f"pad the sequence/shard to a multiple of 8")
    return b


def _triangular(causal, tri_delta, tq, tk, num_k) -> bool:
    """The reference's ``_use_triangular``: offsets with a small key-ahead
    delta, square shapes, at most ``_MAX_UNROLL`` blocks."""
    return causal and tri_delta is not None and tq == tk and num_k <= _MAX_UNROLL


def _tri_mask(rows, block_k, delta, device):
    """Visible iff col + delta <= row, for q rows starting at the k block."""
    return (torch.arange(rows, device=device)[:, None]
            >= torch.arange(block_k, device=device)[None, :] + delta)


def key_blocks(tq: int, tk: int, block_k=None) -> Tuple[int, int]:
    """``(block, count)`` of the blockwise route's key blocks: ``block_k``,
    or the reference's ``_default_blocks`` choice (1024 where the longer
    sequence is at least 2048, else 512), fitted to ``tk``."""
    block_k = fit_block(tk, block_k or (1024 if max(tq, tk) >= 2048 else 512))
    return block_k, tk // block_k


def blockwise_fwd(q, k, v, q_start: int = 0, k_start: int = 0, *, scale: float,
                  causal: bool, block_k=None, tri_delta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [BH,Tq,D] in q.dtype, lse [BH,Tq] f32)`` by the reference's
    ``_blockwise_fwd_xla``: the online-softmax recurrence over key blocks
    of ``block_k`` (:func:`key_blocks`), products of the
    inputs' values accumulated in f32, p rounded to v's dtype before P.V.
    With ``tri_delta`` (key-ahead delta of square, causal inputs) and at
    most 64 blocks it runs the triangular branch, where key block ``j``
    touches only the query rows from ``j * block_k`` on; else the general
    branch, masked on global positions."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    block_k, num_k = key_blocks(tq, tk, block_k)
    qf = q.float()
    o = torch.zeros(bh, tq, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, tq, 1, dtype=torch.float32, device=q.device)
    tri = _triangular(causal, tri_delta, tq, tk, num_k)
    for j in range(num_k):
        j0 = j * block_k
        r0 = j0 if tri else 0  # the triangular branch skips rows above the block
        kb, vb = k[:, j0:j0 + block_k].float(), v[:, j0:j0 + block_k].float()
        s = torch.bmm(qf[:, r0:], kb.transpose(1, 2)) * scale
        if tri:
            s = torch.where(_tri_mask(tq - r0, block_k, tri_delta, q.device)[None], s, _NEG_INF)
        else:
            s = _mask(s, q_start, k_start, j0, causal)
        m_new = torch.maximum(m[:, r0:], s.amax(-1, keepdim=True))
        alpha = torch.exp(m[:, r0:] - m_new)
        p = torch.exp(s - m_new)  # masked entries underflow to 0...
        if (tri and tri_delta) or (not tri and causal):
            # ...except on fully-masked rows, where m_new is the sentinel
            p = torch.where(s > _MASK_THRESH, p, 0.0)
        l[:, r0:] = l[:, r0:] * alpha + p.sum(-1, keepdim=True)
        o[:, r0:] = o[:, r0:] * alpha + torch.bmm(p.to(v.dtype).float(), vb)
        m[:, r0:] = m_new
    out = (o / l.clamp_min(1e-30)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse


def blockwise_bwd(q, k, v, o, lse, g, g_lse, q_start: int = 0, k_start: int = 0, *,
                  scale: float, causal: bool, block_k=None,
                  tri_delta=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` by the reference's ``_blockwise_bwd``: per key
    block, p recomputed from lse, dV = p^T.dO (p in dO's dtype), dS = p *
    (dO.V^T + g_lse - rowsum(o * dO)) * scale rounded to q's dtype (the lse
    cotangent ``g_lse`` folds in as ``p * g_lse``), dQ += dS.K, dK = dS^T.Q.
    Branches and blocks as :func:`blockwise_fwd`."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    block_k, num_k = key_blocks(tq, tk, block_k)
    qf, gf = q.float(), g.float()
    delta = (o.float() * gf).sum(-1, keepdim=True)
    corr = g_lse.float()[..., None] - delta  # [BH, Tq, 1]
    tri = _triangular(causal, tri_delta, tq, tk, num_k)
    dq = torch.zeros(bh, tq, d, dtype=torch.float32, device=q.device)
    dk = torch.empty(bh, tk, d, dtype=torch.float32, device=q.device)
    dv = torch.empty(bh, tk, d, dtype=torch.float32, device=q.device)
    for j in range(num_k):
        j0 = j * block_k
        r0 = j0 if tri else 0
        kb, vb = k[:, j0:j0 + block_k].float(), v[:, j0:j0 + block_k].float()
        qj, gj = qf[:, r0:], gf[:, r0:]
        s = torch.bmm(qj, kb.transpose(1, 2)) * scale
        if tri:
            s = torch.where(_tri_mask(tq - r0, block_k, tri_delta, q.device)[None], s, _NEG_INF)
        else:
            s = _mask(s, q_start, k_start, j0, causal)
        p = torch.exp(s - lse[:, r0:, None])  # masked entries underflow to 0...
        if (tri and tri_delta) or (not tri and causal):
            # ...except on fully-masked rows, whose lse is the sentinel
            p = torch.where(s > _MASK_THRESH, p, 0.0)
        dv[:, j0:j0 + block_k] = torch.bmm(p.to(g.dtype).float().transpose(1, 2), gj)
        dp = torch.bmm(gj, vb.transpose(1, 2))
        ds = (p * (dp + corr[:, r0:]) * scale).to(q.dtype).float()
        dq[:, r0:] += torch.bmm(ds, kb)
        dk[:, j0:j0 + block_k] = torch.bmm(ds.transpose(1, 2), qj)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _lib():
    return bind(_build.load("flash_attention"))


@functools.lru_cache(maxsize=1)
def _lib_f32():
    return bind(_build.load("flash_attention_f32"), prefix="bf_flash_f32")


def bind(lib: ctypes.CDLL, prefix: str = "bf_flash") -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/flash_attention.cu``
    (``prefix`` "bf_flash") or ``csrc/flash_attention_f32.cu``
    ("bf_flash_f32"): ``<prefix>_fwd``, ``_bwd_dkv`` and ``_bwd_dq``, and
    the bf16 library's ``bf_flash_occupancy``."""
    fns = [getattr(lib, f"{prefix}_{name}") for name in ("fwd", "bwd_dkv", "bwd_dq")]
    for fn, n_ptr in zip(fns, (5, 8, 7)):
        fn.argtypes = [_P] * n_ptr + [_I] * 6 + [_F, _I, _P]
        fn.restype = ctypes.c_int
    if prefix == "bf_flash":
        lib.bf_flash_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.bf_flash_occupancy.restype = ctypes.c_int
    return lib


_DTYPES = (torch.bfloat16, torch.float32)  # the kernels' input types


def _kernel(dtype, name: str):
    """(C launcher, launch counts) of kernel ``name`` ("fwd", "bwd_dkv" or
    "bwd_dq") for inputs of ``dtype``."""
    if dtype == torch.bfloat16:
        return getattr(_lib(), f"bf_flash_{name}"), launches
    return getattr(_lib_f32(), f"bf_flash_f32_{name}"), launches_f32


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else raises."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on devices {sorted(types)}")


def _check(name, q, k, v, extra=(), f32=()):
    bh, tq, d = q.shape
    tk = k.shape[1]
    if d > _HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head dim {d} above {_HEAD_DIMS[-1]}, the largest "
                         f"the kernels take")
    if tq < 1 or tk < 1 or bh < 1 or d < 1:
        raise ValueError(f"{name}: empty input {tuple(q.shape)} / {tuple(k.shape)}")
    if k.shape != (bh, tk, d) or v.shape != (bh, tk, d):
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if any(x.shape != (bh, tq, d) for x in extra):
        raise ValueError(f"{name}: dO/o must have q's shape {tuple(q.shape)}")
    if any(x.shape != (bh, tq) for x in f32):
        raise ValueError(f"{name}: lse/corr must be [{bh}, {tq}]")
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take bf16 or float32, got {q.dtype}")
    for x in (k, v, *extra):
        if x.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v and dO must share one dtype, got "
                             f"{q.dtype} and {x.dtype}")
    for x in f32:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: lse/corr must be float32, got {x.dtype}")
    for x in (q, k, v, *extra, *f32):
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    return bh, tq, tk, d


_NO_ENCODER, _ENCODE_FAILED = -2, 10000  # csrc/sm90_tile.cuh


def _raise_on(name, err):
    if err == _NO_ENCODER:
        raise RuntimeError(f"{name}: the CUDA driver offers no cuTensorMapEncodeTiled")
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{name}: TMA tensor-map encode failed (CUresult "
                           f"{err - _ENCODE_FAILED})")
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def pad_head_dim(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every ``[BH, T, D]`` argument zero-padded
    in D to the next head dim the kernels are built for, and every
    ``[BH, T, D]`` result cut back to D.  Exact: the scale is an argument
    (the caller's, from the unpadded D), zero columns add nothing to
    q.k or dO.v, lse and corr do not depend on D, and the padded columns
    of o, dQ, dK and dV are zero.  A D that is built already, or above the
    largest, passes through unchanged."""
    d = args[0].shape[-1]
    kd = next((n for n in _HEAD_DIMS if n >= d), d)
    if kd == d:
        return fn(*args, **kwargs)

    def pad(x):
        if isinstance(x, torch.Tensor) and x.dim() == 3:
            return torch.nn.functional.pad(x, (0, kd - d))
        return x

    def cut(x):
        return x[..., :d].contiguous() if x.dim() == 3 else x

    out = fn(*(pad(x) for x in args), **kwargs)
    return tuple(cut(x) for x in out) if isinstance(out, tuple) else cut(out)


def flash_fwd(q, k, v, q_start: int = 0, k_start: int = 0, *, scale: float,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [BH,Tq,D], lse [BH,Tq] f32)``; the CUDA kernel for CUDA tensors,
    :func:`flash_fwd_plain` for CPU tensors."""
    if not _on_cuda(q, k, v):
        return flash_fwd_plain(q, k, v, q_start, k_start, scale=scale, causal=causal)
    _check("flash_fwd", q, k, v)
    return pad_head_dim(_launch_fwd, q, k, v, q_start, k_start, scale=scale, causal=causal)


def _launch_fwd(q, k, v, q_start, k_start, *, scale, causal):
    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    fn, counts = _kernel(q.dtype, "fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    counts["fwd"] += 1
    return o, lse


def flash_dkv(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0, *,
              scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``; ``g`` is dO, ``corr = g_lse - rowsum(o * dO)``."""
    if not _on_cuda(q, k, v, g, lse, corr):
        return flash_dkv_plain(q, k, v, g, lse, corr, q_start, k_start,
                               scale=scale, causal=causal)
    _check("flash_dkv", q, k, v, (g,), (lse, corr))
    return pad_head_dim(_launch_dkv, q, k, v, g, lse, corr, q_start, k_start,
                        scale=scale, causal=causal)


def _launch_dkv(q, k, v, g, lse, corr, q_start, k_start, *, scale, causal):
    bh, tq, d = q.shape
    tk = k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn, counts = _kernel(q.dtype, "bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), corr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_dkv", err)
    counts["dkv"] += 1
    return dk, dv


def flash_dq(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0, *,
             scale: float, causal: bool) -> torch.Tensor:
    """``dQ``; arguments as :func:`flash_dkv`."""
    if not _on_cuda(q, k, v, g, lse, corr):
        return flash_dq_plain(q, k, v, g, lse, corr, q_start, k_start,
                              scale=scale, causal=causal)
    _check("flash_dq", q, k, v, (g,), (lse, corr))
    return pad_head_dim(_launch_dq, q, k, v, g, lse, corr, q_start, k_start,
                        scale=scale, causal=causal)


def _launch_dq(q, k, v, g, lse, corr, q_start, k_start, *, scale, causal):
    bh, tq, d = q.shape
    tk = k.shape[1]
    dq = torch.empty_like(q)
    fn, counts = _kernel(q.dtype, "bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), corr.data_ptr(), dq.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_dq", err)
    counts["dq"] += 1
    return dq


_KERNEL_IDS = {"fwd": 0, "dkv": 1, "dq": 2}


def occupancy(kernel: str, d: int) -> Dict[str, int]:
    """How the card holds one flash kernel (``"fwd"``, ``"dkv"`` or
    ``"dq"``) at head dim ``d``, as its launcher launches it:
    ``blocks_per_sm`` (resident blocks per SM), ``smem`` (dynamic shared
    memory bytes per block), ``regs`` (registers per thread, as compiled;
    the Hopper kernels move registers from their producer to their
    consumers at run time) and ``threads`` (per block).  Needs the card."""
    out = (_I * 4)()
    err = _lib().bf_flash_occupancy(_KERNEL_IDS[kernel], int(d), out)
    _raise_on(f"occupancy({kernel}, {d})", err)
    return {"blocks_per_sm": out[0], "smem": out[1], "regs": out[2], "threads": out[3]}


def launch_order(kernel: str, tq: int, tk: int, q_start: int = 0, k_start: int = 0,
                 causal: bool = True, bh: int = 1) -> Tuple[List[Tuple[int, List]], int]:
    """The blocks of one launch of ``kernel`` over ``bh`` heads, in the
    order the card is handed them (x fastest): ``(blocks, rows)``.  Each
    block is ``(head, tiles)``, ``tiles`` the ``(query tile, key tile)``
    pairs of 64 x 64 tiles it computes, in the order it walks them;
    ``rows`` is the queries (fwd, dq) or keys (dkv) a block owns.

    Mirrors the launchers' index arithmetic in ``csrc/flash_attention.cu``:
    the forward's and dQ's grid is (head, query tile of 128 rows walked
    from the last), dK/dV's (head, key tile of 128 rows from the first), so
    the longest chains of every head come first.  A warpgroup's 64 rows
    skip the tiles they see nothing of, so every tile with a visible pair
    is computed once."""
    n_q, n_k = -(-tq // _BLOCK), -(-tk // _BLOCK)

    def visible(qi, kj):
        if not causal:
            return True
        return k_start + kj * _BLOCK <= q_start + min((qi + 1) * _BLOCK, tq) - 1

    def keys_reached(rows_end):  # key tiles a block walks, causal break
        q_last = q_start + min(rows_end, tq) - 1
        if not causal:
            return n_k
        return min(n_k, (q_last - k_start) // _BLOCK + 1 if q_last >= k_start else 0)

    if kernel not in launches:
        raise ValueError(f"launch_order: unknown kernel {kernel!r}")
    rows = _BLOCK_ROWS
    blocks = []
    if kernel in ("fwd", "dq"):
        n = -(-tq // rows)
        for y in range(n):
            tile = n - 1 - y
            slabs = [qi for qi in (2 * tile, 2 * tile + 1) if qi < n_q]
            for h in range(bh):
                blocks.append((h, [(qi, kj) for kj in range(keys_reached((tile + 1) * rows))
                                   for qi in slabs if visible(qi, kj)]))
    else:  # dkv
        n = -(-tk // rows)
        for tile in range(n):
            first = k_start + tile * rows - q_start
            it0 = 0 if not causal or first <= 0 else (n_q if first > tq - 1
                                                      else first // _BLOCK)
            slabs = [kj for kj in (2 * tile, 2 * tile + 1) if kj < n_k]
            for h in range(bh):
                blocks.append((h, [(qi, kj) for qi in range(it0, n_q)
                                   for kj in slabs if visible(qi, kj)]))
    return blocks, rows


# --------------------------------------------------------------------------
# Autograd and the public API
# --------------------------------------------------------------------------


class _FlashCore(torch.autograd.Function):
    """(o, lse) over folded ``[BH, T, D]`` inputs; the twin of the JAX
    package's ``_flash_core`` custom VJP.  ``blockwise`` selects the
    blockwise route (``impl="xla"``), with ``block_k`` and ``tri_delta``;
    otherwise the kernels run."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, k_start, scale, causal, blockwise, block_k, tri_delta):
        if blockwise:
            o, lse = blockwise_fwd(q, k, v, q_start, k_start, scale=scale, causal=causal,
                                   block_k=block_k, tri_delta=tri_delta)
        else:
            o, lse = flash_fwd(q, k, v, q_start, k_start, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (q_start, k_start, scale, causal, blockwise, block_k, tri_delta)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        q_start, k_start, scale, causal, blockwise, block_k, tri_delta = ctx.args
        g = g.contiguous()
        if blockwise:
            g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
            dq, dk, dv = blockwise_bwd(q, k, v, o, lse, g, g_lse, q_start, k_start,
                                       scale=scale, causal=causal, block_k=block_k,
                                       tri_delta=tri_delta)
        else:
            delta = (o.float() * g.float()).sum(-1)  # [BH, Tq]
            corr = -delta if g_lse is None else g_lse.float() - delta
            corr = corr.contiguous()
            dk, dv = flash_dkv(q, k, v, g, lse, corr, q_start, k_start,
                               scale=scale, causal=causal)
            dq = flash_dq(q, k, v, g, lse, corr, q_start, k_start,
                          scale=scale, causal=causal)
        return dq, dk, dv, None, None, None, None, None, None, None


def _fold(x):  # [B, T, H, D] -> [B*H, T, D]
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def blockwise_route(impl: str = "auto", block_q=None, block_k=None, interpret=None) -> bool:
    """True where ``impl`` selects the blockwise route (``"xla"``), False for
    the kernel route (``"auto"``, ``"pallas"``, ``"cuda"``); the reference's
    ``:915`` check for any other name, and the port's rules: on the kernel
    route ``block_q`` / ``block_k`` must be None or the built tile (128
    query rows a block, 64 keys a stage), and ``interpret=True`` raises on
    either route."""
    if impl not in _KERNEL_IMPLS + ("xla",):
        raise ValueError(f"impl must be auto/pallas/cuda/xla, got {impl!r}")
    if interpret:
        raise ValueError("interpret=True has no counterpart: the tensors' device picks the "
                         "route (the kernels on CUDA tensors, their plain versions on CPU "
                         "tensors)")
    if impl == "xla":
        return True
    for name, value, tile in (("block_q", block_q, _BLOCK_ROWS), ("block_k", block_k, _BLOCK)):
        if value is not None and value != tile:
            raise ValueError(
                f"{name}={value} on the kernel route (impl={impl!r}): the CUDA kernels' tile "
                f"is fixed when they are built ({name} {tile}); "
                f"bluefog_tpu_torch.benchmarks.flash_variants builds and times other tiles")
    return False


def flash_attention_with_lse(q, k, v, *, q_start: int = 0, k_start: int = 0,
                             causal: bool = True, block_q=None, block_k=None,
                             interpret=None, impl: str = "auto"):
    """``(out [B,T,H,D], lse [B,H,T] f32)`` for q, k, v of shape
    ``[B, T, H, D]``.  ``q_start``/``k_start`` are global sequence offsets
    for the causal mask.  Rows with no visible key give out = 0 and
    lse = -1e30.

    ``impl``: ``"auto"`` (the default), ``"pallas"`` or ``"cuda"`` run the
    kernels (their plain versions on CPU tensors); ``"xla"`` the blockwise
    route (:func:`blockwise_fwd`), which blocks on ``block_k`` alone, as
    the reference's does (``block_q`` is accepted and unused there).  See
    :func:`blockwise_route` for what raises.

    The offsets are host integers (converted with ``int()``), where the
    reference accepts traced ones: under ``shard_map`` each device's
    offset depends on ``lax.axis_index``, while in the rank-major form
    every rank's offset is known on the host, so a ring hop passes
    integers, one launch for the ranks that share them
    (:func:`bluefog_tpu_torch.parallel.ring_attention.hop_launches`), and
    the kernels read no offset from device memory.  As in the reference
    with host offsets, square inputs whose key offset is 0 to 8 ahead of
    the query offset take the blockwise route's triangular branch."""
    blockwise = blockwise_route(impl, block_q, block_k, interpret)
    b, tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q_start, k_start = int(q_start), int(k_start)
    tri_delta = (k_start - q_start if 0 <= k_start - q_start <= 8 and tq == k.shape[1]
                 else None)
    o, lse = _FlashCore.apply(_fold(q), _fold(k), _fold(v), q_start, k_start, scale,
                              bool(causal), blockwise, block_k, tri_delta)
    return o.reshape(b, h, tq, d).permute(0, 2, 1, 3), lse.reshape(b, h, tq)


def flash_attention(q, k, v, *, causal: bool = True, block_q=None, block_k=None,
                    interpret=None, impl: str = "auto"):
    """Exact attention, ``[B, T, H, D]`` layout; drop-in for
    :func:`bluefog_tpu_torch.models.transformer.dense_attention`.  The
    other arguments as :func:`flash_attention_with_lse`."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, block_q=block_q,
                                    block_k=block_k, interpret=interpret, impl=impl)
    return o


def make_flash_attention_fn(causal: bool = True, block_q=None, block_k=None,
                            interpret=None, impl: str = "auto") -> Callable:
    """``attention_fn`` for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`;
    the arguments are checked here, as :func:`blockwise_route` checks them."""
    blockwise_route(impl, block_q, block_k, interpret)
    return functools.partial(flash_attention, causal=causal, block_q=block_q,
                             block_k=block_k, interpret=interpret, impl=impl)
