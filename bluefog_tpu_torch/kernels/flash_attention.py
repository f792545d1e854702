"""Flash attention: hand-written CUDA kernels for Hopper, with plain versions.

Counterpart of ``bluefog_tpu/kernels/flash_attention.py``.  The TPU package
has three Pallas kernels; each has a CUDA C++ kernel here
(``csrc/flash_attention.cu``, built by :mod:`._build`):

=============  =======================================  ===================
wrapper        replaces                                 plain version
=============  =======================================  ===================
``flash_fwd``  ``_fwd_kernel`` (:246)                   ``flash_fwd_plain``
``flash_dkv``  ``_bwd_dkv_kernel`` (:490)               ``flash_dkv_plain``
``flash_dq``   ``_bwd_dq_kernel`` (:575)                ``flash_dq_plain``
=============  =======================================  ===================

All three kernels are built for Hopper (``wgmma`` products, TMA-fed tile
rings, 128-row blocks of two consumer warpgroups, launched longest chain
first).
:func:`launch_order` says which 64 x 64 tiles each block of a launch
computes, in the order the card is handed the blocks.

Every wrapper takes ``[BH, T, D]`` tensors (``lse``/``corr`` ``[BH, Tq]``
f32).  On a CUDA tensor it checks device, dtype, shape and contiguity,
launches its kernel on the current stream and adds one to its count in
:data:`launches`; on a CPU tensor it runs its plain version, the blockwise
recompute of the JAX package's XLA routes (``_blockwise_fwd_xla`` :411 and
``_blockwise_bwd`` :729, split into dK/dV and dQ) with the kernels'
rounding points.  There is no fallback from one to the other.

Causal masking uses global positions (``q_start``/``k_start``), so one call
serves plain attention and one ring-attention hop; rows with no visible key
return o = 0 and lse = -1e30.  The lse output is differentiable: its
cotangent folds into dS through ``corr = g_lse - rowsum(o * dO)``, computed
here in plain torch, as the JAX package computes it outside its kernels.
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
    "launches",
    "reset_launches",
    "occupancy",
    "launch_order",
]

_NEG_INF = -1e30  # finite mask sentinel (real scores can never reach it)
_MASK_THRESH = -0.5e30
_BLOCK = 64  # the kernels' tile; the plain versions step over keys likewise
_HEAD_DIMS = (64, 128)
_BLOCK_ROWS = 128  # rows a block owns: two consumer warpgroups of 64

# Kernel launches per wrapper since the last reset_launches().  Only a
# launch of the CUDA kernel counts; a plain-version call does not.
launches: Dict[str, int] = {"fwd": 0, "dkv": 0, "dq": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def flash_fwd_plain(q, k, v, q_start: int = 0, k_start: int = 0, *,
                    scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax blockwise forward: ``(o [BH,Tq,D] in q.dtype,
    lse [BH,Tq] f32)``."""
    bh, tq, d = q.shape
    qf = q.float()
    o = torch.zeros(bh, tq, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, tq, 1, dtype=torch.float32, device=q.device)
    for j0 in range(0, k.shape[1], _BLOCK):
        kb, vb = k[:, j0:j0 + _BLOCK], v[:, j0:j0 + _BLOCK]
        s = _mask(torch.bmm(qf, kb.float().transpose(1, 2)) * scale,
                  q_start, k_start, j0, causal)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # fully-masked rows: m_new is the sentinel and exp(0) would be 1
        p = torch.where(s > _MASK_THRESH, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.bmm(p.to(v.dtype).float(), vb.float())
        m = m_new
    out = (o / l.clamp_min(1e-30)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse


def _recompute(q, k, v, g, lse, corr, q_start, k_start, j0, *, scale, causal):
    """(p, ds) for the key block starting at j0: p = exp(s - lse) with
    masked entries 0, ds = p * (g.v^T + corr) rounded to q's dtype."""
    kb, vb = k[:, j0:j0 + _BLOCK], v[:, j0:j0 + _BLOCK]
    s = _mask(torch.bmm(q.float(), kb.float().transpose(1, 2)) * scale,
              q_start, k_start, j0, causal)
    p = torch.exp(torch.where(s > _MASK_THRESH, s - lse[..., None], _NEG_INF))
    dp = torch.bmm(g.float(), vb.float().transpose(1, 2))
    ds = (p * (dp + corr[..., None])).to(q.dtype)
    return p, ds


def flash_dkv_plain(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0,
                    *, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` by per-key-block recompute from lse."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for j0 in range(0, k.shape[1], _BLOCK):
        p, ds = _recompute(q, k, v, g, lse, corr, q_start, k_start, j0,
                           scale=scale, causal=causal)
        dv[:, j0:j0 + _BLOCK] = torch.bmm(
            p.to(g.dtype).float().transpose(1, 2), g.float()).to(v.dtype)
        dk[:, j0:j0 + _BLOCK] = (torch.bmm(
            ds.float().transpose(1, 2), q.float()) * scale).to(k.dtype)
    return dk, dv


def flash_dq_plain(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0,
                   *, scale: float, causal: bool) -> torch.Tensor:
    """``dQ`` by per-key-block recompute from lse."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0 in range(0, k.shape[1], _BLOCK):
        _, ds = _recompute(q, k, v, g, lse, corr, q_start, k_start, j0,
                           scale=scale, causal=causal)
        acc += torch.bmm(ds.float(), k[:, j0:j0 + _BLOCK].float())
    return (acc * scale).to(q.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _lib():
    return bind(_build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/flash_attention.cu``."""
    lib.bf_flash_fwd.argtypes = [_P] * 5 + [_I] * 6 + [_F, _I, _P]
    lib.bf_flash_bwd_dkv.argtypes = [_P] * 8 + [_I] * 6 + [_F, _I, _P]
    lib.bf_flash_bwd_dq.argtypes = [_P] * 7 + [_I] * 6 + [_F, _I, _P]
    lib.bf_flash_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    for fn in (lib.bf_flash_fwd, lib.bf_flash_bwd_dkv, lib.bf_flash_bwd_dq,
               lib.bf_flash_occupancy):
        fn.restype = ctypes.c_int
    return lib


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
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if tq < 1 or tk < 1 or bh < 1:
        raise ValueError(f"{name}: empty input {tuple(q.shape)} / {tuple(k.shape)}")
    if k.shape != (bh, tk, d) or v.shape != (bh, tk, d):
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if any(x.shape != (bh, tq, d) for x in extra):
        raise ValueError(f"{name}: dO/o must have q's shape {tuple(q.shape)}")
    if any(x.shape != (bh, tq) for x in f32):
        raise ValueError(f"{name}: lse/corr must be [{bh}, {tq}]")
    dev = q.device
    for x in (q, k, v, *extra):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
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


def flash_fwd(q, k, v, q_start: int = 0, k_start: int = 0, *, scale: float,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [BH,Tq,D], lse [BH,Tq] f32)``; the CUDA kernel for CUDA tensors,
    :func:`flash_fwd_plain` for CPU tensors."""
    if not _on_cuda(q, k, v):
        return flash_fwd_plain(q, k, v, q_start, k_start, scale=scale, causal=causal)
    bh, tq, tk, d = _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().bf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    launches["fwd"] += 1
    return o, lse


def flash_dkv(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0, *,
              scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``; ``g`` is dO, ``corr = g_lse - rowsum(o * dO)``."""
    if not _on_cuda(q, k, v, g, lse, corr):
        return flash_dkv_plain(q, k, v, g, lse, corr, q_start, k_start,
                               scale=scale, causal=causal)
    bh, tq, tk, d = _check("flash_dkv", q, k, v, (g,), (lse, corr))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _lib().bf_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), corr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_dkv", err)
    launches["dkv"] += 1
    return dk, dv


def flash_dq(q, k, v, g, lse, corr, q_start: int = 0, k_start: int = 0, *,
             scale: float, causal: bool) -> torch.Tensor:
    """``dQ``; arguments as :func:`flash_dkv`."""
    if not _on_cuda(q, k, v, g, lse, corr):
        return flash_dq_plain(q, k, v, g, lse, corr, q_start, k_start,
                              scale=scale, causal=causal)
    bh, tq, tk, d = _check("flash_dq", q, k, v, (g,), (lse, corr))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().bf_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), corr.data_ptr(), dq.data_ptr(),
            bh, tq, tk, d, int(q_start), int(k_start), float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_dq", err)
    launches["dq"] += 1
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
    package's ``_flash_core`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, k_start, scale, causal):
        o, lse = flash_fwd(q, k, v, q_start, k_start, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (q_start, k_start, scale, causal)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        q_start, k_start, scale, causal = ctx.args
        g = g.contiguous()
        delta = (o.float() * g.float()).sum(-1)  # [BH, Tq]
        corr = -delta if g_lse is None else g_lse.float() - delta
        corr = corr.contiguous()
        dk, dv = flash_dkv(q, k, v, g, lse, corr, q_start, k_start,
                           scale=scale, causal=causal)
        dq = flash_dq(q, k, v, g, lse, corr, q_start, k_start,
                      scale=scale, causal=causal)
        return dq, dk, dv, None, None, None, None


def _fold(x):  # [B, T, H, D] -> [B*H, T, D]
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def flash_attention_with_lse(q, k, v, *, q_start: int = 0, k_start: int = 0,
                             causal: bool = True):
    """``(out [B,T,H,D], lse [B,H,T] f32)`` for q, k, v of shape
    ``[B, T, H, D]``.  ``q_start``/``k_start`` are global sequence offsets
    for the causal mask.  Rows with no visible key give out = 0 and
    lse = -1e30."""
    b, tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o, lse = _FlashCore.apply(_fold(q), _fold(k), _fold(v), int(q_start),
                              int(k_start), scale, bool(causal))
    return o.reshape(b, h, tq, d).permute(0, 2, 1, 3), lse.reshape(b, h, tq)


def flash_attention(q, k, v, *, causal: bool = True):
    """Exact attention, ``[B, T, H, D]`` layout; drop-in for
    :func:`bluefog_tpu_torch.models.transformer.dense_attention`."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal)
    return o


def make_flash_attention_fn(causal: bool = True) -> Callable:
    """``attention_fn`` for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`."""
    return functools.partial(flash_attention, causal=causal)
