"""Tile-component microkernels of the counted flash-attention roofline.

Counterpart of the Pallas bodies that ``benchmarks/attention_roofline.py``
times through ``_pallas_component`` (:69, ``pallas_call`` :87).  Each has a
CUDA C++ kernel here (``csrc/attention_components.cu``, built by
:mod:`._build`) and a plain PyTorch version:

===========================  ===========================================  ===============================
wrapper                      replaces                                     plain version
===========================  ===========================================  ===============================
``qk_component``             ``qk_make`` (:136)                           ``qk_component_plain``
``pv_component``             ``pv_make`` (:150)                           ``pv_component_plain``
``softmax_chain_component``  ``vpu_make`` (:167)                          ``softmax_chain_component_plain``
``bwd_chain_component``      ``bwd_component_times.make_rows`` (:221)     ``bwd_chain_component_plain``
===========================  ===========================================  ===============================

Each computes ``reps`` repetitions of ``acc <- 0.5 * acc + f(acc)`` on one
64-row tile, with ``f`` reading row 0 of ``acc`` back into an operand (the
source's header gives each ``f``).  ``body=False`` leaves the product or
chain out (``f`` = the fed-back row + 1): the cost of that dependency pass
alone.  A CUDA block computes :data:`TILES_PER_BLOCK` copies of the tile:
every component runs the flash kernels' block, two consumer warpgroups of
64 rows, each on its own tile (qk and pv on ``wgmma``, the chains on the
accumulator's registers with ``ex2.approx``).  The
result is ``[blocks * TILES_PER_BLOCK[name], 64, W]`` f32 with every slice
equal, from the kernel and from the plain version alike.  ``smem_bytes``
reserves that much dynamic shared memory a block (at least what the kernel
needs), to hold the blocks per SM to those of the flash kernel a component
models.

On a CUDA tensor a wrapper checks its inputs, launches its kernel on the
current stream and adds one to its count in :data:`launches`; on a CPU
tensor it runs its plain version, which rounds at the same points.  There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from bluefog_tpu_torch.kernels import _build
from bluefog_tpu_torch.kernels.flash_attention import _on_cuda, _raise_on

__all__ = [
    "qk_component",
    "pv_component",
    "softmax_chain_component",
    "bwd_chain_component",
    "qk_component_plain",
    "pv_component_plain",
    "softmax_chain_component_plain",
    "bwd_chain_component_plain",
    "occupancy",
    "compare",
    "INSTANCES",
    "PLAIN",
    "launches",
    "reset_launches",
    "TILE",
    "TILES_PER_BLOCK",
    "HEAD_DIMS",
    "MAX_SMEM",
]

TILE = 64
HEAD_DIMS = (64, 128)
MAX_SMEM = 232448  # the H100's opt-in dynamic shared memory per block
_IDS = {"qk": 0, "pv": 1, "softmax_chain": 2, "bwd_chain": 3}
# Tiles a CUDA block computes (csrc/attention_components.cu: kConsumers).
TILES_PER_BLOCK = {"qk": 2, "pv": 2, "softmax_chain": 2, "bwd_chain": 2}

# Kernel launches per wrapper since the last reset_launches().  Only a
# launch of the CUDA kernel counts; a plain-version call does not.
launches: Dict[str, int] = {name: 0 for name in _IDS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions ([blocks * TILES_PER_BLOCK[name], rows, cols] out)
# --------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fed_row(acc, width):
    """``acc[..., 0:1, j mod cols]`` for ``j < width``."""
    row = acc[..., 0:1, :]
    cols = row.shape[-1]
    if width != cols:
        row = row[..., torch.arange(width, device=acc.device) % cols]
    return row


def _zeros(name, blocks, rows, cols, like):
    return torch.zeros(blocks * TILES_PER_BLOCK[name], rows, cols, dtype=torch.float32,
                       device=like.device)


def qk_component_plain(q, k, reps: int, *, body: bool = True, blocks: int = 1):
    """``q [64, D]`` and ``k [D, 64]`` bf16 -> ``[2 blocks, 64, 64]`` f32."""
    acc = _zeros("qk", blocks, q.shape[0], k.shape[1], q)
    qf, kf = q.float(), k.float()
    for _ in range(reps):
        if body:
            qi = _bf16(qf + _bf16(_fed_row(acc, q.shape[1])))
            acc = acc * 0.5 + qi @ kf
        else:
            acc = acc * 0.5 + (_bf16(acc[:, 0:1, :]) + 1.0)
    return acc


def pv_component_plain(p16, v, reps: int, *, body: bool = True, blocks: int = 1):
    """``p16 [64, 64]`` and ``v [64, D]`` bf16 -> ``[2 blocks, 64, D]`` f32."""
    acc = _zeros("pv", blocks, p16.shape[0], v.shape[1], p16)
    pf, vf = p16.float(), v.float()
    for _ in range(reps):
        if body:
            acc = acc * 0.5 + pf @ _bf16(vf + _bf16(acc[:, 0:1, :]))
        else:
            acc = acc * 0.5 + (_bf16(acc[:, 0:1, :]) + 1.0)
    return acc


def softmax_chain_component_plain(s0, reps: int, *, body: bool = True,
                                  blocks: int = 1):
    """``s0 [64, 64]`` f32 -> ``[2 blocks, 64, 64]`` f32."""
    acc = _zeros("softmax_chain", blocks, *s0.shape, s0)
    for _ in range(reps):
        if body:
            s = s0 + acc[:, 0:1, :]
            m = s.amax(-1, keepdim=True)
            p = torch.exp2(s - m)
            l = p.sum(-1, keepdim=True)
            acc = acc * 0.5 + _bf16(p) + (m + l)
        else:
            acc = acc * 0.5 + (acc[:, 0:1, :] + 1.0)
    return acc


def bwd_chain_component_plain(s0, dp, reps: int, *, cast_p: bool,
                              body: bool = True, blocks: int = 1):
    """``s0``, ``dp [64, 64]`` f32 -> ``[2 blocks, 64, 64]`` f32."""
    acc = _zeros("bwd_chain", blocks, *s0.shape, s0)
    for _ in range(reps):
        if body:
            p = torch.exp2(s0 + acc[:, 0:1, :] - 1.7)
            ds = p * (dp + 0.3)
            out = acc * 0.5 + _bf16(ds)
            acc = out + (_bf16(p) if cast_p else p)
        else:
            acc = acc * 0.5 + (acc[:, 0:1, :] + 1.0)
    return acc


# Every kernel instance: (component, head dim, keyword arguments).
INSTANCES = [("qk", 64, {}), ("qk", 128, {}), ("pv", 64, {}), ("pv", 128, {}),
             ("softmax_chain", 64, {}), ("bwd_chain", 64, {"cast_p": True}),
             ("bwd_chain", 64, {"cast_p": False})]

PLAIN = {"qk": qk_component_plain, "pv": pv_component_plain,
         "softmax_chain": softmax_chain_component_plain,
         "bwd_chain": bwd_chain_component_plain}

# The tolerance between two versions of a component that round to bf16 at
# the same points (kernel and plain version, or plain version and Pallas
# body).  Every element within F32_REL (|ref| + rms(ref)): f32 sums taken in
# another order.  Beyond that, a value that the two sides hold within an f32
# ulp can still round to adjacent bf16 values (one bf16 step, 2^-7 relative):
#   qk, pv at reps >= 2: one element of the fed-back row; the step moves q's
#     column j (every output by <= step * max|k|) or v's column n (by <=
#     step * max_i sum_k |p_ik|), step <= 2^-7 (max|operand| + max|row|);
#   the chains: p and ds (both below 1 here), at most 2^-7 together, in at
#     most FLIP_FRACTION of the elements.
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7
FLIP_FRACTION = 0.01


def compare(name: str, got, ref, inputs, reps: int, **kw) -> Dict[str, float]:
    """Hold ``got`` to ``ref`` (both ``[..., 64, W]``) under the rule
    above; ``inputs`` and ``kw`` are the component's arguments.  Returns
    ``ok``, ``max_abs_err``, ``tol_ratio`` (worst error over its
    element's f32 tolerance) and ``flip_fraction``."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    f32_tol = F32_REL * (ref.abs() + ref.pow(2).mean().sqrt())
    beyond = err > f32_tol
    flip = 0.0
    if name in ("qk", "pv") and reps >= 2:
        fed = PLAIN[name](*inputs, reps - 1, **kw)[..., 0, :].abs().max()
        a, b = (inputs[0], inputs[1]) if name == "qk" else (inputs[1], inputs[0])
        step = BF16_STEP * (a.float().abs().max() + fed)
        carry = b.float().abs().max() if name == "qk" else b.float().abs().sum(-1).max()
        flip = float(step * carry)
    elif name in ("softmax_chain", "bwd_chain"):
        flip = BF16_STEP if beyond.float().mean().item() <= FLIP_FRACTION else 0.0
    ok = bool((err <= f32_tol + flip).all().item())
    return {"ok": ok, "max_abs_err": err.max().item(),
            "tol_ratio": (err / f32_tol).max().item(),
            "flip_fraction": beyond.float().mean().item()}


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("attention_components")
    lib.bf_qk_component.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.bf_pv_component.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.bf_softmax_chain_component.argtypes = [_P] * 2 + [_I] * 4 + [_P]
    lib.bf_bwd_chain_component.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.bf_component_occupancy.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
    for fn in (lib.bf_qk_component, lib.bf_pv_component,
               lib.bf_softmax_chain_component, lib.bf_bwd_chain_component,
               lib.bf_component_occupancy):
        fn.restype = ctypes.c_int
    return lib


def _check(name, tensors, reps, blocks, smem_bytes) -> bool:
    """Check ``(tensor, shape, dtype)`` triples and the launch counts;
    True if the tensors lie on the card, False if on the CPU."""
    if reps < 0 or blocks < 1 or not 0 <= smem_bytes <= MAX_SMEM:
        raise ValueError(f"{name}: reps {reps} (>= 0), blocks {blocks} (>= 1), "
                         f"smem_bytes {smem_bytes} (0..{MAX_SMEM})")
    cuda = _on_cuda(*(x for x, _, _ in tensors))
    for x, shape, dtype in tensors:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
        if cuda and (x.device != tensors[0][0].device or not x.is_contiguous()
                     or x.data_ptr() % 16):
            raise ValueError(f"{name}: tensors must share one card and be "
                             f"contiguous and 16-byte aligned")
    return cuda


def _head_dim(name, d):
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    return d


def _run(name, fn, ptrs, cols, dev, blocks, ints):
    out = torch.empty(blocks * TILES_PER_BLOCK[name], TILE, cols, dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = fn(*ptrs, out.data_ptr(), *ints,
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(name, err)
    launches[name] += 1
    return out


def qk_component(q, k, reps: int, *, body: bool = True, blocks: int = 1,
                 smem_bytes: int = 0):
    """``reps`` scores products ``[64, D] x [D, 64]`` with the fed-back row;
    the CUDA kernel for CUDA tensors, :func:`qk_component_plain` for CPU."""
    d = _head_dim("qk", q.shape[-1])
    bf = torch.bfloat16
    if not _check("qk", [(q, (TILE, d), bf), (k, (d, TILE), bf)], reps, blocks,
                  smem_bytes):
        return qk_component_plain(q, k, reps, body=body, blocks=blocks)
    return _run("qk", _lib().bf_qk_component, (q.data_ptr(), k.data_ptr()), TILE,
                q.device, blocks, (d, reps, int(body), blocks, smem_bytes))


def pv_component(p16, v, reps: int, *, body: bool = True, blocks: int = 1,
                 smem_bytes: int = 0):
    """``reps`` products ``[64, 64] x [64, D]`` with the fed-back row."""
    d = _head_dim("pv", v.shape[-1])
    bf = torch.bfloat16
    if not _check("pv", [(p16, (TILE, TILE), bf), (v, (TILE, d), bf)], reps,
                  blocks, smem_bytes):
        return pv_component_plain(p16, v, reps, body=body, blocks=blocks)
    return _run("pv", _lib().bf_pv_component, (p16.data_ptr(), v.data_ptr()), d,
                p16.device, blocks, (d, reps, int(body), blocks, smem_bytes))


def softmax_chain_component(s0, reps: int, *, body: bool = True,
                            blocks: int = 1, smem_bytes: int = 0):
    """``reps`` forward softmax chains over a ``[64, 64]`` f32 score tile."""
    if not _check("softmax_chain", [(s0, (TILE, TILE), torch.float32)], reps,
                  blocks, smem_bytes):
        return softmax_chain_component_plain(s0, reps, body=body, blocks=blocks)
    return _run("softmax_chain", _lib().bf_softmax_chain_component,
                (s0.data_ptr(),), TILE, s0.device, blocks,
                (reps, int(body), blocks, smem_bytes))


def bwd_chain_component(s0, dp, reps: int, *, cast_p: bool, body: bool = True,
                        blocks: int = 1, smem_bytes: int = 0):
    """``reps`` backward chains; ``cast_p`` rounds p to bf16 as the dK/dV
    kernel does (the dQ kernel does not)."""
    f32 = torch.float32
    if not _check("bwd_chain", [(s0, (TILE, TILE), f32), (dp, (TILE, TILE), f32)],
                  reps, blocks, smem_bytes):
        return bwd_chain_component_plain(s0, dp, reps, cast_p=cast_p, body=body,
                                         blocks=blocks)
    return _run("bwd_chain", _lib().bf_bwd_chain_component,
                (s0.data_ptr(), dp.data_ptr()), TILE, s0.device, blocks,
                (int(cast_p), reps, int(body), blocks, smem_bytes))


def occupancy(name: str, *, d: int = 64, cast_p: bool = False, body: bool = True,
              smem_bytes: int = 0) -> Dict[str, int]:
    """``blocks_per_sm``, ``smem`` (bytes reserved a block), ``regs`` (a
    thread) and ``tiles_per_block`` of one microkernel instance at
    ``smem_bytes``.  Needs the card."""
    out = (_I * 4)()
    err = _lib().bf_component_occupancy(_IDS[name], int(d), int(cast_p), int(body),
                                        int(smem_bytes), out)
    _raise_on(f"occupancy({name})", err)
    return {"blocks_per_sm": out[0], "smem": out[1], "regs": out[2],
            "tiles_per_block": out[3]}
