"""Megatron-style tensor parallelism on the rank-major backend (counterpart
of ``bluefog_tpu/parallel/tensor_parallel.py``).

The layout is Megatron's (Shoeybi et al., arXiv:1909.08053), as in the
reference: attention q/k/v and the MLP's up-projection are
column-parallel (output features sharded), attention-out and the MLP's
down-projection row-parallel (input features sharded, one reduction):
two reductions a block.

Where the reference runs each tp shard on its own device inside
``shard_map``, the tp shards here are dim 0 of one tensor: a sharded
parameter is ``[tp, ...]`` (:func:`shard_tp_params`), a tp-sharded
activation ``[tp, ...]``, a replicated activation or parameter carries no
tp axis.  Stacked over a data-parallel (gossip) axis the parameters are
rank-major ``[dp, tp, ...]`` and ``[dp, ...]``, one dp replica a row.
Megatron's conjugate operators are then:

- **f** (:func:`copy_to_tp_region`): a replicated value enters the tp
  region as one view a shard, identity forward; the backward sums the
  shards' cotangents over the tp axis;
- **g** (:func:`reduce_from_tp_region`): the shards' partial results sum
  over the tp axis forward; the backward hands every shard the
  replicated cotangent (identity).

So every gradient comes out exact: a sharded leaf's is its shard of the
full gradient, a replicated leaf's the full gradient.  The reference's
trap of a ``psum`` transposing into another ``psum`` has no counterpart.
The products are batched ``einsum`` over the tp axis, as the reference
computes them with ``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "copy_to_tp_region",
    "reduce_from_tp_region",
    "column_parallel_dense",
    "row_parallel_dense",
    "tp_mlp",
    "tp_self_attention",
    "tp_transformer_block",
    "init_tp_block_params",
    "TP_BLOCK_SHARD_AXES",
    "shard_tp_params",
    "split_tp_params",
    "merge_tp_params",
    "unshard_tp_params",
]


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _CopyToTp(torch.autograd.Function):
    """Megatron's f: ``[...]`` -> ``[tp, ...]`` (one view a shard); the
    backward sums over the tp axis."""

    @staticmethod
    def forward(ctx, x, tp):
        return x.unsqueeze(0).expand((tp,) + x.shape)

    @staticmethod
    def backward(ctx, g):
        return g.sum(0), None


class _ReduceFromTp(torch.autograd.Function):
    """Megatron's g: ``[tp, ...]`` -> ``[...]`` summed over the tp axis; the
    backward gives every shard the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x):
        ctx.tp = x.shape[0]
        return x.sum(0)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand((ctx.tp,) + g.shape)


def copy_to_tp_region(x: torch.Tensor, tp: int) -> torch.Tensor:
    """Megatron's **f**: the replicated ``x`` as ``[tp, ...]``, identity
    forward, sum over tp backward.  Apply it where a replicated stream
    enters the tp region (:func:`tp_mlp` and :func:`tp_self_attention` do)."""
    return _CopyToTp.apply(x, tp)


def reduce_from_tp_region(x: torch.Tensor) -> torch.Tensor:
    """Megatron's **g**: ``[tp, ...]`` partials summed over tp forward,
    identity backward."""
    return _ReduceFromTp.apply(x)


def _einsum(eq, a, b, dtype):
    """``einsum`` in the promoted dtype of its operands (as ``jnp.einsum``
    promotes), the result in ``dtype``."""
    pt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(pt), b.to(pt)).to(dtype)


def column_parallel_dense(x, kernel, bias=None):
    """``x [tp, ..., in] @ kernel [tp, in, out_shard]`` -> ``[tp, ...,
    out_shard]``: output features sharded, no reduction; the result in x's
    dtype.  A bias is sharded too, ``[tp, out_shard]``."""
    y = _einsum("p...i,pio->p...o", x, kernel, x.dtype)
    if bias is not None:
        y = y + bias.reshape((bias.shape[0],) + (1,) * (y.dim() - 2) + bias.shape[1:])
    return y


def row_parallel_dense(x, kernel, bias=None):
    """``sum_tp(x [tp, ..., in_shard] @ kernel [tp, in_shard, out])`` ->
    ``[..., out]``: input features sharded, one reduction (g)."""
    y = reduce_from_tp_region(_einsum("p...i,pio->p...o", x, kernel, x.dtype))
    if bias is not None:
        y = y + bias  # replicated: added once, after the reduction
    return y


def tp_mlp(x, params, activation: Callable = _gelu):
    """Column-parallel up-projection, activation, row-parallel down:
    ``x [..., d]`` replicated, ``params["wi"] [tp, d, dff/tp]``,
    ``params["wo"] [tp, dff/tp, d]``."""
    x = copy_to_tp_region(x, params["wi"].shape[0])
    h = activation(column_parallel_dense(x, params["wi"]))
    return row_parallel_dense(h, params["wo"])


def tp_self_attention(x, params, *, causal: bool = False,
                      attention_fn: Optional[Callable] = None):
    """Self-attention with heads sharded over tp.

    ``x [B, T, d]`` replicated; ``params``: ``wq/wk/wv [tp, d, H/tp, Dh]``
    (column-parallel), ``wo [tp, H/tp, Dh, d]`` (row-parallel).
    ``attention_fn(q, k, v)`` on ``[B', T, H/tp, Dh]`` defaults to the
    f32-softmax dense attention; the shards fold into its batch (``B' =
    tp x B``), so a flash ``attention_fn``
    (:func:`bluefog_tpu_torch.kernels.make_flash_attention_fn`) is one
    launch for every shard."""
    dtype = x.dtype
    tp = params["wq"].shape[0]
    x = copy_to_tp_region(x, tp)
    b, t = x.shape[1], x.shape[2]

    def proj(w):
        return _einsum("pbtm,pmhd->pbthd", x, w, dtype)

    q, k, v = (proj(params[n]).reshape((tp * b, t) + params[n].shape[2:])
               for n in ("wq", "wk", "wv"))
    if attention_fn is None:
        from bluefog_tpu_torch.models.transformer import dense_attention

        att = dense_attention(q, k, v, causal=causal, dtype=dtype)
    else:
        att = attention_fn(q, k, v)
    att = att.to(dtype).reshape((tp, b, t) + att.shape[2:])
    out = _einsum("pbthd,phdm->pbtm", att, params["wo"], dtype)
    return reduce_from_tp_region(out)


def _rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def tp_transformer_block(x, params, *, causal: bool = True,
                         attention_fn: Optional[Callable] = None):
    """Pre-norm block on ``x [B, T, d]``: x + attn(norm(x)); x + mlp(norm(x)).
    Two reductions."""
    h = x + tp_self_attention(_rms_norm(x, params["norm1"]), params["attn"],
                              causal=causal, attention_fn=attention_fn)
    return h + tp_mlp(_rms_norm(h, params["norm2"]), params["mlp"])


# --------------------------------------------------------------------------
# Parameter construction / (un)sharding
# --------------------------------------------------------------------------

#: For each block parameter: the axis of the *full* tensor that TP shards,
#: or None for replicated leaves.
TP_BLOCK_SHARD_AXES: Dict[str, Any] = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},  # heads axis
    "mlp": {"wi": 1, "wo": 0},  # dff axis
    "norm1": None,
    "norm2": None,
}


def init_tp_block_params(d_model: int, num_heads: int, dff: int, *,
                         generator: Optional[torch.Generator] = None,
                         seed: Optional[int] = None, dtype=torch.float32, device=None):
    """Full (unsharded) block parameters: N(0, 1/fan_in) projections, ones
    for the norms, drawn from ``generator`` or, with ``seed``, from
    ``numpy.random.default_rng(seed)`` (the same numbers on any device).
    The same distributions as the reference's ``jax.random`` draw, not the
    same bits.  Pair with :func:`shard_tp_params` and
    ``TP_BLOCK_SHARD_AXES``."""
    dh = d_model // num_heads
    rng = np.random.default_rng(seed) if generator is None else None

    def dense(shape, fan_in):
        if rng is not None:
            w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        else:
            w = torch.randn(shape, generator=generator, device=device)
        return (w / math.sqrt(fan_in)).to(dtype=dtype, device=device)

    return {
        "attn": {
            "wq": dense((d_model, num_heads, dh), d_model),
            "wk": dense((d_model, num_heads, dh), d_model),
            "wv": dense((d_model, num_heads, dh), d_model),
            "wo": dense((num_heads, dh, d_model), d_model),
        },
        "mlp": {
            "wi": dense((d_model, dff), d_model),
            "wo": dense((dff, d_model), dff),
        },
        "norm1": torch.ones(d_model, device=device),
        "norm2": torch.ones(d_model, device=device),
    }


def _tree_map_with_axes(fn, params, axes):
    """Map ``fn(leaf, shard_axis_or_None)`` over params following the
    ``axes`` spec tree (dict/list mirroring params; a None or int spec at a
    subtree applies to every leaf under it)."""
    if isinstance(params, dict):
        if isinstance(axes, dict):
            missing = set(params) - set(axes)
            if missing:
                raise ValueError(
                    f"axes spec is missing keys {sorted(missing)}; list every "
                    f"key explicitly (use None for replicated leaves)")
            return {k: _tree_map_with_axes(fn, v, axes[k]) for k, v in params.items()}
        return {k: _tree_map_with_axes(fn, v, axes) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        sub = axes if isinstance(axes, (list, tuple)) else [axes] * len(params)
        if len(sub) != len(params):
            raise ValueError(
                f"axes list length {len(sub)} != params list length {len(params)}")
        out = [_tree_map_with_axes(fn, p, a) for p, a in zip(params, sub)]
        if isinstance(params, tuple):
            return type(params)(*out) if hasattr(params, "_fields") else tuple(out)
        return out
    return fn(params, axes)


def shard_tp_params(params, axes, tp: int):
    """Full params -> stacked ``[tp, ...]`` leaves (replicated leaves
    tiled).  For training, route replicated leaves around the tp axis with
    :func:`split_tp_params` instead."""
    def shard(leaf, ax):
        if leaf is None:  # placeholder from split_tp_params
            return None
        if ax is None:
            return leaf.unsqueeze(0).expand((tp,) + leaf.shape).clone()
        if leaf.shape[ax] % tp:
            raise ValueError(f"axis {ax} of size {leaf.shape[ax]} not divisible by tp={tp}")
        return torch.movedim(leaf.reshape(
            leaf.shape[:ax] + (tp, leaf.shape[ax] // tp) + leaf.shape[ax + 1:]), ax, 0
        ).contiguous()

    return _tree_map_with_axes(shard, params, axes)


def split_tp_params(params, axes):
    """Split a full parameter tree into ``(replicated, sharded)`` subtrees
    by the axes spec (``None`` = replicated), with ``None`` placeholders at
    the other tree's positions.  The training layout: sharded leaves go
    through :func:`shard_tp_params`; replicated leaves stay one copy (no tp
    axis), so their gradient is the full gradient, assembled by f's
    backward."""
    repl = _tree_map_with_axes(lambda l, ax: l if ax is None else None, params, axes)
    shard = _tree_map_with_axes(lambda l, ax: None if ax is None else l, params, axes)
    return repl, shard


def merge_tp_params(replicated, sharded):
    """Inverse of :func:`split_tp_params`: fill each ``None`` placeholder
    from the other tree."""
    if isinstance(replicated, dict):
        return {k: merge_tp_params(replicated[k], sharded[k]) for k in replicated}
    if isinstance(replicated, (list, tuple)):
        return type(replicated)(merge_tp_params(a, b) for a, b in zip(replicated, sharded))
    return sharded if replicated is None else replicated


def unshard_tp_params(params, axes):
    """Inverse of :func:`shard_tp_params` (stacked ``[tp, ...]`` -> full)."""
    def unshard(leaf, ax):
        if leaf is None:  # placeholder from split_tp_params
            return None
        if ax is None:
            return leaf[0]
        tp = leaf.shape[0]
        moved = torch.movedim(leaf, 0, ax)  # [..., tp, shard, ...]
        return moved.reshape(moved.shape[:ax] + (tp * moved.shape[ax + 1],)
                             + moved.shape[ax + 2:])

    return _tree_map_with_axes(unshard, params, axes)
