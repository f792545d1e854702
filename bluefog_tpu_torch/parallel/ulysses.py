"""Ulysses sequence parallelism: head/sequence re-sharding (counterpart of
``bluefog_tpu/parallel/ulysses.py``).

The algorithm is the reference's, DeepSpeed-Ulysses (Jacobs et al.,
arXiv:2309.14509): inputs arrive sharded over the *sequence*, one
all-to-all re-shards them over *heads*, every rank runs ordinary
full-sequence attention on its own head slice, and one all-to-all
restores the sequence sharding.  Against the ring: one attention call on
the whole sequence, but the head count must divide by the rank count.

In the rank-major layout (:mod:`bluefog_tpu_torch.parallel.ring_attention`)
the reference's tiled ``all_to_all`` is a permute of the rank axis:
``[n, B, T_local, H, D]`` -> ``[n, B, n*T_local, H/n, D]``, rank ``r'``
receiving head slice ``r'`` of every rank's block, in rank order along the
sequence.  The attention then runs once over all ranks' head slices (one
flash launch, or the dense product), and the inverse permute follows.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from bluefog_tpu_torch.parallel._util import resolve_axis_size

__all__ = ["ulysses_attention", "make_ulysses_attention_fn"]


def _to_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n*B, Tl, H, D]`` -> ``[..., n*B, n*Tl, H/n, D]`` (the tiled
    all-to-all with split axis H and concat axis T)."""
    *lead, rows, tl, h, d = x.shape
    b, k = len(lead), rows // n
    x = x.reshape(*lead, n, k, tl, n, h // n, d)
    # rank r' gets [B, (r, t), h'] = rank r's [B, t, (r', h')]
    x = x.permute(*range(b), b + 3, b + 1, b, b + 2, b + 4, b + 5)
    return x.reshape(*lead, rows, n * tl, h // n, d)


def _to_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_to_heads`: ``[n*B, n*Tl, H/n, D]`` -> ``[n*B, Tl, H, D]``."""
    rows, t, hn, d = x.shape
    x = x.reshape(n, rows // n, n, t // n, hn, d)  # [r', B, r, t, h', d]
    return x.permute(2, 1, 3, 0, 4, 5).reshape(rows, t // n, n * hn, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_size: int, *,
                      causal: bool = True, flash: bool = False, block_q=None,
                      block_k=None, interpret=None, impl: str = "auto") -> torch.Tensor:
    """Exact attention across ``axis_size`` sequence shards by head
    re-sharding.

    q, k, v: ``[n*B, T_local, H, D]`` rank-major; H must be divisible by
    ``axis_size``.  Returns ``[n*B, T_local, H, D]`` in q's dtype.
    ``flash=True`` runs :func:`bluefog_tpu_torch.kernels.flash_attention`
    on the gathered sequence (the CUDA kernels on CUDA tensors), else
    :func:`bluefog_tpu_torch.models.transformer.dense_attention`.  Under
    ``flash=True``, ``impl``, ``block_q``, ``block_k`` and ``interpret``
    reach the flash call, as in the reference (``impl="xla"``: the
    blockwise route, no kernel launch); the dense path does not read them."""
    n = resolve_axis_size(axis_size, q.shape[0])
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(
            f"ulysses_attention needs num_heads ({H}) divisible by the "
            f"sequence axis size ({n}); use ring_attention otherwise")
    # when q/k/v agree in shape and dtype (the training path) they move as
    # one stacked tensor, as they ride one collective in the reference;
    # otherwise (e.g. cross-attention with Tk != Tq) each moves alone
    if q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype:
        qg, kg, vg = _to_heads(torch.stack((q, k, v)), n).unbind(0)
    else:
        qg, kg, vg = (_to_heads(x, n) for x in (q, k, v))

    if flash:
        from bluefog_tpu_torch.kernels import flash_attention

        out = flash_attention(qg, kg, vg, causal=causal, block_q=block_q, block_k=block_k,
                              interpret=interpret, impl=impl)
    else:
        from bluefog_tpu_torch.models.transformer import dense_attention

        out = dense_attention(qg, kg, vg, causal=causal, dtype=q.dtype)
    return _to_sequence(out.to(q.dtype), n)


def make_ulysses_attention_fn(axis_size: int, causal: bool = True, *, flash: bool = False,
                              **flash_kwargs) -> Callable:
    """``attention_fn`` for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`:
    Ulysses sequence parallelism in the decoder blocks (same slot and
    layout as ``make_ring_attention_fn``, interchangeable)."""
    return functools.partial(ulysses_attention, axis_size=axis_size, causal=causal,
                             flash=flash, **flash_kwargs)
