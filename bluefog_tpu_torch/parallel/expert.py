"""Expert parallelism: Switch-style mixture-of-experts over an ep axis on
the rank-major backend (counterpart of ``bluefog_tpu/parallel/expert.py``).

The algorithm is the reference's (Fedus et al., arXiv:2101.03961): top-1
routing, a static per-rank, per-expert capacity ``ceil(cf·T/E)``, the
dense one-hot dispatch and combine products, overflow tokens passed
through (their output is zero, the caller's residual carries them), the
gate probability scaling the expert output so the router learns, and the
Switch load-balancing loss averaged over the ep ranks.

In the rank-major layout the ep ranks are dim 0: tokens ``[ep, T, d]``
(each rank's token shard), expert weights ``[ep, E/ep, ...]`` (each
rank's expert shard), the router ``[d, E]`` one copy (replicated, so its
gradient sums every rank's share).  The reference's two tiled
``all_to_all``s, out to the experts' ranks and back, are permutes of the
rank axis, as in :mod:`bluefog_tpu_torch.parallel.ulysses`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["switch_moe", "init_moe_params", "EP_AXIS"]

EP_AXIS = "ep"


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_moe_params(d_model: int, d_ff: int, num_experts: int, *,
                    generator: Optional[torch.Generator] = None, seed: Optional[int] = None,
                    dtype=torch.float32, device=None):
    """Full (unsharded) MoE params: router ``[d, E]`` N(0, 0.02²), expert
    stacks ``wi [E, d, f]`` N(0, 1/d) and ``wo [E, f, d]`` N(0, 1/f), drawn
    from ``generator`` or ``numpy.random.default_rng(seed)``: the
    reference's distributions, not its bits.  Shard the experts with
    ``leaf.reshape(ep, E // ep, ...)``."""
    rng = np.random.default_rng(seed) if generator is None else None

    def normal(shape, std):
        if rng is not None:
            w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        else:
            w = torch.randn(shape, generator=generator, device=device)
        return (w * std).to(dtype=dtype, device=device)

    return {"router": normal((d_model, num_experts), 0.02),
            "wi": normal((num_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
            "wo": normal((num_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff))}


def _einsum(eq, a, b, dtype):
    pt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(pt), b.to(pt)).to(dtype)


def switch_moe(x: torch.Tensor, params, *, capacity_factor: float = 1.25,
               activation: Callable = _gelu) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE layer over ``ep = x.shape[0]`` ranks.

    ``x [ep, T_local, d]``: every rank's token shard.  ``params``: ``router
    [d, E]``; ``wi [ep, E/ep, d, f]`` / ``wo [ep, E/ep, f, d]``: every rank's
    expert shard.  Returns ``(out [ep, T_local, d], aux_loss)``, the Switch
    load-balancing term averaged over the ranks."""
    n = x.shape[0]
    wi, wo = params["wi"], params["wo"]
    e_local = wi.shape[1] if wi.dim() == 4 else wi.shape[0]
    E = n * e_local
    if wi.dim() != 4 or wi.shape[0] != n or params["router"].shape[1] != E:
        raise ValueError(
            f"router is {params['router'].shape[1]} experts wide but "
            f"ep={n} x {e_local} local experts = {E}; pass every rank's "
            f"[ep, E/ep, ...] expert shard, not the full stack")
    T = x.shape[1]
    # per-rank, per-expert slot budget (ceil: capacity_factor headroom must
    # yield slots even when T/E is small)
    cap = max(1, math.ceil(capacity_factor * T / E))

    logits = _einsum("ntd,de->nte", x, params["router"], torch.float32)
    probs = torch.softmax(logits, dim=-1)  # [n, T, E] f32
    expert = probs.argmax(dim=-1)  # [n, T], the first on a tie, as jnp.argmax
    gate = probs.amax(dim=-1)
    onehot = F.one_hot(expert, E).float()  # [n, T, E]
    # position of each token within its expert's slots (this rank's view)
    pos = (torch.cumsum(onehot, dim=1) * onehot - 1.0).long()
    # pos == -1 (no token) and pos >= cap (overflow) give all-zero slots
    dispatch = (pos[..., None] == torch.arange(cap, device=x.device)).float()  # [n,T,E,cap]
    combine = dispatch * gate[..., None, None]  # the gradient reaches the router

    wdt = x.dtype
    xin = _einsum("ntd,ntec->necd", x, dispatch.to(wdt), wdt)  # [n_src, E, cap, d]
    # the all_to_all out: rank j receives every rank's slots of its experts,
    # [n_src, n_dst, E/ep, cap, d] -> [n_dst, E/ep, n_src * cap, d]
    d = x.shape[-1]
    xin = xin.reshape(n, n, e_local, cap, d).permute(1, 2, 0, 3, 4).reshape(
        n, e_local, n * cap, d)
    h = activation(_einsum("necd,nedf->necf", xin, wi, wdt))
    y = _einsum("necf,nefd->necd", h, wo, wdt)
    # the all_to_all back: [n_dst, E/ep, n_src, cap, d] -> [n_src, E, cap, d]
    y = y.reshape(n, e_local, n, cap, d).permute(2, 0, 1, 3, 4).reshape(n, E, cap, d)
    out = _einsum("necd,ntec->ntd", y, combine.to(wdt), wdt)

    # Switch aux loss: E * <fraction routed to e> . <mean router prob e>,
    # averaged over the ranks
    aux = (E * (onehot.mean(dim=1) * probs.mean(dim=1)).sum(-1)).mean()
    return out, aux
