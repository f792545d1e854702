"""Mixture-of-experts x decentralized-gossip training on the rank-major backend.

Counterpart of ``examples/jax_moe_gossip.py``: each of ``--dp`` replicas
runs ``--layers`` blocks of dense attention and a Switch MoE
(:func:`bluefog_tpu_torch.parallel.expert.switch_moe`) whose experts shard
over ``--ep`` ranks; each ep rank holds ``batch / ep`` of the replica's
sequences.  The replicas neighbor-average every parameter on
``ExponentialTwoGraph(dp)`` after each momentum-SGD step.  Expert leaves
are rank-major ``[dp, ep, E/ep, ...]``, the rest ``[dp, ...]``.  The loss
is the mean cross-entropy over the replica's tokens plus ``--aux-weight``
times the layers' mean Switch aux loss (a per-shard statistic: ep > 1
differs slightly from ep = 1 unless the weight is 0).  Ground truth: an
ep = N run matches ep = 1 loss for loss.

Run (one H100):  python -m bluefog_tpu_torch.examples.moe_gossip
Run (CPU):       python -m bluefog_tpu_torch.examples.moe_gossip --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core.basics import resolve_device
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.models.transformer import dense_attention
from bluefog_tpu_torch.ops import neighbor_allreduce_plan, tree_flatten, tree_map
from bluefog_tpu_torch.parallel import expert as epx
from bluefog_tpu_torch.parallel.pipeline import stack_stage_params

VOCAB = 64


def init_params(d_model: int, heads: int, d_ff: int, n_experts: int, layers: int, *,
                seed: int, device=None, generator: Optional[torch.Generator] = None,
                vocab: int = VOCAB):
    """One replica over ``vocab`` tokens: ``(replicated, experts)`` drawn from
    ``numpy.random.default_rng(seed)``, or from ``generator`` (a torch
    generator on ``device``; quicker at large widths), with the reference's
    distributions: ``replicated`` holds the embedding (N(0, 9/d)),
    unembedding, and each block's attention, norms and router; ``experts``
    each block's full ``wi [E, d, f]`` / ``wo [E, f, d]``."""
    rng = np.random.default_rng(seed)
    dh = d_model // heads

    def dense(shape, fan):
        if generator is not None:
            return torch.randn(shape, generator=generator, device=device) / math.sqrt(fan)
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                / np.float32(math.sqrt(fan))).to(device)

    repl = {"embed": dense((vocab, d_model), d_model) * 3.0,
            "unembed": dense((d_model, vocab), d_model), "blocks": []}
    experts = {"blocks": []}
    for _ in range(layers):
        moe = epx.init_moe_params(d_model, d_ff, n_experts, seed=int(rng.integers(2 ** 31)),
                                  generator=generator, device=device)
        repl["blocks"].append({
            "wq": dense((d_model, heads, dh), d_model), "wk": dense((d_model, heads, dh), d_model),
            "wv": dense((d_model, heads, dh), d_model), "wo": dense((heads, dh, d_model), d_model),
            "norm1": torch.ones(d_model, device=device),
            "norm2": torch.ones(d_model, device=device), "router": moe["router"]})
        experts["blocks"].append({"wi": moe["wi"], "wo": moe["wo"]})
    return repl, experts


def rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def forward(repl, experts, ids, capacity_factor: float):
    """ids ``[ep, B_local, T]`` (every ep rank's sequences) -> (logits
    ``[ep, B_local, T, V]``, the layers' mean aux loss)."""
    ep, b, t = ids.shape
    x = repl["embed"][ids].reshape(ep * b, t, -1)
    auxes = []
    for blk, moe in zip(repl["blocks"], experts["blocks"]):
        h = rms(x, blk["norm1"])
        q = torch.einsum("btm,mhd->bthd", h, blk["wq"])
        k = torch.einsum("btm,mhd->bthd", h, blk["wk"])
        v = torch.einsum("btm,mhd->bthd", h, blk["wv"])
        att = dense_attention(q, k, v, causal=True, dtype=x.dtype)
        x = x + torch.einsum("bthd,hdm->btm", att, blk["wo"])
        h = rms(x, blk["norm2"])
        out, aux = epx.switch_moe(h.reshape(ep, b * t, -1),
                                  {"router": blk["router"], "wi": moe["wi"], "wo": moe["wo"]},
                                  capacity_factor=capacity_factor)
        auxes.append(aux)
        x = x + out.reshape(x.shape)
    logits = torch.einsum("btm,mv->btv", x, repl["unembed"])
    return logits.reshape(ep, b, t, -1), torch.stack(auxes).mean()


def replica_loss(repl, experts, ids, capacity_factor: float, aux_weight: float):
    """(loss, ce) of one replica, ``ids [ep, B_local, T+1]``."""
    logits, aux = forward(repl, experts, ids[..., :-1], capacity_factor)
    ce = F.cross_entropy(logits.flatten(0, 2), ids[..., 1:].reshape(-1))
    return ce + aux_weight * aux, ce


def shard_experts(experts: Dict, ep: int):
    return {"blocks": [{k: a.reshape((ep, a.shape[0] // ep) + a.shape[1:])
                        for k, a in blk.items()} for blk in experts["blocks"]]}


def stack_replicas(trees: List):
    """Per-replica trees -> one tree of rank-major ``[dp, ...]`` leaves that
    require grad."""
    return tree_map(lambda a: a.requires_grad_(True), stack_stage_params(trees))


def make_step(repl, experts, plan, lr: float, capacity_factor: float, aux_weight: float):
    """``step(ids [dp, ep, B_local, T+1]) -> mean ce`` on the rank-major
    leaves: every replica's loss, one backward, momentum SGD, every leaf
    mixed over dp."""
    params = tree_flatten([repl, experts])[0]
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    dp = params[0].shape[0]

    def step(ids):
        opt.zero_grad(set_to_none=True)
        out = [replica_loss(*tree_map(lambda a: a[r], [repl, experts]), ids[r],
                            capacity_factor, aux_weight) for r in range(dp)]
        torch.stack([loss for loss, _ in out]).sum().backward()
        opt.step()
        with torch.no_grad():
            for p in params:
                p.copy_(neighbor_allreduce_plan(p, plan))
        return torch.stack([ce.detach() for _, ce in out]).mean()

    return step


def synthetic_batches(dp: int, ep: int, batch: int, seq: int, steps: int, device,
                      seed: int = 0, vocab: int = VOCAB):
    """The reference's learnable language, ``[dp, ep, batch / ep, seq + 1]``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        start = rng.integers(0, vocab, size=(dp, batch, 1))
        ids = (start + np.arange(seq + 1)) % vocab
        out.append(torch.from_numpy(ids.reshape(dp, ep, batch // ep, seq + 1)).to(device))
    return out


def run(args, replicas: Optional[List] = None) -> dict:
    device = resolve_device(args.device)
    if args.experts % args.ep or args.batch % args.ep:
        raise SystemExit("--experts and --batch must divide by --ep")
    cf = args.capacity_factor or float(args.experts)
    if replicas is None:
        replicas = [init_params(args.d_model, args.heads, args.d_ff, args.experts, args.layers,
                                seed=r, device=device) for r in range(args.dp)]
    repl = stack_replicas([r[0] for r in replicas])
    experts = stack_replicas([shard_experts(r[1], args.ep) for r in replicas])
    step = make_step(repl, experts, compile_plan(topology_util.ExponentialTwoGraph(args.dp)),
                     args.lr, cf, args.aux_weight)
    losses = []
    for i, ids in enumerate(synthetic_batches(args.dp, args.ep, args.batch, args.seq,
                                              args.steps, device)):
        losses.append(step(ids).item())
        if (i + 1) % 10 == 0 or i == 0:
            w = experts["blocks"][0]["wi"].detach()
            print(f"step {i + 1:3d}: loss {losses[-1]:.4f} consensus-spread "
                  f"{(w - w.mean(0, keepdim=True)).abs().max().item():.2e}")
    print(f"done: dp={args.dp} ep={args.ep} on {device}")
    return {"dp": args.dp, "ep": args.ep, "experts": args.experts, "layers": args.layers,
            "losses": losses}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--ep", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="sequences per replica")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--capacity-factor", type=float, default=0.0, help="0 = ample (no drops)")
    ap.add_argument("--aux-weight", type=float, default=0.01,
                    help="Switch load-balancing loss weight")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


if __name__ == "__main__":
    print(json.dumps(run(_parser().parse_args())))
