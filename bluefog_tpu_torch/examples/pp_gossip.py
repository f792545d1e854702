"""Pipeline-parallel x decentralized-gossip training on the rank-major backend.

Counterpart of ``examples/jax_pp_gossip.py``: each of ``--dp`` replicas
splits its ``--layers`` transformer blocks into ``--pp`` stages of
:func:`bluefog_tpu_torch.parallel.pipeline.pipeline_apply` (GPipe
microbatches, ``--microbatches``), the embedding and unembedding outside
the pipeline, and the replicas neighbor-average every parameter on
``ExponentialTwoGraph(dp)`` after each momentum-SGD step.  Stage weights
are rank-major ``[dp, pp, layers/pp, ...]``, the rest ``[dp, ...]``.  Dense
f32 attention, as the reference example's.  Ground truth: a pp = N run
matches the sequential blocks.

Run (one H100):  python -m bluefog_tpu_torch.examples.pp_gossip
Run (CPU):       python -m bluefog_tpu_torch.examples.pp_gossip --device cpu
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
from bluefog_tpu_torch.ops import neighbor_allreduce_plan
from bluefog_tpu_torch.parallel import pipeline as ppx

VOCAB = 64


def init_block(rng: np.random.Generator, d_model: int, heads: int, device=None):
    dh = d_model // heads

    def dense(shape, fan):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                / np.float32(math.sqrt(fan))).to(device)

    return {"wq": dense((d_model, heads, dh), d_model), "wk": dense((d_model, heads, dh), d_model),
            "wv": dense((d_model, heads, dh), d_model), "wo": dense((heads, dh, d_model), d_model),
            "wi": dense((d_model, 4 * d_model), d_model),
            "wd": dense((4 * d_model, d_model), 4 * d_model),
            "norm1": torch.ones(d_model, device=device), "norm2": torch.ones(d_model, device=device)}


def init_replica(d_model: int, heads: int, layers: int, *, seed: int, device=None,
                 vocab: int = VOCAB):
    """One replica: ``(blocks, {"embed", "unembed"})`` over ``vocab`` tokens
    from ``numpy.random.default_rng(seed)`` (the reference's distributions)."""
    rng = np.random.default_rng(seed)
    blocks = [init_block(rng, d_model, heads, device) for _ in range(layers)]
    embed = torch.from_numpy(rng.standard_normal((vocab, d_model), dtype=np.float32)
                             * np.float32(0.3)).to(device)
    unembed = torch.from_numpy(rng.standard_normal((d_model, vocab), dtype=np.float32)
                               / np.float32(math.sqrt(d_model))).to(device)
    return blocks, {"embed": embed, "unembed": unembed}


def rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def block_apply(blk, x):
    """One transformer block on [B, T, d]."""
    h = rms(x, blk["norm1"])
    q = torch.einsum("btm,mhd->bthd", h, blk["wq"])
    k = torch.einsum("btm,mhd->bthd", h, blk["wk"])
    v = torch.einsum("btm,mhd->bthd", h, blk["wv"])
    att = dense_attention(q, k, v, causal=True, dtype=x.dtype)
    x = x + torch.einsum("bthd,hdm->btm", att, blk["wo"])
    h = rms(x, blk["norm2"])
    return x + F.gelu(h @ blk["wi"], approximate="tanh") @ blk["wd"]


def stage_fn(stage_params, x):
    """A stage's blocks stacked on axis 0 (``[k, ...]`` leaves)."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = block_apply({n: a[i] for n, a in stage_params.items()}, x)
    return x


def stage_stack(blocks: List[Dict], pp: int):
    """Stage s owns blocks ``[s*k, (s+1)*k)``: leaves ``[pp, k, ...]``."""
    k = len(blocks) // pp
    return ppx.stack_stage_params([ppx.stack_stage_params(blocks[s * k:(s + 1) * k])
                                   for s in range(pp)])


def replica_loss(repl, stages, ids, microbatches: int):
    x = repl["embed"][ids[:, :-1]]
    y = ppx.pipeline_apply(stage_fn, stages, x, num_microbatches=microbatches)
    logits = torch.einsum("btm,mv->btv", y, repl["unembed"])
    return F.cross_entropy(logits.flatten(0, 1), ids[:, 1:].reshape(-1))


def synthetic_batches(dp: int, batch: int, seq: int, steps: int, device, seed: int = 0,
                      vocab: int = VOCAB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        start = rng.integers(0, vocab, size=(dp, batch, 1))
        out.append(torch.from_numpy((start + np.arange(seq + 1)) % vocab).to(device))
    return out


def make_step(repl: Dict, stages: Dict, plan, lr: float, microbatches: int):
    """``step(ids [dp, B, T+1]) -> mean loss`` on the rank-major leaves:
    every replica's loss, one backward, momentum SGD, every leaf mixed."""
    params = list(repl.values()) + list(stages.values())
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    dp = params[0].shape[0]

    def step(ids):
        opt.zero_grad(set_to_none=True)
        losses = torch.stack([
            replica_loss({k: v[r] for k, v in repl.items()},
                         {k: v[r] for k, v in stages.items()}, ids[r], microbatches)
            for r in range(dp)])
        losses.sum().backward()
        opt.step()
        with torch.no_grad():
            for p in params:
                p.copy_(neighbor_allreduce_plan(p, plan))
        return losses.detach().mean()

    return step


def run(args, replicas: Optional[List] = None) -> dict:
    device = resolve_device(args.device)
    if args.layers % args.pp or args.batch % args.microbatches:
        raise SystemExit("--layers must divide by --pp and --batch by --microbatches")
    if replicas is None:
        replicas = [init_replica(args.d_model, args.heads, args.layers, seed=r, device=device)
                    for r in range(args.dp)]
    repl = {k: torch.stack([r[1][k] for r in replicas]).to(device).requires_grad_(True)
            for k in ("embed", "unembed")}
    per = [stage_stack(r[0], args.pp) for r in replicas]
    stages = {k: torch.stack([p[k] for p in per]).to(device).requires_grad_(True)
              for k in per[0]}
    step = make_step(repl, stages, compile_plan(topology_util.ExponentialTwoGraph(args.dp)),
                     args.lr, args.microbatches)
    losses = []
    for i, ids in enumerate(synthetic_batches(args.dp, args.batch, args.seq, args.steps,
                                              device)):
        losses.append(step(ids).item())
        if (i + 1) % 10 == 0 or i == 0:
            w = stages["wq"].detach()
            print(f"step {i + 1:3d}: loss {losses[-1]:.4f} consensus-spread "
                  f"{(w - w.mean(0, keepdim=True)).abs().max().item():.2e}")
    print(f"done: dp={args.dp} pp={args.pp} on {device}")
    return {"dp": args.dp, "pp": args.pp, "layers": args.layers, "losses": losses}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8, help="sequences per replica")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


if __name__ == "__main__":
    print(json.dumps(run(_parser().parse_args())))
