"""Tensor-parallel x decentralized-gossip training on the rank-major backend.

Counterpart of ``examples/jax_tp_gossip.py``: a transformer LM (vocab
128, ``--layers`` Megatron blocks of
:mod:`bluefog_tpu_torch.parallel.tensor_parallel`) sharded over ``--tp``
while ``--dp`` replicas gossip their parameters on
``ExponentialTwoGraph(dp)`` after every momentum-SGD step (ATC).  The
parameters are rank-major: sharded leaves ``[dp, tp, ...]``, replicated
leaves (embedding, norms, unembedding) ``[dp, ...]`` (the split layout of
``split_tp_params``).  Each replica starts from its own init; the data is
the reference's learnable synthetic language, token' = token + 1 mod 128
(``init_params`` and ``synthetic_batches`` take another ``vocab``).
``--attention flash`` runs the flash kernels of the compute dtype (the
tp shards folded into one launch a layer), ``dense`` the reference's
dense attention.  f32, as the reference example.

Run (one H100):  python -m bluefog_tpu_torch.examples.tp_gossip
Run (CPU):       python -m bluefog_tpu_torch.examples.tp_gossip --device cpu --attention dense
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core.basics import resolve_device
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.ops import neighbor_allreduce_plan, tree_flatten, tree_map
from bluefog_tpu_torch.parallel import tensor_parallel as tpp
from bluefog_tpu_torch.parallel.pipeline import stack_stage_params

VOCAB = 128


def init_params(d_model: int, heads: int, dff: int, layers: int, *, seed: int, device=None,
                vocab: int = VOCAB):
    """One replica's full parameters from ``numpy.random.default_rng(seed)``:
    N(0, 0.02²) embedding and unembedding over ``vocab`` tokens, the blocks
    of ``init_tp_block_params`` (the reference's distributions, not its
    ``jax.random`` bits)."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std).to(device)

    embed = normal((vocab, d_model), 0.02)
    blocks = [tpp.init_tp_block_params(d_model, heads, dff, seed=int(rng.integers(2 ** 31)),
                                       device=device) for _ in range(layers)]
    return {"embed": embed, "blocks": blocks, "unembed": normal((d_model, vocab), 0.02)}


def param_axes(layers: int):
    return {"embed": None, "blocks": [tpp.TP_BLOCK_SHARD_AXES for _ in range(layers)],
            "unembed": None}


def forward(params, ids, attention_fn=None):
    """ids [B, T] -> logits [B, T, V] for one replica (sharded leaves
    ``[tp, ...]``)."""
    x = params["embed"][ids]
    for blk in params["blocks"]:
        x = tpp.tp_transformer_block(x, blk, causal=True, attention_fn=attention_fn)
    return torch.einsum("btm,mv->btv", x, params["unembed"])


def replica_loss(params, ids, attention_fn=None):
    """The reference's loss: softmax cross-entropy of the next token."""
    logits = forward(params, ids[:, :-1], attention_fn)
    return F.cross_entropy(logits.flatten(0, 1).float(), ids[:, 1:].reshape(-1))


def stack_replicas(per_replica: List[Dict], axes, tp: int):
    """Per-replica full parameters -> rank-major ``(replicated [dp, ...],
    sharded [dp, tp, ...])`` leaves that require grad."""
    split = [tpp.split_tp_params(p, axes) for p in per_replica]

    def stack(trees):
        return tree_map(lambda a: a.requires_grad_(True), stack_stage_params(trees))

    return (stack([r for r, _ in split]),
            stack([tpp.shard_tp_params(s, axes, tp) for _, s in split]))


def make_step(repl, shard, plan, lr: float, attention_fn=None):
    """``step(ids [dp, B, T+1]) -> mean loss``: every replica's loss (each
    reads its own slice, so one backward gives each its gradient), momentum
    SGD (``optax.sgd(lr, momentum=0.9)``'s update, elementwise on the
    rank-major leaves), then every leaf mixed over the dp axis on
    ``plan``."""
    params = tree_flatten([repl, shard])[0]
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    dp = params[0].shape[0]

    def step(ids):
        opt.zero_grad(set_to_none=True)
        losses = torch.stack([
            replica_loss(tpp.merge_tp_params(*tree_map(lambda a: a[r], [repl, shard])), ids[r],
                         attention_fn) for r in range(dp)])
        losses.sum().backward()
        opt.step()
        with torch.no_grad():
            for p in params:
                p.copy_(neighbor_allreduce_plan(p, plan))
        return losses.detach().mean()

    return step


def synthetic_batches(dp: int, batch: int, seq: int, steps: int, device, seed: int = 0,
                      vocab: int = VOCAB):
    """The reference's learnable language: next token = (token + 1) mod vocab."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        start = rng.integers(0, vocab, size=(dp, batch, 1))
        out.append(torch.from_numpy((start + np.arange(seq + 1)) % vocab).to(device))
    return out


def spread(x: torch.Tensor) -> float:
    return (x - x.mean(0, keepdim=True)).abs().max().item()


def run(args, per_replica: Optional[List[Dict]] = None) -> dict:
    device = resolve_device(args.device)
    axes = param_axes(args.layers)
    if per_replica is None:
        per_replica = [init_params(args.d_model, args.heads, args.dff, args.layers, seed=r,
                                   device=device) for r in range(args.dp)]
    per_replica = [tree_map(lambda a: a.to(device), p) for p in per_replica]
    repl, shard = stack_replicas(per_replica, axes, args.tp)
    attention_fn = make_flash_attention_fn() if args.attention == "flash" else None
    step = make_step(repl, shard, compile_plan(topology_util.ExponentialTwoGraph(args.dp)),
                     args.lr, attention_fn)
    losses = []
    for i, ids in enumerate(synthetic_batches(args.dp, args.batch, args.seq, args.steps,
                                              device)):
        losses.append(step(ids).item())
        if (i + 1) % 10 == 0 or i == 0:
            print(f"step {i + 1:3d}: loss {losses[-1]:.4f} consensus-spread "
                  f"{spread(shard['blocks'][0]['mlp']['wi']):.2e} "
                  f"(embed {spread(repl['embed']):.2e})")
    print(f"done: dp={args.dp} tp={args.tp} on {device}")
    return {"dp": args.dp, "tp": args.tp, "layers": args.layers, "d_model": args.d_model,
            "attention": args.attention, "losses": losses,
            "consensus_spread": spread(shard["blocks"][0]["mlp"]["wi"])}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dff", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="per dp rank")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--attention", choices=["flash", "dense"], default="flash")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


if __name__ == "__main__":
    print(json.dumps(run(_parser().parse_args())))
