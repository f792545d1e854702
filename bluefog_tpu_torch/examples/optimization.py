"""Decentralized optimization: logistic regression by gossip.

Counterpart of ``examples/jax_optimization.py``: each of ``size`` virtual
ranks holds a private shard of a synthetic logistic-regression problem,
and the ranks reach a common solution without any global reduction.
``--mode atc|awc`` runs gossip SGD (a neighborhood of the optimum under
heterogeneous shards), ``allreduce`` the synchronous baseline, and
``gt|extra|pushdiging`` the exact methods of
:mod:`bluefog_tpu_torch.algorithms` at a constant step.

Run (one H100):  python -m bluefog_tpu_torch.examples.optimization --mode gt
Run (CPU):       python -m bluefog_tpu_torch.examples.optimization --mode gt --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util

MODES = ("atc", "awc", "allreduce", "gt", "extra", "pushdiging")


def make_problem(n_ranks: int, n_per_rank: int, dim: int, rng: np.random.Generator):
    """(X [n, m, dim], y [n, m], w_true [dim]) as f32 numpy arrays, drawn
    as the JAX example draws them."""
    w_true = rng.normal(size=(dim,))
    X = rng.normal(size=(n_ranks, n_per_rank, dim))
    logits = X @ w_true
    y = (rng.uniform(size=logits.shape) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X.astype(np.float32), y, w_true.astype(np.float32)


def local_loss(w, X, y):
    """Every rank's mean logistic loss on its shard: [n]."""
    logits = torch.einsum("rmd,rd->rm", X, w)
    return F.binary_cross_entropy_with_logits(logits, y, reduction="none").mean(1)


def run(args) -> dict:
    bf.init(size=args.size, device=args.device)
    try:
        n, dev = bf.size(), bf.device()
        bf.set_topology(topology_util.ExponentialTwoGraph(n))
        X, y, _ = (torch.from_numpy(a).to(dev)
                   for a in make_problem(n, args.samples_per_rank, args.dim,
                                         np.random.default_rng(1)))
        w = torch.zeros(n, args.dim, device=dev, requires_grad=True)

        def grads_at(wv):
            wv = wv.detach().requires_grad_(True)
            local_loss(wv, X, y).sum().backward()  # rank r's loss reaches only w[r]
            return wv.grad

        log = []
        if args.mode in ("gt", "extra", "pushdiging"):
            # exact methods at a CONSTANT step: no decay needed to kill the bias
            opt = {"gt": bf.DistributedGradientTrackingOptimizer,
                   "extra": bf.DistributedEXTRAOptimizer,
                   "pushdiging": bf.DistributedPushDIGingOptimizer}[args.mode](args.lr)
            params = {"w": w.detach()}
            state = opt.init(params)
            step = lambda: opt.step(params, {"w": grads_at(params["w"])}, state)
        else:
            sgd = torch.optim.SGD([w], lr=args.lr)
            sched = torch.optim.lr_scheduler.LambdaLR(sgd, lambda t: 0.7 ** (t / 100))
            if args.mode == "allreduce":
                opt = bf.DistributedGradientAllreduceOptimizer(sgd)
            else:
                cls = (bf.DistributedAdaptThenCombineOptimizer if args.mode == "atc"
                       else bf.DistributedAdaptWithCombineOptimizer)
                opt = cls(sgd, plan=bf.context().plan)
            params = {"w": w}
        for it in range(args.iters):
            if args.mode in ("gt", "extra", "pushdiging"):
                params, state = step()
            else:
                opt.zero_grad()
                local_loss(w, X, y).sum().backward()
                opt.step()
                sched.step()
            if (it + 1) % 100 == 0:
                wv = params["w"].detach()
                loss = local_loss(wv, X, y).mean().item()
                spread = wv.std(0, unbiased=False).max().item()
                log.append({"iter": it + 1, "loss": loss, "spread": spread})
                print(f"iter {it + 1:4d} mean-local-loss {loss:.4f} "
                      f"consensus-spread {spread:.2e}", flush=True)
        wv = params["w"].detach()
        final = local_loss(wv, X, y).mean().item()
        print(f"final mean local loss: {final:.4f} (mode={args.mode}, ranks={n})")
        return {"mode": args.mode, "ranks": n, "final_loss": final,
                "consensus_spread": wv.std(0, unbiased=False).max().item(), "log": log}
    finally:
        bf.shutdown()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--samples-per-rank", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--mode", default="atc", choices=MODES)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def main(argv=None) -> None:
    print(json.dumps(run(_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
