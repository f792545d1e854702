"""Average consensus: pure gossip, no optimizer.

Counterpart of ``examples/jax_average_consensus.py``: each of ``size``
virtual ranks starts from a random vector and repeatedly neighbor-averages
until every rank holds the global mean.

Run (one H100):  python -m bluefog_tpu_torch.examples.average_consensus
Run (CPU):       python -m bluefog_tpu_torch.examples.average_consensus --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util

TOPOLOGIES = {
    "exp2": topology_util.ExponentialTwoGraph,
    "ring": topology_util.RingGraph,
    "mesh2d": topology_util.MeshGrid2DGraph,
    "star": topology_util.StarGraph,
    "full": topology_util.FullyConnectedGraph,
}


def run(args) -> dict:
    bf.init(size=args.size, device=args.device)
    try:
        n = bf.size()
        bf.set_topology(TOPOLOGIES[args.topology](n))
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(n, args.dim)).astype(np.float32)).to(bf.device())
        target = x.mean(0)
        for it in range(args.max_iters):
            x = bf.neighbor_allreduce(x)
            err = (x - target).abs().max().item()
            if err < args.atol:
                print(f"consensus reached at iter {it + 1}: max|x - mean| = {err:.2e}")
                return {"topology": args.topology, "ranks": n, "iters": it + 1,
                        "max_err": err, "converged": True}
        print(f"no consensus after {args.max_iters} iters: max err {err:.2e}")
        return {"topology": args.topology, "ranks": n, "iters": args.max_iters,
                "max_err": err, "converged": False}
    finally:
        bf.shutdown()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--dim", type=int, default=1000)
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--topology", default="exp2", choices=sorted(TOPOLOGIES))
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def main(argv=None) -> None:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    if not out["converged"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
