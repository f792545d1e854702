"""Synthetic throughput benchmark on the rank-major backend: the twin of
``examples/jax_benchmark.py`` (the reference's ``pytorch_benchmark``),
images/s with warm-up, with a selectable model, topology and
communication mode.

``--mode hierarchical`` averages each machine's ranks and mixes the
machines on ``ExponentialTwoGraph(machines)``.  One process holds every
rank, so the machines come from ``BLUEFOG_SIMULATE_SLICES=k`` (k machines
of ``--size // k`` ranks), as in the reference's single-process run.
The reference's ``--loader native`` (a C++ prefetching pipeline) waits for
the port of its native library; this script always reuses one synthetic
batch from a seed, the reference's ``--loader host``.

Run (CPU):  BLUEFOG_SIMULATE_SLICES=2 python -m bluefog_tpu_torch.examples.benchmark \\
                --model tiny --mode hierarchical --iters 3 --device cpu
Run (card): BLUEFOG_SIMULATE_SLICES=4 python -m bluefog_tpu_torch.examples.benchmark \\
                --size 8 --mode hierarchical
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.models import ResNet18, ResNet50
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
)

TOPOS = {
    "exp2": topology_util.ExponentialTwoGraph,
    "ring": topology_util.RingGraph,
    "full": topology_util.FullyConnectedGraph,
    "mesh2d": topology_util.MeshGrid2DGraph,
}
MODES = {
    "neighbor_allreduce": CommunicationType.neighbor_allreduce,
    "allreduce": CommunicationType.allreduce,
    "hierarchical": CommunicationType.hierarchical_neighbor_allreduce,
    "empty": CommunicationType.empty,
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50", choices=["resnet50", "resnet18", "tiny"])
    ap.add_argument("--batch-size", type=int, default=0,
                    help="per rank (0 = 64 on the card, 2 on the CPU)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--topology", default="exp2", choices=sorted(TOPOS))
    ap.add_argument("--mode", default="neighbor_allreduce", choices=sorted(MODES))
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace) -> Dict:
    bf.init(size=args.size, device=args.device)
    try:
        n, dev = bf.size(), bf.device()
        bf.set_topology(TOPOS[args.topology](n))
        ctx = bf.context()
        cuda = dev.type == "cuda"
        if cuda:
            torch.backends.cudnn.benchmark = True
        gen = torch.Generator().manual_seed(0)
        if args.model == "resnet50":
            model, img = ResNet50(num_classes=1000, device="cpu", generator=gen), 224
        elif args.model == "resnet18":
            model, img = ResNet18(num_classes=1000, device="cpu", generator=gen), 224
        else:
            model, img = ResNet18(num_classes=10, num_filters=8, small_images=True,
                                  device="cpu", generator=gen), 16
        model = model.to(dev)
        bsz = args.batch_size or (64 if cuda else 2)
        params = replicate_for_mesh(dict(model.named_parameters()), n)
        stats = replicate_for_mesh(dict(model.named_buffers()), n, requires_grad=False)
        rng = np.random.default_rng(0)
        labels = torch.from_numpy(rng.integers(0, 10, size=(n, bsz))).to(dev)
        batch = torch.from_numpy(
            rng.normal(size=(n, bsz, img, img, 3)).astype(np.float32)).to(dev)

        comm = MODES[args.mode]
        step_fn = make_decentralized_train_step(
            make_classifier_apply_fn(model), params,
            torch.optim.SGD(list(params.values()), lr=0.1, momentum=0.9),
            communication_type=comm,
            plan=ctx.plan if comm == CommunicationType.neighbor_allreduce else None,
            machine_plan=ctx.machine_plan if args.mode == "hierarchical" else None,
            batch_stats=stats)

        def sync(loss):
            assert torch.isfinite(loss).all().item(), loss

        loss = None
        for _ in range(args.warmup):
            loss, _ = step_fn(batch, labels)
        if loss is not None:
            sync(loss)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss, _ = step_fn(batch, labels)
        sync(loss)
        dt = (time.perf_counter() - t0) / args.iters
        return {"model": args.model, "topology": args.topology, "mode": args.mode,
                "ranks": n, "machines": bf.machine_size(), "batch_per_rank": bsz,
                "device": str(dev), "step_ms": dt * 1e3, "images_per_s_per_rank": bsz / dt,
                "images_per_s": n * bsz / dt}
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(f"model={out['model']} topology={out['topology']} mode={out['mode']} "
          f"ranks={out['ranks']} batch/rank={out['batch_per_rank']}")
    print(f"step time {out['step_ms']:.2f} ms | {out['images_per_s_per_rank']:.1f} "
          f"img/s/rank | {out['images_per_s']:.1f} img/s total")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
