"""ResNet/CIFAR-style decentralized training on the rank-major backend.

Counterpart of ``examples/jax_cifar_resnet.py``: a small-image ResNet-18
trains with ATC gossip over ``ExponentialTwoGraph(size)``, each rank's
BatchNorm statistics local to it (``batch_stats``).  The arrays
are CIFAR-10's where ``$CIFAR_NPZ`` names a file that exists; otherwise a
structured synthetic stand-in (one smoothed colored template a class, plus
noise).

Run (one card):  python -m bluefog_tpu_torch.examples.cifar_resnet
Run (CPU):       python -m bluefog_tpu_torch.examples.cifar_resnet --device cpu --filters 8
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.models import ResNet18
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
)


def load_cifar(n_train: int, n_test: int, rng: np.random.Generator):
    """Real CIFAR-10 if present at ``$CIFAR_NPZ``, else structured synthetic:
    ``(x_train [n, 32, 32, 3] f32, y_train [n] int, x_test, y_test)``."""
    path = os.environ.get("CIFAR_NPZ", "")
    if path and os.path.exists(path):
        d = np.load(path)
        return ((d["x_train"][:n_train] / 255.0).astype(np.float32),
                d["y_train"][:n_train].astype(np.int64).reshape(-1),
                (d["x_test"][:n_test] / 255.0).astype(np.float32),
                d["y_test"][:n_test].astype(np.int64).reshape(-1))
    templates = rng.normal(size=(10, 32, 32, 3)).astype(np.float32)
    for _ in range(3):
        templates = (templates + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)) / 5.0

    def make(m):
        y = rng.integers(0, 10, size=m)
        x = templates[y] + 0.6 * rng.normal(size=(m, 32, 32, 3)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8, help="per rank")
    ap.add_argument("--train-size", type=int, default=1024)
    ap.add_argument("--filters", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args: argparse.Namespace) -> Dict:
    """Train ``args.epochs`` epochs; return per-epoch train loss and rank 0's
    test accuracy with its own running statistics (eval mode)."""
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            device=args.device)
    try:
        dev, n = bf.device(), bf.size()
        rng = np.random.default_rng(args.seed)
        xtr, ytr, xte, yte = load_cifar(args.train_size, 256, rng)
        per_rank = len(xtr) // n
        xtr = torch.from_numpy(xtr[:per_rank * n]).view(n, per_rank, 32, 32, 3).to(dev)
        ytr = torch.from_numpy(ytr[:per_rank * n]).view(n, per_rank).to(dev)
        xte, yte = torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev)

        gen = torch.Generator().manual_seed(args.seed)
        model = ResNet18(num_classes=10, num_filters=args.filters, small_images=True,
                         device="cpu", generator=gen).to(dev)
        params = replicate_for_mesh(dict(model.named_parameters()), n)
        stats = replicate_for_mesh(dict(model.named_buffers()), n, requires_grad=False)
        opt = torch.optim.SGD(list(params.values()), lr=args.lr, momentum=0.9)
        apply_fn = make_classifier_apply_fn(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, opt, communication_type=CommunicationType.neighbor_allreduce,
            plan=bf.context().plan, batch_stats=stats)

        epochs = []
        for _ in range(args.epochs):
            perm = torch.from_numpy(rng.permutation(per_rank)).to(dev)
            losses = []
            model.train()
            for s in range(per_rank // args.batch_size):
                idx = perm[s * args.batch_size:(s + 1) * args.batch_size]
                losses.append(step_fn(xtr[:, idx], ytr[:, idx])[0])
            model.eval()
            with torch.no_grad():
                rank0 = {k: v[0] for k, v in {**params, **stats}.items()}
                acc = (apply_fn(rank0, xte).argmax(-1) == yte).float().mean().item()
            epochs.append({"train_loss": torch.stack(losses).mean().item(),
                           "test_acc_rank0": acc})
        model.train()
        return {"ranks": n, "device": str(dev), "epochs": epochs}
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    for i, e in enumerate(out["epochs"]):
        print(f"epoch {i + 1}: test acc {e['test_acc_rank0']:.4f}, "
              f"train loss {e['train_loss']:.4f}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
