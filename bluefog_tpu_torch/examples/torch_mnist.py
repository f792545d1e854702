"""LeNet/MNIST decentralized training on the rank-major backend.

Counterpart of ``examples/jax_mnist.py``: ``size`` virtual ranks each hold
a private shard of the training set; parameters start broadcast from rank 0
(:func:`bluefog_tpu_torch.broadcast_parameters`) and mix each momentum-SGD
step by the chosen communication over ``ExponentialTwoGraph(size)``.

The arrays are MNIST's where ``$MNIST_NPZ`` names a file that exists;
otherwise a structured synthetic stand-in of the same shapes and dtypes
(one smoothed random template a class, plus noise), so accuracy still
moves.  ``--loader native`` writes every (epoch, step) batch to one packed
binary file and streams it through the C++ prefetching loader
(``native/data_loader.cc``), as the reference's does; the batches, and so
the training, are the Python route's.

Run (one card):  python -m bluefog_tpu_torch.examples.torch_mnist
Run (CPU):       python -m bluefog_tpu_torch.examples.torch_mnist --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.models import LeNet5
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
)


def load_mnist(n_train: int = 2048, n_test: int = 512, rng=None):
    """Real MNIST if present at ``$MNIST_NPZ``, else structured synthetic:
    ``(x_train [n, 28, 28, 1] f32, y_train [n] int, x_test, y_test)``."""
    path = os.environ.get("MNIST_NPZ", "")
    if path and os.path.exists(path):
        d = np.load(path)
        return (
            (d["x_train"][:n_train, ..., None] / 255.0).astype(np.float32),
            d["y_train"][:n_train].astype(np.int64),
            (d["x_test"][:n_test, ..., None] / 255.0).astype(np.float32),
            d["y_test"][:n_test].astype(np.int64),
        )
    rng = rng or np.random.default_rng(0)
    templates = rng.normal(size=(10, 28, 28)).astype(np.float32)
    for _ in range(2):  # cheap smoothing
        templates = (templates + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)) / 5.0

    def make(n):
        y = rng.integers(0, 10, size=n)
        x = templates[y] + 0.5 * rng.normal(size=(n, 28, 28)).astype(np.float32)
        return x[..., None].astype(np.float32), y.astype(np.int64)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=16, help="per rank")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--mode", default="neighbor_allreduce",
                    choices=["neighbor_allreduce", "allreduce", "empty"])
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loader", default="python", choices=["python", "native"],
                    help="native: stream the batches from a packed binary file "
                    "through the C++ prefetching loader (data_loader.cc)")
    return ap


def _write_batches(path, xtr, ytr, perms, batch, steps) -> None:
    """Every (epoch, step) batch as one f32 record [n, B, 784 + 1] (pixels,
    then the label), in training order."""
    n = xtr.shape[0]
    with open(path, "wb") as f:
        for perm in perms:
            for s in range(steps):
                idx = perm[s * batch:(s + 1) * batch]
                bx = xtr[:, idx].reshape(n, batch, -1)
                by = ytr[:, idx].astype(np.float32)[..., None]
                f.write(np.concatenate([bx, by], axis=2).astype(np.float32).tobytes())


def run(args: argparse.Namespace) -> Dict:
    """Train ``args.epochs`` epochs; return per-epoch train loss and
    accuracy (mean over ranks), rank 0's test accuracy and the consensus
    spread."""
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            device=args.device)
    loader = loader_path = None
    try:
        dev, n = bf.device(), bf.size()
        xtr, ytr, xte, yte = load_mnist(args.train_size, rng=np.random.default_rng(args.seed))
        per_rank = len(xtr) // n
        xtr_np = xtr[:per_rank * n].reshape(n, per_rank, 28, 28, 1)
        ytr_np = ytr[:per_rank * n].reshape(n, per_rank)
        xtr, ytr = torch.from_numpy(xtr_np).to(dev), torch.from_numpy(ytr_np).to(dev)
        xte, yte = torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev)

        gen = torch.Generator().manual_seed(args.seed)
        model = LeNet5(device="cpu", generator=gen).to(dev)
        params = replicate_for_mesh(dict(model.named_parameters()), n)
        bf.broadcast_parameters(params, root_rank=0)
        opt = torch.optim.SGD(list(params.values()), lr=args.lr, momentum=0.9)
        step_fn = make_decentralized_train_step(
            make_classifier_apply_fn(model), params, opt,
            communication_type=CommunicationType[args.mode], plan=bf.context().plan)

        steps = per_rank // args.batch_size
        rng = np.random.default_rng(args.seed + 1)
        perms = [rng.permutation(per_rank) for _ in range(args.epochs)]
        B = args.batch_size
        if args.loader == "native":
            from bluefog_tpu_torch.native.data_native import NativeDataLoader

            fd, loader_path = tempfile.mkstemp(prefix="bf_mnist_", suffix=".bin")
            os.close(fd)
            _write_batches(loader_path, xtr_np, ytr_np, perms, B, steps)
            # workers=1: records arrive in written (epoch, step) order
            loader = NativeDataLoader((n, B, 28 * 28 + 1), depth=4, workers=1,
                                      path=loader_path)
        epochs = []
        for perm_np in perms:
            perm = torch.from_numpy(perm_np).to(dev)
            losses, accs = [], []
            for s in range(steps):
                if loader is not None:
                    rec = torch.from_numpy(loader.next())
                    bx = rec[..., :-1].reshape(n, B, 28, 28, 1).to(dev)
                    by = rec[..., -1].to(torch.int64).to(dev)
                else:
                    idx = perm[s * B:(s + 1) * B]
                    bx, by = xtr[:, idx], ytr[:, idx]
                loss, acc = step_fn(bx, by)
                losses.append(loss)
                accs.append(acc)
            with torch.no_grad():
                rank0 = {k: v[0] for k, v in params.items()}
                logits = make_classifier_apply_fn(model)(rank0, xte)
                test_acc = (logits.argmax(-1) == yte).float().mean().item()
                spread = max(float(v.std(dim=0).max()) for v in params.values())
            epochs.append({"train_loss": torch.stack(losses).mean().item(),
                           "train_acc": torch.stack(accs).mean().item(),
                           "test_acc_rank0": test_acc, "consensus_spread": spread})
        return {"ranks": n, "mode": args.mode, "device": str(dev),
                "loader": args.loader, "steps_per_epoch": steps, "epochs": epochs}
    finally:
        if loader is not None:
            loader.close()
        if loader_path is not None:
            os.unlink(loader_path)
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    for i, e in enumerate(out["epochs"]):
        print(f"epoch {i + 1}: test acc (rank0) {e['test_acc_rank0']:.4f}, "
              f"train loss {e['train_loss']:.4f}, "
              f"param consensus spread {e['consensus_spread']:.2e}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
