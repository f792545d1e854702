"""BERT-style push-sum fine-tuning on the rank-major backend (BASELINE config #3).

Counterpart of ``examples/jax_bert_pushsum.py``: each of ``size`` virtual
ranks fine-tunes a small BERT encoder with Adam on its own stream of a
synthetic sentence-classification task (label: is the first token in the
upper half of the vocabulary).  Instead of any global reduction, ranks mix
parameters by push-sum over the directed ring, one window per parameter:
``win_accumulate`` half to the successor, ``win_update`` (keep half, take
the predecessor's deposit whole, reset), debias by the associated p, then
``win_set_exposed`` with p back at 1.

Run (one H100):  python -m bluefog_tpu_torch.examples.bert_pushsum
Run (CPU):       python -m bluefog_tpu_torch.examples.bert_pushsum --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.models.transformer import BertEncoder
from bluefog_tpu_torch.training import replicate_for_mesh

VOCAB = 128


def run(args) -> dict:
    bf.init(size=args.size, device=args.device)
    try:
        n, dev = bf.size(), bf.device()
        # directed ring: push-sum handles the column-stochastic asymmetry
        bf.set_topology(topology_util.RingGraph(n, connect_style=1))
        bf.turn_on_win_ops_with_associated_p()
        model = BertEncoder(vocab_size=VOCAB, hidden_size=args.hidden, num_layers=args.layers,
                            num_heads=4, dff=args.hidden * 4, max_len=args.seq_len,
                            num_classes=2, dtype=torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(0)).to(dev)
        rng = np.random.default_rng(0)

        def make_batch(shape):
            ids = rng.integers(0, VOCAB, size=shape + (args.seq_len,))
            return (torch.from_numpy(ids).to(dev),
                    torch.from_numpy((ids[..., 0] >= VOCAB // 2).astype(np.int64)).to(dev))

        params = replicate_for_mesh(dict(model.named_parameters()), n)
        names = list(params)
        for i, k in enumerate(names):
            bf.win_create(params[k].detach(), f"bert.{i}", zero_init=True)
        opt = torch.optim.Adam(params.values(), lr=args.lr)
        dst = [{(r + 1) % n: 0.5} for r in range(n)]
        ones_prev = [{(r - 1) % n: 1.0} for r in range(n)]
        losses, p_mass = [], 0.0
        for step in range(args.steps):
            ids, y = make_batch((n, args.batch_size))
            opt.zero_grad(set_to_none=True)
            loss = torch.stack([
                F.cross_entropy(functional_call(model, {k: v[r] for k, v in params.items()},
                                                (ids[r],)), y[r]) for r in range(n)])
            loss.sum().backward()  # rank r's loss reaches only rank r's slice
            opt.step()
            with torch.no_grad():  # push-sum: send half on, keep half, debias
                for i, k in enumerate(names):
                    name = f"bert.{i}"
                    bf.win_accumulate(params[k].detach(), name, dst_weights=dst)
                    m = bf.win_update(name, self_weight=0.5, neighbor_weights=ones_prev,
                                      reset=True)
                    p = bf.win_associated_p(name)
                    if i == 0:  # sum p after the update, before the restart
                        p_mass = p.sum().item()
                    merged = m / p.view((n,) + (1,) * (m.dim() - 1)).to(m.dtype)
                    bf.win_set_exposed(name, merged, associated_p=1.0)
                    params[k].copy_(merged)
            losses.append(loss.mean().item())
            if (step + 1) % 10 == 0:
                print(f"step {step + 1:3d}: mean loss {losses[-1]:.4f}", flush=True)
        bx, by = make_batch((256,))
        with torch.no_grad():
            logits = functional_call(model, {k: v[0] for k, v in params.items()}, (bx,))
        acc = (logits.argmax(-1) == by).float().mean().item()
        print(f"final rank-0 accuracy on fresh data: {acc:.3f}")
        return {"losses": losses, "accuracy": acc, "p_mass": p_mass, "ranks": n,
                "device": str(dev)}
    finally:
        bf.shutdown()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def main(argv=None) -> None:
    print(json.dumps(run(_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
