"""ZeRO-1 packed optimizer state + machine gossip on the rank-major backend.

Counterpart of ``examples/jax_zero_gossip.py``: a small Llama (vocab 211,
hidden 32, 2 layers, 4 heads, dff 64, remat, ``scan_layers``, f32) trains
on random tokens under :func:`bluefog_tpu_torch.parallel.zero.
make_zero_gossip_train_step`: the f32 master and momentum as a
``[machines, local, padded/local]`` grid, each (machine, local) batch its
own forward and backward, the machine's mean gradient updating each
shard, the shards mixing over the machine topology
(``ExponentialTwoGraph(machines)``).  30 steps at lr 0.1; the loss must
fall.  ``--size`` ranks in machines of ``--local-size`` (the reference
splits its devices into 2 machines).

Run (one H100):  python -m bluefog_tpu_torch.examples.zero_gossip
Run (CPU):       python -m bluefog_tpu_torch.examples.zero_gossip --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.parallel.zero import make_zero_gossip_train_step
from bluefog_tpu_torch.training import make_lm_loss_fns

VOCAB = 211


def make_model(device, seed: int = 0) -> LlamaLM:
    return LlamaLM(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, dff=64,
                   remat=True, scan_layers=True, dtype=torch.float32, device=device,
                   generator=torch.Generator(device=device).manual_seed(seed))


def loss_fn(logits, labels):
    """Shifted next-token cross-entropy, as the reference example's."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, labels[:, 1:, None]).mean()


def token_batches(machines: int, local: int, steps: int, device, seed: int = 0):
    """The reference example's batches: ``rng.integers(0, 211, (machines,
    local, 2, 16))`` a step from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, VOCAB, size=(machines, local, 2, 16))).to(device)
            for _ in range(steps)]


def build(model: LlamaLM, machines: int, local: int):
    """The reference example's builder call: lr 0.1, f32 compute, the
    machine plan when there is more than one machine."""
    apply_fn, _ = make_lm_loss_fns(model)
    plan = bf.context().machine_plan if machines > 1 else None
    return make_zero_gossip_train_step(apply_fn, loss_fn, (machines, local), plan,
                                       learning_rate=0.1, compute_dtype=torch.float32)


def run(args) -> dict:
    bf.init(size=args.size, local_size=args.local_size, device=args.device)
    try:
        machines, local = bf.machine_size(), bf.local_size()
        print(f"mesh: {machines} machines x {local} ranks")
        model = make_model(bf.device())
        params = {k: v.detach() for k, v in model.named_parameters()}
        init_fn, step_fn, params_of = build(model, machines, local)
        state = init_fn(params)
        n_params = sum(p.numel() for p in params.values())
        print(f"params {n_params}; each rank's shard holds {state['master'].shape[-1]} "
              f"f32 master elements (~1/{local} + padding)")
        losses = []
        for i, ids in enumerate(token_batches(machines, local, args.steps, bf.device())):
            state, loss = step_fn(state, ids, ids)
            losses.append(loss.item())
            if i % 10 == 0:
                print(f"step {i:3d}  loss {losses[-1]:.4f}")
        if losses[-1] >= losses[0]:
            raise RuntimeError(f"zero gossip: the loss did not fall ({losses[0]} -> {losses[-1]})")
        _ = params_of(state)  # the full tree, for eval or a checkpoint
        print("zero gossip demo OK")
        return {"machines": machines, "local": local, "params": n_params, "losses": losses}
    finally:
        bf.shutdown()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--local-size", type=int, default=4, help="ranks a machine")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


if __name__ == "__main__":
    print(json.dumps(run(_parser().parse_args())))
