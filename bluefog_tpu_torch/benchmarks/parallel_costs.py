"""What three parallel layers cost on the card, in time and in peak memory:

- ``ring``: one forward and backward of ``ring_flash_attention`` (bf16,
  causal, contiguous and striped) at the seq-parallel shape of the small
  preset: 4 ranks, batch 2, a context of 8192 tokens (shards of 2048),
  12 heads of 64;
- ``zero``: one step of the packed ZeRO-1 builder
  (``parallel.zero.make_zero_gossip_train_step``) on one layer of the 8B
  Llama widths (``benchmarks.zero_8b.CFG``), mesh 2 machines x 4 local
  ranks, f32 momentum, the machine gossip on ExponentialTwoGraph(2);
- ``pipeline``: one forward and backward of ``examples.pp_gossip``'s
  pipelined loss at the small preset's widths (d 768, 12 heads, 12
  layers over 4 stages, vocab 32000), 4 microbatches, batch 8 x seq 512,
  f32.

Each is timed between CUDA events, the median of ``--reps`` runs after
one untimed run, and its peak is ``torch.cuda.max_memory_allocated`` over
the timed runs, beside what was allocated before them.  The script uses
only functions its package has had since the layers were ported, so the
same file measures an older checkout of the package put first on
``PYTHONPATH``.  One JSON line, with the card's name and power limit.
Exits 1 without a card.

Run (one H100):  python bluefog_tpu_torch/benchmarks/parallel_costs.py [--only ring,zero]
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict

import torch

RING = dict(ranks=4, batch=2, seq=8192, heads=12, head_dim=64)
ZERO = dict(layers=1, mesh=(2, 4))
PIPE = dict(d_model=768, heads=12, layers=12, stages=4, micro=4, batch=8, seq=512,
            vocab=32000)
PARTS = ("ring", "zero", "pipeline")


def _measure(fn: Callable[[], None], reps: int) -> Dict[str, float]:
    fn()
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"ms": statistics.median(times), "ms_all": times,
            "allocated_before_gb": base / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def ring(reps: int) -> Dict:
    from bluefog_tpu_torch.parallel.ring_attention import ring_flash_attention

    c = RING
    n, t = c["ranks"], c["seq"] // c["ranks"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(n * c["batch"], t, c["heads"], c["head_dim"], generator=gen,
                              device="cuda").bfloat16() for _ in range(4))
    for x in (q, k, v):
        x.requires_grad_(True)
    out = {}
    for striped in (False, True):
        def step():
            o = ring_flash_attention(q, k, v, n, causal=True, striped=striped)
            torch.autograd.grad(o, (q, k, v), g)

        out["striped" if striped else "contiguous"] = _measure(step, reps)
    return out


def zero(reps: int) -> Dict:
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.benchmarks import zero_8b
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.parallel import zero as z

    mesh = ZERO["mesh"]
    model = zero_8b.build_model(zero_8b.CFG, ZERO["layers"], grad_dtype=None, device="cuda")
    init = {k: v.detach() for k, v in model.named_parameters()}
    model.to("meta")
    plan = compile_plan(topology_util.ExponentialTwoGraph(mesh[0]))
    _, init_fn, step_fn, _, _ = zero_8b.make_step(model, mesh, plan,
                                                  builder=z.make_zero_gossip_train_step,
                                                  momentum_dtype=torch.float32)
    box = {"state": init_fn(init)}
    del init
    (ids,) = zero_8b.token_batches(zero_8b.CFG, mesh[0], mesh[1], 1, "cuda")
    x = ids.reshape(mesh + (-1, ids.shape[-1]))

    def step():
        box["state"], _ = step_fn(box["state"], x, x)

    row = _measure(step, reps)
    del box
    return row


def pipeline(reps: int) -> Dict:
    from bluefog_tpu_torch.examples import pp_gossip

    c = PIPE
    blocks, repl = pp_gossip.init_replica(c["d_model"], c["heads"], c["layers"], seed=0,
                                          device="cuda", vocab=c["vocab"])
    stages = pp_gossip.stage_stack(blocks, c["stages"])
    ids = pp_gossip.synthetic_batches(1, c["batch"], c["seq"], 1, "cuda",
                                      vocab=c["vocab"])[0][0]
    params = list(repl.values()) + list(stages.values())
    for p in params:
        p.requires_grad_(True)

    def step():
        loss = pp_gossip.replica_loss(repl, stages, ids, c["micro"])
        torch.autograd.grad(loss, params)

    return _measure(step, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)}")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parallel_costs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    import bluefog_tpu_torch

    row = {"bench": "parallel_costs", "card": card.strip().splitlines()[0],
           "package": bluefog_tpu_torch.__file__, "reps": args.reps,
           "shapes": {"ring": RING, "zero": dict(ZERO, widths="zero_8b.CFG"), "pipeline": PIPE}}
    for part in args.only.split(","):
        row[part] = {"ring": ring, "zero": zero, "pipeline": pipeline}[part](args.reps)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
