"""Llama-style decentralized pretraining throughput, tokens/sec/chip
(counterpart of ``benchmarks/llama.py``): the ATC train step with the
exponential-2 plan, timed by the paired-slope estimator over ``--passes``
passes, and a global-allreduce baseline phase from the same host copy of
the initial weights for ``vs_baseline``.  One JSON line.

The presets, the token streams and the model builder are
``examples/llama_pretrain.py``'s.  On one card ``--size`` virtual ranks
(default 4) train side by side in the rank-major layout, so a step moves
``size x batch x seq`` tokens through the chip; the reference ran one rank
a chip.  ``--attn-impl`` selects the flash route
(:func:`bluefog_tpu_torch.kernels.make_flash_attention_fn`'s ``impl``:
``auto`` / ``pallas`` / ``cuda`` the kernels, ``xla`` the blockwise route)
or ``dense``, the model's own attention; there is no fallback from one to
another.  ``--blocks`` sets ``block_q = block_k``: on the kernel route only
the built tile is accepted.  The MFU keys count the reference's 6N flops a
token (and 6 L T d of causal attention for ``mfu_attn_incl``) against the
H100's dense bf16 peak, 989 TFLOP/s; on the CPU they are null.

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.llama [--optimizer adafactor]
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.llama --device cpu --preset tiny --iters 3 --passes 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.examples.llama_pretrain import (
    DP_LR,
    OPTIMIZERS,
    PRESETS,
    build_model,
    make_optimizer,
    make_streams,
)
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.profiling import measure_rtt, paired_slope, robust_min, throughput_range
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
ATTN_IMPLS = ("auto", "pallas", "cuda", "xla", "dense")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=4, help="virtual ranks on the device")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--passes", type=int, default=3,
                    help="paired-slope passes of the gossip phase; the value is their "
                    "robust_min and the JSON carries their range")
    ap.add_argument("--attn-impl", default="auto", choices=ATTN_IMPLS,
                    help="flash route (dense = the model's own softmax attention)")
    ap.add_argument("--batch", type=int, default=0, help="per-rank batch (0 = preset)")
    ap.add_argument("--blocks", type=int, default=0,
                    help="flash block_q = block_k (0 = the default; on the kernel route "
                    "only the built tile)")
    ap.add_argument("--remat-policy", default=None, choices=["dots", "dots_no_batch", "attn"],
                    help="checkpoint policy; needs a remat preset")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: kv head count (0 = MHA)")
    ap.add_argument("--head-chunks", type=int, default=-1,
                    help="chunked LM loss: sequence chunks (-1 = preset, 0/1 = full logits)")
    ap.add_argument("--head-bf16", action="store_true",
                    help="LM head with bf16 operands and f32 accumulation")
    ap.add_argument("--seq", type=int, default=0, help="sequence length (0 = preset)")
    ap.add_argument("--layers", type=int, default=0, help="decoder layers (0 = preset)")
    ap.add_argument("--fuse", action="store_true",
                    help="gossip through the fusion buffer (gossip phase only)")
    ap.add_argument("--optimizer", default=None, choices=sorted(OPTIMIZERS),
                    help="base optimizer (default: the preset's, else adamw)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _sync(loss: torch.Tensor) -> float:
    """Wait for ``loss`` (a scalar fetch) and check it is finite."""
    v = float(loss.float().sum())
    if not np.isfinite(v):
        raise RuntimeError(f"llama: non-finite loss {v}")
    return v


def _effective_attn(impl: str, dev: torch.device) -> str:
    if impl == "dense":
        return "dense"
    if impl == "xla":
        return "blockwise route (impl=xla)"
    return "cuda kernels" if dev.type == "cuda" else "plain versions (cpu)"


def run(args: argparse.Namespace) -> Dict:
    """Both phases; returns the JSON record."""
    cfg = dict(PRESETS[args.preset])
    B = args.batch or cfg["batch"]
    T = args.seq or cfg["seq"]
    layers = args.layers or cfg["layers"]
    head_chunks = cfg["head_chunks"] if args.head_chunks < 0 else args.head_chunks
    optimizer = args.optimizer or cfg.get("optimizer", "adamw")
    attention_fn = None
    if args.attn_impl != "dense":
        attention_fn = make_flash_attention_fn(impl=args.attn_impl, block_q=args.blocks or None,
                                               block_k=args.blocks or None)
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size, device=args.device)
    try:
        dev = bf.device()
        n = bf.size()
        plan = bf.context().plan
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # the reference's model computes in bf16
        model = build_model(argparse.Namespace(**vars(args), dtype="bf16"), cfg, layers,
                            head_chunks, attention_fn)
        host = {k: v.detach().clone() for k, v in model.named_parameters()}
        n_params = sum(v.numel() for v in host.values())
        ids = torch.from_numpy(make_streams(np.random.default_rng(args.seed), cfg["vocab"],
                                            n * B, T)).view(n, B, T).to(dev)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        steps, fallbacks = [0], [0]

        def timed(comm: CommunicationType, passes: int) -> Tuple[List[float], List[float]]:
            """The phase's per-step seconds by pass, and its last step's
            per-rank losses."""
            params = replicate_for_mesh({k: v.to(dev) for k, v in host.items()}, n)
            opt = make_optimizer(optimizer, model, params, DP_LR)
            step_fn = make_decentralized_train_step(
                apply_fn, params, opt, communication_type=comm,
                plan=plan if comm == CommunicationType.neighbor_allreduce else None,
                loss_fn=loss_fn,
                # the allreduce baseline has no fusion buffer
                comm_fuse=args.fuse and comm == CommunicationType.neighbor_allreduce)
            loss = None

            def step():
                nonlocal loss
                loss = step_fn(ids, ids)[0]
                steps[0] += 1

            for _ in range(args.warmup):
                step()
            if loss is not None:
                _sync(loss)

            def region(k: int) -> float:
                t0 = time.perf_counter()
                for _ in range(k):
                    step()
                _sync(loss)
                return time.perf_counter() - t0

            ts = []
            for _ in range(passes):
                t, fb = paired_slope(region, args.iters, "llama", lambda: measure_rtt(loss))
                fallbacks[0] += int(fb)
                ts.append(t)
            return ts, loss.float().cpu().tolist()

        dec_times, losses = timed(CommunicationType.neighbor_allreduce, args.passes)
        t_dec = robust_min(dec_times, "llama-dec")
        if n == 1 and cfg.get("remat"):
            # one rank: the exp2 plan has no edges, both phases are one program
            t_ar = t_dec
        else:
            t_ar = min(timed(CommunicationType.allreduce, 1)[0])
        on_card = dev.type == "cuda"
        toks = n * B * T / t_dec
        flops_per_tok = 6.0 * n_params  # PaLM's MFU convention, remat not counted
        attn_per_tok = 6.0 * layers * T * cfg["hidden"]  # causal QK and PV, fwd + bwd
        return {
            "metric": f"Llama-{args.preset} ({n_params / 1e6:.0f}M) tokens/sec/chip "
                      f"({n} ranks a chip, neighbor_allreduce exp2, S={T}, {dev.type})",
            "value": round(toks, 1),
            "unit": "tok/s/chip",
            "vs_baseline": round(t_ar / t_dec, 4),
            "mfu_vs_989tf_bf16": (round(toks * flops_per_tok / PEAK_BF16_FLOPS, 4)
                                  if on_card else None),
            "mfu_attn_incl": (round(toks * (flops_per_tok + attn_per_tok) / PEAK_BF16_FLOPS, 4)
                              if on_card else None),
            "estimator": "paired-slope",
            "estimator_fallbacks": fallbacks[0],
            "range": throughput_range(dec_times, n * B * T),
            "n_runs": len(dec_times),
            "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                               if on_card else None),
            "effective_attn": _effective_attn(args.attn_impl, dev),
            "step_ms": t_dec * 1e3, "baseline_step_ms": t_ar * 1e3,
            "pass_ms": [t * 1e3 for t in dec_times], "losses": losses,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "ranks": n, "batch": B, "seq": T, "layers": layers,
            "params_per_rank": n_params, "optimizer": optimizer, "lr": DP_LR,
            "head_chunks": head_chunks, "attn_impl": args.attn_impl,
            "blocks": args.blocks or None, "fuse": args.fuse, "steps": steps[0],
        }
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.remat_policy and not PRESETS[args.preset].get("remat"):
        # the model reads remat_policy only under remat: a number attributed
        # to a policy that never applied would mislead
        ap.error(f"--remat-policy requires a remat preset (preset {args.preset!r} has "
                 f"remat=False)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("llama: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
