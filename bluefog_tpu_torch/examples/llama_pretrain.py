"""Llama-style decentralized pretraining on the rank-major backend.

Counterpart of ``examples/jax_llama_pretrain.py`` with the presets of
``benchmarks/llama.py``: ``size`` virtual ranks each train a Llama decoder
on a private token stream, and parameters mix by ``neighbor_allreduce``
on the exponential-2 graph after every optimizer step (ATC; AdamW, or
the preset's optimizer).  Attention runs through the hand-written
flash-attention kernels on the card.  The ``1b`` preset runs the
reference's remat, ``scan_layers`` and ``sgdm_bf16`` (momentum SGD with a
bf16 trace); ``--kv-heads`` gives grouped-query attention.

Run (one H100):  python -m bluefog_tpu_torch.examples.llama_pretrain --preset small
                 python -m bluefog_tpu_torch.examples.llama_pretrain --preset 1b --kv-heads 2 --batch 2
Run (CPU):       python -m bluefog_tpu_torch.examples.llama_pretrain --preset tiny --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import CommunicationType, TraceSGD
from bluefog_tpu_torch.profiling import device_profile
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

PRESETS = {
    # ~134M: GPT-2-small-shaped Llama (benchmarks/llama.py "small")
    "small": dict(vocab=32000, hidden=768, layers=12, heads=12, dff=2048,
                  seq=2048, batch=8, head_chunks=8),
    # ~0.9-1.05B (benchmarks/llama.py "1b"): per-block remat, the blocks'
    # weights stacked (scan_layers), momentum SGD with a bf16 trace
    "1b": dict(vocab=32000, hidden=1792, layers=24, heads=14, dff=4864,
               seq=2048, batch=8, remat=True, scan_layers=True,
               optimizer="sgdm_bf16", head_chunks=8),
    "tiny": dict(vocab=256, hidden=64, layers=2, heads=4, dff=128,
                 seq=128, batch=2, head_chunks=0),
}


# base optimizers of benchmarks/llama.py (adafactor is left out: torch's
# Adafactor is not optax's)
OPTIMIZERS = {
    "adamw": lambda leaves: torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                              eps=1e-8, weight_decay=1e-4),
    "sgdm": lambda leaves: torch.optim.SGD(leaves, lr=3e-4, momentum=0.9),
    "sgdm_bf16": lambda leaves: TraceSGD(leaves, lr=3e-4, momentum=0.9,
                                         trace_dtype=torch.bfloat16),
}


def make_streams(rng: np.random.Generator, vocab: int, rows: int, length: int,
                 fanout: int = 8) -> np.ndarray:
    """``rows`` Markov-chain token streams of ``length`` tokens: each token
    has ``fanout`` possible successors with Dirichlet(0.1) probabilities,
    next-token structure an LM can learn (a sparse form of the JAX example's
    ``make_stream``, whose dense ``vocab x vocab`` table is too large at
    vocab 32000)."""
    nxt = rng.integers(0, vocab, size=(vocab, fanout))
    cum = np.cumsum(rng.dirichlet(np.full(fanout, 0.1), size=vocab), axis=1)
    toks = np.empty((rows, length), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=rows)
    for t in range(1, length):
        prev = toks[:, t - 1]
        pick = (cum[prev] < rng.random(rows)[:, None]).sum(axis=1)
        toks[:, t] = nxt[prev, np.minimum(pick, fanout - 1)]
    return toks


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--batch", type=int, default=0, help="per-rank batch (0 = preset)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attention", choices=["flash", "dense"], default="flash")
    ap.add_argument("--comm", choices=["neighbor_allreduce", "allreduce"],
                    default="neighbor_allreduce")
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                    help="compute dtype of the decoder (the flash kernels of that "
                    "dtype run); parameters are f32 either way")
    ap.add_argument("--head-bf16", action="store_true",
                    help="LM head matmul with bf16 operands and f32 accumulation "
                    "(default: f32 operands)")
    ap.add_argument("--seq", type=int, default=0, help="sequence length (0 = preset)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: kv head count (0 = MHA; must "
                    "divide the preset's heads)")
    ap.add_argument("--remat-policy", default=None,
                    choices=["dots", "dots_no_batch", "attn"],
                    help="what a remat preset saves for the backward (default: "
                    "nothing, every block recomputed)")
    ap.add_argument("--optimizer", default=None, choices=sorted(OPTIMIZERS),
                    help="base optimizer (default: the preset's, else adamw)")
    ap.add_argument("--head-chunks", type=int, default=-1,
                    help="chunked LM loss: sequence chunks of the head (-1 = "
                    "preset, 0/1 = full logits)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler and report "
                    "device time by kernel")
    return ap


def run(args: argparse.Namespace,
        setup: Optional[Callable[[Dict[str, torch.Tensor], torch.optim.Optimizer], None]] = None
        ) -> Dict:
    """Train ``args.steps`` steps; return losses, timings and memory.
    ``setup(params, base_optimizer)``, where given, is called once before
    the first step (to register hooks, e.g. on the local step)."""
    cfg = dict(PRESETS[args.preset])
    if args.remat_policy and not cfg.get("remat"):
        # the model consults remat_policy only under remat: a number
        # attributed to a policy that never applied would mislead
        raise ValueError(f"--remat-policy requires a remat preset (preset "
                         f"{args.preset!r} has remat=False)")
    B = args.batch or cfg["batch"]
    T = args.seq or cfg["seq"]
    layers = cfg["layers"]
    head_chunks = cfg["head_chunks"] if args.head_chunks < 0 else args.head_chunks
    optimizer = args.optimizer or cfg.get("optimizer", "adamw")
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            device=args.device)
    try:
        dev = bf.device()
        n = bf.size()
        gen = torch.Generator(device="cpu").manual_seed(args.seed)
        model = LlamaLM(
            vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=layers,
            num_heads=cfg["heads"], dff=cfg["dff"],
            dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
            attention_fn=make_flash_attention_fn() if args.attention == "flash" else None,
            head_chunks=head_chunks, device="cpu", generator=gen,
            head_dtype=torch.bfloat16 if args.head_bf16 else torch.float32,
            remat=cfg.get("remat", False), remat_policy=args.remat_policy,
            scan_layers=cfg.get("scan_layers", False), num_kv_heads=args.kv_heads or None,
        )
        # the model stays on the host: the step calls it on the rank-major
        # leaves' slices, so its own weights need no copy on the card
        params = replicate_for_mesh({k: v.to(dev) for k, v in model.named_parameters()}, n)
        n_params = sum(v[0].numel() for v in params.values())
        opt = OPTIMIZERS[optimizer](list(params.values()))
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, opt,
            communication_type=CommunicationType[args.comm],
            plan=bf.context().plan, loss_fn=loss_fn)

        if setup is not None:
            setup(params, opt)
        rng = np.random.default_rng(args.seed)
        toks = make_streams(rng, cfg["vocab"], n * B * args.steps, T)
        data = torch.from_numpy(toks).view(args.steps, n, B, T).to(dev)
        on_cuda = dev.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        prof = None
        if args.profile:
            # device activity only on the card: host-side op tracing would
            # stretch the gaps between launches that the idle share reads
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA if on_cuda
                else torch.profiler.ProfilerActivity.CPU])
        for s in range(args.steps):
            traced = prof is not None and s == args.steps - 1
            with prof if traced else contextlib.nullcontext():
                if on_cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                loss, _ = step_fn(data[s], data[s])
                if on_cuda:
                    torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.cpu().tolist())
        with torch.no_grad():
            spread = max(float(v.float().std(dim=0).max()) for v in params.values())
        # the first step warms up; a traced step carries the profiler's cost
        steady = step_ms[1:len(step_ms) - (prof is not None)] or step_ms
        out = {
            "preset": args.preset, "layers": layers, "ranks": n, "batch": B,
            "seq": T, "params_per_rank": n_params, "hidden": cfg["hidden"],
            "heads": cfg["heads"], "kv_heads": args.kv_heads or cfg["heads"],
            "remat": cfg.get("remat", False), "remat_policy": args.remat_policy,
            "scan_layers": cfg.get("scan_layers", False), "optimizer": optimizer,
            "head_chunks": head_chunks, "leaves": len(params),
            "dtype": args.dtype, "head_dtype": "bf16" if args.head_bf16 else "f32",
            "losses": losses,
            "step_ms": step_ms,
            "tokens_per_s": n * B * T / (float(np.mean(steady)) / 1e3),
            "consensus_spread": spread, "device": str(dev),
        }
        if on_cuda:
            stats = torch.cuda.memory_stats(dev)
            out["max_memory_allocated"] = stats["allocated_bytes.all.peak"]
            out["max_memory_reserved"] = stats["reserved_bytes.all.peak"]
            # allocations that failed and freed the cache to retry: each
            # synchronizes the card
            out["alloc_retries"] = stats["num_alloc_retries"]
        if prof is not None:
            out["profile"] = device_profile(prof, step_ms[-1])
        return out
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
