"""Llama-style decentralized pretraining on the rank-major backend.

Counterpart of ``examples/jax_llama_pretrain.py`` with the presets of
``benchmarks/llama.py``: ``size`` virtual ranks each train a Llama decoder
on a private token stream, and parameters mix by ``neighbor_allreduce``
on the exponential-2 graph after every AdamW step (ATC).  Attention runs
through the hand-written flash-attention kernels on the card.

Run (one H100):  python -m bluefog_tpu_torch.examples.llama_pretrain --preset small
Run (CPU):       python -m bluefog_tpu_torch.examples.llama_pretrain --preset tiny --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

PRESETS = {
    # ~134M: GPT-2-small-shaped Llama (benchmarks/llama.py "small")
    "small": dict(vocab=32000, hidden=768, layers=12, heads=12, dff=2048,
                  seq=2048, batch=8, head_chunks=8),
    "tiny": dict(vocab=256, hidden=64, layers=2, heads=4, dff=128,
                 seq=128, batch=2, head_chunks=0),
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler and report "
                    "device time by kernel")
    return ap


def _device_timeline(prof) -> Dict:
    """Busy time and span of the device in the traced step, from the trace's
    own timeline: the union of kernel, memcpy and memset intervals, over the
    time from the first device operation's start to the last one's end."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, spans[0][0] if spans else 0.0
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    span_us = end - spans[0][0] if spans else 0.0
    return {"device_ops": len(spans), "device_union_busy_ms": busy_us / 1e3,
            "device_span_ms": span_us / 1e3,
            "idle_share": 1.0 - busy_us / span_us if span_us else None}


def _device_profile(prof, wall_ms: float, top: int = 15) -> Dict:
    """Device time by kernel name from a torch.profiler trace of one step,
    and the device's idle share on the trace's own timeline."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        # user annotations (e.g. "Optimizer.step#AdamW.step") span kernels
        # already counted under their own names
        if (e.device_type.name == "CUDA" and dev_us > 0
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, **_device_timeline(prof),
            "top": [[name[:90], ms, n] for name, ms, n in rows[:top]]}


def run(args: argparse.Namespace) -> Dict:
    """Train ``args.steps`` steps; return losses, timings and memory."""
    cfg = dict(PRESETS[args.preset])
    B = args.batch or cfg["batch"]
    T = cfg["seq"]
    layers = cfg["layers"]
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            device=args.device)
    try:
        dev = bf.device()
        n = bf.size()
        gen = torch.Generator(device="cpu").manual_seed(args.seed)
        model = LlamaLM(
            vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=layers,
            num_heads=cfg["heads"], dff=cfg["dff"], dtype=torch.bfloat16,
            attention_fn=make_flash_attention_fn() if args.attention == "flash" else None,
            head_chunks=cfg["head_chunks"], device="cpu", generator=gen,
        ).to(dev)
        params = replicate_for_mesh(dict(model.named_parameters()), n)
        n_params = sum(v[0].numel() for v in params.values())
        opt = torch.optim.AdamW(list(params.values()), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, opt,
            communication_type=CommunicationType[args.comm],
            plan=bf.context().plan, loss_fn=loss_fn)

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
                loss = step_fn(data[s], data[s])
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
            "seq": T, "params_per_rank": n_params, "losses": losses,
            "step_ms": step_ms,
            "tokens_per_s": n * B * T / (float(np.mean(steady)) / 1e3),
            "consensus_spread": spread, "device": str(dev),
        }
        if on_cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        if prof is not None:
            out["profile"] = _device_profile(prof, step_ms[-1])
        return out
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
