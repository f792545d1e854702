"""Llama-style decentralized pretraining on the rank-major backend.

Counterpart of ``examples/jax_llama_pretrain.py`` with the presets of
``benchmarks/llama.py``, or with ``--hidden`` the reference example's own
model (``LlamaLM(vocab --vocab, hidden H, layers, heads 4, dff 3H)``; head
dim H / 4, 256 at ``--hidden 1024``): ``size`` virtual ranks each train a Llama decoder
on a private token stream, and parameters mix by ``neighbor_allreduce``
on the exponential-2 graph after every optimizer step (ATC; AdamW, or
the preset's optimizer).  Attention runs through the hand-written
flash-attention kernels on the card.  The ``1b`` preset runs the
reference's remat, ``scan_layers`` and ``sgdm_bf16`` (momentum SGD with a
bf16 trace); ``--kv-heads`` gives grouped-query attention.

``--seq-parallel`` is the reference's long-context mode (its
``run_seq_parallel``): ``--size`` ranks shard the *sequence* of one batch
``[B, --seq]``, ring attention (:mod:`bluefog_tpu_torch.parallel`) gives
exact global attention, and one replicated copy of the parameters trains
with Adam on the gradient of the global mean loss, in the rank-major
layout of :mod:`bluefog_tpu_torch.parallel.ring_attention`.  ``--striped``
selects the load-balanced striped layout, ``--ulysses`` Ulysses head
re-sharding in place of the ring; ``--attention flash`` runs the flash
kernels a hop, ``dense`` the plain f32 ring (no kernel), as the
reference's flag does.

Under ``bftpu-torch-run -np P`` the data-parallel path runs over P
processes (``init`` joins their gloo group): each trains its block of
``size // P`` ranks, the gossip moves the rows that cross a process
boundary, and the process's JSON line gives every rank's losses (gathered
over the group) and, a step, the bytes that crossed and the host staging
and transfer time (``cross_process``).

Run (one H100):  python -m bluefog_tpu_torch.examples.llama_pretrain --preset small
                 bftpu-torch-run -np 2 -- python -m bluefog_tpu_torch.examples.llama_pretrain --preset small
                 python -m bluefog_tpu_torch.examples.llama_pretrain --preset 1b --kv-heads 2 --batch 2
                 python -m bluefog_tpu_torch.examples.llama_pretrain --hidden 1024 --vocab 32000 --layers 12 --batch 2
                 python -m bluefog_tpu_torch.examples.llama_pretrain --preset small --seq 8192 --batch 2 --seq-parallel [--striped | --ulysses]
Run (CPU):       python -m bluefog_tpu_torch.examples.llama_pretrain --preset tiny --device cpu
                 python -m bluefog_tpu_torch.examples.llama_pretrain --preset tiny --hidden 256 --vocab 64 --device cpu
                 python -m bluefog_tpu_torch.examples.llama_pretrain --preset tiny --device cpu --seq-parallel --striped
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core import distributed as _dist
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import Adafactor, CommunicationType, TraceSGD
from bluefog_tpu_torch.parallel.ring_attention import make_ring_attention_fn, shard_inputs
from bluefog_tpu_torch.parallel.ulysses import make_ulysses_attention_fn
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


# base optimizers of benchmarks/llama.py, at its learning rate 3e-4 unless
# --lr, over the rank-major leaves; ``shapes`` maps a leaf to the per-rank
# shape of its reference leaf (LlamaLM.split_head_shapes), which only
# adafactor's factoring reads
OPTIMIZERS = {
    "adamw": lambda leaves, lr, shapes: torch.optim.AdamW(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
    "sgdm": lambda leaves, lr, shapes: torch.optim.SGD(leaves, lr=lr, momentum=0.9),
    "sgdm_bf16": lambda leaves, lr, shapes: TraceSGD(leaves, lr=lr, momentum=0.9,
                                                     trace_dtype=torch.bfloat16),
    "adafactor": lambda leaves, lr, shapes: Adafactor(leaves, lr=lr, shapes=shapes),
}
# the reference example's model (examples/jax_llama_pretrain.py): --hidden H
# gives LlamaLM(hidden H, heads 4, dff 3H)
REF_HEADS = 4
REF_DFF_MULT = 3
DP_LR = 3e-4  # benchmarks/llama.py
SP_LR = 3e-3  # examples/jax_llama_pretrain.py's --lr, its seq-parallel Adam


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
    ap.add_argument("--layers", type=int, default=0, help="decoder layers (0 = preset)")
    ap.add_argument("--hidden", type=int, default=0,
                    help="the reference example's model in place of the preset's widths: "
                    f"hidden H, {REF_HEADS} heads, dff {REF_DFF_MULT}H (0 = the preset's)")
    ap.add_argument("--vocab", type=int, default=0, help="vocabulary (0 = the preset's)")
    ap.add_argument("--lr", type=float, default=None,
                    help=f"learning rate (default {DP_LR}, or {SP_LR} under --seq-parallel)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard the sequence over --size ranks (ring attention); one "
                    "replicated copy of the parameters, Adam")
    ap.add_argument("--striped", action="store_true",
                    help="load-balanced striped sequence layout (stripe_blocks); needs "
                    "--seq-parallel")
    ap.add_argument("--ulysses", action="store_true",
                    help="Ulysses head re-sharding in place of the ring; needs "
                    "--seq-parallel, heads divisible by --size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler and report "
                    "device time by kernel")
    return ap


def model_config(args: argparse.Namespace) -> Dict:
    """The preset's configuration, with ``--hidden`` the reference example's
    widths (``LlamaLM(hidden H, heads 4, dff 3H)``) and ``--vocab`` its
    vocabulary in place of the preset's."""
    cfg = dict(PRESETS[args.preset])
    if args.hidden:
        if args.hidden % REF_HEADS:
            raise ValueError(f"--hidden {args.hidden} is not divisible by the reference "
                             f"model's {REF_HEADS} heads")
        cfg.update(hidden=args.hidden, heads=REF_HEADS, dff=REF_DFF_MULT * args.hidden)
    if args.vocab:
        cfg["vocab"] = args.vocab
    return cfg


def _check_flags(args: argparse.Namespace, cfg: Dict) -> None:
    """The reference's flag rules, and the port's for its own flags."""
    if args.remat_policy and not cfg.get("remat"):
        # the model consults remat_policy only under remat: a number
        # attributed to a policy that never applied would mislead
        raise ValueError(f"--remat-policy requires a remat preset (preset "
                         f"{args.preset!r} has remat=False)")
    if (args.striped or args.ulysses) and not args.seq_parallel:
        raise ValueError("--striped and --ulysses are sequence-layout options: add "
                         "--seq-parallel")
    if args.striped and args.ulysses:
        raise ValueError("--striped is a ring layout; Ulysses gathers the whole sequence")
    if args.seq_parallel and args.head_chunks > 1:
        # the seq-parallel loss is computed over sequence shards (and the
        # striped form needs the next stripe's ids): silently ignoring the
        # flag would misattribute the run
        raise ValueError("--head-chunks applies to the data-parallel path only (the "
                         "seq-parallel loss is computed per shard)")
    if args.seq_parallel and args.optimizer:
        raise ValueError("--optimizer applies to the data-parallel path only "
                         "(--seq-parallel trains with Adam, as the reference)")


def _timed_steps(step: Callable[[int], torch.Tensor], steps: int, dev: torch.device,
                 profile: bool) -> Dict:
    """Run ``step(s)`` (which returns the step's loss) for ``s < steps``,
    each between synchronizations of the card: the losses, each step's ms,
    the mean ms of the steady steps, peak memory on the card and, with
    ``profile``, the last step's device profile."""
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    prof = None
    if profile:
        # device activity only on the card: host-side op tracing would
        # stretch the gaps between launches that the idle share reads
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if on_cuda
            else torch.profiler.ProfilerActivity.CPU])
    for s in range(steps):
        traced = prof is not None and s == steps - 1
        with prof if traced else contextlib.nullcontext():
            if on_cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = step(s)
            if on_cuda:
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.cpu().tolist())
    # the first step warms up; a traced step carries the profiler's cost
    steady = step_ms[1:len(step_ms) - (prof is not None)] or step_ms
    out = {"losses": losses, "step_ms": step_ms, "steady_ms": float(np.mean(steady))}
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


def _flash_launches(fa) -> Dict[str, int]:
    """Each flash kernel's launches so far, over its bf16, f16 and f32
    instances."""
    return {k: fa.launches[k] + fa.launches_f16[k] + fa.launches_f32[k] for k in fa.launches}


def make_optimizer(name: str, model: LlamaLM, params: Dict[str, torch.Tensor],
                   lr: float) -> torch.optim.Optimizer:
    """Base optimizer ``name`` of :data:`OPTIMIZERS` over the rank-major
    ``params`` (``model``'s parameters by name)."""
    shapes = {params[k]: s for k, s in model.split_head_shapes().items()}
    return OPTIMIZERS[name](list(params.values()), lr, shapes)


def build_model(args: argparse.Namespace, cfg: Dict, layers: int, head_chunks: int,
                attention_fn: Optional[Callable]) -> LlamaLM:
    """The preset's LlamaLM on the host, drawn from ``--seed``."""
    return LlamaLM(
        vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=layers,
        num_heads=cfg["heads"], dff=cfg["dff"],
        dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
        attention_fn=attention_fn, head_chunks=head_chunks, device="cpu",
        generator=torch.Generator(device="cpu").manual_seed(args.seed),
        head_dtype=torch.bfloat16 if args.head_bf16 else torch.float32,
        remat=cfg.get("remat", False), remat_policy=args.remat_policy,
        scan_layers=cfg.get("scan_layers", False), num_kv_heads=args.kv_heads or None,
    )


def run(args: argparse.Namespace,
        setup: Optional[Callable[..., None]] = None) -> Dict:
    """Train ``args.steps`` steps; return losses, timings and memory.
    ``setup``, where given, is called once before the first step (to
    register hooks, e.g. on the local step): ``setup(params,
    base_optimizer)`` on the data-parallel path, ``setup(model,
    optimizer)`` under ``--seq-parallel``.  On the data-parallel path a
    context manager that ``setup`` returns is entered around the steps
    alone (e.g. a ``CollectiveInventory`` that records their rank-axis
    ops)."""
    cfg = model_config(args)
    _check_flags(args, cfg)
    if args.seq_parallel:
        return _run_seq_parallel(args, cfg, setup)
    B = args.batch or cfg["batch"]
    T = args.seq or cfg["seq"]
    layers = args.layers or cfg["layers"]
    head_chunks = cfg["head_chunks"] if args.head_chunks < 0 else args.head_chunks
    optimizer = args.optimizer or cfg.get("optimizer", "adamw")
    lr = args.lr or DP_LR
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            device=args.device)
    try:
        dev = bf.device()
        n = bf.size()
        lay = basics.process_layout()
        model = build_model(args, cfg, layers, head_chunks,
                            make_flash_attention_fn() if args.attention == "flash" else None)
        # the model stays on the host: the step calls it on the rank-major
        # leaves' slices, so its own weights need no copy on the card
        params = replicate_for_mesh({k: v.to(dev) for k, v in model.named_parameters()}, n)
        if lay is not None:  # this process's block of ranks
            params = basics.to_rank_major_global(params)
        n_params = sum(v[0].numel() for v in params.values())
        opt = make_optimizer(optimizer, model, params, lr)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, opt,
            communication_type=CommunicationType[args.comm],
            plan=bf.context().plan, loss_fn=loss_fn)

        around = setup(params, opt) if setup is not None else None
        rng = np.random.default_rng(args.seed)
        toks = make_streams(rng, cfg["vocab"], n * B * args.steps, T)
        data = torch.from_numpy(toks).view(args.steps, n, B, T)
        crossed = []  # a step: what crossed processes, the losses' gather excluded

        def step(s):
            before = _dist.transfer_stats()
            losses = step_fn(data[s], data[s])[0]
            if lay is None:
                return losses
            after = _dist.transfer_stats()
            crossed.append({k: after[k] - before[k] for k in
                            ("bytes_sent", "bytes_received", "messages", "staging_s",
                             "wire_s")})
            return _dist.all_gather_rows(losses)  # every rank's, in rank order

        if lay is not None:
            r0 = lay.first(n)
            data = data[:, r0:r0 + n // lay.nprocs]
        data = data.to(dev)
        fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
        before = _flash_launches(fa)
        with around if around is not None else contextlib.nullcontext():
            timed = _timed_steps(step, args.steps, dev, args.profile)
        launched = {k: n - before[k] for k, n in _flash_launches(fa).items()}
        with torch.no_grad():  # over this process's ranks
            spread = max(float(v.float().std(dim=0).max()) for v in params.values())
        out = {
            "preset": args.preset, "layers": layers, "ranks": n, "batch": B,
            "seq": T, "params_per_rank": n_params, "hidden": cfg["hidden"],
            "heads": cfg["heads"], "kv_heads": args.kv_heads or cfg["heads"],
            "head_dim": cfg["hidden"] // cfg["heads"], "vocab": cfg["vocab"],
            "remat": cfg.get("remat", False), "remat_policy": args.remat_policy,
            "scan_layers": cfg.get("scan_layers", False), "optimizer": optimizer, "lr": lr,
            "head_chunks": head_chunks, "leaves": len(params),
            "dtype": args.dtype, "head_dtype": "bf16" if args.head_bf16 else "f32",
            "losses": timed.pop("losses"),
            "step_ms": timed.pop("step_ms"),
            "tokens_per_s": n * B * T / (timed.pop("steady_ms") / 1e3),
            "consensus_spread": spread, "device": str(dev),
            "flash_launches": launched, **timed,
        }
        if lay is not None:
            out.update(processes=lay.nprocs, process=lay.pid,
                       ranks_held=basics.local_ranks(), cross_process=crossed,
                       spread_over="this process's ranks")
        return out
    finally:
        bf.shutdown()


def seq_parallel_loss(logits: torch.Tensor, ids: torch.Tensor, n: int,
                      striped: bool) -> torch.Tensor:
    """The global mean next-token loss of ``n`` sequence shards, rank-major
    (``logits [n*B, T_local, V]`` f32, ``ids [n*B, T_local]``), as the
    reference's ``run_seq_parallel`` defines it.

    Contiguous: the mean over ranks of each shard's shifted cross-entropy,
    which drops the tokens at the shard boundaries.  Striped: the successor
    of a token is at the same local index on the next stripe, whose ids
    come by a roll of the rank axis (the reference's ppermute ``(r+1) % n
    -> r``), or at the next local index on stripe 0 for the last stripe,
    whose last token has no target; normalised by the global count."""
    rows, tl, _ = logits.shape
    b = rows // n
    if not striped:
        ce = torch.logsumexp(logits[:, :-1], dim=-1) - logits[:, :-1].gather(
            -1, ids[:, 1:, None])[..., 0]
        return ce.reshape(n, b * (tl - 1)).mean(1).mean()
    nxt = torch.roll(ids.view(n, b, tl), -1, 0)
    last = torch.cat([nxt[-1:, :, 1:], torch.zeros_like(nxt[-1:, :, :1])], dim=-1)
    labels = torch.cat([nxt[:-1], last]).view(rows, tl)
    mask = torch.ones(n, 1, tl, device=logits.device)
    mask[-1, :, -1] = 0.0
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    return (ce.view(n, b, tl) * mask).sum() / (mask.sum() * b)


def _run_seq_parallel(args: argparse.Namespace, cfg: Dict,
                      setup: Optional[Callable[..., None]]) -> Dict:
    """The reference's ``run_seq_parallel`` on the rank-major layout: the
    batch ``[B, T]`` (striped first, under ``--striped``) is folded to
    ``[n*B, T/n]``, the model runs once on it with the shards' global
    positions, and one backward of the global mean loss gives its
    gradient (the reference reduces per-shard gradients with pmean or
    psum instead).  The preset's ``head_chunks`` is set to 0: the loss is
    computed per shard."""
    n = args.size
    B = args.batch or cfg["batch"]
    T = args.seq or cfg["seq"]
    if T % n:
        raise ValueError(f"--seq {T} not divisible by --size {n}")
    tl = T // n
    layers = args.layers or cfg["layers"]
    lr = args.lr or SP_LR
    flash = args.attention == "flash"
    fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
    bf.init(size=n, device=args.device)
    try:
        dev = bf.device()
        if args.ulysses:
            attention_fn = make_ulysses_attention_fn(n, flash=flash)
        else:
            attention_fn = make_ring_attention_fn(n, flash=flash, striped=args.striped)
        model = build_model(args, cfg, layers, 0, attention_fn).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr)  # optax.adam's defaults
        if setup is not None:
            setup(model, opt)
        rng = np.random.default_rng(args.seed)
        data = torch.from_numpy(make_streams(rng, cfg["vocab"], B * args.steps, T))
        shards = [shard_inputs(x, n, args.striped) for x in data.view(args.steps, B, T)]
        data = torch.stack([x for x, _ in shards]).to(dev)
        positions = shards[0][1].to(dev)  # [n*B, T_local]
        per_step = []

        def step(s):
            before = _flash_launches(fa)
            opt.zero_grad(set_to_none=True)
            loss = seq_parallel_loss(model(data[s], positions), data[s], n, args.striped)
            loss.backward()
            opt.step()
            per_step.append({k: n - before[k] for k, n in _flash_launches(fa).items()})
            return loss.detach()

        timed = _timed_steps(step, args.steps, dev, args.profile)
        mode = "ulysses" if args.ulysses else ("ring_striped" if args.striped else "ring")
        return {
            "preset": args.preset, "seq_parallel": True, "mode": mode,
            "striped": args.striped, "attention": args.attention, "layers": layers,
            "ranks": n, "batch": B, "seq": T, "t_local": tl,
            "params": sum(p.numel() for p in model.parameters()),
            "hidden": cfg["hidden"], "heads": cfg["heads"],
            "kv_heads": args.kv_heads or cfg["heads"], "remat": cfg.get("remat", False),
            "scan_layers": cfg.get("scan_layers", False), "optimizer": "adam", "lr": lr,
            "head_chunks": 0, "preset_head_chunks": cfg["head_chunks"],
            "head_chunks_note": "the preset's head_chunks is set to 0 under --seq-parallel: "
                                "the loss is computed "
                                "per sequence shard",
            "dtype": args.dtype, "head_dtype": "bf16" if args.head_bf16 else "f32",
            "losses": timed.pop("losses"), "step_ms": timed.pop("step_ms"),
            "tokens_per_s": B * T / (timed.pop("steady_ms") / 1e3),
            "launches_per_step": per_step, "device": str(dev), **timed,
        }
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
