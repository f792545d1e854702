"""Llama-3-8B widths under the FSDP + machine-gossip train step, executed on
the card (counterpart of ``benchmarks/zero_8b.py``, BASELINE config #5).

The reference lowers (or compiles) the 32-layer step on ShapeDtypeStructs
and reads XLA's own memory accounting (``memory_analysis()``); it executes
these widths only cut in depth (``--execute-truncated``).  Eager PyTorch
compiles no program to lower or account, so this script has no
counterpart of ``--compile`` or the lowered hand table: it *executes* the
step, cut in depth by ``--layers`` (default 2, the reference's own cut),
at full width: vocab 128256, hidden 4096, 32 heads on 8 kv heads (D =
128), dff 14336, seq 2048, batch 1 a local rank; remat, ``scan_layers``
(``--unrolled`` for unrolled leaves), ``head_chunks=16``, ``spmd_vocab``,
the three FSDP hooks with bf16 gradients, the flash kernels, momentum SGD
(lr 3e-4, momentum 0.9) with a bf16 momentum (``--optimizer adamw`` for
adamw with a bf16 mu), ``ZERO8B_MESH=MxL`` machines x local ranks (default
``2x4``: each machine's batch is ``[4, 2048]``), the machine topology
``ExponentialTwoGraph(machines)``.  One JSON line: step ms (the first
step warms up), tokens/s, peak ``torch.cuda.max_memory_allocated`` and
each machine's loss a step; ``--profile`` adds the traced last step's
device time by kernel and its idle share.

``--execute-truncated 2 3`` is the reference's per-layer slope on one
replica (no hooks, no gossip, the reference's dense attention): each
layer count runs 2 and 6 steps, the difference over 4 steps is a step's
cost, and the slope over layer counts extrapolates the 32-layer step.

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.zero_8b
                 python -m bluefog_tpu_torch.benchmarks.zero_8b --execute-truncated 2 3
Run (CPU, toy widths only): python -m bluefog_tpu_torch.benchmarks.zero_8b --device cpu --toy
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core.basics import resolve_device
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import TraceSGD
from bluefog_tpu_torch.parallel import zero
from bluefog_tpu_torch.profiling import device_profile
from bluefog_tpu_torch.training import make_lm_loss_fns

# Llama-3-8B shape (BASELINE config #5): GQA with 8 kv heads, 128k vocab
CFG = dict(vocab=128256, hidden=4096, layers=32, heads=32, kv_heads=8,
           dff=14336, seq=2048, batch=1)
# the same structure at CPU-test widths (--toy)
TOY = dict(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, dff=128, seq=32, batch=1,
           head_chunks=4)
LR, MOMENTUM = 3e-4, 0.9


def mesh_shape() -> tuple:
    """``(machines, local)`` from ``ZERO8B_MESH`` (default ``2x4``)."""
    machines, local = (int(v) for v in os.environ.get("ZERO8B_MESH", "2x4").split("x"))
    return machines, local


def build_model(cfg: Dict, layers: int, *, unrolled: bool = False, hooks: bool = True,
                grad_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                attention: str = "flash") -> LlamaLM:
    """The config's ``LlamaLM`` at ``layers`` layers, f32 parameters drawn on
    ``device`` from ``seed``, with the FSDP hooks (``grad_dtype`` rounds
    the weights' gradients; None leaves them)."""
    kw = {}
    if hooks:
        kw = dict(act_constraint=zero.fsdp_act_constraint(),
                  onehot_constraint=zero.fsdp_onehot_constraint(),
                  weight_constraint=zero.fsdp_param_io_constraint(grad_dtype=grad_dtype),
                  spmd_vocab=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    return LlamaLM(vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=layers,
                   num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"], dff=cfg["dff"],
                   remat=True, scan_layers=not unrolled, head_chunks=cfg.get("head_chunks", 16),
                   attention_fn=make_flash_attention_fn() if attention == "flash" else None,
                   device=device, generator=gen, **kw)


def token_batches(cfg: Dict, machines: int, local: int, steps: int, device, seed: int = 0):
    """``steps`` batches ``[machines, local * batch, seq]`` of random ids."""
    rng = np.random.default_rng(seed)
    shape = (machines, local * cfg["batch"], cfg["seq"])
    return [torch.from_numpy(rng.integers(0, cfg["vocab"], shape)).to(device)
            for _ in range(steps)]


def make_step(model: LlamaLM, grid, machine_plan, *, builder=zero.make_fsdp_gossip_train_step,
              optimizer: str = "sgdm", momentum_dtype=torch.bfloat16):
    """``(params, init_fn, step_fn, params_of, losses)`` for ``model`` under
    ``builder``; ``losses`` collects each machine's loss as the step
    computes it."""
    apply_fn, lm_loss = make_lm_loss_fns(model)
    losses: List[torch.Tensor] = []

    def loss_fn(out, labels):
        loss = lm_loss(out, labels)
        losses.append(loss.detach())
        return loss

    kw = {} if builder is zero.make_zero_gossip_train_step else dict(
        momentum_dtype=momentum_dtype)
    init_fn, step_fn, params_of = builder(apply_fn, loss_fn, grid, machine_plan,
                                          learning_rate=LR, momentum=MOMENTUM,
                                          optimizer=optimizer, **kw)
    params = {k: v.detach() for k, v in model.named_parameters()}
    return params, init_fn, step_fn, params_of, losses


def run(args: argparse.Namespace, *, setup=None, on_step=None) -> Dict:
    """The executed FSDP step; ``setup(state)`` is called once before the
    steps, ``on_step(step, state)`` after each."""
    cfg = TOY if args.toy else CFG
    machines, local = mesh_shape()
    layers = args.layers
    device = resolve_device(args.device)
    model = build_model(cfg, layers, unrolled=args.unrolled, device=device,
                        attention="flash")
    plan = compile_plan(topology_util.ExponentialTwoGraph(machines)) if machines > 1 else None
    params, init_fn, step_fn, _, losses = make_step(model, (machines, local), plan,
                                                    optimizer=args.optimizer)
    n_params = sum(p.numel() for p in params.values())
    state = init_fn(params)
    del params
    model.to("meta")  # the step reads the state's parameters, not the model's
    batches = token_batches(cfg, machines, local, args.steps, device, args.seed)
    if setup is not None:
        setup(state)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_ms, per_machine = [], []
    prof = None
    if args.profile:  # device activity only: host tracing would stretch the idle gaps
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU])
    for s, ids in enumerate(batches):
        losses.clear()
        traced = prof is not None and s == len(batches) - 1
        with prof if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            state, _ = step_fn(state, ids, ids)
            if device.type == "cuda":
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        per_machine.append([l.item() for l in losses])
        if on_step is not None:
            on_step(s, state)
    # the first step warms up; a traced step carries the profiler's cost
    steady = step_ms[1:len(step_ms) - (prof is not None)] or step_ms
    tokens = machines * local * cfg["batch"] * cfg["seq"]
    out = {"metric": "8B-widths FSDP + machine gossip step (executed)",
           "config": "toy" if args.toy else "llama3_8b", "layers": layers,
           "optimizer": args.optimizer, "leaves": "unrolled" if args.unrolled else "scan-stacked",
           "mesh": f"{machines}x{local}", "params_b": n_params / 1e9,
           "tokens_per_step": tokens, "step_ms": step_ms,
           "tok_per_s": tokens / (sum(steady) / len(steady) / 1e3),
           "machine_losses": per_machine, "device": str(device),
           "reduced": f"depth {cfg['layers']} -> {layers} layers"}
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        out["profile"] = device_profile(prof, step_ms[-1])
    return out


def execute_truncated(layers_list: List[int], *, device="cuda", toy: bool = False) -> Dict:
    """The reference's depth-truncated execution on one replica: per layer
    count, ``lo = 2`` and ``hi = 6`` steps timed in turns three times; the
    best ``(t_hi - t_lo) / (hi - lo)`` is a step.  Momentum SGD with a bf16
    trace where every count is at most 2 layers, plain SGD otherwise (one
    optimizer for every count, as the reference).  The slope over counts
    gives the per-layer ms and the extrapolated 32-layer step."""
    cfg = TOY if toy else CFG
    device = resolve_device(device)
    use_momentum = max(layers_list) <= 2
    results = {}
    for layers in layers_list:
        if device.type == "cuda":  # each count's peak is its own
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        model = build_model(cfg, layers, hooks=False, device=device, attention="dense")
        n_params = sum(p.numel() for p in model.parameters())
        opt = (TraceSGD(model.parameters(), lr=LR, momentum=MOMENTUM,
                        trace_dtype=torch.bfloat16) if use_momentum
               else torch.optim.SGD(model.parameters(), lr=LR))
        ids = token_batches(cfg, 1, 1, 1, device)[0][0]

        def steps(k):
            loss = None
            for _ in range(k):
                opt.zero_grad(set_to_none=True)
                loss = model(ids, labels=ids)
                loss.backward()
                opt.step()
            if device.type == "cuda":
                torch.cuda.synchronize()
            return loss

        lo, hi = 2, 6
        t0 = time.perf_counter()
        steps(lo)
        compile_s = time.perf_counter() - t0
        steps(hi)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            steps(lo)
            t1 = time.perf_counter()
            loss = steps(hi)
            t2 = time.perf_counter()
            best = min(best, ((t2 - t1) - (t1 - t0)) / (hi - lo))
        row = dict(params_b=n_params / 1e9, optimizer="sgdm_bf16" if use_momentum else "sgd",
                   first_steps_s=compile_s, step_ms=best * 1e3,
                   tok_per_s=cfg["batch"] * cfg["seq"] / best, loss=loss.item())
        if device.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        results[layers] = row
        del model, opt, loss  # the loss's graph holds the model's parameters
    out = {"metric": "8B-dims truncated EXECUTION (full width/vocab/GQA)",
           "per_layers": results}
    if len(results) >= 2:
        ls = sorted(results)
        per_layer = (results[ls[-1]]["step_ms"] - results[ls[0]]["step_ms"]) / (ls[-1] - ls[0])
        embed_head = results[ls[0]]["step_ms"] - ls[0] * per_layer
        full = embed_head + cfg["layers"] * per_layer
        out.update(per_layer_ms=per_layer, embed_head_ms=embed_head,
                   extrapolated_8b_step_ms=full,
                   extrapolated_8b_tok_per_s=cfg["batch"] * cfg["seq"] / (full / 1e3))
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--execute-truncated", nargs="*", type=int, default=None,
                    metavar="LAYERS", help="the reference's per-layer slope on one replica "
                    "(default layer counts: 2 3)")
    ap.add_argument("--unrolled", action="store_true",
                    help="unrolled per-layer leaves instead of the stacked (scan) ones")
    ap.add_argument("--layers", type=int, default=2,
                    help="depth (the config's is 32; the default 2 is the reference's cut)")
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler: device time by kernel "
                    "and the idle share")
    ap.add_argument("--toy", action="store_true",
                    help="the same structure at CPU-test widths (vocab 256, hidden 64)")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.execute_truncated is not None:
        print(json.dumps(execute_truncated(args.execute_truncated or [2, 3],
                                           device=args.device, toy=args.toy)))
        return
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
