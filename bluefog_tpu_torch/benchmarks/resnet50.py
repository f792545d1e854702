"""ResNet-50 images/s on one card: the GPU twin of ``bench.py``'s metric.

``bench.py`` reports "ResNet-50 images/sec/chip (neighbor_allreduce)" with
the gradient allreduce beside it (``bench.py:240-300``).  This script runs
the same workload on the rank-major backend: ResNet-50 at full width
(224 x 224 images, 1000 classes, bf16 compute, f32 parameters and batch
statistics), ``--size`` virtual ranks on one card over
``ExponentialTwoGraph``, per-rank batch ``--batch``, momentum SGD (0.1,
0.9), each rank's BatchNorm statistics local to it.  One synthetic batch
from ``--seed`` is reused every step, as in ``bench.py``.

Three train states are built from the same initial weights: one mixes
parameters by ATC ``neighbor_allreduce``, one averages gradients by
``allreduce``, and one mixes by ATC ``hierarchical_neighbor_allreduce``
(BASELINE config #4): the ranks form machines of ``--local-size``
consecutive ranks, each machine's ranks are averaged and the machines mix
on ``ExponentialTwoGraph(machines)``.  After ``--warmup`` steps of each,
they are timed in turns (gossip, allreduce, hierarchical, then the same
backwards, per ``--rounds``): ``--steps`` synchronized steps between two
CUDA events a turn.  cuDNN picks its
convolution algorithms by measurement (``cudnn.benchmark``) during the
warm-up.  ``--profile`` traces one more step of each mode and reports
device time by kernel and the device's idle share, by mode.

    python -m bluefog_tpu_torch.benchmarks.resnet50

prints one JSON line: images/s of each turn and their median for each
mode, step ms, peak device memory, and the card's name and power limit.
It claims nothing: it is the measurement a benchmark cell can be built on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.benchmarks.attention_roofline import nvidia_smi
from bluefog_tpu_torch.models import ResNet50
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.profiling import device_profile
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
)

MODES = ("neighbor_allreduce", "allreduce", "hierarchical_neighbor_allreduce")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128, help="per-rank batch")
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--local-size", type=int, default=2,
                    help="ranks a machine of the hierarchical mode")
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--filters", type=int, default=64, help="ResNet width (64 = ResNet-50)")
    ap.add_argument("--steps", type=int, default=5, help="timed steps a turn")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (gossip, allreduce, allreduce, gossip)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one step of each mode with torch.profiler")
    return ap


def rank_major_state(model: torch.nn.Module, n: int) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)``: the model's parameters and buffers
    replicated into rank-major leaves ``[n, ...]``."""
    return (replicate_for_mesh(dict(model.named_parameters()), n),
            replicate_for_mesh(dict(model.named_buffers()), n, requires_grad=False))


def make_step(model, params: Dict, stats: Dict, mode: str, lr: float = 0.1,
              momentum: float = 0.9) -> Tuple[Callable, torch.optim.Optimizer]:
    """``(step_fn, base_optimizer)``: momentum SGD under ATC
    ``neighbor_allreduce``, gradient ``allreduce`` or ATC
    ``hierarchical_neighbor_allreduce`` (on the context's machine plan),
    with batch statistics."""
    opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=momentum)
    ctx = bf.context()
    hier = mode == "hierarchical_neighbor_allreduce"
    step_fn = make_decentralized_train_step(
        make_classifier_apply_fn(model), params, opt,
        communication_type=CommunicationType[mode], plan=ctx.plan,
        machine_plan=ctx.machine_plan if hier else None, batch_stats=stats)
    return step_fn, opt


def synthetic_batch(n: int, batch: int, image: int, classes: int, device,
                    seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank-major NHWC image batch ``[n, batch, image, image, 3]`` f32 and
    its labels, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, batch, image, image, 3), dtype=np.float32)
    y = rng.integers(0, classes, size=(n, batch))
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def timed_steps(step_fn: Callable, x, y, steps: int, cuda: bool) -> Tuple[float, torch.Tensor]:
    """(ms a step, the last losses) over ``steps`` steps: between two CUDA
    events after a synchronize, or on the host clock on the CPU."""
    if cuda:
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses, _ = step_fn(x, y)
    if cuda:
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / steps, losses
    return (time.perf_counter() - t0) * 1e3 / steps, losses


def run(args: argparse.Namespace) -> Dict:
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            local_size=args.local_size, device=args.device)
    try:
        dev, n = bf.device(), bf.size()
        cuda = dev.type == "cuda"
        if args.profile and not cuda:
            raise ValueError("--profile traces the card's kernels: it needs --device cuda")
        if cuda:
            torch.backends.cudnn.benchmark = True
        gen = torch.Generator().manual_seed(args.seed)
        model = ResNet50(num_classes=args.classes, num_filters=args.filters,
                         device="cpu", generator=gen).to(dev)
        x, y = synthetic_batch(n, args.batch, args.image, args.classes, dev, args.seed)
        steps = {}
        for mode in MODES:
            params, stats = rank_major_state(model, n)
            steps[mode] = make_step(model, params, stats, mode, args.lr)[0]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for mode in MODES:
            if args.warmup:
                timed_steps(steps[mode], x, y, args.warmup, cuda)
        step_ms = {mode: [] for mode in MODES}
        losses = {}
        for _ in range(args.rounds):
            for mode in MODES + MODES[::-1]:
                ms, last = timed_steps(steps[mode], x, y, args.steps, cuda)
                step_ms[mode].append(ms)
                losses[mode] = last.cpu().tolist()
        images = n * args.batch
        out = {
            "metric": "resnet50_images_per_s", "model": "ResNet50",
            "config": {"ranks": n, "per_rank_batch": args.batch, "image": args.image,
                       "classes": args.classes, "filters": args.filters,
                       "topology": f"ExponentialTwoGraph({n})",
                       "machines": bf.machine_size(), "local_size": bf.local_size(),
                       "machine_topology": f"ExponentialTwoGraph({bf.machine_size()})",
                       "optimizer": "sgd",
                       "lr": args.lr, "momentum": 0.9, "dtype": "bf16",
                       "batch_stats": "per rank", "steps_a_turn": args.steps,
                       "warmup": args.warmup, "rounds": args.rounds},
            "device": str(dev),
        }
        for mode in MODES:
            ips = [images / (ms / 1e3) for ms in step_ms[mode]]
            out[mode] = {"images_per_s": ips, "images_per_s_median": statistics.median(ips),
                         "step_ms": step_ms[mode], "last_losses": losses[mode]}
        out["gossip_over_allreduce"] = (out["neighbor_allreduce"]["images_per_s_median"]
                                        / out["allreduce"]["images_per_s_median"])
        out["hierarchical_over_allreduce"] = (
            out["hierarchical_neighbor_allreduce"]["images_per_s_median"]
            / out["allreduce"]["images_per_s_median"])
        if args.profile:
            out["profile"] = {}
            for mode in MODES:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                with prof:
                    ms, _ = timed_steps(steps[mode], x, y, 1, cuda)
                out["profile"][mode] = device_profile(prof, ms, top=25)
        if cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            out["gpu"] = torch.cuda.get_device_name(dev)
            out["nvidia_smi"] = nvidia_smi()
        return out
    finally:
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
