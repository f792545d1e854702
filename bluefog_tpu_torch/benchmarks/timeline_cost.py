"""What the timeline costs: ResNet-50 train steps with the
``BLUEFOG_TIMELINE`` writer on and off, in turns in one process.

Setting ``BLUEFOG_TIMELINE`` makes :mod:`bluefog_tpu_torch.timeline` create
one :class:`~bluefog_tpu_torch.timeline.TimelineWriter`; every span then
appends an event to it.  This script builds the ResNet-50 train step of
``benchmarks/resnet50.py`` (``--mode``, default hierarchical: ``--size``
ranks in machines of ``--local-size``), warms it up, and times
``--steps`` synchronized steps a turn between two CUDA events (host clock
on the CPU), with the writer off, on, on, off, per ``--rounds``; the same
process and state throughout, so the host's spread between processes
stays out of the comparison.  It also times the span alone: ``--spans``
empty ``timeline_context`` blocks with the writer off and on, and the
``torch.profiler.record_function`` inside it alone, in µs a span.

    python -m bluefog_tpu_torch.benchmarks.timeline_cost --size 8 --batch 64

prints one JSON line: step ms of each turn and their medians, the events a
step writes, µs a span, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import timeline, topology_util
from bluefog_tpu_torch.benchmarks import resnet50 as rb
from bluefog_tpu_torch.benchmarks.attention_roofline import nvidia_smi
from bluefog_tpu_torch.models import ResNet50


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="hierarchical_neighbor_allreduce", choices=rb.MODES)
    ap.add_argument("--batch", type=int, default=64, help="per-rank batch")
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--local-size", type=int, default=2)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--filters", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10, help="timed steps a turn")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2, help="rounds of turns (off, on, on, off)")
    ap.add_argument("--spans", type=int, default=100000, help="spans timed alone")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def span_us(n: int) -> Dict[str, float]:
    """µs a span: an empty ``timeline_context`` with the writer off and on
    (a throwaway writer), and ``record_function`` alone."""
    def per_span(body):
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) * 1e6 / n

    def ctx_loop():
        for _ in range(n):
            with timeline.timeline_context("span"):
                pass

    def rf_loop():
        for _ in range(n):
            with torch.profiler.record_function("bluefog/span"):
                pass

    saved = timeline._writer
    try:
        timeline._writer = None
        off = per_span(ctx_loop)
        timeline._writer = timeline.TimelineWriter(os.devnull)
        on = per_span(ctx_loop)
    finally:
        timeline._writer = saved
    return {"off": off, "on": on, "record_function": per_span(rf_loop)}


def run(args: argparse.Namespace) -> Dict:
    bf.init(topology_util.ExponentialTwoGraph(args.size), size=args.size,
            local_size=args.local_size, device=args.device)
    saved = timeline._writer
    try:
        dev, n = bf.device(), bf.size()
        cuda = dev.type == "cuda"
        if cuda:
            torch.backends.cudnn.benchmark = True
        model = ResNet50(num_classes=args.classes, num_filters=args.filters, device="cpu",
                         generator=torch.Generator().manual_seed(args.seed)).to(dev)
        x, y = rb.synthetic_batch(n, args.batch, args.image, args.classes, dev, args.seed)
        params, stats = rb.rank_major_state(model, n)
        step = rb.make_step(model, params, stats, args.mode)[0]
        timeline._writer = None
        rb.timed_steps(step, x, y, args.warmup, cuda)
        path = os.path.join(tempfile.gettempdir(), f"timeline_cost_{os.getpid()}.json")
        writer = timeline.TimelineWriter(path)
        step_ms = {"off": [], "on": []}
        for _ in range(args.rounds):
            for state in ("off", "on", "on", "off"):
                timeline._writer = writer if state == "on" else None
                ms, losses = rb.timed_steps(step, x, y, args.steps, cuda)
                step_ms[state].append(ms)
        timeline._writer = None
        events = len(writer._events)
        writer._events.clear()  # nothing to keep: flush writes no file
        out = {"metric": "timeline_cost", "mode": args.mode,
               "config": {"ranks": n, "machines": bf.machine_size(),
                          "per_rank_batch": args.batch, "image": args.image,
                          "classes": args.classes, "filters": args.filters,
                          "steps_a_turn": args.steps, "rounds": args.rounds},
               "device": str(dev), "step_ms": step_ms,
               "step_ms_median": {k: statistics.median(v) for k, v in step_ms.items()},
               "events_a_step": events / (args.steps * 2 * args.rounds),
               "last_losses": losses.cpu().tolist(), "span_us": span_us(args.spans)}
        out["on_over_off"] = out["step_ms_median"]["on"] / out["step_ms_median"]["off"]
        if cuda:
            out["gpu"] = torch.cuda.get_device_name(dev)
            out["nvidia_smi"] = nvidia_smi()
        return out
    finally:
        timeline._writer = saved
        bf.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = run(_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
