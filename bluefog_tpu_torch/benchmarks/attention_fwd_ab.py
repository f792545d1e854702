"""Forward-only A/B: the flash forward kernel against the blockwise route
(counterpart of ``benchmarks/attention_fwd_ab.py``, whose pair is the
Pallas kernel and its XLA blockwise forward), with PyTorch's
``scaled_dot_product_attention`` as the library arm.

Protocol, the reference's: one dispatch is ``--chain`` forwards in a
dependency chain (each q is ``q0 + 0.001 * o`` of the last, so none can be
skipped or merged), under ``torch.no_grad``; a timed region runs ``group``
or ``2 * group`` dispatches back to back and ends in one synchronization,
the arms interleaved within each of ``--repeats`` rounds, and per call =
``conservative_delta(smalls, bigs) / (group * chain)``, so the constant
per-region cost cancels.  No round trip is subtracted: the sync's round
trip overlaps the device work it waits on (the reference's docstring
records how subtracting it over-corrects); the session's round trip rides
in the JSON as context.

Arms: ``impl="cuda"`` (the kernels on the card, their plain versions on
the CPU), ``impl="xla"`` (the blockwise route, plain torch with f32
products) and SDPA on its own ``[B, H, T, D]`` layout.  Shapes in the
reference's docstring: B4/H12/T2048/D64 (the default), B4/H16/T2048/D128
and B2/H12/T8192/D64.  One JSON line; ``value`` is xla time / cuda time
(> 1: the kernel faster).

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.attention_fwd_ab [--heads 16 --head-dim 128]
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.attention_fwd_ab --device cpu --batch 1 --heads 1 --seq 128 --chain 2 --group 1 --repeats 1
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from bluefog_tpu_torch.kernels import flash_attention
from bluefog_tpu_torch.profiling import conservative_delta, measure_rtt

ARMS = ("cuda", "xla", "sdpa")


def _sync(x: torch.Tensor) -> None:
    v = float(x.float().sum())
    if not math.isfinite(v):
        raise RuntimeError(f"attention_fwd_ab: non-finite result {v}")


def _attend(arm: str) -> Callable:
    if arm == "sdpa":
        return lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)
    return lambda q, k, v: flash_attention(q, k, v, causal=True, impl=arm)


def make_run(arm: str, q0, k0, v0, n_chain: int) -> Callable[[], torch.Tensor]:
    """One dispatch of ``arm``: ``n_chain`` chained forwards; warmed once."""
    attend = _attend(arm)

    @torch.no_grad()
    def run():
        q = q0
        for _ in range(n_chain):
            q = (q0 + 0.001 * attend(q, k0, v0)).to(q0.dtype)
        return q

    _sync(run())
    return run


def measure(args: argparse.Namespace) -> Dict:
    dev = torch.device(args.device)
    b, h, t, d = args.batch, args.heads, args.seq, args.head_dim
    gen = torch.Generator(device="cpu").manual_seed(0)
    q0, k0, v0 = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(3))
    runs = {arm: make_run(arm, q0, k0, v0, args.chain) for arm in ARMS}

    def region(run, n_disp: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n_disp):
            out = run()
        _sync(out)
        return time.perf_counter() - t0

    smalls = {arm: [] for arm in runs}
    bigs = {arm: [] for arm in runs}
    rts = []
    for _ in range(args.repeats):
        rts.append(measure_rtt(q0, n=2))
        for arm, run in runs.items():
            smalls[arm].append(region(run, args.group))
            bigs[arm].append(region(run, 2 * args.group))
    n_delta = args.chain * args.group
    per_call, fallbacks = {}, []
    for arm in runs:
        delta = conservative_delta(smalls[arm], bigs[arm])
        if delta is None:
            print(f"fwd_ab:{arm}: all paired slopes non-positive -- raise --chain/--group; "
                  "falling back to the min big region (carries the constant per-region "
                  "cost the slope would have cancelled)", file=sys.stderr)
            fallbacks.append(arm)
            per_call[arm] = min(bigs[arm]) / (2 * n_delta)
        else:
            per_call[arm] = delta / n_delta
    tc, tx, ts = per_call["cuda"], per_call["xla"], per_call["sdpa"]
    flops = 2 * 2 * b * h * t * t * d * 0.5  # QK and PV, causal half
    return {
        "metric": f"flash fwd-only cuda-vs-xla speedup (B{b} H{h} T{t} D{d}, {args.chain}-chain, "
                  f"interleaved x{args.repeats}, {dev.type})",
        "value": round(tx / tc, 3),
        "unit": "x (xla_time/cuda_time, >1 = the kernel faster)",
        "vs_baseline": round(tx / tc, 3),
        "cuda_ms": tc * 1e3, "xla_ms": tx * 1e3, "sdpa_ms": ts * 1e3,
        "sdpa_over_cuda": ts / tc,
        "cuda_tf_s": flops / tc / 1e12, "sdpa_tf_s": flops / ts / 1e12,
        "session_rtt_ms": min(rts) * 1e3, "session_rtt_max_ms": max(rts) * 1e3,
        "fallback": fallbacks,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--chain", type=int, default=20, help="forwards chained a dispatch")
    ap.add_argument("--group", type=int, default=3,
                    help="dispatches a timed region (and twice that), one sync at the end")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("attention_fwd_ab: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    print(json.dumps(measure(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
