"""The card's measured peaks, the denominators of MFU and roofline claims
(counterpart of ``benchmarks/peaks.py``).

Each peak is the slope between two counts of chained operations, so the
fixed cost of a timed run (the events, the synchronization) cancels:
``per_op = (T(k_hi) - T(k_lo)) / (k_hi - k_lo)``, each T the least of
``n`` runs, timed between CUDA events on the card (``profiling.timed_region``;
the host clock on the CPU).

- matmul: ``y <- y @ (0.02 w)`` chained ``k`` times (``torch.matmul``, the
  library's own product, as the reference measures XLA's; the 0.02 folded
  into ``w`` once, so a link is one GEMM), bf16 at 4096^3 and 8192^3, f32
  at 4096^3 with TF32 off and with TF32 on (two keys);
- HBM stream: ``x <- 0.999 x + 0.5`` over 1 GB of f32 as one ``lerp_`` a
  pass (``x + 0.001 (500 - x)``), counted as 2 x bytes (one read, one
  write); eager ``x * 0.999 + 0.5`` would be two kernels and move twice the
  bytes it counts.  On the card a profiled pair of passes counts the
  kernels a pass launches (``kernels_per_pass``, which must be 1);
- dispatch: one 4 KB add plus a synchronization, the least of ``n``.

``--quick`` runs small sizes.  One JSON line, the H100's spec peaks beside
the measured ones.

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.peaks
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.peaks --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from bluefog_tpu_torch.profiling import device_timeline, timed_region

# H100 SXM, dense, at the full 700 W limit (NVIDIA data sheet)
SPEC = {"bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_ffma_tflops": 67.0, "hbm_gbs": 3350.0}


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _time_calls(fn: Callable[[], object], cuda: bool, n: int = 3) -> float:
    """Least seconds of ``fn()`` over ``n`` runs, after one warm-up."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    return min(timed_region(fn, cuda) for _ in range(n))


def _slope(make_fn: Callable[[int], Callable], cuda: bool, k_lo: int, k_hi: int, n: int):
    t_lo = _time_calls(make_fn(k_lo), cuda, n)
    t_hi = _time_calls(make_fn(k_hi), cuda, n)
    return (t_hi - t_lo) / (k_hi - k_lo), t_lo, t_hi


def matmul_peak(dim: int, dtype: torch.dtype, k_lo: int = 4, k_hi: int = 24, n: int = 3,
                device: str = "cuda", tf32: bool = False) -> Dict:
    """TFLOP/s of one ``dim``^3 product in a chain of them; ``tf32`` lets an
    f32 product run on TF32 tensor cores."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    y = torch.randn(dim, dim, generator=gen).to(dev, dtype)
    w = (torch.randn(dim, dim, generator=gen) * 0.02).to(dev, dtype)

    def make(k):
        def run():
            z = y
            for _ in range(k):
                z = torch.matmul(z, w)
            return z
        return run

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        per_op, t_lo, t_hi = _slope(make, dev.type == "cuda", k_lo, k_hi, n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return {"tflops": 2.0 * dim ** 3 / per_op / 1e12, "ms_per_matmul": per_op * 1e3,
            "t_lo_s": t_lo, "t_hi_s": t_hi}


def _kernels_per_pass(step: Callable[[], object], passes: int = 2) -> float:
    """Device operations a call of ``step`` runs, from the timeline of a
    profiled run (``profiling.device_timeline``: kernels, copies, sets).
    The profiler traces one cycle of ``passes`` calls and discards it before
    the cycle it counts: a trace's first device activity can be lost while
    the tracing starts up (a pair of passes once read 0.5 a pass)."""
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=sched) as prof:
        for _ in range(2):  # the warm-up cycle, then the counted one
            for _ in range(passes):
                step()
            torch.cuda.synchronize()
            prof.step()
    return device_timeline(prof)["device_ops"] / passes


def hbm_stream(mb: float = 1024, k_lo: int = 4, k_hi: int = 24, n: int = 3,
               device: str = "cuda") -> Dict:
    """GB/s of ``x <- 0.999 x + 0.5`` in place (one read, one write)."""
    dev = torch.device(device)
    elems = int(mb * 1e6 / 4)
    x = torch.ones(elems, dtype=torch.float32, device=dev)
    end = torch.tensor(500.0, device=dev)

    def step():
        x.lerp_(end, 0.001)  # x + 0.001 (500 - x) = 0.999 x + 0.5, one kernel

    def make(k):
        def run():
            for _ in range(k):
                step()
        return run

    cuda = dev.type == "cuda"
    per_iter, t_lo, t_hi = _slope(make, cuda, k_lo, k_hi, n)
    return {"gbs": 2.0 * elems * 4 / 1e9 / per_iter, "ms_per_iter": per_iter * 1e3,
            "array_mb": round(elems * 4 / 1e6, 1),
            "kernels_per_pass": _kernels_per_pass(step) if cuda else None}


def dispatch_cost(n: int = 10, device: str = "cuda") -> Dict:
    """Milliseconds of one 4 KB add and a synchronization, the least of ``n``."""
    x = torch.ones(1024, dtype=torch.float32, device=device)
    best = float("inf")
    for _ in range(n + 1):  # the first call warms up
        t0 = time.perf_counter()
        _sync(x + 1.0)
        best = min(best, time.perf_counter() - t0)
    return {"ms": best * 1e3}


def measure(args: argparse.Namespace) -> Dict:
    dev = args.device
    out = {"platform": torch.device(dev).type,
           "device": torch.cuda.get_device_name(dev) if dev.startswith("cuda") else "cpu",
           "dispatch": dispatch_cost(device=dev)}
    if args.quick:
        out["bf16_matmul_256"] = matmul_peak(256, torch.bfloat16, 2, 6, device=dev)
        out["f32_matmul_256"] = matmul_peak(256, torch.float32, 2, 6, device=dev)
        out["hbm_stream"] = hbm_stream(8, 2, 6, device=dev)
        return out
    # spans sized so the slope's delta is well above the run-to-run noise
    out["bf16_matmul_4096"] = matmul_peak(4096, torch.bfloat16, 8, 200, device=dev)
    out["bf16_matmul_8192"] = matmul_peak(8192, torch.bfloat16, 2, 20, device=dev)
    out["f32_matmul_4096"] = matmul_peak(4096, torch.float32, 8, 100, device=dev)
    out["f32_tf32_matmul_4096"] = matmul_peak(4096, torch.float32, 8, 100, device=dev,
                                              tf32=True)
    out["hbm_stream"] = hbm_stream(1024, 4, 40, device=dev)
    out["spec_h100_sxm"] = SPEC
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small sizes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("peaks: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    print(json.dumps(measure(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
