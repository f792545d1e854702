"""Attention benchmark: the flash kernels' forward + backward against the
model's dense attention across sequence lengths (counterpart of
``benchmarks/attention.py``), with PyTorch's
``scaled_dot_product_attention`` timed beside them as the library
yardstick.

Each arm is ``grad(sum(attention(q, k, v)), (q, k, v))`` at ``[B, T, H, D]``
(default B 4, H 8, D 128, causal; bf16 on the card, f32 on the CPU as the
reference runs off the TPU), timed by the paired-slope estimator with the
reference's iteration sizing: enough calls that the slope's delta is about
0.5 s of compute at 50 TFLOP/s.  Only the dense arm may stop on
``torch.cuda.OutOfMemoryError`` (its ``vs_baseline`` is then null); any
other error, a kernel's included, propagates.

One JSON line: ``value`` the flash TFLOP/s at the longest sequence,
``vs_baseline`` dense time / flash time there (> 1: flash faster),
``by_seq`` every length's milliseconds and TFLOP/s of the three arms
(useful flops: 12 B H T^2 D / 2 for causal forward + backward).

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.attention [--seqs 1024 2048 4096 8192]
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.attention --device cpu --seqs 128 --batch 1 --heads 2 --head-dim 16
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bluefog_tpu_torch.kernels import flash_attention
from bluefog_tpu_torch.models.transformer import dense_attention
from bluefog_tpu_torch.profiling import measure_rtt, paired_slope

SEQS = (1024, 2048, 4096, 8192)
SIZING_RATE = 50e12  # the reference's estimate for its iteration sizing


def _sync(x: torch.Tensor) -> None:
    """Wait for ``x`` (a scalar fetch) and check it is finite."""
    v = float(x.float().sum())
    if not math.isfinite(v):
        raise RuntimeError(f"attention: non-finite result {v}")


def timed(f: Callable[[], Tuple[torch.Tensor, ...]], iters: int) -> Tuple[float, bool]:
    """Per-call seconds of ``f()`` by :func:`profiling.paired_slope`."""
    first = f()[0]
    _sync(first)

    def region(k: int) -> float:
        out = None
        t0 = time.perf_counter()
        for _ in range(k):
            out = f()
        _sync(out[0])
        return time.perf_counter() - t0

    return paired_slope(region, iters, "attention", lambda: measure_rtt(first))


def _grad_fn(attn: Callable, q, k, v) -> Callable[[], Tuple[torch.Tensor, ...]]:
    def f():
        return torch.autograd.grad(attn(q, k, v).float().sum(), (q, k, v))
    return f


def run_seq(S: int, B: int, H: int, D: int, iters: int, dev: torch.device) -> Dict:
    """The three arms at one sequence length."""
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(dev, dtype).requires_grad_()
               for _ in range(3))
    flops = 12 * B * H * S * S * D * 0.5  # causal fwd + bwd useful flops
    if dev.type == "cuda":
        iters = max(iters, min(int(1.0 / (flops / SIZING_RATE)), 2000))
    tf, tf_fb = timed(_grad_fn(lambda a, b, c: flash_attention(a, b, c, causal=True),
                               q, k, v), iters)
    # the library yardstick on its own [B, H, T, D] layout
    qs, ks, vs = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    ts, ts_fb = timed(_grad_fn(
        lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True),
        qs, ks, vs), iters)
    del qs, ks, vs
    try:
        td, td_fb = timed(_grad_fn(
            lambda a, b, c: dense_attention(a, b, c, causal=True, dtype=dtype), q, k, v), iters)
    except torch.cuda.OutOfMemoryError:  # dense runs out first at long S
        td, td_fb = math.inf, False
        gc.collect()
        torch.cuda.empty_cache()
    row = {"seq": S, "iters": iters, "flash_ms": tf * 1e3, "sdpa_ms": ts * 1e3,
           "dense_ms": td * 1e3 if math.isfinite(td) else None,
           "flash_tf_s": flops / tf / 1e12, "sdpa_tf_s": flops / ts / 1e12,
           "dense_tf_s": flops / td / 1e12 if math.isfinite(td) else None,
           "estimator_fallbacks": int(tf_fb) + int(ts_fb) + int(td_fb)}
    print(f"# S={S}: flash {tf * 1e3:8.3f} ms  sdpa {ts * 1e3:8.3f} ms  dense "
          f"{td * 1e3:8.3f} ms  ({row['flash_tf_s']:5.1f} TF/s)", file=sys.stderr)
    return row


def run(args: argparse.Namespace) -> Dict:
    dev = torch.device(args.device)
    B, H, D = args.batch, args.heads, args.head_dim
    rows = [run_seq(S, B, H, D, args.iters, dev) for S in args.seqs]
    last = rows[-1]
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    return {
        "metric": f"flash attention fwd+bwd TFLOP/s (B{B} H{H} S{last['seq']} D{D} causal "
                  f"{dtype}, {dev.type})",
        "value": round(last["flash_tf_s"], 2),
        "unit": "TFLOP/s",
        "vs_baseline": (round(last["dense_ms"] / last["flash_ms"], 4)
                        if last["dense_ms"] is not None else None),
        "estimator_fallbacks": sum(r["estimator_fallbacks"] for r in rows),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "by_seq": rows,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--seqs", type=int, nargs="+", default=list(SEQS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("attention: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
