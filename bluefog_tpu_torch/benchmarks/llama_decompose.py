"""Where the Llama step's time goes: the per-block and embed + head split
of one model's forward + backward by the layer-count slope (counterpart of
``benchmarks/llama_decompose.py``).

Protocol, the reference's: ``profiling.slope_time`` of the loss gradient
of one ``LlamaLM`` at two layer counts (``small``: 6 and 12), measured
back to back in each of ``--rounds`` interleaved rounds, so each round's
delta shares one window of the session.  ``conservative_delta`` over the
rounds gives a block's cost; the intercept (``robust_min`` of the low
count minus its blocks) is embed + head + harness.  Each is set against
its ideal on the H100's spec peaks, named in the JSON: 6 flops a parameter
a token at 989 TFLOP/s (dense bf16) for a block; 8 flops a head parameter
a token (forward, chunked recompute, two backward products) at 989
TFLOP/s for the bf16 head or 67 TFLOP/s (FFMA) for the f32 head.

``--attn flash`` runs the flash kernels on the card (their plain versions
with ``--device cpu``, and ``effective_attn`` says so); ``dense`` the
model's own attention; ``none`` a pass-through (``v``), which leaves the
projections, rotary, norms and MLP: flash's share is per_block(flash) -
per_block(none).  There is no fallback from one to another.

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.llama_decompose [--attn none]
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.llama_decompose --device cpu --preset tiny
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.profiling import conservative_delta, robust_min, slope_time

PRESETS = {
    "small": dict(vocab=32000, hidden=768, heads=12, dff=2048, seq=2048, batch=8,
                  layers_lo=6, layers_hi=12, head_chunks=8),
    "tiny": dict(vocab=256, hidden=64, heads=4, dff=128, seq=128, batch=2,
                 layers_lo=1, layers_hi=2, head_chunks=4),
}
PEAKS = {"bf16": 989e12, "f32_ffma": 67e12}  # H100 SXM spec (NVIDIA data sheet)


def build_grad_fn(cfg: Dict, layers: int, head_bf16: bool, attn: str,
                  dev: torch.device) -> Tuple[Callable, int, str]:
    """``(grad_step, parameter count, effective attention)``: ``grad_step()``
    is the loss gradient of the preset's model at ``layers`` layers on a
    fixed batch, warmed once."""
    attention_fn = {"flash": make_flash_attention_fn(), "dense": None,
                    "none": lambda q, k, v: v}[attn]
    effective = attn
    if attn == "flash":
        effective = "flash (cuda kernels)" if dev.type == "cuda" else "flash (plain versions, cpu)"
    model = LlamaLM(vocab_size=cfg["vocab"], hidden_size=cfg["hidden"], num_layers=layers,
                    num_heads=cfg["heads"], dff=cfg["dff"], head_chunks=cfg["head_chunks"],
                    head_dtype=torch.bfloat16 if head_bf16 else torch.float32,
                    attention_fn=attention_fn, device="cpu",
                    generator=torch.Generator(device="cpu").manual_seed(0)).to(dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab"], size=(cfg["batch"], cfg["seq"]))).to(dev)
    params = list(model.parameters())

    def grad_step():
        # under attn "none" q and k are unused: their gradient is zeros, as jax.grad's
        return torch.autograd.grad(model(ids, labels=ids), params, allow_unused=True,
                                   materialize_grads=True)

    grad_step()
    return grad_step, sum(p.numel() for p in params), effective


def measure(args: argparse.Namespace) -> Dict:
    dev = torch.device(args.device)
    cfg = PRESETS[args.preset]
    lo, hi = cfg["layers_lo"], cfg["layers_hi"]
    built, n_params = {}, {}
    effective = args.attn
    for layers in (lo, hi):
        built[layers], n_params[layers], effective = build_grad_fn(
            cfg, layers, args.head_bf16, args.attn, dev)
    t_los, t_his = [], []
    for _ in range(max(args.rounds, 1)):
        t_los.append(slope_time(built[lo]))
        t_his.append(slope_time(built[hi]))
    delta = conservative_delta(t_los, t_his)
    if delta is None:
        raise RuntimeError("llama_decompose: all paired layer-count deltas non-positive -- "
                           "session too noisy, rerun")
    per_block = delta / (hi - lo)
    deltas = [(th - tl) / (hi - lo) for tl, th in zip(t_los, t_his)]
    embed_head = robust_min(t_los, "decompose-lo") - lo * per_block
    toks = cfg["batch"] * cfg["seq"]
    block_params = (n_params[hi] - n_params[lo]) / (hi - lo)
    head_params = cfg["vocab"] * cfg["hidden"]
    ideal_block_ms = 6 * block_params * toks / PEAKS["bf16"] * 1e3
    head_peak = "bf16" if args.head_bf16 else "f32_ffma"
    ideal_head_ms = 8 * head_params * toks / PEAKS[head_peak] * 1e3
    on_card = dev.type == "cuda"
    return {
        "metric": f"Llama-{args.preset} fwd+bwd decomposition (layer-count slope {lo}->{hi}, "
                  f"{dev.type})",
        "per_block_ms": per_block * 1e3,
        "per_block_ideal_ms": ideal_block_ms,
        "per_block_gap_x": per_block * 1e3 / ideal_block_ms if on_card else None,
        "embed_head_ms": embed_head * 1e3,
        "head_ideal_ms": ideal_head_ms,
        "head_gap_x": embed_head * 1e3 / ideal_head_ms if on_card else None,
        "step_ms_at_hi": robust_min(t_his, "decompose-hi") * 1e3,
        "per_block_rounds_ms": [d * 1e3 for d in deltas],
        "per_block_spread_pct": ((max(deltas) - min(deltas)) / per_block * 100
                                 if len(deltas) > 1 else 0.0),
        "n_rounds": len(deltas),
        "estimator": "interleaved paired rounds (two-statistic)",
        "ideal_peaks_tf_s": {"block": PEAKS["bf16"] / 1e12, "head": PEAKS[head_peak] / 1e12,
                             "head_route": head_peak, "source": "H100 SXM spec"},
        "head_bf16": bool(args.head_bf16),
        "attn": args.attn,
        "effective_attn": effective,
        "unit": "ms",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--head-bf16", action="store_true")
    ap.add_argument("--attn", default="flash", choices=["flash", "dense", "none"],
                    help="attention inside the blocks (none = pass-through)")
    ap.add_argument("--rounds", type=int, default=3, help="interleaved lo/hi rounds")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("llama_decompose: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    print(json.dumps(measure(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
