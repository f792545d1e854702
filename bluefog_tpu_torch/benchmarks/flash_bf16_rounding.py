"""Where the bf16 flash kernels and their plain versions part, held
against a float64 truth.

Both versions round p and dS to bf16 before their products (as the TPU
kernel does for the MXU), but each computes the f32 values it rounds in
its own way (wgmma sums and ``ex2.approx`` in the kernels, cuBLAS-free
FFMA sums and ``exp`` in the plain versions), so a value near a bf16
boundary rounds one way in one and the other way in the other.  This
script measures how far that carries: for each ``[bh, 2048, 128]`` causal
case (inputs drawn as ``chip_smoke.py``'s kernel cases draw them, one
generator seed each) it runs the three kernels and their plain versions
on the same inputs and computes the exact function of those inputs in
float64 (p = exp(s - lse), dS = p (dO V^T + corr), no rounding inside).
For each output (o, dK, dV, dQ) it reports the worst error over the bf16
element rule of ``chip_smoke.py`` (|err| <= 2^-7 |ref| + 2^-6 rms(ref))
and the norm error for kernel against plain, kernel against the truth
and plain against the truth, how many elements break the rule, and where
the worst kernel-against-plain element lies: its head, row, column, the
number of terms its sum has (queries for a dK / dV row, keys for an o /
dQ row) and the three values.

    python -m bluefog_tpu_torch.benchmarks.flash_bf16_rounding [--bh 28 128] [--seeds 4]

prints one JSON line a case, then the card's name and power limit.
Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys

import torch

from bluefog_tpu_torch.benchmarks.attention_roofline import nvidia_smi

ELEM_REL, ELEM_RMS = 2.0 ** -7, 2.0 ** -6  # chip_smoke.py's bf16 element rule
T, D = 2048, 128
HEADS_A_CHUNK = 8


def rule(got, ref):
    """(worst |err| / element tolerance, ||err|| / ||ref||, elements over
    the rule, flat index of the worst element)."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    tol = ELEM_REL * ref.abs() + ELEM_RMS * ref.pow(2).mean().sqrt()
    ratio = (err / tol).masked_fill(err == 0, 0.0)
    worst = int(ratio.argmax())
    return (ratio.max().item(), (err.norm() / ref.norm()).item(), int((ratio > 1).sum()),
            worst)


def truth(q, k, v, g, lse, corr, scale):
    """o, dK, dV, dQ in float64: the exact function of the kernels' inputs
    (o with its own exact logsumexp)."""
    out = {n: torch.empty(q.shape, dtype=torch.float64, device=q.device)
           for n in ("o", "dk", "dv", "dq")}
    t = q.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    for h0 in range(0, q.shape[0], HEADS_A_CHUNK):
        sl = slice(h0, h0 + HEADS_A_CHUNK)
        q64, k64, v64, g64 = (x[sl].double() for x in (q, k, v, g))
        s = (q64 @ k64.transpose(1, 2) * scale).masked_fill(~causal, -math.inf)
        out["o"][sl] = torch.softmax(s, -1) @ v64
        p = torch.exp(s - lse[sl].double()[..., None])
        ds = p * (g64 @ v64.transpose(1, 2) + corr[sl].double()[..., None])
        out["dk"][sl] = ds.transpose(1, 2) @ q64 * scale
        out["dv"][sl] = p.transpose(1, 2) @ g64
        out["dq"][sl] = ds @ k64 * scale
    return out


def case(fa, bh, seed, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q, k, v, g = (rnd(bh, T, D).to(torch.bfloat16) for _ in range(4))
    g_lse = rnd(bh, T)
    kw = dict(scale=1.0 / math.sqrt(D), causal=True)
    o, _ = fa.flash_fwd(q, k, v, 0, 0, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, 0, 0, **kw)
    corr = (g_lse - (o_ref.float() * g.float()).sum(-1)).contiguous()
    dk, dv = fa.flash_dkv(q, k, v, g, lse_ref, corr, 0, 0, **kw)
    dq = fa.flash_dq(q, k, v, g, lse_ref, corr, 0, 0, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse_ref, corr, 0, 0, **kw)
    dq_ref = fa.flash_dq_plain(q, k, v, g, lse_ref, corr, 0, 0, **kw)
    exact = truth(q, k, v, g, lse_ref, corr, kw["scale"])
    row = {"bh": bh, "t": T, "d": D, "causal": True, "seed": seed}
    for name, got, plain in (("o", o, o_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref),
                             ("dq", dq, dq_ref)):
        r_kp, n_kp, over, worst = rule(got, plain)
        r_kt, n_kt, over_kt, _ = rule(got, exact[name])
        r_pt, n_pt, over_pt, _ = rule(plain, exact[name])
        h, rest = divmod(worst, T * D)
        r, c = divmod(rest, D)
        row[name] = {
            "kernel_vs_plain": r_kp, "kernel_vs_plain_norm": n_kp, "over_rule": over,
            "kernel_vs_truth": r_kt, "kernel_vs_truth_norm": n_kt, "kernel_over_rule": over_kt,
            "plain_vs_truth": r_pt, "plain_vs_truth_norm": n_pt, "plain_over_rule": over_pt,
            "worst": {"head": h, "row": r, "col": c,
                      "terms": T - r if name in ("dk", "dv") else r + 1,
                      "kernel": got.flatten()[worst].item(),
                      "plain": plain.flatten()[worst].item(),
                      "truth": exact[name].flatten()[worst].item(),
                      "rms": plain.float().pow(2).mean().sqrt().item()}}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bh", type=int, nargs="+", default=[28, 128],
                    help="batch x heads of each case (llama_1b's 28, zero_8b's 128)")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bf16_rounding: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
    for bh in args.bh:
        for seed in range(args.seeds):
            print(json.dumps(case(fa, bh, seed)), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
