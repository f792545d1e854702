"""Smoke run of bluefog_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- nvidia-smi name and power limit, torch/CUDA versions, and the
               nvcc builds of csrc/flash_attention.cu (with the headers
               sm90_tile.cuh and mma_tile.cuh) and
               csrc/attention_components.cu, side by side (seconds, ptxas);
               the three flash kernels, built for Hopper, must hold wgmma
               (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA) in
               their SASS where cuobjdump is found.
2. kernels  -- each CUDA kernel (flash fwd, dK/dV and dQ on wgmma and TMA)
               against its plain
               PyTorch version on the same bf16 inputs, over seven cases
               (the main path's shape, two ring hops with q_start > k_start,
               a fully masked hop, non-causal, D = 128, a ragged length);
               then times at the main path's shape (between events around
               eager calls, and by CUDA-graph replay, which leaves out the
               wrappers' host time) beside the bound, the plain version and
               scaled_dot_product_attention.
3. model    -- a small LlamaLM whose attention runs through the kernels,
               against the same weights with the model's dense attention
               in f32, beside dense attention in bf16: loss and gradients.
4. main     -- the main path: examples/llama_pretrain at the "small" widths
               (12 layers, hidden 768), 4 virtual ranks, per-rank batch
               2 x 2048, AdamW under ATC gossip on ExponentialTwoGraph(4),
               3 steps; the launch counts must be 12 x 4 x 3 per kernel.
5. components -- each roofline microkernel instance (qk and pv at D 64 and
               128, the softmax chain, the backward chain with and without
               cast_p) against its plain version at reps 1 and 2, with its
               body and with the dependency pass alone, on 3 blocks.
6. roofline -- the second path: the counted roofline of the flash kernels
               (bluefog_tpu_torch.benchmarks.attention_roofline) at the main
               path's shape [24, 2048, 64], forward and backward; every
               microkernel must launch in it.

Then the kernel table, the nvidia-smi line, and the result line.  Any
failed check raises, so the script exits non-zero and prints no result.
It needs one CUDA device and exits non-zero without one.
"""

import importlib
import json
import math
import re
import subprocess
import sys

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
STEPS, RANKS, BATCH = 3, 4, 2

# Kernel vs plain version, element by element:
#   |got - ref| <= 2^-7 |ref| + 2^-6 rms(ref)   and   ||got - ref|| <= 1e-2 ||ref||.
# 2^-7 |ref| is one bf16 step of the value itself (both versions round their
# f32 sums to bf16 once, and may land on either side of a rounding
# boundary); 2^-6 rms(ref) allows a few bf16 steps of p or dS that round
# differently inside the sums.  Each value is held to its own size, so a
# kernel that drops or zeroes a tile of small values fails.  lse (f32, never
# rounded to bf16): |got - ref| <= 1e-3 on rows with a visible key, and the
# sentinel on rows without one.
ELEM_REL, ELEM_RMS, NORM_REL, LSE_ABS = 2.0 ** -7, 2.0 ** -6, 1e-2, 1e-3
TOLERANCE = ("|err| <= 2^-7|ref| + 2^-6 rms(ref) per element, ||err|| <= 1e-2 ||ref||;"
             " lse |err| <= 1e-3 on visible rows")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def compare(got, ref):
    """(max abs error, worst error / element tolerance, ||err|| / ||ref||)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = ELEM_REL * ref.abs() + ELEM_RMS * ref.pow(2).mean().sqrt()
    ratio = (err / tol).masked_fill(err == 0, 0.0)  # err > 0 at tol 0 is inf
    err_norm, ref_norm = err.norm().item(), ref.norm().item()
    norm_rel = err_norm / ref_norm if ref_norm else (0.0 if err_norm == 0 else math.inf)
    return err.max().item(), ratio.max().item(), norm_rel


def compare_lse(got, ref):
    """(max abs error on rows with a visible key, error / LSE_ABS); a row
    without one must hold the sentinel in both versions."""
    visible = ref > -1e29
    check(bool((got[~visible] < -1e29).all().item()), "lse: masked row lost its sentinel")
    err = (got - ref)[visible].abs().max().item() if visible.any().item() else 0.0
    return err, err / LSE_ABS


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def visible_pairs(tq, tk, q_start, k_start, causal):
    """Number of (query, key) pairs the causal mask lets through."""
    if not causal:
        return tq * tk
    total = 0
    for i in range(tq):
        total += max(0, min(tk, q_start + i - k_start + 1))
    return total


def sass_ops(_build):
    """{kernel: {"HGMMA": n, "UTMALDG": n, "HMMA": n}} over the flash
    library's kernels (both head dims together), from cuobjdump's SASS; None
    where cuobjdump is not found."""
    funcs = _build.sass("flash_attention")
    if funcs is None:
        return None
    counts = {}
    for fname, body in funcs.items():
        found = re.search(r"fwd_kernel|dkv_kernel|dq_kernel", fname)
        if found:
            ops = counts.setdefault(found.group(0), {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0})
            for op in ops:
                ops[op] += len(re.findall(rf"\b{op}\b", body))
    return counts


def phase_device(torch, _build, fa, ac):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sources = ["flash_attention", "attention_components"]
    build_s = _build.build_all(sources)
    fa._lib()
    ac._lib()
    ptxas = {name: [l.strip() for l in _build.build_logs.get(name, "").splitlines()
                    if "registers" in l or "spill" in l] for name in sources}
    sass = sass_ops(_build)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas, "sass": sass or "cuobjdump not found"})
    for kname in ("fwd_kernel", "dkv_kernel", "dq_kernel") if sass else ():
        ops = sass.get(kname, {})
        check(ops.get("HGMMA", 0) > 0 and ops.get("UTMALDG", 0) > 0 and ops.get("HMMA", 0) == 0,
              f"device: {kname} holds no wgmma, no TMA load, or mma.sync ({ops})")
    return smi


def _case_inputs(torch, gen, bh, t, d):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v, g = (rnd(bh, t, d).to(torch.bfloat16) for _ in range(4))
    g_lse = rnd(bh, t)
    return q, k, v, g, g_lse


def phase_kernels(torch, fa):
    """Kernel vs plain on each case; returns per-kernel max error and the
    main-path-shape inputs for timing."""
    from bluefog_tpu_torch.profiling import graph_seconds

    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = dict(bh=BATCH * 12, t=2048, d=64, q_start=0, k_start=0, causal=True)
    cases = {
        "path": path,
        "ring_hop": dict(bh=8, t=1024, d=64, q_start=1536, k_start=1024, causal=True),
        "ring_hop_diag": dict(bh=8, t=1024, d=64, q_start=512, k_start=0, causal=True),
        "masked_hop": dict(bh=8, t=1024, d=64, q_start=0, k_start=1024, causal=True),
        "non_causal": dict(bh=8, t=1024, d=64, q_start=0, k_start=0, causal=False),
        "d128": dict(bh=8, t=1024, d=128, q_start=0, k_start=0, causal=True),
        "ragged": dict(bh=4, t=1000, d=64, q_start=0, k_start=0, causal=True),
    }
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    failures = []
    saved = None
    for name, c in cases.items():
        q, k, v, g, g_lse = _case_inputs(torch, gen, c["bh"], c["t"], c["d"])
        scale = 1.0 / math.sqrt(c["d"])
        kw = dict(scale=scale, causal=c["causal"])
        o, lse = fa.flash_fwd(q, k, v, c["q_start"], c["k_start"], **kw)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, c["q_start"], c["k_start"], **kw)
        corr = (g_lse - (o_ref.float() * g.float()).sum(-1)).contiguous()
        dk, dv = fa.flash_dkv(q, k, v, g, lse_ref, corr, c["q_start"], c["k_start"], **kw)
        dq = fa.flash_dq(q, k, v, g, lse_ref, corr, c["q_start"], c["k_start"], **kw)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse_ref, corr,
                                            c["q_start"], c["k_start"], **kw)
        dq_ref = fa.flash_dq_plain(q, k, v, g, lse_ref, corr,
                                   c["q_start"], c["k_start"], **kw)
        torch.cuda.synchronize()
        row = {"phase": "kernel_case", "case": name, **c}
        for kname, pairs in (("fwd", [("o", o, o_ref)]),
                             ("dkv", [("dk", dk, dk_ref), ("dv", dv, dv_ref)]),
                             ("dq", [("dq", dq, dq_ref)])):
            worst, worst_ratio, worst_norm = 0.0, 0.0, 0.0
            for what, got, ref in pairs:
                check(torch.isfinite(got).all().item(), f"{name}: non-finite {what}")
                err, ratio, norm_rel = compare(got, ref)
                if ratio > 1.0 or norm_rel > NORM_REL:
                    failures.append(f"{name} {what}: max error {err}, {ratio:.3g} x the "
                                    f"element tolerance, norm error {norm_rel:.3g}")
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
                worst_norm = max(worst_norm, norm_rel)
            row[f"{kname}_max_abs_err"] = worst
            row[f"{kname}_tol_ratio"] = worst_ratio
            row[f"{kname}_norm_rel_err"] = worst_norm
            errs[kname] = max(errs[kname], worst)
        lse_err, lse_ratio = compare_lse(lse, lse_ref)
        if lse_ratio > 1.0:
            failures.append(f"{name} lse: max error {lse_err} > {LSE_ABS}")
        row["lse_max_abs_err"] = lse_err
        errs["fwd"] = max(errs["fwd"], lse_err)
        if name == "masked_hop":
            check(o.float().abs().max().item() == 0.0, "masked hop: o must be 0")
            check(lse.max().item() < -1e29, "masked hop: lse must be the sentinel")
        row["tolerance"] = TOLERANCE
        if name == "path":
            saved = (q, k, v, g, lse_ref, corr, o_ref)
            # the rule must fail an output whose last 64-row tile was lost
            for what, ref in (("o", o_ref), ("dv", dv_ref)):
                lost = ref.clone()
                lost[:, -64:] = 0
                row[f"{what}_last_tile_zeroed_tol_ratio"] = ratio = compare(lost, ref)[1]
                check(ratio > 1.0, f"tolerance rule passes {what} with its last tile zeroed")
        emit(row)
    check(not failures, "kernel vs plain: " + "; ".join(failures))

    # times at the main path's shape (inputs resident in L2, as in the model
    # where attention reads q/k/v right after their projections)
    q, k, v, g, lse, corr, o = saved
    bh, t, d = q.shape
    kw = dict(scale=1.0 / math.sqrt(d), causal=True)
    counts_before = dict(fa.launches)
    calls = {
        "fwd": lambda: fa.flash_fwd(q, k, v, 0, 0, **kw),
        "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, corr, 0, 0, **kw),
        "dq": lambda: fa.flash_dq(q, k, v, g, lse, corr, 0, 0, **kw),
    }
    ms = {kname: cuda_ms(fn) for kname, fn in calls.items()}
    # at ~0.05 ms a call the eager reading partly times the wrappers' host
    # work (tensor-map encodes); a graph replays the launches without it
    graph_ms = {kname: graph_seconds(fn, calls=20) * 1e3 for kname, fn in calls.items()}
    plain_ms = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, 0, 0, **kw), iters=5),
        "dkv": cuda_ms(lambda: fa.flash_dkv_plain(q, k, v, g, lse, corr, 0, 0, **kw), iters=5),
        "dq": cuda_ms(lambda: fa.flash_dq_plain(q, k, v, g, lse, corr, 0, 0, **kw), iters=5),
    }
    fa.launches.update(counts_before)  # timing launches are not the path's
    b = bh // 12
    q4, k4, v4 = (x.view(b, 12, t, d) for x in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
    g4 = g.view(b, 12, t, d)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(g4)

    sdpa_fb = cuda_ms(sdpa_fwd_bwd)
    # PyTorch's flash backward alone: dQ, dK and dV in one call.  It is the
    # yardstick for dkv and dq together; no library call computes dK/dV or
    # dQ alone, or takes an lse cotangent, so their library_ms stays null.
    aten = torch.ops.aten
    fo = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True, False)
    sdpa_bwd = cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        g4, q4, k4, v4, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, True,
        fo[6], fo[7]))
    pairs = visible_pairs(t, t, 0, 0, True)
    e = 2  # bf16 bytes
    work = {  # (flops, bytes): each input read once, each output written once
        "fwd": (4 * d * pairs * bh, (3 * e * t * d + e * t * d + 4 * t) * bh),
        "dkv": (8 * d * pairs * bh, (4 * e * t * d + 8 * t + 2 * e * t * d) * bh),
        "dq": (6 * d * pairs * bh, (4 * e * t * d + 8 * t + e * t * d) * bh),
    }
    timing = {"phase": "kernel_times", "shape": [bh, t, d], "causal": True,
              "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_fb,
              "sdpa_flash_bwd_ms": sdpa_bwd}
    table = {}
    for kname in ("fwd", "dkv", "dq"):
        flops, nbytes = work[kname]
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        table[kname] = {
            "max_abs_err": errs[kname], "ms": ms[kname], "graph_ms": graph_ms[kname],
            "plain_ms": plain_ms[kname],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sdpa_fwd if kname == "fwd" else None,
        }
        timing[f"{kname}_ms"] = ms[kname]
        timing[f"{kname}_graph_ms"] = graph_ms[kname]
        timing[f"{kname}_plain_ms"] = plain_ms[kname]
        timing[f"{kname}_bound_ms"] = table[kname]["bound_ms"]
        timing[f"{kname}_tflops"] = flops / (ms[kname] * 1e-3) / 1e12
    emit(timing)
    return table


def phase_model(torch, fa):
    """A small LlamaLM (D = 64) with flash attention on bf16 compute, held
    against the same weights with the model's dense attention in f32 (the
    truth here), beside the dense attention on bf16 compute.  bf16 moves
    every gradient by ~2% of its norm whichever attention runs, so flash
    must come no further from the truth than the dense bf16 model does, up
    to a margin: per parameter, ||g_flash - g_f32|| <= 1.25 ||g_dense - g_f32||
    (a wiring or scale fault moves a gradient by far more)."""
    from bluefog_tpu_torch.models.transformer import LlamaLM

    torch.backends.cuda.matmul.allow_tf32 = False

    def build(attention_fn, dtype):
        gen = torch.Generator().manual_seed(1)
        return LlamaLM(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                       dff=256, dtype=dtype, attention_fn=attention_fn,
                       head_chunks=4, device="cpu", generator=gen).cuda()

    models = {"flash": build(fa.make_flash_attention_fn(), torch.bfloat16),
              "dense": build(None, torch.bfloat16), "f32": build(None, torch.float32)}
    ids = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(2)).cuda()
    loss = {}
    for name, m in models.items():
        out = m(ids, labels=ids)
        out.backward()
        loss[name] = out.item()
    truth = dict(models["f32"].named_parameters())

    def grad_err(name):  # per parameter, ||g - g_f32|| / ||g_f32||
        return {n: ((p.grad - truth[n].grad).norm() / truth[n].grad.norm()).item()
                for n, p in models[name].named_parameters()}

    err_flash, err_dense = grad_err("flash"), grad_err("dense")
    ratio = max(err_flash[n] / err_dense[n] for n in err_flash)
    LOSS_ABS, GRAD_RATIO = 2e-3, 1.25
    emit({"phase": "model", "loss_flash": loss["flash"], "loss_dense": loss["dense"],
          "loss_f32": loss["f32"], "loss_abs_err": abs(loss["flash"] - loss["f32"]),
          "grad_norm_rel_err": max(err_flash.values()),
          "grad_norm_rel_err_dense": max(err_dense.values()), "grad_err_ratio": ratio,
          "tolerance": f"|loss - loss_f32| <= {LOSS_ABS}; per parameter "
                       f"||g - g_f32|| <= {GRAD_RATIO} x the dense bf16 model's"})
    check(math.isfinite(loss["flash"]) and abs(loss["flash"] - loss["f32"]) <= LOSS_ABS,
          f"model: flash loss {loss['flash']} vs f32 {loss['f32']}")
    check(ratio <= GRAD_RATIO, f"model: flash gradients {ratio} x further from f32 than dense")


def phase_main(torch, fa):
    from bluefog_tpu_torch.examples import llama_pretrain

    fa.reset_launches()
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "small", "--steps", str(STEPS), "--size", str(RANKS),
         "--batch", str(BATCH), "--device", "cuda"]))
    counts = dict(fa.launches)
    losses = [x for step in out["losses"] for x in step]
    check(all(math.isfinite(x) for x in losses), f"main: non-finite loss {losses}")
    check(math.isfinite(out["consensus_spread"]), "main: non-finite parameters")
    want = out["layers"] * RANKS * STEPS
    for kname, n in counts.items():
        check(n == want, f"main: {kname} launched {n} times, expected {want}")
    emit({"phase": "main", **out, "launches": counts})
    return counts


COMPONENT_BLOCKS = 3


def phase_components(torch, ac, roof):
    """Each microkernel instance against its plain version on the card, on
    the same inputs, at reps 1 (the body) and 2 (the fed-back row), with
    the body and with the dependency pass alone.  The rule is
    attention_components.compare (stated there): every element within
    1e-5 (|ref| + rms(ref)), beyond it only a one-step bf16 rounding flip,
    bounded through the product.  Every block must hold the same tile.
    Returns the worst absolute error per microkernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = {d: roof.component_inputs(d, seed=2) for d in (64, 128)}
    worst = {name: 0.0 for name in ac.PLAIN}
    failures = []
    for name, d, kw in ac.INSTANCES:
        args = inputs[d][name]
        for body in (True, False):
            for reps in (1, 2):
                got = roof.WRAPPERS[name](*args, reps, body=body, blocks=COMPONENT_BLOCKS, **kw)
                ref = ac.PLAIN[name](*args, reps, body=body, blocks=COMPONENT_BLOCKS, **kw)
                torch.cuda.synchronize()
                what = f"{name} d={d} {kw} body={body} reps={reps}"
                check(torch.isfinite(got).all().item(), f"components: non-finite {what}")
                check(bool((got == got[:1]).all().item()), f"components: blocks differ, {what}")
                res = ac.compare(name, got, ref, args, reps, body=body, **kw)
                if not res["ok"]:
                    failures.append(f"{what}: {res}")
                worst[name] = max(worst[name], res["max_abs_err"])
                emit({"phase": "component_case", "kernel": name, "d": d, **kw, "body": body,
                      "reps": reps, **res})
    check(not failures, "components vs plain: " + "; ".join(failures))
    return worst


def phase_roofline(torch, fa, ac, roof):
    """The counted roofline at the main path's shape, forward and backward,
    with every launch count set to 0 just before and read just after."""
    fa.reset_launches()
    ac.reset_launches()
    row = roof.roofline_row("path", roof.SHAPES["path"], bwd=True)
    counts = {"components": dict(ac.launches), "flash": dict(fa.launches)}
    check(not row.get("invalid"), f"roofline: {row}")
    check(row["tiles"] == 12672, f"roofline: {row['tiles']} tiles, expected 24 x 528")
    for kname in ("fwd", "dkv", "dq"):
        for key in ("pred_overlap_ms", "pred_serial_ms", "measured_ms", "unexplained_pct"):
            check(math.isfinite(row[f"{kname}_{key}"]), f"roofline: {kname}_{key} not finite")
        for cname, c in row["components"][kname].items():
            # a hoisted loop body would make later repetitions cheaper
            check(0.5 <= c["linearity"] <= 2.0,
                  f"roofline: {kname} {cname} time not linear in reps ({c['linearity']})")
    for name, n in counts["components"].items():
        check(n > 0, f"roofline: microkernel {name} was not launched")
    emit({"phase": "roofline", **row, "launches": counts})
    return row, counts["components"]


LINE_REPS = 256
LIBRARY_NONE = ("null: no PyTorch call computes reps dependent repetitions of the "
                "component on one tile")


def component_times(torch, ac, roof, row):
    """Each microkernel's kernel-table entry at the roofline's configuration
    for the forward (the dK/dV one for the backward chain): its blocks and
    shared memory there, LINE_REPS repetitions, one launch; its plain
    version on the same inputs and the same number of blocks."""
    ops = roof.component_inputs(64)
    timed = {}
    for name, model, kw in (("qk", "fwd", {}), ("pv", "fwd", {}),
                            ("softmax_chain", "fwd", {}), ("bwd_chain", "dkv", {"cast_p": True})):
        blocks, smem = (row["components"][model][name][k] for k in ("blocks", "smem"))
        args = ops[name]
        ms = cuda_ms(lambda: roof.WRAPPERS[name](*args, LINE_REPS, blocks=blocks,
                                                 smem_bytes=smem, **kw), iters=10)
        plain_ms = cuda_ms(lambda: ac.PLAIN[name](*args, LINE_REPS, blocks=blocks, **kw),
                           iters=2, warmup=1)
        t_ops = roof.tile_bound_us(name, 64) * 1e-3 * blocks * LINE_REPS
        in_bytes = sum(x.numel() * x.element_size() for x in args)
        out_bytes = 4 * blocks * 64 * 64
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": None, "library_note": LIBRARY_NONE,
                       "config": {"blocks": blocks, "reps": LINE_REPS, "smem": smem, **kw}}
    emit({"phase": "component_times", **timed})
    return timed


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bluefog_tpu_torch.benchmarks import attention_roofline as roof
    from bluefog_tpu_torch.kernels import _build
    from bluefog_tpu_torch.kernels import attention_components as ac

    # the package re-exports a function of the module's own name
    fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")

    smi = phase_device(torch, _build, fa, ac)
    table = phase_kernels(torch, fa)
    phase_model(torch, fa)
    counts = phase_main(torch, fa)
    comp_err = phase_components(torch, ac, roof)
    row, comp_counts = phase_roofline(torch, fa, ac, roof)
    comp_table = component_times(torch, ac, roof, row)
    replaces = {"fwd": "bluefog_tpu/kernels/flash_attention.py:246",
                "dkv": "bluefog_tpu/kernels/flash_attention.py:490",
                "dq": "bluefog_tpu/kernels/flash_attention.py:575",
                "qk": "benchmarks/attention_roofline.py:136",
                "pv": "benchmarks/attention_roofline.py:150",
                "softmax_chain": "benchmarks/attention_roofline.py:167",
                "bwd_chain": "benchmarks/attention_roofline.py:221"}
    emit({"kernels": [
        {"name": f"flash_{k}", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/flash_attention.cu",
         "replaces": replaces[k], "launches": counts[k], **table[k]}
        for k in ("fwd", "dkv", "dq")] + [
        {"name": f"{k}_component", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/attention_components.cu",
         "replaces": replaces[k], "launches": comp_counts[k],
         "max_abs_err": comp_err[k], **comp_table[k]}
        for k in ("qk", "pv", "softmax_chain", "bwd_chain")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
