"""Smoke run of bluefog_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- nvidia-smi name and power limit, torch/CUDA versions, and the
               nvcc builds of csrc/flash_attention.cu,
               csrc/flash_attention_f32.cu and csrc/attention_components.cu
               (with the headers sm90_tile.cuh and mma_tile.cuh), side by
               side (seconds, ptxas); the three flash kernels, built for Hopper, must hold
               wgmma (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA)
               in their SASS where cuobjdump is found, the qk and pv
               microkernels HGMMA (with their body) and no HMMA at both
               head dims, and the chain microkernels MUFU.EX2 (with their
               body) and no HMMA; each chain's loop must issue per element
               on each pipe what its bound prices
               (attention_roofline.CHAIN_PIPES); the f32 forward, dK/dV
               and dQ (csrc/flash_attention_f32.cu, 3xTF32) must hold TF32
               tensor-core products (HMMA.1688.F32.TF32 or HGMMA ... TF32)
               at both head dims.
2. kernels  -- each CUDA kernel (flash fwd, dK/dV and dQ on wgmma and TMA)
               against its plain
               PyTorch version on the same bf16 inputs, over nine cases
               (the main path's shape, two ring hops with q_start > k_start,
               a fully masked hop, non-causal, D = 128, D = 16 and 96
               zero-padded by the wrappers, a ragged length, phase
               llama_1b's [28, 2048, 128]);
               then times at the main path's shape (between events around
               eager calls, and by CUDA-graph replay, which leaves out the
               wrappers' host time) beside the bound, the plain version and
               scaled_dot_product_attention, and the same at the 1b
               roofline shape [8 x 14, 2048, 128] (kernel_times_d128).
2b. kernels_f32 -- each f32 CUDA kernel (the flash fwd, dK/dV and dQ
               instances of csrc/flash_attention_f32.cu, all three on the
               tensor cores by the 3xTF32 split)
               against its plain version on the same f32 inputs: the f32
               path's shape [24, 2048, 64], D = 128, D = 16 zero-padded,
               causal with offsets, tq != tk; then
               times at [24, 2048, 64] and [24, 2048, 128] beside the
               bound at three TF32 products a product (the FFMA bound
               beside it as bound_ffma_ms), the plain version and f32
               scaled_dot_product_attention, forward and forward+backward.
2c. f32     -- the f32 path: a small f32 LlamaLM with flash attention
               against the same weights with dense f32 attention (loss and
               gradients), then examples/llama_pretrain --dtype f32 at the
               "small" widths (12 layers, hidden 768, D = 64), 4 ranks,
               per-rank batch 2 x 2048 as in the main path, 2 steps, with
               every launch count set to 0 just before: each f32 count must
               be layers x ranks x steps, and no bf16 kernel may launch.
3. model    -- a small LlamaLM whose attention runs through the kernels,
               against the same weights with the model's dense attention
               in f32, beside dense attention in bf16: loss and gradients.
4. main     -- the main path: examples/llama_pretrain at the "small" widths
               (12 layers, hidden 768), 4 virtual ranks, per-rank batch
               2 x 2048, AdamW under ATC gossip on ExponentialTwoGraph(4),
               3 steps; the launch counts must be 12 x 4 x 3 per kernel.
5. components -- each roofline microkernel instance (qk and pv at D 64 and
               128; the softmax chain, the backward chain with and without
               cast_p) at reps 1, 2 and 3 against its plain version, with
               its body and with the dependency pass alone, on 3 blocks
               (6 tiles, one a warpgroup).
6. roofline -- the second path: the counted roofline of the flash kernels
               (bluefog_tpu_torch.benchmarks.attention_roofline) at the main
               path's shape [24, 2048, 64], forward and backward, with both
               band pairs (with and without the dependency pass); every
               microkernel must launch in it.

7. resnet   -- this slice's path, which runs no kernel of the repo
               (convolutions are cuDNN's, as the JAX package leaves them to
               XLA): ResNet-50 at 224 x 224 and 1000 classes on 4 ranks,
               per-rank batch cut from the benchmark's 128 to 32, 3 steps
               under ATC neighbor_allreduce and 3 under gradient allreduce,
               with batch statistics: finite losses, every rank's running
               statistics moved in its own slice, parameters after gossip
               equal to the plan's weighted mix of the adapted parameters
               on one leaf, allreduce ranks identical; step ms, images/s and
               peak memory.  Then examples/torch_mnist (LeNet-5) on the card
               for 2 epochs: the loss must fall.
8. windows  -- every one-sided window op (win_put, a selective win_put,
               win_accumulate, win_get, win_update with default and explicit
               weights and reset, win_put_update, a fused dict window) on
               4 ranks x 4M elements, f32 and bf16, over
               ExponentialTwoGraph(4) and RingGraph(4, connect_style=1),
               associated p on, against a dense float64 reference (mixing
               matrix x rank rows) with versions and p; ms of each op.
9. bert_pushsum -- BERT-base (110M parameters), 4 ranks x batch 32 x seq
               128, the push-sum fine-tune round of
               bluefog_tpu_torch.benchmarks.bert_pushsum: 4 eager rounds
               and 4 device-flow rounds from the same state must agree,
               losses finite, sum p = 4 after every update; round ms,
               tokens/s, peak memory.
10. exact_algorithms -- gradient tracking, EXTRA and Push-DIGing on the
               reference test's heterogeneous quadratics (8 ranks, dim 6):
               distance to the centralized optimum within 1e-4 / 1e-3 /
               1e-3, and ATC above 1e-2.
11. eager_api -- the reference's eager API on 8 ranks = 4 machines x 2,
               4M elements a rank, f32 and bf16: allgather,
               neighbor_allgather on ExponentialTwoGraph(8) and
               StarGraph(8), the dynamic neighbor_allreduce (src, dst,
               both), hierarchical_neighbor_allreduce, pairwise_gossip, the
               _nonblocking forms through synchronize, barrier; against a
               float64 reference (gathers exact); ms of each op.
12. hierarchical -- BASELINE config #4: ResNet-50 (224 x 224, 1000
               classes), 8 ranks = 4 machines x 2, per-rank batch 16, ATC
               momentum SGD with hierarchical_neighbor_allreduce on the
               machine topology ExponentialTwoGraph(4), batch statistics,
               3 steps: finite losses, running statistics moved and
               differ, the ranks of a machine bit-equal, a leaf equal to
               the machine plan's mix of the local means; then one call
               with steps_per_call=2.
13. llama_1b -- the 1b preset of benchmarks/llama.py with GQA through
               examples/llama_pretrain: hidden 1792, 24 layers, 14 heads on
               2 kv heads (D = 128), dff 4864, vocab 32000, S = 2048, remat,
               scan_layers (nine stacked leaves), momentum SGD with a bf16
               trace, head_chunks 8; 4 ranks, per-rank batch cut from 8 to
               2, ATC gossip on ExponentialTwoGraph(4), 3 steps: finite
               losses, a stacked leaf equal to the plan's mix after every
               step, bf16 traces, and the launch counts remat makes
               (forward 2 x 24 x 4 x 3, dK/dV and dQ 24 x 4 x 3).
14. vit      -- ViT-B/16 (86M) at 224 x 224, 1000 classes, bf16, 4 ranks x
               32 images, ATC SGD on ExponentialTwoGraph(4), 3 steps:
               finite losses, the plan's mix after every step; no kernel of
               the repo launches (dense attention, as the reference's).
15. seq_parallel -- sequence parallelism on the flash kernels, the
               reference's --seq-parallel Llama path through
               examples/llama_pretrain --seq-parallel at the small preset's
               widths (12 layers, hidden 768, 12 heads, D = 64, bf16) over
               a global context of 8192 tokens on 4 ranks (shards of
               2048), batch 2, Adam 3e-3.  First, at the layer shape
               [2, 8192, 12, 64], the contiguous and striped rings and
               Ulysses in bf16 and the striped ring in f32 (forward, dq,
               dk, dv under a seeded cotangent): every launch against its
               plain version (the kernels' bf16 or f32 rule, element
               part widened 1.5x), faults planted in one launch of each
               kernel and dtype read above that limit, the merged outputs against
               the rings on the plain versions, one full-sequence launch
               and the f32 truth (in norm); then
               three modes, 3 steps each: contiguous ring flash, striped
               ring flash, Ulysses with flash: finite losses, fwd = dK/dV =
               dQ launches of 48 / 84 / 12 a step, the logits before any
               update against the full-sequence model (both against the
               f32 truth); then 2 layers in f32, striped, 2 steps: 14 f32
               launches a step, no bf16 launch.
16. zero_8b  -- BASELINE config #5: the FSDP + machine-gossip step of
               benchmarks/zero_8b.py (bluefog_tpu_torch.benchmarks.zero_8b)
               at the Llama-3-8B widths (vocab 128256, hidden 4096, 32 heads
               on 8 kv heads, D = 128, dff 14336, seq 2048), cut 32 -> 2
               layers, 2 machines x 4 local ranks x batch 1, remat,
               scan_layers, head_chunks 16, spmd_vocab, the FSDP hooks with
               bf16 gradients, momentum SGD with a bf16 momentum, 3 steps:
               finite losses, f32 masters and bf16 momenta, after every step
               a leaf equal to the machine plan's mix of its adapted values,
               the flash launches the design predicts (forward 24, dK/dV and
               dQ 12); step ms, tokens/s, peak memory.  Then at 1 layer
               (f32 momentum, no gradient cast) the packed ZeRO-1 and the
               FSDP builders, 2 steps each from one start: their updates
               agree in norm, and not with the machine mix skipped.
17. tensor_parallel -- examples/tp_gossip at the small preset's widths
               (12 layers, hidden 768, 12 heads, D = 64, dff 2048), seq
               2048, batch 2 a dp rank, dp 2 x tp 2, f32 on the f32 flash
               kernels: the loss and unsharded gradients of tp 2 against tp
               1, then 3 gossip steps (f32 launches 12 x 2 a step).
18. pipeline -- examples/pp_gossip's pipeline at the same widths, 4 stages,
               4 microbatches, seq 512, dense attention: loss and gradients
               against the sequential blocks.
19. expert   -- examples/moe_gossip at the same widths, 8 experts, ep 4 and
               ep 1, dp 2, batch 4 x 512, 3 steps each: loss for loss.
Phases 8-12, 14, 18 and 19 run no kernel of the repo and add no row to the
kernel table; the bf16 rows' launches sum the main, llama_1b, seq_parallel
and zero_8b paths, the f32 rows' the f32_path, seq_parallel and
tensor_parallel paths.

Then the kernel table, the nvidia-smi line, and the result line.  Any
failed check raises, so the script exits non-zero and prints no result.
It needs one CUDA device and exits non-zero without one.
"""

import gc
import importlib
import json
import math
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (FFMA)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
TF32_SPLIT = 3            # TF32 products a 3xTF32 product takes
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
# The f32 kernels against their plain versions (no rounding to bf16):
# |got - ref| <= 2^-14 (|ref| + rms(ref)) per element.  Three sources move
# a value: the order of the sums (the kernels' against cuBLAS's), a few f32
# steps (2^-23 each) times the sqrt of the terms summed; in all three
# kernels, the 3xTF32 split, whose dropped small.small term and TF32 read of
# small move each product by under 2^-21 |a||b| (the CPU test
# tests/test_torch_flash_f32_split.py emulates the split against the JAX
# kernel: it stays over 15x inside this rule, one TF32 product lands over
# 20x outside it); and there too the tensor cores' sums, which round toward
# zero, so the kernels keep each chain of products to a short partial sum
# (that test's model of it: a hundredth of this rule with 32-row partial
# sums, against half for one chain over T = 2048).  All are well below
# 2^-14 of the value or of the rms.
# lse: |got - ref| <= 2e-5 on rows with a visible key (about 20 f32 steps
# at the size lse takes at T = 2048), the sentinel on rows without one.
F32_ELEM, F32_LSE_ABS = 2.0 ** -14, 2e-5
TOLERANCE_F32 = "|err| <= 2^-14 (|ref| + rms(ref)) per element; lse |err| <= 2e-5 on visible rows"
# Where the element rule cannot part two faithful versions, both are held
# against a float64 truth instead: at every element the version under test
# may stray from the truth by at most one element tolerance (of the truth)
# beyond where its reference strays.  The bf16 kernels and their plain
# versions both round p and dS to bf16 inside their sums; at zero_8b's
# [128, 2048, 128] each sits up to ~3-6x the bf16 rule from the truth at
# thousands of elements, and where they part most it is the plain version
# that is farther (benchmarks/flash_bf16_rounding.py): that case's element
# gate is this one, its norm gate the bf16 rule's.
TRUTH_CASES = ("zero_8b",)
TOLERANCE_TRUTH = ("|got - truth| - |ref - truth| <= tol(truth) per element, truth in float64, "
                   "tol the element rule's")


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


def excess_over_reference(got, ref, truth):
    """The worst (|got - truth| - |ref - truth|) / tol over the elements,
    tol = the bf16 element rule's of the truth: how far ``got`` strays from
    the float64 truth beyond where ``ref`` stands (<= 1 passes)."""
    t = truth.double()
    tol = ELEM_REL * t.abs() + ELEM_RMS * t.pow(2).mean().sqrt()
    excess = (got.double() - t).abs() - (ref.double() - t).abs()
    return (excess / tol).max().clamp_min(0.0).item()


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


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "MUFU.EX2")
BODY = {"1": "body", "0": "dep"}


def component_name(fname):
    """A microkernel instance's name ("qk_kernel<64, body>",
    "bwd_chain_kernel<cast_p=1, dep>") from its mangled name, or None."""
    m = re.search(r"(qk|pv)_kernelILi(\d+)ELb([01])E", fname)
    if m:
        return f"{m.group(1)}_kernel<{m.group(2)}, {BODY[m.group(3)]}>"
    m = re.search(r"softmax_chain_kernelILb([01])E", fname)
    if m:
        return f"softmax_chain_kernel<{BODY[m.group(1)]}>"
    m = re.search(r"bwd_chain_kernelILb([01])ELb([01])E", fname)
    if m:
        return f"bwd_chain_kernel<cast_p={m.group(1)}, {BODY[m.group(2)]}>"
    return None


def sass_ops(_build):
    """{kernel: {op: n for op in SASS_OPS}} from cuobjdump's SASS: the flash
    library's kernels (both head dims together) and each microkernel
    instance (component_name); None where cuobjdump is not found."""
    flash = _build.sass("flash_attention")
    if flash is None:
        return None
    found = [(re.search(r"fwd_kernel|dkv_kernel|dq_kernel", f), b) for f, b in flash.items()]
    named = [(m.group(0), b) for m, b in found if m]
    named += [(component_name(f), b) for f, b in _build.sass("attention_components").items()
              if component_name(f)]
    counts = {}
    for kname, body in named:
        ops = counts.setdefault(kname, dict.fromkeys(SASS_OPS, 0))
        for op in ops:
            ops[op] += len(re.findall(rf"\b{re.escape(op)}\b", body))
    return counts


TF32_MMA = r"\bHMMA\.\w+\.F32\.TF32\b|\bHGMMA\.\S*TF32"


def sass_tf32(_build):
    """{f32 flash kernel: [TF32 tensor-core instructions of each instance]}
    from cuobjdump's SASS of csrc/flash_attention_f32.cu; None where
    cuobjdump is not found."""
    funcs = _build.sass("flash_attention_f32")
    if funcs is None:
        return None
    counts = {}
    for fname, body in sorted(funcs.items()):
        m = re.search(r"(fwd|dkv|dq)_f32_kernel", fname)
        if m:
            counts.setdefault(m.group(0), []).append(len(re.findall(TF32_MMA, body)))
    return counts


def phase_device(torch, _build, fa, ac, roof):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sources = ["flash_attention", "flash_attention_f32", "attention_components"]
    build_s = _build.build_all(sources)
    fa._lib()
    fa._lib_f32()
    ac._lib()
    ptxas = {name: [l.strip() for l in _build.build_logs.get(name, "").splitlines()
                    if "registers" in l or "spill" in l] for name in sources}
    sass = sass_ops(_build)
    tf32 = sass_tf32(_build)
    # the chains' instructions an element per pipe, which their bound prices
    named = {component_name(f): b for f, b in (_build.sass("attention_components") or {}).items()}
    pipes = {name: roof.loop_pipe_counts(b) for name, b in named.items()
             if name and "chain" in name and "body" in name}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": torch.cuda.get_device_name(0),
          "build_s": build_s, "ptxas": ptxas, "sass": sass or "cuobjdump not found",
          "sass_f32_tf32_mma": tf32 or "cuobjdump not found", "chain_pipes": pipes})
    for kname in ("fwd_f32_kernel", "dkv_f32_kernel", "dq_f32_kernel") if tf32 else ():
        n = tf32.get(kname, [])
        check(len(n) == 2 and all(x > 0 for x in n),
              f"device: {kname} must hold TF32 tensor-core products at both head dims ({n})")
    for key, counts in roof.CHAIN_PIPES.items() if sass else ():
        name = ("softmax_chain_kernel<body>" if key[0] == "softmax_chain"
                else f"bwd_chain_kernel<cast_p={int(key[1])}, body>")
        check(pipes.get(name) == counts,
              f"device: {name} issues {pipes.get(name)} an element, the bound prices {counts}")
    for kname in ("fwd_kernel", "dkv_kernel", "dq_kernel") if sass else ():
        ops = sass.get(kname, {})
        check(ops.get("HGMMA", 0) > 0 and ops.get("UTMALDG", 0) > 0 and ops.get("HMMA", 0) == 0,
              f"device: {kname} holds no wgmma, no TMA load, or mma.sync ({ops})")
    for name in ("qk", "pv") if sass else ():
        for d in (64, 128):
            body, dep = (sass.get(f"{name}_kernel<{d}, {b}>") for b in ("body", "dep"))
            check(body is not None and dep is not None, f"device: {name} d={d} not in the SASS")
            check(body["HGMMA"] > 0 and body["HMMA"] == 0 and dep["HMMA"] == 0,
                  f"device: {name}_kernel<{d}> holds no wgmma, or mma.sync ({body}, {dep})")
    chains = ["softmax_chain_kernel<{}>", "bwd_chain_kernel<cast_p=1, {}>",
              "bwd_chain_kernel<cast_p=0, {}>"]
    for name in chains if sass else ():
        body, dep = (sass.get(name.format(b)) for b in ("body", "dep"))
        check(body is not None and dep is not None, f"device: {name} not in the SASS")
        check(body["MUFU.EX2"] > 0 and body["HMMA"] == 0 and dep["HMMA"] == 0,
              f"device: {name} holds no MUFU.EX2, or mma.sync ({body}, {dep})")
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
    from bluefog_tpu_torch.benchmarks.flash_bf16_rounding import truth
    from bluefog_tpu_torch.benchmarks.zero_8b import CFG as Z8_CFG
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
        # head dims the kernels take zero-padded to 64 and to 128
        "d16": dict(bh=8, t=1024, d=16, q_start=0, k_start=0, causal=True),
        "d96": dict(bh=8, t=1024, d=96, q_start=0, k_start=0, causal=True),
        "ragged": dict(bh=4, t=1000, d=64, q_start=0, k_start=0, causal=True),
        # phase llama_1b's shape: per-rank batch 2 x 14 heads (GQA repeats
        # k and v before the kernels), D = 128
        "llama_1b": dict(bh=L1B_BATCH * 14, t=2048, d=128, q_start=0, k_start=0, causal=True),
        # phase zero_8b's shape: a machine's 4 local ranks x batch 1 x 32
        # heads (GQA's 8 kv heads repeated), D = 128
        "zero_8b": dict(bh=Z8_MESH[1] * Z8_CFG["batch"] * Z8_CFG["heads"], t=Z8_CFG["seq"],
                        d=Z8_CFG["hidden"] // Z8_CFG["heads"], q_start=0, k_start=0,
                        causal=True),
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
        exact = truth(q, k, v, g, lse_ref, corr, scale) if name in TRUTH_CASES else None
        for kname, pairs in (("fwd", [("o", o, o_ref)]),
                             ("dkv", [("dk", dk, dk_ref), ("dv", dv, dv_ref)]),
                             ("dq", [("dq", dq, dq_ref)])):
            worst, worst_ratio, worst_norm = 0.0, 0.0, 0.0
            for what, got, ref in pairs:
                check(torch.isfinite(got).all().item(), f"{name}: non-finite {what}")
                err, ratio, norm_rel = compare(got, ref)
                elem = ratio
                if exact is not None:
                    elem = excess_over_reference(got, ref, exact[what])
                    row[f"{what}_excess_over_plain_vs_truth"] = elem
                    row[f"{what}_plain_vs_truth_tol_ratio"] = compare(ref, exact[what])[1]
                if elem > 1.0 or norm_rel > NORM_REL:
                    failures.append(f"{name} {what}: max error {err}, {elem:.3g} x the "
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
        if exact is not None:
            row["element_gate"] = TOLERANCE_TRUTH
            # the gate must fail an output whose last 64-row tile was lost
            lost = o.clone()
            lost[:, -64:] = 0
            row["o_last_tile_zeroed_excess"] = bad = excess_over_reference(
                lost, o_ref, exact["o"])
            check(bad > 1.0, f"{name}: the truth gate passes o with its last tile zeroed")
            del exact
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
    work = bf16_work(bh, t, d)
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
    for kname, entry in kernel_times_1b(torch, fa, gen).items():
        table[kname].update({f"{key}_d128": v for key, v in entry.items()})
    return table


def bf16_work(bh, t, d):
    """(flops, bytes) of the bf16 fwd, dK/dV and dQ at [bh, t, d], causal:
    each input read once, each output written once."""
    pairs = visible_pairs(t, t, 0, 0, True)
    e = 2
    return {
        "fwd": (4 * d * pairs * bh, (3 * e * t * d + e * t * d + 4 * t) * bh),
        "dkv": (8 * d * pairs * bh, (4 * e * t * d + 8 * t + 2 * e * t * d) * bh),
        "dq": (6 * d * pairs * bh, (4 * e * t * d + 8 * t + e * t * d) * bh),
    }


ROOFLINE_1B = (8, 14, 2048, 128)  # B, H, T, D: the 1b roofline shape


def kernel_times_1b(torch, fa, gen):
    """The bf16 kernels at the 1b roofline shape [8 x 14, 2048, 128],
    causal: eager and CUDA-graph ms beside the bound, the plain version and
    scaled_dot_product_attention (forward; its flash backward beside
    dK/dV + dQ).  lse and the row correction come from the kernel's own
    forward (the kernels were held against their plain versions at D = 128
    in the cases above).  Launches made here are not a path's."""
    from bluefog_tpu_torch.profiling import graph_seconds

    F = torch.nn.functional
    b, h, t, d = ROOFLINE_1B
    bh = b * h
    q, k, v, g = (torch.randn(bh, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    kw = dict(scale=1.0 / math.sqrt(d), causal=True)
    counts_before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, 0, 0, **kw)
    corr = (-(o.float() * g.float()).sum(-1)).contiguous()
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v, 0, 0, **kw),
             "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, corr, 0, 0, **kw),
             "dq": lambda: fa.flash_dq(q, k, v, g, lse, corr, 0, 0, **kw)}
    plain = {"fwd": lambda: fa.flash_fwd_plain(q, k, v, 0, 0, **kw),
             "dkv": lambda: fa.flash_dkv_plain(q, k, v, g, lse, corr, 0, 0, **kw),
             "dq": lambda: fa.flash_dq_plain(q, k, v, g, lse, corr, 0, 0, **kw)}
    ms = {kname: cuda_ms(fn) for kname, fn in calls.items()}
    graph_ms = {kname: graph_seconds(fn, calls=20) * 1e3 for kname, fn in calls.items()}
    plain_ms = {kname: cuda_ms(fn, iters=3, warmup=1) for kname, fn in plain.items()}
    fa.launches.update(counts_before)
    q4, k4, v4, g4 = (x.view(b, h, t, d) for x in (q, k, v, g))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    aten = torch.ops.aten
    fo = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True, False)
    sdpa_bwd = cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        g4, q4, k4, v4, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, True,
        fo[6], fo[7]))
    timing = {"phase": "kernel_times_d128", "shape": [bh, t, d], "causal": True,
              "sdpa_fwd_ms": sdpa_fwd, "sdpa_flash_bwd_ms": sdpa_bwd,
              "dkv_plus_dq_ms": ms["dkv"] + ms["dq"]}
    out = {}
    for kname, (flops, nbytes) in bf16_work(bh, t, d).items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[kname] = {"ms": ms[kname], "graph_ms": graph_ms[kname], "plain_ms": plain_ms[kname],
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "library_ms": sdpa_fwd if kname == "fwd" else None}
        timing[kname] = {**out[kname], "tflops": flops / (ms[kname] * 1e-3) / 1e12}
    emit(timing)
    return out


def compare_f32(got, ref):
    """(max abs error, worst error / element tolerance) under F32_ELEM."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = F32_ELEM * (ref.abs() + ref.pow(2).mean().sqrt())
    ratio = (err / tol).masked_fill(err == 0, 0.0)
    return err.max().item(), ratio.max().item()


F32_CASES = {  # bh, tq, tk, d, q_start, k_start, causal
    "path": (BATCH * 12, 2048, 2048, 64, 0, 0, True),  # phase_f32's: batch 2 x 12 heads
    "d128": (8, 1024, 1024, 128, 0, 0, True),
    "d16": (8, 1024, 1024, 16, 0, 0, True),  # zero-padded to 64
    "offsets": (8, 640, 640, 64, 200, 37, True),
    "cross": (8, 384, 1000, 64, 616, 0, True),  # tq != tk, a ring hop's shape
    "cross_non_causal": (8, 1000, 384, 128, 0, 0, False),
}


def f32_work(bh, t, d):
    """(flops, bytes) of the f32 fwd, dK/dV and dQ at [bh, t, d], causal;
    flops count each f32 product once (multiply and add)."""
    pairs = visible_pairs(t, t, 0, 0, True)
    e = 4
    return {
        "fwd": (4 * d * pairs * bh, (3 * e * t * d + e * t * d + 4 * t) * bh),
        "dkv": (8 * d * pairs * bh, (4 * e * t * d + 8 * t + 2 * e * t * d) * bh),
        "dq": (6 * d * pairs * bh, (4 * e * t * d + 8 * t + e * t * d) * bh),
    }


def phase_kernels_f32(torch, fa):
    """Each f32 kernel against its plain version over F32_CASES, then its
    times at [24, 2048, 64] (the main path's attention shape) and
    [24, 2048, 128] beside the plain version and f32
    scaled_dot_product_attention (forward; forward+backward beside the sum
    of the three kernels).  The bound is the f32-accurate one on this card:
    three TF32 tensor-core products a product (3 x flops / 495 TFLOP/s), or
    the bytes, whichever is longer; the FFMA bound (flops / 67 TFLOP/s), the
    least time of a design on the FP32 pipe, which none of the three runs,
    stands beside it as bound_ffma_ms.  Returns the kernel-table entries."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    failures = []
    for name, (bh, tq, tk, d, q_start, k_start, causal) in F32_CASES.items():
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        q, g, k, v = rnd(bh, tq, d), rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d)
        g_lse = rnd(bh, tq)
        kw = dict(scale=1.0 / math.sqrt(d), causal=causal)
        before = dict(fa.launches_f32)
        o, lse = fa.flash_fwd(q, k, v, q_start, k_start, **kw)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, q_start, k_start, **kw)
        corr = (g_lse - (o_ref * g).sum(-1)).contiguous()
        dk, dv = fa.flash_dkv(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
        dq = fa.flash_dq(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
        dq_ref = fa.flash_dq_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
        torch.cuda.synchronize()
        check({n: fa.launches_f32[n] - before[n] for n in before} == {"fwd": 1, "dkv": 1, "dq": 1},
              f"kernels_f32 {name}: the f32 kernels did not launch once each")
        row = {"phase": "kernel_case_f32", "case": name, "bh": bh, "tq": tq, "tk": tk, "d": d,
               "q_start": q_start, "k_start": k_start, "causal": causal}
        for kname, pairs in (("fwd", [("o", o, o_ref)]),
                             ("dkv", [("dk", dk, dk_ref), ("dv", dv, dv_ref)]),
                             ("dq", [("dq", dq, dq_ref)])):
            worst, worst_ratio = 0.0, 0.0
            for what, got, ref in pairs:
                check(torch.isfinite(got).all().item(), f"{name}: non-finite f32 {what}")
                check(ref.abs().max().item() > 0, f"{name}: f32 {what} reference is all zero")
                err, ratio = compare_f32(got, ref)
                if ratio > 1.0:
                    failures.append(f"{name} {what}: max error {err}, {ratio:.3g} x tolerance")
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            row[f"{kname}_max_abs_err"] = worst
            row[f"{kname}_tol_ratio"] = worst_ratio
            errs[kname] = max(errs[kname], worst)
        visible = lse_ref > -1e29
        check(bool((lse[~visible] < -1e29).all().item()), f"{name}: f32 lse lost its sentinel")
        lse_err = (lse - lse_ref)[visible].abs().max().item() if visible.any().item() else 0.0
        if lse_err > F32_LSE_ABS:
            failures.append(f"{name} lse: max error {lse_err} > {F32_LSE_ABS}")
        row["lse_max_abs_err"] = lse_err
        errs["fwd"] = max(errs["fwd"], lse_err)
        row["tolerance"] = TOLERANCE_F32
        emit(row)
    check(not failures, "f32 kernels vs plain: " + "; ".join(failures))

    counts_before = dict(fa.launches_f32)
    timing = {"phase": "kernel_times_f32", "causal": True}
    table = {}
    for d in (64, 128):
        bh, t = 24, 2048
        q, k, v, g = (torch.randn(bh, t, d, generator=gen, device="cuda") for _ in range(4))
        kw = dict(scale=1.0 / math.sqrt(d), causal=True)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        corr = (-(o * g).sum(-1)).contiguous()
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, **kw),
                 "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, corr, **kw),
                 "dq": lambda: fa.flash_dq(q, k, v, g, lse, corr, **kw)}
        plain = {"fwd": lambda: fa.flash_fwd_plain(q, k, v, **kw),
                 "dkv": lambda: fa.flash_dkv_plain(q, k, v, g, lse, corr, **kw),
                 "dq": lambda: fa.flash_dq_plain(q, k, v, g, lse, corr, **kw)}
        ms = {kname: cuda_ms(fn, iters=10) for kname, fn in calls.items()}
        plain_ms = {kname: cuda_ms(fn, iters=3, warmup=1) for kname, fn in plain.items()}
        q4, k4, v4 = (x.view(2, 12, t, d) for x in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
        g4 = g.view(2, 12, t, d)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(g4)

        sdpa_fb = cuda_ms(sdpa_fwd_bwd, iters=10)
        timing[f"d{d}"] = {"shape": [bh, t, d], "sdpa_fwd_ms": sdpa, "sdpa_fwd_bwd_ms": sdpa_fb,
                           "fwd_dkv_dq_ms": sum(ms.values())}
        for kname, (flops, nbytes) in f32_work(bh, t, d).items():
            t_ops = TF32_SPLIT * flops / PEAK_TF32_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            entry = {"ms": ms[kname], "plain_ms": plain_ms[kname],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "bound_pipe": "tensor cores, 3 TF32 products a product (3xTF32)",
                     "bound_ffma_ms": max(flops / PEAK_F32_FLOPS * 1e3, t_bytes),
                     "library_ms": sdpa if kname == "fwd" else None,
                     "tflops": flops / (ms[kname] * 1e-3) / 1e12}
            timing[f"d{d}"][kname] = entry
            if d == 64:
                table[kname] = {"max_abs_err": errs[kname],
                                **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "bound_pipe",
                                                         "bound_ffma_ms", "library_ms")}}
            else:
                table[kname].update({"ms_d128": entry["ms"], "bound_ms_d128": entry["bound_ms"],
                                     "bound_ffma_ms_d128": entry["bound_ffma_ms"],
                                     "library_ms_d128": entry["library_ms"]})
    fa.launches_f32.update(counts_before)  # timing launches are not the path's
    emit(timing)
    return table


def phase_f32(torch, fa):
    """The f32 path: a small f32 LlamaLM with flash attention (D = 64)
    against the same weights with dense f32 attention on the card (loss
    within 1e-5, each parameter's gradient within 1e-4 of its norm: both
    f32 throughout); then the example's small preset in f32 on 4 ranks
    at the main path's per-rank batch, 2 steps, with every launch count set
    to 0 just before and read just after.  Returns the f32 launch counts."""
    from bluefog_tpu_torch.examples import llama_pretrain
    from bluefog_tpu_torch.models.transformer import LlamaLM

    torch.backends.cuda.matmul.allow_tf32 = False

    def build(attention_fn):
        gen = torch.Generator().manual_seed(4)
        return LlamaLM(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, dff=256,
                       dtype=torch.float32, attention_fn=attention_fn, head_chunks=4,
                       device="cpu", generator=gen).cuda()

    models = {"flash": build(fa.make_flash_attention_fn()), "dense": build(None)}
    ids = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(5)).cuda()
    before = dict(fa.launches_f32)
    loss = {}
    for name, m in models.items():
        out = m(ids, labels=ids)
        out.backward()
        loss[name] = out.item()
    check(all(fa.launches_f32[k] > before[k] for k in before),
          f"f32: the f32 model did not launch every f32 kernel ({fa.launches_f32})")
    dense = dict(models["dense"].named_parameters())
    grad_err = max(((p.grad - dense[n].grad).norm() / dense[n].grad.norm()).item()
                   for n, p in models["flash"].named_parameters())
    row = {"phase": "f32_model", "loss_flash": loss["flash"], "loss_dense": loss["dense"],
           "loss_abs_err": abs(loss["flash"] - loss["dense"]), "grad_norm_rel_err": grad_err,
           "tolerance": "|loss - loss_dense| <= 1e-5; per parameter ||g - g_dense|| <= "
                        "1e-4 ||g_dense|| (both f32, sums in another order)"}
    emit(row)
    check(row["loss_abs_err"] <= 1e-5, f"f32: flash loss {loss['flash']} vs dense {loss['dense']}")
    check(grad_err <= 1e-4, f"f32: flash gradients {grad_err} from the dense f32 model's")

    fa.reset_launches()
    steps = 2
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "small", "--dtype", "f32", "--steps", str(steps), "--size", str(RANKS),
         "--batch", str(BATCH), "--device", "cuda"]))
    counts, bf16_counts = dict(fa.launches_f32), dict(fa.launches)
    losses = [x for step in out["losses"] for x in step]
    check(all(math.isfinite(x) for x in losses), f"f32: non-finite loss {losses}")
    want = out["layers"] * RANKS * steps
    for kname, n in counts.items():
        check(n == want, f"f32: {kname}_f32 launched {n} times, expected {want}")
    check(not any(bf16_counts.values()), f"f32: a bf16 kernel launched ({bf16_counts})")
    emit({"phase": "f32_path", **out, "launches_f32": counts})
    return counts


RESNET_BATCH, RESNET_STEPS = 32, 3


def _plan_mix(plan, a):
    """The plan's weighted mix of rank-major ``a``, in float64 on the host:
    out[d] = w_dd a[d] + sum over classes of w_c[d] a[src_c[d]]."""
    a = a.double().cpu()
    shape = (plan.size,) + (1,) * (a.dim() - 1)
    out = a * a.new_tensor(plan.self_weights).view(shape)
    for cls in plan.classes:
        out += a.new_tensor(cls.recv_weights).view(shape) * a[list(cls.sources())]
    return out


def phase_resnet(torch):
    """This slice's path at full width (ResNet-50, 224 x 224, 1000 classes,
    4 ranks, per-rank batch RESNET_BATCH) under both communications, with
    batch statistics; then LeNet-5 through examples/torch_mnist."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.benchmarks import resnet50 as rb
    from bluefog_tpu_torch.examples import torch_mnist
    from bluefog_tpu_torch.models import ResNet50

    bf.init(topology_util.ExponentialTwoGraph(RANKS), size=RANKS, device="cuda")
    try:
        plan = bf.context().plan
        model = ResNet50(num_classes=1000, device="cpu",
                         generator=torch.Generator().manual_seed(0)).cuda()
        x, y = rb.synthetic_batch(RANKS, RESNET_BATCH, 224, 1000, "cuda", seed=0)
        torch.cuda.reset_peak_memory_stats()
        row = {"phase": "resnet", "model": "ResNet50", "image": 224, "classes": 1000,
               "ranks": RANKS, "per_rank_batch": RESNET_BATCH,
               "reduced": "per-rank batch 128 -> 32 (the benchmark's 128 in "
                          "bluefog_tpu_torch.benchmarks.resnet50)"}
        for mode in ("neighbor_allreduce", "allreduce"):
            params, stats = rb.rank_major_state(model, RANKS)
            step_fn, opt = rb.make_step(model, params, stats, mode)
            leaf = "blocks.3.convs.1.weight"
            adapted = {}
            if mode == "neighbor_allreduce":  # ATC: after the local step, before the combine
                opt.register_step_post_hook(
                    lambda *_: adapted.__setitem__("w", params[leaf].detach().clone()))
            stat = "blocks.3.norms.1.mean"
            losses, step_ms = [], []
            for s in range(RESNET_STEPS):
                before = stats[stat].clone()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, acc = step_fn(x, y)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.tolist())
                check(torch.isfinite(loss).all().item(), f"resnet {mode}: non-finite loss {loss}")
                check(acc.shape == (RANKS,) and not torch.isnan(acc).any().item(),
                      f"resnet {mode}: accuracy {acc}")
                moved = [(stats[stat][r] != before[r]).any().item() for r in range(RANKS)]
                check(all(moved), f"resnet {mode} step {s}: running statistics of ranks "
                                  f"{[r for r, m in enumerate(moved) if not m]} did not move")
                # each rank's statistics come from its own batch: no two agree
                check(all(not torch.equal(stats[stat][r], stats[stat][0])
                          for r in range(1, RANKS)),
                      f"resnet {mode} step {s}: ranks share running statistics")
                if mode == "neighbor_allreduce":
                    want = _plan_mix(plan, adapted["w"])
                    err = (params[leaf].detach().double().cpu() - want).abs().max().item()
                    scale = want.abs().max().item()
                    check(err <= 1e-6 * scale, f"resnet gossip step {s}: {leaf} is {err} "
                                               f"from the plan's mix of the adapted values")
                else:
                    p = params[leaf].detach()
                    check(bool((p == p[:1]).all().item()), f"resnet allreduce step {s}: "
                                                           f"ranks' parameters differ")
            steady = step_ms[1:]
            row[mode] = {"losses": losses, "step_ms": step_ms,
                         "images_per_s": RANKS * RESNET_BATCH / (sum(steady) / len(steady) / 1e3)}
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        emit(row)
    finally:
        bf.shutdown()

    out = torch_mnist.run(torch_mnist._parser().parse_args(
        ["--epochs", "2", "--train-size", "1024", "--device", "cuda"]))
    first, last = out["epochs"][0]["train_loss"], out["epochs"][-1]["train_loss"]
    emit({"phase": "lenet", **out})
    check(math.isfinite(last) and last < first, f"lenet: train loss {first} -> {last}")


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
# reps 1 runs the body on the staged operands, 2 the fed-back row, 3 a fed
# operand rewritten over one that was rewritten before (qk and pv rewrite
# their shared-memory copy every repetition) and, for every component, a
# row published into the ping-pong buffer that reps 1 used
COMPONENT_REPS = {"qk": (1, 2, 3), "pv": (1, 2, 3), "softmax_chain": (1, 2, 3),
                  "bwd_chain": (1, 2, 3)}


def phase_components(torch, ac, roof):
    """Each microkernel instance against its plain version on the card, on
    the same inputs, at COMPONENT_REPS, with the body and with the
    dependency pass alone.  The rule is attention_components.compare
    (stated there): every element within 1e-5 (|ref| + rms(ref)), beyond it
    only a one-step bf16 rounding flip, bounded through the product.  Every
    slice (each tile of every block) must hold the same tile.  Returns the
    worst absolute error per microkernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = {d: roof.component_inputs(d, seed=2) for d in (64, 128)}
    worst = {name: 0.0 for name in ac.PLAIN}
    failures = []
    for name, d, kw in ac.INSTANCES:
        args = inputs[d][name]
        for body in (True, False):
            for reps in COMPONENT_REPS[name]:
                got = roof.WRAPPERS[name](*args, reps, body=body, blocks=COMPONENT_BLOCKS, **kw)
                ref = ac.PLAIN[name](*args, reps, body=body, blocks=COMPONENT_BLOCKS, **kw)
                torch.cuda.synchronize()
                what = f"{name} d={d} {kw} body={body} reps={reps}"
                slices = COMPONENT_BLOCKS * ac.TILES_PER_BLOCK[name]
                check(got.shape[0] == slices, f"components: {got.shape[0]} slices, {what}")
                check(torch.isfinite(got).all().item(), f"components: non-finite {what}")
                check(bool((got == got[:1]).all().item()), f"components: slices differ, {what}")
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
        for key in ("pred_overlap_ms", "pred_serial_ms", "measured_ms", "unexplained_pct",
                    "pred_overlap_nodep_ms", "pred_serial_nodep_ms", "pred_sched_nodep_ms",
                    "longest_block_nodep_ms", "unexplained_nodep_pct"):
            check(math.isfinite(row[f"{kname}_{key}"]), f"roofline: {kname}_{key} not finite")
        for cname, c in row["components"][kname].items():
            # a hoisted loop body would make later repetitions cheaper
            check(0.5 <= c["linearity"] <= 2.0,
                  f"roofline: {kname} {cname} time not linear in reps ({c['linearity']})")
            check(c["tiles_per_block"] == ac.TILES_PER_BLOCK[cname]
                  and c["component_tile"] == roof.COMPONENT_TILE[cname],
                  f"roofline: {kname} {cname} tiles a block or tile name ({c})")
    check(sorted(row["component_tile"]) == sorted(ac.PLAIN),
          f"roofline: component_tile {row['component_tile']}")
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
    version on the same inputs and the same number of blocks.  The bound
    counts every tile computed: blocks x TILES_PER_BLOCK x LINE_REPS."""
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
        tiles = blocks * ac.TILES_PER_BLOCK[name]
        tile_us, pipe = roof.tile_bound(name, 64, **kw)
        t_ops = tile_us * 1e-3 * tiles * LINE_REPS
        in_bytes = sum(x.numel() * x.element_size() for x in args)
        out_bytes = 4 * tiles * 64 * 64
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "bound_pipe": pipe,
                       "library_ms": None, "library_note": LIBRARY_NONE,
                       "config": {"blocks": blocks, "tiles": tiles, "reps": LINE_REPS,
                                  "smem": smem, **kw}}
    emit({"phase": "component_times", **timed})
    return timed


# ---------------------------------------------------------------------------
# The window slice: one-sided windows, the BERT push-sum round, the exact
# algorithms.  None of it runs a kernel of the repo (the window ops are
# gathers and weighted sums in PyTorch, BERT's attention is the reference's
# dense product), so it adds no row to the kernel table.
# ---------------------------------------------------------------------------

WIN_ELEMS = 1 << 22  # elements a rank in each window
WIN_ITERS = 5


def _win_tol(torch, dtype, terms, scale):
    """|err| allowed against the float64 dense reference: ``terms`` products
    and sums, each rounded once in the window dtype (f32, or bf16 where the
    window's weight dtype is bf16): terms x eps(dtype) x the largest input."""
    return terms * torch.finfo(dtype).eps * scale


def phase_windows(torch):
    """Every window op on 4 ranks x WIN_ELEMS elements, f32 and bf16, over
    ExponentialTwoGraph(4) and RingGraph(4, connect_style=1), associated p
    on, each held against a plain dense reference written here (mixing
    matrix x rank rows in float64), with versions and p; the ms of each op
    between CUDA events (mean of WIN_ITERS calls, after one warm-up)."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology_util as tu

    results = []
    for topo_name, make in (("exp2", lambda: tu.ExponentialTwoGraph(RANKS)),
                            ("ring_directed", lambda: tu.RingGraph(RANKS, connect_style=1))):
        for dtype in (torch.float32, torch.bfloat16):
            bf.init(make(), size=RANKS, device="cuda")
            try:
                results.append(_window_case(torch, bf, topo_name, dtype))
            finally:
                bf.shutdown()
    return results


def _window_case(torch, bf, topo_name, dtype):
    n = RANKS
    plan = bf.context().plan
    in_nb, out_nb = plan.in_neighbors, plan.out_neighbors
    maxd = max(plan.max_in_degree, 1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, WIN_ELEMS, generator=gen, device="cuda").to(dtype)
    x2 = torch.randn(n, WIN_ELEMS, generator=gen, device="cuda").to(dtype)
    xd, x2d = x.double(), x2.double()
    scale = max(xd.abs().max().item(), x2d.abs().max().item())
    ctx = bf.context()
    bf.turn_on_win_ops_with_associated_p()
    row = {"phase": "windows", "topology": topo_name, "dtype": str(dtype).replace("torch.", ""),
           "ranks": n, "elements_a_rank": WIN_ELEMS, "max_in_degree": maxd, "ops": {}}

    def record(op, got, want, terms, fn):
        err = (got.double() - want).abs().max().item()
        tol = _win_tol(torch, dtype, terms, scale * 2)
        check(err <= tol, f"windows {topo_name} {dtype} {op}: |err| {err} > {tol}")
        row["ops"][op] = {"max_abs_err": err, "tol": tol,
                          "ms": cuda_ms(fn, iters=WIN_ITERS, warmup=1)}

    def versions(name):
        return ctx.windows[name].versions.cpu().tolist()

    def mail(name):
        return ctx.windows[name].mail

    uniform = torch.zeros(n, n, dtype=torch.float64, device="cuda")
    for d in range(n):
        for s in (d,) + tuple(in_nb[d]):
            uniform[d, s] = 1.0 / (len(in_nb[d]) + 1)

    def mix(W, a):
        return W @ a

    def slots(name):  # every in-neighbor slot, rank by rank
        return torch.stack([mail(name)[d, k] for d in range(n) for k in range(len(in_nb[d]))])

    def slot_ref(weight):  # what each slot must hold: weight x the source's row
        return torch.stack([weight * xd[s] for d in range(n) for s in in_nb[d]])

    # win_put (default weights), then the default win_update
    bf.win_create(x, "put")
    bf.win_put(x, "put")
    check(all(v[:len(in_nb[d])] == [1] * len(in_nb[d]) for d, v in enumerate(versions("put"))),
          f"windows {topo_name}: put versions {versions('put')}")
    record("win_put", slots("put"), slot_ref(1.0), 0, lambda: bf.win_put(x, "put"))
    out = bf.win_update("put")
    p = bf.win_associated_p("put")
    check(torch.allclose(p, torch.ones_like(p)), f"windows {topo_name}: p after put+update {p}")
    record("win_update", out, mix(uniform, xd), maxd + 2, lambda: bf.win_update("put"))

    # selective win_put: rank 0 puts to its first out-neighbor only, weight 2
    o = out_nb[0][0]
    bf.win_create(x, "sel", zero_init=True)
    dst = [{o: 2.0}] + [{} for _ in range(n - 1)]
    bf.win_put(x, "sel", dst_weights=dst)
    slot = in_nb[o].index(0)
    ver = versions("sel")
    check(all(ver[d][k] == (1 if (d, k) == (o, slot) else 0) for d in range(n)
              for k in range(len(in_nb[d]))), f"windows {topo_name}: selective versions {ver}")
    others = [mail("sel")[d, k] for d in range(n) for k in range(len(in_nb[d]))
              if (d, k) != (o, slot)]
    check(all(not t.any().item() for t in others), f"windows {topo_name}: selective put "
                                                   f"touched another slot")
    record("win_put_selective", mail("sel")[o, slot], 2.0 * xd[0], 1,
           lambda: bf.win_put(x, "sel", dst_weights=dst))

    # win_accumulate 0.5 to every out-neighbor, then win_update(self 0.5,
    # neighbors 1.0, reset): the push-sum round; p = 0.5 + 0.5 in-degree
    bf.win_create(x, "acc", zero_init=True)
    half = [{t: 0.5 for t in out_nb[r]} for r in range(n)]
    ones = [{s: 1.0 for s in in_nb[d]} for d in range(n)]
    bf.win_accumulate(x, "acc", dst_weights=half)
    acc_ref = torch.zeros_like(xd)
    for d in range(n):
        for s in in_nb[d]:
            acc_ref[d] += 0.5 * xd[s]
    got_acc = mail("acc").double().sum(dim=1)
    check(versions("acc") == [[1] * len(in_nb[d]) + [0] * (maxd - len(in_nb[d]))
                              for d in range(n)], f"windows {topo_name}: accumulate versions")
    out = bf.win_update("acc", self_weight=0.5, neighbor_weights=ones, reset=True)
    p = bf.win_associated_p("acc").double()
    want_p = torch.tensor([0.5 + 0.5 * len(in_nb[d]) for d in range(n)], dtype=torch.float64,
                          device="cuda")
    check(torch.allclose(p, want_p), f"windows {topo_name}: p {p.tolist()} != {want_p.tolist()}")
    if topo_name == "ring_directed":  # column-stochastic: push-sum keeps the mass
        check(abs(p.sum().item() - n) < 1e-6, f"windows: sum p = {p.sum().item()} != {n}")
    check(not mail("acc").any().item(), f"windows {topo_name}: reset left mail")
    record("win_accumulate", got_acc, acc_ref, maxd + 1,
           lambda: bf.win_accumulate(x, "acc", dst_weights=half))
    bf.win_update("acc", reset=True)
    bf.win_accumulate(x, "acc", dst_weights=half)
    upd_ref = 0.5 * xd + acc_ref
    out = bf.win_update("acc", self_weight=0.5, neighbor_weights=ones, reset=True)
    record("win_update_explicit_reset", out, upd_ref, maxd + 3,
           lambda: bf.win_update("acc", self_weight=0.5, neighbor_weights=ones, reset=True))
    row["p_after_push_sum"] = p.tolist()

    # win_get with receiver weights 0.25
    bf.win_create(x, "get", zero_init=True)
    quarter = [{s: 0.25 for s in in_nb[d]} for d in range(n)]
    bf.win_get("get", src_weights=quarter)
    record("win_get", slots("get"), slot_ref(0.25), 1,
           lambda: bf.win_get("get", src_weights=quarter))

    # win_put_update (default weights) on a window created from x
    bf.win_create(x, "pu")
    got = bf.win_put_update(x2, "pu")
    check(versions("pu") == [[1] * len(in_nb[d]) + [0] * (maxd - len(in_nb[d]))
                             for d in range(n)], f"windows {topo_name}: put_update versions")
    record("win_put_update", got, mix(uniform, x2d), maxd + 2,
           lambda: bf.win_put_update(x2, "pu"))

    # a fused (dict) window: two leaves of one packed window
    h = WIN_ELEMS // 2
    tree = {"a": x[:, :h].reshape(n, 1024, -1), "b": x[:, h:]}
    bf.win_create(tree, "fused")
    bf.win_put(tree, "fused")
    out = bf.win_update("fused")
    check(sorted(out) == ["a", "b"] and out["a"].shape == tree["a"].shape,
          f"windows {topo_name}: fused structure {({k: v.shape for k, v in out.items()})}")
    got = torch.cat([out["a"].reshape(n, -1), out["b"]], dim=1)

    def fused_round():
        bf.win_put(tree, "fused")
        bf.win_update("fused")

    record("fused_put_update", got, mix(uniform, xd), maxd + 2, fused_round)
    bf.win_free()
    emit(row)
    return row


def phase_bert_pushsum(torch, rounds=4):
    """BERT-base (the benchmark's "base" preset), 4 ranks x batch 32 x seq
    128, through bluefog_tpu_torch.benchmarks.bert_pushsum.build_flows:
    ``rounds`` eager rounds and ``rounds`` device-flow rounds from the same
    state; equal parameters (Adam's first steps move a weight by at most
    ~1.004 lr, so two runs whose gradients differ in rounding end within
    2 x 1.004 x lr x rounds), finite losses, sum p = 4 after every update.
    Round ms by the host clock around a synchronized round; tokens/s from
    the rounds after the first."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.benchmarks import bert_pushsum as bp

    cfg = bp.PRESETS["base"]
    bf.init(size=RANKS, device="cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        (params, opt), eager_step, device_rounds, meta = bp.build_flows(cfg, RANKS, seed=0)
        dstate = meta["device_init"](params, opt)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, out

        eager_ms, losses, device_ms, dlosses = [], [], [], []
        for _ in range(rounds):
            ms, (params, opt, loss) = timed(lambda: eager_step(params, opt))
            eager_ms.append(ms)
            losses.append(loss.tolist())
        for _ in range(rounds):
            ms, (dstate, loss) = timed(lambda: device_rounds(dstate, 1))
            device_ms.append(ms)
            dlosses.append(loss.tolist())
        peak = torch.cuda.max_memory_allocated()
        err = max((params[k].detach() - dstate["params"][k].detach()).abs().max().item()
                  for k in params)
        tol = 2 * 1.004 * bp.LR * rounds
        p_mass = torch.stack(meta["p_mass"]).tolist()
        tokens = RANKS * meta["B"] * meta["T"]
        steady = sum(eager_ms[1:]) / (rounds - 1)
        steady_dev = sum(device_ms[1:]) / (rounds - 1)
        row = {"phase": "bert_pushsum", "preset": "base", "ranks": RANKS,
               "per_rank_batch": meta["B"], "seq": meta["T"], "n_params": meta["n_params"],
               "rounds": rounds, "eager_round_ms": eager_ms, "device_round_ms": device_ms,
               "tokens_per_s": tokens / (steady / 1e3),
               "device_flow_tokens_per_s": tokens / (steady_dev / 1e3),
               "peak_gb": peak / 1e9, "losses": losses, "device_flow_losses": dlosses,
               "eager_vs_device_max_abs_err": err, "tol": tol, "p_mass": p_mass}
        emit(row)
        flat = [x for r in losses + dlosses for x in r]
        check(all(math.isfinite(x) for x in flat), f"bert_pushsum: non-finite loss {flat}")
        check(len(p_mass) == 2 * rounds and all(abs(m - RANKS) < 1e-5 for m in p_mass),
              f"bert_pushsum: sum p after update {p_mass}, expected {RANKS}")
        check(err <= tol, f"bert_pushsum: eager and device flows {err} apart (tol {tol})")
        check(100e6 < meta["n_params"] < 120e6, f"bert_pushsum: {meta['n_params']} parameters")
        return row
    finally:
        bf.shutdown()


# ---------------------------------------------------------------------------
# Slice 11: the rest of the eager API and the machine hierarchy.  Like the
# window slice, it runs no kernel of the repo (gathers, indexed writes and
# weighted sums in PyTorch), so it adds no row to the kernel table.
# ---------------------------------------------------------------------------

EAGER_RANKS, EAGER_LOCAL = 8, 2


def phase_eager_api(torch):
    """The eager API on 8 ranks = 4 machines x 2, WIN_ELEMS elements a rank,
    f32 and bf16: allgather, neighbor_allgather on ExponentialTwoGraph(8)
    and StarGraph(8), the dynamic neighbor_allreduce (src, dst, both),
    hierarchical_neighbor_allreduce on ExponentialTwoGraph(4),
    pairwise_gossip, each _nonblocking form through synchronize, and
    barrier.  Gathers must be exact; the weighted ops are held against a
    float64 reference on the card within _win_tol; a nonblocking form must
    equal its blocking op.  ms a call between CUDA events (mean of
    WIN_ITERS calls after one warm-up)."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import ops, topology_util as tu

    n, loc = EAGER_RANKS, EAGER_LOCAL
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        bf.init(tu.ExponentialTwoGraph(n), size=n, local_size=loc, device="cuda")
        try:
            rows.append(_eager_case(torch, bf, ops, tu, dtype))
        finally:
            bf.shutdown()
    return rows


def _eager_case(torch, bf, ops, tu, dtype):
    n, loc = EAGER_RANKS, EAGER_LOCAL
    m = n // loc
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(n, WIN_ELEMS, generator=gen, device="cuda").to(dtype)
    xd = x.double()
    scale = xd.abs().max().item()
    name = str(dtype).replace("torch.", "")
    row = {"phase": "eager_api", "dtype": name, "ranks": n, "machines": m,
           "local_size": loc, "elements_a_rank": WIN_ELEMS, "ops": {}}

    def record(op, got, want, terms, fn):
        """``terms`` roundings allowed (_win_tol); 0 for a gather, which
        moves values and must match exactly (``want`` then in x's dtype)."""
        check(got.dtype == x.dtype, f"eager_api {name} {op}: dtype {got.dtype}")
        if terms == 0:
            err, tol = (0.0 if torch.equal(got, want) else math.inf), 0.0
        else:
            err = (got.double() - want).abs().max().item()
            tol = _win_tol(torch, dtype, terms, scale * 2)
        check(err <= tol, f"eager_api {name} {op}: |err| {err} > {tol}")
        row["ops"][op] = {"max_abs_err": err, "tol": tol,
                          "ms": cuda_ms(fn, iters=WIN_ITERS, warmup=1)}

    def dense(W):  # rows of W mix the rank rows of x, in float64
        return torch.tensor(W, dtype=torch.float64, device="cuda") @ xd

    # allgather: every rank holds all ranks' rows, in order
    got = bf.allgather(x)
    check(got.shape == (n, n * WIN_ELEMS), f"eager_api allgather shape {tuple(got.shape)}")
    record("allgather", got, x.reshape(1, -1).expand(n, -1), 0, lambda: bf.allgather(x))
    del got

    # neighbor_allgather: regular (concatenated) and StarGraph (padded)
    for topo_name, topo in (("exp2", tu.ExponentialTwoGraph(n)), ("star", tu.StarGraph(n))):
        bf.set_topology(topo)
        plan = bf.context().plan
        got = bf.neighbor_allgather(x)
        maxd = plan.max_in_degree
        want = torch.zeros((n, maxd, WIN_ELEMS), dtype=dtype, device="cuda")
        for d in range(n):
            for k, s in enumerate(plan.in_neighbors[d]):
                want[d, k] = x[s]
        if plan.is_regular:
            want = want.reshape(n, maxd * WIN_ELEMS)
        check(got.shape == want.shape, f"eager_api neighbor_allgather {topo_name} shape")
        record(f"neighbor_allgather_{topo_name}", got, want, 0, lambda: bf.neighbor_allgather(x))
        del got, want
    bf.set_topology(tu.ExponentialTwoGraph(n))

    # the dynamic neighbor_allreduce: src, dst and both
    src = [{(r - 1) % n: 0.25, (r + 2) % n: 0.25} for r in range(n)]
    dst = [{(s + 1) % n: 0.5} for s in range(n)]
    both_dst = [{(s + 1) % n: 2.0, (s - 2) % n: 1.0} for s in range(n)]
    W_src = [[0.0] * n for _ in range(n)]
    W_dst = [[0.0] * n for _ in range(n)]
    W_both = [[0.0] * n for _ in range(n)]
    for d in range(n):
        W_src[d][d], W_src[d][(d - 1) % n], W_src[d][(d + 2) % n] = 0.5, 0.25, 0.25
        W_dst[d][d], W_dst[d][(d - 1) % n] = 0.5, 0.5
        W_both[d][d], W_both[d][(d - 1) % n], W_both[d][(d + 2) % n] = 0.25, 0.5, 0.25
    record("neighbor_allreduce_src", bf.neighbor_allreduce(x, src_weights=src), dense(W_src),
           6, lambda: bf.neighbor_allreduce(x, src_weights=src))
    record("neighbor_allreduce_dst", bf.neighbor_allreduce(x, 0.5, dst_weights=dst),
           dense(W_dst), 4, lambda: bf.neighbor_allreduce(x, 0.5, dst_weights=dst))
    record("neighbor_allreduce_src_dst",
           bf.neighbor_allreduce(x, 0.25, src_weights=src, dst_weights=both_dst), dense(W_both),
           6, lambda: bf.neighbor_allreduce(x, 0.25, src_weights=src, dst_weights=both_dst))

    # hierarchical: local means, the machine plan's mix, repeated per machine
    mplan = bf.context().machine_plan
    local = xd.reshape(m, loc, -1).mean(1)
    want = _plan_mix(mplan, local).to("cuda").repeat_interleave(loc, dim=0)
    got = bf.hierarchical_neighbor_allreduce(x)
    check(all(torch.equal(got[loc * k], got[loc * k + j]) for k in range(m)
              for j in range(1, loc)), f"eager_api {name}: a machine's ranks differ")
    record("hierarchical_neighbor_allreduce", got, want, 2 * (mplan.max_in_degree + 1) + loc + 1,
           lambda: bf.hierarchical_neighbor_allreduce(x))
    del got, want, local

    # pairwise_gossip: ranks 2k and 2k + 1 swap and average
    pairs = [(r, r ^ 1) for r in range(n)]
    want = 0.5 * xd + 0.5 * xd[[r ^ 1 for r in range(n)]]
    record("pairwise_gossip", ops.pairwise_gossip(x, pairs), want, 3,
           lambda: ops.pairwise_gossip(x, pairs))

    # the nonblocking forms equal their blocking ops
    for op, args in (("allreduce", (False,)), ("broadcast", (3,)), ("allgather", ()),
                     ("neighbor_allgather", ()), ("neighbor_allreduce", (0.5, src)),
                     ("hierarchical_neighbor_allreduce", ())):
        nb = getattr(bf, f"{op}_nonblocking")
        h = nb(x, *args)
        got = bf.synchronize(h)
        check(h.poll() and torch.equal(got, getattr(bf, op)(x, *args)),
              f"eager_api {name}: {op}_nonblocking differs from {op}")
        row["ops"][f"{op}_nonblocking"] = {
            "ms": cuda_ms(lambda: bf.synchronize(nb(x, *args)), iters=WIN_ITERS, warmup=1)}
        del got
    bf.barrier()
    row["ops"]["barrier"] = {"ms": cuda_ms(bf.barrier, iters=WIN_ITERS, warmup=1)}
    emit(row)
    return row


HIER_BATCH = 16  # per rank: 8 x 16 = the resnet phase's 4 x 32 images a step


def phase_hierarchical(torch):
    """BASELINE config #4 on the card: ResNet-50 (224 x 224, 1000 classes),
    8 ranks = 4 machines x 2, per-rank batch HIER_BATCH, machine topology
    ExponentialTwoGraph(4), ATC momentum SGD with
    hierarchical_neighbor_allreduce and per-rank batch statistics,
    RESNET_STEPS steps.  After each: finite losses, every rank's running
    statistics moved and differ, the two ranks of each machine hold
    bit-equal parameters, and a leaf equals the machine plan's mix of the
    local means of the adapted values (float64 on the host) within 1e-6 of
    its scale.  Then one call with steps_per_call=2."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.benchmarks import resnet50 as rb
    from bluefog_tpu_torch.models import ResNet50
    from bluefog_tpu_torch.training import make_classifier_apply_fn, make_decentralized_train_step

    n, loc = EAGER_RANKS, EAGER_LOCAL
    m = n // loc
    bf.init(topology_util.ExponentialTwoGraph(n), size=n, local_size=loc, device="cuda")
    try:
        mplan = bf.context().machine_plan
        check(mplan.size == m and topology_util.IsTopologyEquivalent(
            bf.load_machine_topology(), topology_util.ExponentialTwoGraph(m)),
            "hierarchical: machine topology is not ExponentialTwoGraph(4)")
        model = ResNet50(num_classes=1000, device="cpu",
                         generator=torch.Generator().manual_seed(0)).cuda()
        x, y = rb.synthetic_batch(n, HIER_BATCH, 224, 1000, "cuda", seed=0)
        torch.cuda.reset_peak_memory_stats()
        params, stats = rb.rank_major_state(model, n)
        step_fn, opt = rb.make_step(model, params, stats, "hierarchical_neighbor_allreduce")
        leaf, stat = "blocks.3.convs.1.weight", "blocks.3.norms.1.mean"
        adapted = {}
        opt.register_step_post_hook(
            lambda *_: adapted.__setitem__("w", params[leaf].detach().clone()))
        losses, step_ms, mix_err = [], [], []
        for s in range(RESNET_STEPS):
            before = stats[stat].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, acc = step_fn(x, y)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.tolist())
            check(torch.isfinite(loss).all().item(), f"hierarchical: non-finite loss {loss}")
            moved = [(stats[stat][r] != before[r]).any().item() for r in range(n)]
            check(all(moved), f"hierarchical step {s}: running statistics of ranks "
                              f"{[r for r, mv in enumerate(moved) if not mv]} did not move")
            check(all(not torch.equal(stats[stat][r], stats[stat][0]) for r in range(1, n)),
                  f"hierarchical step {s}: ranks share running statistics")
            for k, p in params.items():
                p = p.detach()
                check(all(torch.equal(p[loc * j], p[loc * j + i]) for j in range(m)
                          for i in range(1, loc)),
                      f"hierarchical step {s}: the ranks of a machine differ on {k}")
            a = adapted["w"].double().cpu()
            local = a.reshape((m, loc) + a.shape[1:]).mean(1)
            want = _plan_mix(mplan, local).repeat_interleave(loc, dim=0)
            err = (params[leaf].detach().double().cpu() - want).abs().max().item()
            scale = want.abs().max().item()
            mix_err.append(err / scale)
            check(err <= 1e-6 * scale, f"hierarchical step {s}: {leaf} is {err} from the "
                                       f"machine plan's mix of the local means")
        steady = step_ms[1:]
        row = {"phase": "hierarchical", "model": "ResNet50", "image": 224, "classes": 1000,
               "ranks": n, "machines": m, "local_size": loc, "per_rank_batch": HIER_BATCH,
               "machine_topology": f"ExponentialTwoGraph({m})", "losses": losses,
               "step_ms": step_ms, "mix_err_over_scale": mix_err,
               "images_per_s": n * HIER_BATCH / (sum(steady) / len(steady) / 1e3),
               "reduced": "per-rank batch 64 -> 16 (8 x 16 = the resnet phase's 4 x 32)"}
        # steps_per_call=2 on a fresh state
        params, stats = rb.rank_major_state(model, n)
        step2 = make_decentralized_train_step(
            make_classifier_apply_fn(model), params,
            torch.optim.SGD(list(params.values()), lr=0.1, momentum=0.9),
            communication_type=bf.CommunicationType.hierarchical_neighbor_allreduce,
            machine_plan=mplan, batch_stats=stats, steps_per_call=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss2, _ = step2(torch.stack([x, x]), torch.stack([y, y]))
        torch.cuda.synchronize()
        row["steps_per_call_2"] = {"losses": loss2.tolist(),
                                   "call_ms": (time.perf_counter() - t0) * 1e3}
        check(torch.isfinite(loss2).all().item(), f"hierarchical: steps_per_call=2 loss {loss2}")
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        emit(row)
        return row
    finally:
        bf.shutdown()


# ---------------------------------------------------------------------------
# The transformer options at full size.  llama_1b runs the bf16
# flash kernels at D = 128 (the forward twice a layer under remat); vit runs
# no kernel of the repo (dense attention, as the reference's ViT).
# ---------------------------------------------------------------------------

L1B_BATCH, L1B_KV_HEADS = 2, 2
L1B_LEAF = "layers.k"  # the stacked k projections, [ranks, 24, 256, 1792] f32


def _check_mix(torch, plan, adapted, now, what):
    """``now`` (rank-major, after the combine) equals the plan's mix of
    ``adapted`` (after the local step) within 1e-6 of its scale, in float64
    on the host; returns error / scale."""
    want = _plan_mix(plan, adapted)
    err = (now.detach().double().cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-6 * scale, f"{what}: {err} from the plan's mix of the adapted values "
                               f"(scale {scale})")
    return err / scale


def phase_llama_1b(torch, fa):
    """The 1b preset of benchmarks/llama.py with GQA: hidden 1792, 24
    layers, 14 heads on 2 kv heads (D = 128), dff 4864, vocab 32000, S =
    2048, remat, scan_layers, sgdm_bf16, head_chunks 8, on RANKS ranks
    under ATC gossip on ExponentialTwoGraph(4), per-rank batch L1B_BATCH,
    STEPS steps, through examples/llama_pretrain, with every launch count
    set to 0 just before and read just after.  Under remat the backward
    recomputes each block's forward, flash forward included: the forward
    kernel launches 2 x layers x ranks x steps times, dK/dV and dQ layers x
    ranks x steps, and no f32 kernel.  After every step a stacked leaf must
    equal the plan's mix of its values after the local step."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.examples import llama_pretrain

    # (after the local step, after the combine) copies of the leaf on the
    # card, held against the plan's mix after the run, outside the timed steps
    seen = {"pairs": []}

    def setup(params, opt):
        seen["plan"], seen["params"], seen["opt"] = bf.context().plan, params, opt

        def before_local_step(*_):  # the previous step's combine is done
            if "adapted" in seen:
                seen["pairs"].append((seen.pop("adapted"), params[L1B_LEAF].detach().clone()))

        opt.register_step_pre_hook(before_local_step)
        opt.register_step_post_hook(
            lambda *_: seen.__setitem__("adapted", params[L1B_LEAF].detach().clone()))

    gc.collect()  # earlier phases' tensors held in reference cycles
    torch.cuda.empty_cache()
    fa.reset_launches()
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "1b", "--kv-heads", str(L1B_KV_HEADS), "--steps", str(STEPS),
         "--size", str(RANKS), "--batch", str(L1B_BATCH), "--device", "cuda"]), setup=setup)
    counts, f32_counts = dict(fa.launches), dict(fa.launches_f32)
    seen["pairs"].append((seen.pop("adapted"), seen["params"][L1B_LEAF].detach()))
    mix_err = [_check_mix(torch, seen["plan"], adapted, now, f"llama_1b step {s}")
               for s, (adapted, now) in enumerate(seen.pop("pairs"))]
    traces = {str(st["trace"].dtype) for st in seen.pop("opt").state.values()}
    losses = [x for step in out["losses"] for x in step]
    layers = out["layers"]
    want = {"fwd": 2 * layers * RANKS * STEPS, "dkv": layers * RANKS * STEPS,
            "dq": layers * RANKS * STEPS}
    row = {"phase": "llama_1b", **out, "launches": counts, "launches_expected": want,
           "mix_err_over_scale": mix_err, "trace_dtypes": sorted(traces),
           "peak_gb": out.get("max_memory_allocated", 0) / 1e9,
           "reduced": f"per-rank batch 8 -> {L1B_BATCH} (benchmarks/llama.py's 1b preset); "
                      "widths, depth, sequence, remat, scan_layers, sgdm_bf16 and "
                      "head_chunks as published"}
    emit(row)
    check((out["hidden"], out["layers"], out["heads"], out["kv_heads"], out["seq"]) ==
          (1792, 24, 14, L1B_KV_HEADS, 2048), f"llama_1b: widths {out}")
    check(out["remat"] and out["scan_layers"] and out["optimizer"] == "sgdm_bf16"
          and out["head_chunks"] == 8 and out["leaves"] == 12, f"llama_1b: options {out}")
    check(traces == {"torch.bfloat16"}, f"llama_1b: momentum traces in {traces}")
    check(all(math.isfinite(x) for x in losses), f"llama_1b: non-finite loss {losses}")
    check(math.isfinite(out["consensus_spread"]), "llama_1b: non-finite consensus spread")
    check(len(mix_err) == STEPS, f"llama_1b: mix checked {len(mix_err)} times")
    for kname, n in counts.items():
        check(n == want[kname], f"llama_1b: {kname} launched {n} times, expected {want[kname]}")
    check(not any(f32_counts.values()), f"llama_1b: an f32 kernel launched ({f32_counts})")
    return counts


VIT_BATCH = 32


def phase_vit(torch, fa):
    """ViT-B/16 (86M parameters) at 224 x 224 and 1000 classes, bf16, on
    RANKS ranks x VIT_BATCH images, ATC SGD (lr 0.05, as the reference's
    ViT test) on ExponentialTwoGraph(4) through
    make_decentralized_train_step, STEPS steps: finite losses, and after
    every step a leaf equal to the plan's mix of its adapted values.  No
    kernel of the repo is on this path: every launch count stays 0.  One
    more step is traced for its device time by kernel and idle share."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.models import ViT_B16
    from bluefog_tpu_torch.profiling import device_profile
    from bluefog_tpu_torch.training import (
        make_classifier_apply_fn,
        make_decentralized_train_step,
        replicate_for_mesh,
    )

    bf.init(topology_util.ExponentialTwoGraph(RANKS), size=RANKS, device="cuda")
    try:
        plan = bf.context().plan
        model = ViT_B16(num_classes=1000, device="cpu",
                        generator=torch.Generator().manual_seed(0)).cuda()
        params = replicate_for_mesh(dict(model.named_parameters()), RANKS)
        n_params = sum(v[0].numel() for v in params.values())
        opt = torch.optim.SGD(list(params.values()), lr=0.05)
        step = make_decentralized_train_step(
            make_classifier_apply_fn(model), params, opt,
            communication_type=bf.CommunicationType.neighbor_allreduce, plan=plan)
        leaf, adapted = "layers.11.fc1.weight", {}
        opt.register_step_post_hook(
            lambda *_: adapted.__setitem__("w", params[leaf].detach().clone()))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(RANKS, VIT_BATCH, 224, 224, 3, generator=gen, device="cuda")
        y = torch.randint(0, 1000, (RANKS, VIT_BATCH), generator=gen, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, step_ms, mix_err = [], [], []
        for s in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, acc = step(x, y)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.tolist())
            check(torch.isfinite(loss).all().item(), f"vit step {s}: non-finite loss {loss}")
            mix_err.append(_check_mix(torch, plan, adapted.pop("w"), params[leaf],
                                      f"vit step {s}: {leaf}"))
        counts = {**fa.launches, **{f"{k}_f32": n for k, n in fa.launches_f32.items()}}
        # one more step, traced (device activity only): where its time goes
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
        traced = device_profile(prof, (time.perf_counter() - t0) * 1e3, top=12)
        steady = step_ms[1:]
        row = {"phase": "vit", "model": "ViT_B16", "n_params": n_params, "image": 224,
               "classes": 1000, "ranks": RANKS, "per_rank_batch": VIT_BATCH,
               "dtype": "bf16", "losses": losses, "step_ms": step_ms,
               "images_per_s": RANKS * VIT_BATCH / (sum(steady) / len(steady) / 1e3),
               "mix_err_over_scale": mix_err,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
               "kernels_on_path": "none (dense attention, as the reference's ViT)",
               "profile": traced}
        emit(row)
        check(n_params == 86_567_656, f"vit: {n_params} parameters, ViT-B/16 has 86,567,656")
        check(not any(counts.values()), f"vit: a kernel of the repo launched ({counts})")
        return row
    finally:
        bf.shutdown()


ALG_SIZE, ALG_DIM, ALG_LR, ALG_ITERS = 8, 6, 0.05, 600


def _quadratics(np, rng):
    """The reference test's heterogeneous quadratics
    (tests/test_algorithms.py: f_r(w) = 0.5 (w - c_r)^T A_r (w - c_r) with
    well-spread centers), copied here: A, c (f32) and w* (float64)."""
    As, cs = [], []
    for _ in range(ALG_SIZE):
        M = rng.normal(size=(ALG_DIM, ALG_DIM))
        As.append(M @ M.T / ALG_DIM + np.eye(ALG_DIM))
        cs.append(rng.normal(size=(ALG_DIM,)) * 3.0)
    A, c = np.stack(As), np.stack(cs)
    w_star = np.linalg.solve(A.sum(0), np.einsum("rij,rj->i", A, c))
    return A.astype(np.float32), c.astype(np.float32), w_star


def phase_exact_algorithms(torch):
    """Gradient tracking and EXTRA (600 steps, ExponentialTwoGraph(8)),
    Push-DIGing (1200 steps, a ring plus 0 -> 2 and 0 -> 4, the port's
    DiGraph) on the card: distance to the centralized optimum within the
    reference tests' tolerances (1e-4, 1e-3, 1e-3); ATC at the same step
    stays above 1e-2."""
    import numpy as np

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import algorithms, topology_util as tu

    torch.backends.cuda.matmul.allow_tf32 = False

    def run(opt, A, c, iters):
        A, c = torch.from_numpy(A).cuda(), torch.from_numpy(c).cuda()
        params = {"w": torch.zeros(ALG_SIZE, ALG_DIM, device="cuda")}
        state = opt.init(params)
        for _ in range(iters):
            grads = {"w": torch.einsum("rij,rj->ri", A, params["w"] - c)}
            params, state = opt.step(params, grads, state)
        return params["w"].double().cpu().numpy()

    G = tu.DiGraph()
    G.add_nodes_from(range(ALG_SIZE))
    for r in range(ALG_SIZE):
        G.add_edge(r, (r + 1) % ALG_SIZE)
    G.add_edge(0, 2)
    G.add_edge(0, 4)

    class DirectedPushDIGing(bf.DistributedPushDIGingOptimizer):
        def _plan(self, ctx):
            return algorithms.column_stochastic_plan(G)

    bf.init(tu.ExponentialTwoGraph(ALG_SIZE), size=ALG_SIZE, device="cuda")
    try:
        row = {"phase": "exact_algorithms", "ranks": ALG_SIZE, "dim": ALG_DIM, "lr": ALG_LR}
        for name, cls, seed, iters, tol in (
                ("gt", bf.DistributedGradientTrackingOptimizer, 0, ALG_ITERS, 1e-4),
                ("extra", bf.DistributedEXTRAOptimizer, 0, ALG_ITERS, 1e-3),
                ("pushdiging", DirectedPushDIGing, 1, 2 * ALG_ITERS, 1e-3)):
            A, c, w_star = _quadratics(np, np.random.default_rng(seed))
            t0 = time.perf_counter()
            w = run(cls(ALG_LR), A, c, iters)
            row[name] = {"iters": iters, "dist_to_optimum": float(np.abs(w.mean(0) - w_star).max()),
                         "spread": float(np.abs(w - w.mean(0)).max()), "tol": tol,
                         "s": time.perf_counter() - t0}
        A, c, w_star = _quadratics(np, np.random.default_rng(2))
        At, ct = torch.from_numpy(A).cuda(), torch.from_numpy(c).cuda()
        w = torch.zeros(ALG_SIZE, ALG_DIM, device="cuda", requires_grad=True)
        atc = bf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([w], lr=ALG_LR),
                                                      plan=bf.context().plan)
        for _ in range(ALG_ITERS):
            w.grad = torch.einsum("rij,rj->ri", At, w.detach() - ct)
            atc.step()
        w_gt = run(bf.DistributedGradientTrackingOptimizer(ALG_LR), A, c, ALG_ITERS)
        row["atc_dist_to_optimum"] = float(np.abs(w.detach().double().cpu().numpy().mean(0)
                                                  - w_star).max())
        row["gt_same_problem_dist"] = float(np.abs(w_gt.mean(0) - w_star).max())
        emit(row)
        for name in ("gt", "extra", "pushdiging"):
            r = row[name]
            check(r["dist_to_optimum"] < r["tol"] and r["spread"] < r["tol"],
                  f"exact_algorithms: {name} {r}")
        check(row["atc_dist_to_optimum"] > 1e-2,
              f"exact_algorithms: ATC unexpectedly exact ({row['atc_dist_to_optimum']})")
        check(row["gt_same_problem_dist"] < 1e-4, f"exact_algorithms: GT {row}")
        return row
    finally:
        bf.shutdown()


SP_RANKS, SP_SEQ, SP_BATCH, SP_HEADS, SP_D = 4, 8192, 2, 12, 64
SP_MODES = {"ring": [], "ring_striped": ["--striped"], "ulysses": ["--ulysses"]}
# flash launches a layer of one step, each of fwd, dK/dV and dQ
SP_PER_LAYER = {"ring": SP_RANKS, "ring_striped": 2 * SP_RANKS - 1, "ulysses": 1}


def _sp_fwd_bwd(fn, q, k, v, g):
    """(o, dq, dk, dv) of fn under the cotangent g."""
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    out.backward(g)
    return [out.detach()] + [x.grad for x in xs]


# A seq-parallel launch against its plain version: under the kernels' rule
# (bf16) or the f32 rule, its element part widened SP_LAUNCH_WIDEN times.
# Phases kernel_case and kernel_case_f32 hold every kernel to the rule
# itself on i.i.d. inputs (worst 0.87 and 0.32); a ring's launches take the
# merge's cotangents, scaled row by row by the merge weights, over up to 4x
# the elements of the largest case, and their rounding tail reaches a
# little past it (on an H100: 1.050 for one bf16 dK/dV launch of the
# striped ring, 1.092 for one f32 one).  _sp_fault_ratios plants faults in
# the striped ring's delta-1 launch (its key offset off by one, one 64-row
# tile of the output zeroed) and gates that each lands above this limit
# (bf16: 58 to 2,457 on an H100).
SP_LAUNCH_WIDEN = 1.5


def _sp_launch_checker(torch, fa, worst, failures, samples):
    """Wrappers for fa.flash_fwd / flash_dkv / flash_dq that run the
    kernel, run its plain version on the same inputs, hold the kernel's
    outputs to the rule (bf16: the kernels' rule with its element part
    widened SP_LAUNCH_WIDEN times, lse to LSE_ABS; f32: the f32 rule
    widened as much, lse to F32_LSE_ABS; both ||err|| <= NORM_REL ||ref||)
    and return the
    kernel's: every launch a ring or Ulysses makes, at the shape, offsets
    and lse cotangent (in corr) it makes it with.  The first causal
    launch of each kernel and dtype whose offsets differ (the striped
    ring's delta-1 hop) is kept in ``samples`` for
    :func:`_sp_fault_ratios`."""
    names = {"flash_fwd": ("fwd", ("o", "lse")), "flash_dkv": ("dkv", ("dk", "dv")),
             "flash_dq": ("dq", ("dq",))}
    wrappers = {}
    for fname, (kname, outs) in names.items():
        kernel, plain = getattr(fa, fname), getattr(fa, f"{fname}_plain")

        def call(*args, _k=kernel, _p=plain, _name=kname, _outs=outs, **kw):
            got, want = _k(*args, **kw), _p(*args, **kw)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            f32 = args[0].dtype == torch.float32
            offsets = args[3:5] if _name == "fwd" else args[6:8]
            key = (_name, "f32" if f32 else "bf16")
            if kw["causal"] and offsets[0] != offsets[1] and key not in samples:
                samples[key] = (args, kw)
            for what, a, b in zip(_outs, got, want):
                if what == "lse":
                    err, ratio = compare_lse(a, b)
                    ratio, norm_rel, limit = (err / F32_LSE_ABS if f32 else ratio), 0.0, 1.0
                else:
                    err, ratio, norm_rel = compare(a, b)
                    if f32:
                        err, ratio = compare_f32(a, b)
                    limit = SP_LAUNCH_WIDEN
                w = worst.setdefault(_name, {"launches": 0, "max_abs_err": 0.0,
                                             "tol_ratio": 0.0, "norm_rel_err": 0.0})
                w["max_abs_err"] = max(w["max_abs_err"], err)
                w["tol_ratio"] = max(w["tol_ratio"], ratio)
                w["norm_rel_err"] = max(w["norm_rel_err"], norm_rel)
                if not (ratio <= limit and norm_rel <= NORM_REL):  # NaN fails
                    failures.append(f"{_name} launch {what} at offsets {offsets}: {ratio:.3g} x "
                                    f"the tolerance, norm error {norm_rel:.3g}")
            worst[_name]["launches"] += 1
            return got if len(got) > 1 else got[0]

        wrappers[fname] = call
    return wrappers


def _sp_fault_ratios(fa, samples):
    """The launch rule's reading of two faults planted in one launch of
    each kernel and dtype (``samples``: the striped ring's delta-1 hop,
    k_start = 1, causal, with the merge's lse cotangent): the kernel run
    with its key offset off by one (k_start + 1: each query loses its last
    visible key), and the kernel's right output with one 64-row tile (rows
    1024-1087 of the first head) zeroed, each against the plain version
    at the launch's own arguments under the launch's rule.  The largest
    ratio of each output, by dtype and kernel."""
    fnames = {"fwd": "flash_fwd", "dkv": "flash_dkv", "dq": "flash_dq"}
    out = {}
    for (kname, dtype), (args, kw) in samples.items():
        fname = fnames[kname]
        ratio = (lambda a, b: compare_f32(a, b)[1]) if dtype == "f32" else (
            lambda a, b: compare(a, b)[1])
        at = 4 if kname == "fwd" else 7
        want = getattr(fa, f"{fname}_plain")(*args, **kw)
        shifted = list(args)
        shifted[at] += 1
        off = getattr(fa, fname)(*shifted, **kw)
        right = getattr(fa, fname)(*args, **kw)
        want, off, right = ((x,) if not isinstance(x, tuple) else x for x in (want, off, right))
        zeroed = right[0].clone()
        zeroed[0, 1024:1088] = 0
        outs = 2 if kname == "dkv" else 1  # not the forward's lse
        out.setdefault(dtype, {})[kname] = {
            "k_start_off_by_one": max(ratio(a, b) for a, b in zip(off[:outs], want)),
            "tile_zeroed": ratio(zeroed, want[0])}
    return out


def _sp_layer_checks(torch, fa):
    """Sequence-parallel attention at the layer shape [2, 8192, 12, 64] of
    the seq-parallel path over SP_RANKS ranks: the contiguous and striped
    ring and Ulysses in bf16, and the striped ring in f32 (the reduced-depth
    f32 run's launches), forward and (dq, dk, dv) under a seeded cotangent:

    - every kernel launch (fwd, dK/dV, dQ of every hop group, with its
      offsets and the merge's lse cotangent; Ulysses' one launch at the
      folded [24, 8192, 64]) against its plain version on the same inputs
      (:func:`_sp_launch_checker`), and the rule's reading of faults
      planted in one launch of each kernel and dtype above its limit
      (:func:`_sp_fault_ratios`);
    - bf16: the merged outputs against the same ring on the plain versions
      and against one full-sequence flash_attention_with_lse launch:
      ||err|| <= 1e-2 ||ref||, and both against the f32 truth (f32
      scaled_dot_product_attention on the same bf16 inputs): the ring's
      norm error at most sqrt(2n - 1) times the launch's;
    - f32: the merged outputs against the plain ring, ||err|| <= 1e-2
      ||ref|| (element ratios under the f32 rule printed).

    The merged bf16 outputs are not held to the rule's element part: a
    merged value sums per-hop parts rounded to bf16 at their own size
    (each hop's o; each hop's dQ / dK / dV, summed in bf16 across hops),
    which can be larger than the value, where one launch rounds once at
    the value's size (the ring's 2n - 1 roundings add in quadrature:
    sqrt(2n - 1)).  The element ratios are printed.  Launches made here
    are not a path's; returns the timing row."""
    from bluefog_tpu_torch.parallel import ring_attention as ring
    from bluefog_tpu_torch.parallel.ulysses import ulysses_attention

    F = torch.nn.functional
    n = SP_RANKS
    roundings = 2 * n - 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (SP_BATCH, SP_SEQ, SP_HEADS, SP_D)
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(4))
    counts_before = (dict(fa.launches), dict(fa.launches_f32))

    def full(q, k, v):
        return fa.flash_attention_with_lse(q, k, v, causal=True)[0]

    def truth(q, k, v):
        o = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                           is_causal=True)
        return o.transpose(1, 2)

    def sp_fn(mode):
        striped = mode == "striped"

        def fn(q, k, v):
            xs = (ring.shard_inputs(x, n, striped)[0] for x in (q, k, v))
            if mode == "ulysses":
                o = ulysses_attention(*xs, n, causal=True, flash=True)
            else:
                o = ring.ring_flash_attention(*xs, n, causal=True, striped=striped)
            return ring.gather_outputs(o, n, striped)
        return fn

    def swapped(fns, fn, *args):
        saved = {x: getattr(fa, x) for x in fns}
        try:
            for x, f in fns.items():
                setattr(fa, x, f)
            return _sp_fwd_bwd(fn, *args)
        finally:
            for x, f in saved.items():
                setattr(fa, x, f)

    ref_full = _sp_fwd_bwd(full, q, k, v, g)
    ref_truth = _sp_fwd_bwd(truth, q.float(), k.float(), v.float(), g.float())
    plain = {x: getattr(fa, f"{x}_plain") for x in ("flash_fwd", "flash_dkv", "flash_dq")}
    rows, failures, samples = {}, [], {}
    names = ("o", "dq", "dk", "dv")
    launches = {"contiguous": n, "striped": 2 * n - 1, "ulysses": 1, "striped_f32": 2 * n - 1}
    for mode, want in launches.items():
        f32 = mode == "striped_f32"
        fn = sp_fn("striped" if f32 else mode)
        inputs = [x.float() for x in (q, k, v, g)] if f32 else (q, k, v, g)
        worst = {}
        got = swapped(_sp_launch_checker(torch, fa, worst, failures, samples), fn, *inputs)
        on_plain = swapped(plain, fn, *inputs)
        row = {"phase": "seq_parallel_layer", "layout": mode, "shape": list(shape),
               "dtype": "f32" if f32 else "bf16", "ranks": n, "launch_vs_plain": worst}
        for kname in ("fwd", "dkv", "dq"):
            got_n = worst.get(kname, {}).get("launches", 0)
            if got_n != want:
                failures.append(f"{mode}: {got_n} {kname} launches, expected {want}")
        for name, a, p, f, t in zip(names, got, on_plain, ref_full, ref_truth):
            if not torch.isfinite(a).all().item():
                failures.append(f"{mode}: non-finite {name}")
            err_p, ratio_p, norm_p = compare(a, p)
            row[name] = {"vs_plain_max_abs_err": err_p, "vs_plain_norm_rel_err": norm_p}
            if f32:
                row[name]["vs_plain_f32_tol_ratio"] = compare_f32(a, p)[1]
                if norm_p > NORM_REL:
                    failures.append(f"{mode} {name}: norm error {norm_p:.3g} vs the plain ring")
                continue
            err_f, ratio_f, norm_f = compare(a, f)
            ring_truth = ((a.float() - t).norm() / t.norm()).item()
            full_truth = ((f.float() - t).norm() / t.norm()).item()
            row[name].update({"vs_plain_tol_ratio": ratio_p, "vs_full_max_abs_err": err_f,
                              "vs_full_tol_ratio": ratio_f, "vs_full_norm_rel_err": norm_f,
                              "ring_truth_norm_rel_err": ring_truth,
                              "full_truth_norm_rel_err": full_truth})
            if norm_p > NORM_REL or norm_f > NORM_REL:
                failures.append(f"{mode} {name}: norm error {norm_p:.3g} vs the plain ring, "
                                f"{norm_f:.3g} vs one launch")
            if ring_truth > math.sqrt(roundings) * full_truth:
                failures.append(f"{mode} {name}: {ring_truth:.3g} from the f32 truth, one "
                                f"launch {full_truth:.3g}")
        row["tolerance"] = (
            f"each launch vs plain: {TOLERANCE_F32}, element part x {SP_LAUNCH_WIDEN}" if f32
            else f"each launch vs plain: {TOLERANCE}, element part x {SP_LAUNCH_WIDEN}; merged: "
            f"||err|| <= 1e-2 ||ref|| vs the plain ring and one launch, ||ring - truth|| <= "
            f"sqrt({roundings}) ||launch - truth||")
        if f32:
            row["tolerance"] += "; merged: ||err|| <= 1e-2 ||ref|| vs the plain ring"
        emit(row)
        rows[mode] = row
    faults = _sp_fault_ratios(fa, samples)
    emit({"phase": "seq_parallel_planted_faults", "limit": SP_LAUNCH_WIDEN,
          "launch": "striped ring, delta-1 hop (q_start 0, k_start 1, causal)",
          "tol_ratio": faults})
    check(sorted(samples) == sorted((k, d) for k in ("fwd", "dkv", "dq")
                                    for d in ("bf16", "f32")),
          f"seq_parallel layer: delta-1 launches sampled {sorted(samples)}")
    for dtype, by_kernel in faults.items():
        for kname, r in by_kernel.items():
            for fault, ratio in r.items():
                if not ratio > SP_LAUNCH_WIDEN:
                    failures.append(f"planted fault {fault} in {dtype} {kname} read "
                                    f"{ratio:.3g}, within the launch limit {SP_LAUNCH_WIDEN}")
    check(not failures, "seq_parallel layer: " + "; ".join(failures))

    # forward + backward times at the layer shape, one launch against the
    # rings and Ulysses (eager: a ring's host work between its launches is
    # its cost)
    def timed(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        return cuda_ms(lambda: fn(*xs).backward(g), iters=5, warmup=2)

    timing = {"phase": "seq_parallel_layer_times", "shape": list(shape), "ranks": n,
              "full_fwd_bwd_ms": timed(full), "ring_fwd_bwd_ms": timed(sp_fn("contiguous")),
              "ring_striped_fwd_bwd_ms": timed(sp_fn("striped")),
              "ulysses_fwd_bwd_ms": timed(sp_fn("ulysses"))}
    fa.launches.update(counts_before[0])
    fa.launches_f32.update(counts_before[1])
    emit(timing)
    return timing


def _sp_logits_check(torch, fa, model, mode, refs):
    """Called by llama_pretrain before the first step: the seq-parallel
    logits of ``model`` on a seeded [2, 8192] batch, put back into
    sequence order, against one LlamaLM with make_flash_attention_fn on
    the whole sequence and the same weights.  Two bf16 computations of 12
    layers differ by more than the kernels' rule (each rounds its
    attention outputs at other points, and 12 layers carry the
    differences on), so both are held against the f32 truth
    (the same weights in f32, f32 scaled_dot_product_attention), as phase
    model holds gradients: ||sp - truth|| <= 1.25 ||full - truth||.  The
    references are made once (every mode draws the same weights from the
    same seed, checked) and kept on the host.  Launches here are not the
    path's."""
    from bluefog_tpu_torch.models.transformer import LlamaLM
    from bluefog_tpu_torch.parallel import ring_attention as ring

    F = torch.nn.functional
    counts_before = (dict(fa.launches), dict(fa.launches_f32))
    n = SP_RANKS
    striped = mode == "ring_striped"
    ids = torch.randint(0, 32000, (SP_BATCH, SP_SEQ),
                        generator=torch.Generator().manual_seed(17)).cuda()
    state = model.state_dict()
    digest = sum(float(v.double().sum()) for v in state.values())
    cfg = dict(vocab_size=32000, hidden_size=768, num_layers=12, num_heads=SP_HEADS,
               dff=2048, device="cuda")

    def truth_attention(q, k, v):
        o = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                           is_causal=True)
        return o.transpose(1, 2)

    with torch.no_grad():
        if "full" not in refs:
            for name, kw in (("full", dict(dtype=torch.bfloat16,
                                           attention_fn=fa.make_flash_attention_fn())),
                             ("truth", dict(dtype=torch.float32,
                                            attention_fn=truth_attention))):
                twin = LlamaLM(**cfg, **kw)
                twin.load_state_dict(state)
                refs[name] = twin(ids).cpu()
                del twin
            refs["digest"] = digest
        check(digest == refs["digest"], f"seq_parallel {mode}: other weights than the "
                                        f"first mode's ({digest} vs {refs['digest']})")
        x, pos = ring.shard_inputs(ids, n, striped)
        sp = ring.gather_outputs(model(x, pos), n, striped)
        full, truth = refs["full"].cuda(), refs["truth"].cuda()
        check(torch.isfinite(sp).all().item(), f"seq_parallel {mode}: non-finite logits")
        sp_truth = ((sp - truth).norm() / truth.norm()).item()
        full_truth = ((full - truth).norm() / truth.norm()).item()
        err, ratio, norm_rel = compare(sp, full)
        del full, truth, sp
    fa.launches.update(counts_before[0])
    fa.launches_f32.update(counts_before[1])
    return {"logits_sp_truth_norm_rel_err": sp_truth,
            "logits_full_truth_norm_rel_err": full_truth,
            "logits_vs_full_max_abs_err": err, "logits_vs_full_tol_ratio": ratio,
            "logits_vs_full_norm_rel_err": norm_rel,
            "logits_tolerance": "||sp - truth|| <= 1.25 ||full - truth|| (f32 truth)"}


def phase_seq_parallel(torch, fa):
    """Sequence parallelism on the flash kernels: the reference's
    ``--seq-parallel`` Llama path (examples/jax_llama_pretrain.py
    run_seq_parallel) at the small preset's widths (vocab 32000, hidden
    768, 12 layers, 12 heads, D = 64, dff 2048, bf16) over a global context
    of 8192 tokens on SP_RANKS ranks (shards of 2048), batch 2, Adam 3e-3,
    through examples/llama_pretrain --seq-parallel: contiguous ring flash,
    striped ring flash, Ulysses with flash, STEPS steps each, every launch
    count set to 0 just before each mode and read just after.  Each mode:
    finite losses, fwd = dK/dV = dQ launches of layers x 4 (contiguous),
    layers x 7 (striped) or layers (Ulysses) in every step, and the logits
    before any update held against the full-sequence model
    (:func:`_sp_logits_check`).  Before them, the layer-shape checks
    (:func:`_sp_layer_checks`); after them, 2 layers in f32, striped, 2
    steps: the f32 kernels' launches 2 x 7 a step and no bf16 launch.
    Returns the bf16 and f32 launch counts of the path."""
    from bluefog_tpu_torch.examples import llama_pretrain

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    _sp_layer_checks(torch, fa)
    base = ["--preset", "small", "--seq", str(SP_SEQ), "--batch", str(SP_BATCH),
            "--size", str(SP_RANKS), "--seq-parallel", "--device", "cuda"]
    counts = {"fwd": 0, "dkv": 0, "dq": 0}
    refs = {}
    for mode, flags in SP_MODES.items():
        gc.collect()
        torch.cuda.empty_cache()
        logits = {}

        def setup(model, opt, mode=mode, logits=logits):
            logits.update(_sp_logits_check(torch, fa, model, mode, refs))

        fa.reset_launches()
        out = llama_pretrain.run(llama_pretrain._parser().parse_args(
            base + ["--steps", str(STEPS)] + flags), setup=setup)
        got, got_f32 = dict(fa.launches), dict(fa.launches_f32)
        per_step = out["layers"] * SP_PER_LAYER[mode]
        row = {"phase": "seq_parallel", **out, "launches": got,
               "launches_expected_per_step": per_step,
               "peak_gb": out["max_memory_allocated"] / 1e9, **logits}
        emit(row)
        check((out["hidden"], out["layers"], out["heads"], out["seq"], out["t_local"]) ==
              (768, 12, SP_HEADS, SP_SEQ, SP_SEQ // SP_RANKS), f"seq_parallel: widths {out}")
        check(out["mode"] == mode and out["head_chunks"] == 0, f"seq_parallel: mode {out}")
        check(all(math.isfinite(x) for x in out["losses"]),
              f"seq_parallel {mode}: non-finite loss {out['losses']}")
        check(logits["logits_sp_truth_norm_rel_err"]
              <= 1.25 * logits["logits_full_truth_norm_rel_err"],
              f"seq_parallel {mode}: logits {logits}")
        for s, step in enumerate(out["launches_per_step"]):
            check(step == {k: per_step for k in step},
                  f"seq_parallel {mode}: step {s} launched {step}, expected {per_step} each")
        for kname, c in got.items():
            check(c == per_step * STEPS, f"seq_parallel {mode}: {kname} launched {c} times")
            counts[kname] += c
        check(not any(got_f32.values()), f"seq_parallel {mode}: an f32 kernel launched")

    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launches()
    steps_f32, layers_f32 = 2, 2
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        base + ["--steps", str(steps_f32), "--striped", "--dtype", "f32",
                "--layers", str(layers_f32)]))
    counts_f32, bf16 = dict(fa.launches_f32), dict(fa.launches)
    per_step = layers_f32 * SP_PER_LAYER["ring_striped"]
    emit({"phase": "seq_parallel_f32", **out, "launches_f32": counts_f32,
          "launches_expected_per_step": per_step,
          "peak_gb": out["max_memory_allocated"] / 1e9,
          "reduced": "depth 12 -> 2 layers, 2 steps: the f32 kernels through the ring"})
    check(all(math.isfinite(x) for x in out["losses"]),
          f"seq_parallel f32: non-finite loss {out['losses']}")
    for kname, c in counts_f32.items():
        check(c == per_step * steps_f32, f"seq_parallel f32: {kname}_f32 launched {c} times, "
                                         f"expected {per_step * steps_f32}")
    check(not any(bf16.values()), f"seq_parallel f32: a bf16 kernel launched ({bf16})")
    return counts, counts_f32


# ---------------------------------------------------------------------------
# The parallel layers.  zero_8b runs the bf16 flash kernels at D = 128
# (BASELINE config #5), tensor_parallel the f32 flash kernels at D = 64;
# pipeline and expert run dense attention, as the reference's examples.
# ---------------------------------------------------------------------------

Z8_MESH, Z8_LAYERS, Z8_STEPS = (2, 4), 2, 3
Z8_LEAF = "layers.k"  # the stacked k projections, [2 machines, 2, 1024, 4096] f32
Z8_CMP_LAYERS, Z8_CMP_STEPS = 1, 2
# the packed ZeRO-1 and FSDP builders' updates, in norm: the honest reading is
# bf16 roundoff (the packed builder runs each local batch alone, the FSDP
# builder the machine's batch as one); the mix skipped moves it to ~0.5
Z8_UPDATE_LIMIT = 0.1
PAR_TOL = 1e-5  # a model's f32 loss / gradients against another layout, in norm
PAR_VOCAB = 32000  # the small preset's vocabulary, for the tp / pp / ep phases' LM heads


def _norm_rel(torch, got, ref):
    """||got - ref|| / ||ref|| over a list of tensor pairs, in float64."""
    num = sum(float((g.double() - r.double()).pow(2).sum()) for g, r in zip(got, ref))
    den = sum(float(r.double().pow(2).sum()) for r in ref)
    return math.sqrt(num / den)


def phase_zero_8b(torch, fa):
    """BASELINE config #5 on the card: the reference's FSDP + machine-gossip
    step (benchmarks/zero_8b.py, make_fsdp_gossip_train_step) through
    bluefog_tpu_torch.benchmarks.zero_8b at the Llama-3-8B widths (vocab
    128256, hidden 4096, 32 heads on 8 kv heads, D = 128, dff 14336, seq
    2048), cut 32 -> Z8_LAYERS layers (the reference's own cut), mesh 2
    machines x 4 local ranks, batch 1 a local rank ([4, 2048] a machine),
    remat, scan_layers, head_chunks 16, spmd_vocab, the three FSDP hooks
    with bf16 gradients, momentum SGD 3e-4 / 0.9 with a bf16 momentum,
    machine topology ExponentialTwoGraph(2), Z8_STEPS steps, every launch
    count set to 0 just before.  The design's launches: each machine's
    batch is one forward a layer (GQA's k/v repeated to 32 heads:
    [4 x 32, 2048, 128] bf16), which remat recomputes in the backward, so
    the forward launches 2 x layers x machines x steps = 24 times and dK/dV
    and dQ layers x machines x steps = 12, and no f32 kernel.  After every
    step a leaf of each machine equals the machine plan's mix of its
    adapted values; the masters stay f32 and the momenta bf16; losses
    finite.  Then from the same initial parameters and batches, at
    Z8_CMP_LAYERS layer, f32 momentum and no gradient cast, the packed
    ZeRO-1 builder and the FSDP builder take Z8_CMP_STEPS steps each: their
    parameter updates agree in norm within Z8_UPDATE_LIMIT, and the FSDP
    builder with the machine mix skipped (a planted fault) must not."""
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.benchmarks import zero_8b
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.parallel import zero

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    seen = {"pairs": []}
    mix = zero.neighbor_allreduce_plan

    def recording_mix(x, plan, **kw):  # the adapted leaf, before the builder's mix
        if x is seen.get("leaf"):
            seen["adapted"], seen["plan"] = x.detach().clone(), plan
        return mix(x, plan, **kw)

    def setup(state):
        seen["leaf"], seen["state"] = state["master"][Z8_LEAF], state

    def on_step(s, state):
        seen["pairs"].append((seen.pop("adapted"), state["master"][Z8_LEAF].detach().clone()))

    args = zero_8b._parser().parse_args(["--layers", str(Z8_LAYERS), "--steps", str(Z8_STEPS),
                                         "--device", "cuda"])
    zero.neighbor_allreduce_plan = recording_mix
    fa.reset_launches()
    try:
        out = zero_8b.run(args, setup=setup, on_step=on_step)
    finally:
        zero.neighbor_allreduce_plan = mix
    counts, counts_f32 = dict(fa.launches), dict(fa.launches_f32)
    state = seen.pop("state")
    mix_err = [_check_mix(torch, seen["plan"], a, now, f"zero_8b step {s}")
               for s, (a, now) in enumerate(seen.pop("pairs"))]
    master_dtypes = {str(l.dtype) for l in state["master"].values()}
    mom_dtypes = {str(l.dtype) for l in state["opt"][0].values()}
    del state, seen
    machines = Z8_MESH[0]
    want = {"fwd": 2 * Z8_LAYERS * machines * Z8_STEPS, "dkv": Z8_LAYERS * machines * Z8_STEPS,
            "dq": Z8_LAYERS * machines * Z8_STEPS}
    losses = [x for step in out["machine_losses"] for x in step]
    row = {"phase": "zero_8b", **out, "launches": counts, "launches_expected": want,
           "mix_err_over_scale": mix_err, "master_dtypes": sorted(master_dtypes),
           "momentum_dtypes": sorted(mom_dtypes),
           "peak_gb": out.get("max_memory_allocated", 0) / 1e9}
    emit(row)
    check(out["mesh"] == "%dx%d" % Z8_MESH and out["layers"] == Z8_LAYERS, f"zero_8b: {out}")
    check(all(math.isfinite(x) for x in losses) and len(losses) == machines * Z8_STEPS,
          f"zero_8b: losses {losses}")
    check(master_dtypes == {"torch.float32"} and mom_dtypes == {"torch.bfloat16"},
          f"zero_8b: masters {master_dtypes}, momenta {mom_dtypes}")
    check(len(mix_err) == Z8_STEPS, f"zero_8b: mix checked {len(mix_err)} times")
    for kname, n in counts.items():
        check(n == want[kname], f"zero_8b: {kname} launched {n} times, expected {want[kname]}")
    check(not any(counts_f32.values()), f"zero_8b: an f32 kernel launched ({counts_f32})")

    # the packed ZeRO-1 builder against the FSDP builder, from one start
    gc.collect()
    torch.cuda.empty_cache()
    model = zero_8b.build_model(zero_8b.CFG, Z8_CMP_LAYERS, grad_dtype=None, device="cuda")
    init = {k: v.detach() for k, v in model.named_parameters()}
    model.to("meta")
    plan = compile_plan(topology_util.ExponentialTwoGraph(machines))
    batches = zero_8b.token_batches(zero_8b.CFG, machines, Z8_MESH[1], Z8_CMP_STEPS, "cuda")

    def updates(builder, machine_plan):
        _, init_fn, step_fn, _, _ = zero_8b.make_step(model, Z8_MESH, machine_plan,
                                                      builder=builder,
                                                      momentum_dtype=torch.float32)
        state = init_fn(init)
        t0 = time.perf_counter()
        for ids in batches:
            x = ids.reshape(Z8_MESH + (-1, ids.shape[-1])) if builder is \
                zero.make_zero_gossip_train_step else ids
            state, _ = step_fn(state, x, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        if builder is zero.make_zero_gossip_train_step:
            layout = zero.packed_layout(init, Z8_MESH[1])
            per = [zero.unpack_params(state["master"][m].reshape(-1), layout, torch.float32)
                   for m in range(machines)]
            ups = [per[m][k] - init[k] for m in range(machines) for k in sorted(init)]
        else:
            ups = [state["master"][k][m] - init[k] for m in range(machines) for k in sorted(init)]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return ups, ms

    packed, packed_ms = updates(zero.make_zero_gossip_train_step, plan)
    fsdp, fsdp_ms = updates(zero.make_fsdp_gossip_train_step, plan)
    honest = _norm_rel(torch, packed, fsdp)
    del fsdp
    fault, _ = updates(zero.make_fsdp_gossip_train_step, None)
    planted = _norm_rel(torch, packed, fault)
    cmp_row = {"phase": "zero_8b_builders", "layers": Z8_CMP_LAYERS, "steps": Z8_CMP_STEPS,
               "momentum_dtype": "float32", "grad_dtype": None,
               "packed_step_ms": packed_ms, "fsdp_step_ms": fsdp_ms,
               "update_rel_packed_vs_fsdp": honest,
               "update_rel_packed_vs_fsdp_without_mix": planted, "limit": Z8_UPDATE_LIMIT,
               "reduced": f"depth 32 -> {Z8_CMP_LAYERS} layer, {Z8_CMP_STEPS} steps",
               "phase_seconds": time.perf_counter() - t_phase}
    emit(cmp_row)
    check(honest <= Z8_UPDATE_LIMIT < planted,
          f"zero_8b: packed vs FSDP updates {honest}, with the mix skipped {planted}")
    del model, init, packed, fault
    return counts


TP_WIDTHS = dict(d_model=768, heads=12, dff=2048, layers=12)  # the small preset's
TP_DP, TP_TP, TP_BATCH, TP_SEQ, TP_STEPS = 2, 2, 2, 2048, 3
TP_LR = 0.01  # the example's 0.05 diverges at these widths


def phase_tensor_parallel(torch, fa):
    """examples/tp_gossip at the small preset's widths (d 768, 12 heads, D =
    64, dff 2048, 12 layers, vocab PAR_VOCAB), seq TP_SEQ, batch
    TP_BATCH a dp rank, dp TP_DP x tp TP_TP, f32, the f32 flash kernels as
    ``attention_fn`` (the tp shards folded into one launch a layer).  Replica
    0's loss and unsharded gradients at tp = 2 against tp = 1 (the same
    parameters and tokens): within PAR_TOL in norm (f32 sums split over the
    shards; the kernels' element rule beside it, reported).  Then TP_STEPS
    gossip steps on ExponentialTwoGraph(dp) with every launch count set to
    0 just before: finite losses, each f32 kernel launched layers x dp a
    step (the tp shards in one launch), no bf16 kernel."""
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.examples import tp_gossip
    from bluefog_tpu_torch.kernels import make_flash_attention_fn
    from bluefog_tpu_torch.ops import tree_flatten, tree_map
    from bluefog_tpu_torch.parallel import tensor_parallel as tpp

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    w = TP_WIDTHS
    per_replica = [tp_gossip.init_params(w["d_model"], w["heads"], w["dff"], w["layers"], seed=r,
                                         device="cuda", vocab=PAR_VOCAB) for r in range(TP_DP)]
    axes = tp_gossip.param_axes(w["layers"])
    flash = make_flash_attention_fn()
    batches = tp_gossip.synthetic_batches(TP_DP, TP_BATCH, TP_SEQ, TP_STEPS, "cuda",
                                          vocab=PAR_VOCAB)

    def loss_and_grads(tp):
        repl, shard = tp_gossip.stack_replicas(per_replica[:1], axes, tp)
        loss = tp_gossip.replica_loss(
            tpp.merge_tp_params(*tree_map(lambda a: a[0], [repl, shard])), batches[0][0], flash)
        loss.backward()
        grads = tpp.unshard_tp_params(
            tpp.merge_tp_params(*tree_map(lambda a: a.grad[0], [repl, shard])), axes)
        return loss.detach(), tree_flatten(grads)[0]

    t0 = time.perf_counter()
    loss1, g1 = loss_and_grads(1)
    loss2, g2 = loss_and_grads(TP_TP)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    loss_rel = abs(loss2.item() - loss1.item()) / abs(loss1.item())
    grad_rel = _norm_rel(torch, g2, g1)
    elem = max(compare_f32(a, b)[1] for a, b in zip(g2, g1))
    del g1, g2

    repl, shard = tp_gossip.stack_replicas(per_replica, axes, TP_TP)
    step = tp_gossip.make_step(repl, shard,
                               compile_plan(topology_util.ExponentialTwoGraph(TP_DP)), TP_LR,
                               flash)
    fa.reset_launches()
    losses, step_ms = [], []
    for ids in batches:
        t0 = time.perf_counter()
        losses.append(step(ids).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts, bf16 = dict(fa.launches_f32), dict(fa.launches)
    per_step = w["layers"] * TP_DP
    tokens = TP_DP * TP_BATCH * TP_SEQ
    row = {"phase": "tensor_parallel", **w, "vocab": PAR_VOCAB, "dp": TP_DP, "tp": TP_TP,
           "batch": TP_BATCH, "seq": TP_SEQ, "dtype": "float32", "attention": "flash",
           "loss_tp1": loss1.item(), "loss_tp2": loss2.item(), "loss_rel_err": loss_rel,
           "grad_norm_rel_err": grad_rel, "grad_worst_over_f32_elem_rule": elem,
           "check_s": check_s, "losses": losses, "step_ms": step_ms,
           "tok_per_s": tokens / (sum(step_ms[1:]) / len(step_ms[1:]) / 1e3),
           "launches_f32": counts, "launches_expected": per_step * TP_STEPS,
           "consensus_spread": tp_gossip.spread(shard["blocks"][0]["mlp"]["wi"]),
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    check(loss_rel <= PAR_TOL and grad_rel <= PAR_TOL and elem <= 1.0,
          f"tensor_parallel: tp={TP_TP} against tp=1: loss {loss_rel}, gradients {grad_rel} "
          f"in norm, {elem} of the f32 element rule")
    check(all(math.isfinite(x) for x in losses), f"tensor_parallel: losses {losses}")
    for kname, n in counts.items():
        check(n == per_step * TP_STEPS,
              f"tensor_parallel: {kname}_f32 launched {n} times, expected {per_step * TP_STEPS}")
    check(not any(bf16.values()), f"tensor_parallel: a bf16 kernel launched ({bf16})")
    return counts


PP_STAGES, PP_MICRO, PP_BATCH, PP_SEQ = 4, 4, 8, 512
PP_WIDTHS = dict(d_model=768, heads=12, layers=12)


def phase_pipeline(torch):
    """examples/pp_gossip's pipeline at the small preset's widths (d 768, 12
    heads, 12 layers: 3 a stage; vocab PAR_VOCAB), PP_STAGES stages,
    PP_MICRO microbatches, batch PP_BATCH x seq PP_SEQ, dense f32 attention
    as in the example: the pipelined loss and every gradient against the
    same blocks run in sequence on the whole batch, within PAR_TOL in norm.
    Element by element both f32 gradients are held against the sequential
    blocks run in float64, under the f32 element rule: leaf by leaf the
    pipelined gradient's worst element may be at most one tolerance farther
    than the sequential one's.  (The two sum the same terms in other
    orders, and at the 32000-row embedding the sequential f32 gradient
    itself breaks the f32 rule against float64, so the rule cannot part
    the two directly.)  Runs no kernel of the repo."""
    from bluefog_tpu_torch.examples import pp_gossip

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    w = PP_WIDTHS
    blocks, repl = pp_gossip.init_replica(w["d_model"], w["heads"], w["layers"], seed=0,
                                          device="cuda", vocab=PAR_VOCAB)
    stages = pp_gossip.stage_stack(blocks, PP_STAGES)
    ids = pp_gossip.synthetic_batches(1, PP_BATCH, PP_SEQ, 1, "cuda", vocab=PAR_VOCAB)[0][0]
    names = list(repl) + list(stages)

    def run(repl, stages, pipelined):
        params = list(repl.values()) + list(stages.values())
        for p in params:
            p.grad = None
            p.requires_grad_(True)
        t0 = time.perf_counter()
        if pipelined:
            loss = pp_gossip.replica_loss(repl, stages, ids, PP_MICRO)
        else:
            x = repl["embed"][ids[:, :-1]]
            for s in range(PP_STAGES):
                x = pp_gossip.stage_fn({k: v[s] for k, v in stages.items()}, x)
            logits = torch.einsum("btm,mv->btv", x, repl["unembed"])
            loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1),
                                                     ids[:, 1:].reshape(-1))
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), [p.grad.detach().clone() for p in params], \
            (time.perf_counter() - t0) * 1e3

    seq_loss, seq_grads, _ = run(repl, stages, False)
    pipe_loss, pipe_grads, _ = run(repl, stages, True)
    # the second runs of each are timed
    seq_loss, seq_grads, seq_ms = run(repl, stages, False)
    pipe_loss, pipe_grads, pipe_ms = run(repl, stages, True)

    def f64(tree):
        return {k: v.detach().double() for k, v in tree.items()}

    _, exact, _ = run(f64(repl), f64(stages), False)
    loss_rel = abs(pipe_loss.item() - seq_loss.item()) / abs(seq_loss.item())
    grad_rel = _norm_rel(torch, pipe_grads, seq_grads)
    pipe_vs_f64 = {n: compare_f32(a, t)[1] for n, a, t in zip(names, pipe_grads, exact)}
    seq_vs_f64 = {n: compare_f32(b, t)[1] for n, b, t in zip(names, seq_grads, exact)}
    beyond = {n: pipe_vs_f64[n] - seq_vs_f64[n] for n in names}
    row = {"phase": "pipeline", **w, "vocab": PAR_VOCAB,
           "stages": PP_STAGES, "microbatches": PP_MICRO, "batch": PP_BATCH, "seq": PP_SEQ,
           "dtype": "float32", "attention": "dense", "loss": pipe_loss.item(),
           "loss_rel_err": loss_rel, "grad_norm_rel_err": grad_rel,
           "grad_over_f32_elem_rule": {n: compare_f32(a, b)[1]
                                       for n, a, b in zip(names, pipe_grads, seq_grads)},
           "pipelined_vs_f64_over_f32_elem_rule": pipe_vs_f64,
           "sequential_vs_f64_over_f32_elem_rule": seq_vs_f64,
           "pipelined_fwd_bwd_ms": pipe_ms, "sequential_fwd_bwd_ms": seq_ms,
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    check(loss_rel <= PAR_TOL and grad_rel <= PAR_TOL and max(beyond.values()) <= 1.0,
          f"pipeline: against the sequential blocks: loss {loss_rel}, gradients {grad_rel} "
          f"in norm; against float64, the pipelined worst element {beyond} f32 tolerances "
          f"beyond the sequential one's")


EP_RANKS, EP_EXPERTS, EP_DP, EP_BATCH, EP_SEQ, EP_STEPS = 4, 8, 2, 4, 512, 3
EP_LR = 0.01  # the example's 0.05 diverges at these widths
EP_WIDTHS = dict(d_model=768, heads=12, d_ff=2048, layers=12)


def phase_expert(torch):
    """examples/moe_gossip at the small preset's widths (d 768, 12 heads,
    d_ff 2048, 12 layers, vocab PAR_VOCAB), EP_EXPERTS experts,
    ample capacity, dp EP_DP, batch EP_BATCH a replica (cut from the
    example's 8) x seq EP_SEQ, f32, dense attention: EP_STEPS gossip steps
    at ep = EP_RANKS and at ep = 1 from the same parameters and batches,
    loss for loss within PAR_TOL, aux weight 0 (the Switch aux loss is a
    per-shard statistic: with it ep > 1 is another objective).  Runs no
    kernel of the repo."""
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.examples import moe_gossip

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = compile_plan(topology_util.ExponentialTwoGraph(EP_DP))
    w = EP_WIDTHS
    inits = [moe_gossip.init_params(w["d_model"], w["heads"], w["d_ff"], EP_EXPERTS, w["layers"],
                                    seed=r, device="cuda", vocab=PAR_VOCAB,
                                    generator=torch.Generator(device="cuda").manual_seed(r))
             for r in range(EP_DP)]
    out = {}
    for ep in (EP_RANKS, 1):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        repl = moe_gossip.stack_replicas([i[0] for i in inits])
        experts = moe_gossip.stack_replicas([moe_gossip.shard_experts(i[1], ep) for i in inits])
        step = moe_gossip.make_step(repl, experts, plan, EP_LR, float(EP_EXPERTS), 0.0)
        losses, step_ms = [], []
        for ids in moe_gossip.synthetic_batches(EP_DP, ep, EP_BATCH, EP_SEQ, EP_STEPS, "cuda",
                                                vocab=PAR_VOCAB):
            t0 = time.perf_counter()
            losses.append(step(ids).item())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out[ep] = {"losses": losses, "step_ms": step_ms,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del repl, experts, step
    rel = [abs(a - b) / abs(b) for a, b in zip(out[EP_RANKS]["losses"], out[1]["losses"])]
    row = {"phase": "expert", **EP_WIDTHS, "vocab": PAR_VOCAB, "experts": EP_EXPERTS,
           "ep": EP_RANKS, "dp": EP_DP, "batch": EP_BATCH, "seq": EP_SEQ, "lr": EP_LR,
           "dtype": "float32", "aux_weight": 0.0, f"ep{EP_RANKS}": out[EP_RANKS], "ep1": out[1],
           "loss_rel_err": rel, "reduced": "batch 8 -> 4 sequences a replica",
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    check(all(math.isfinite(x) for x in out[EP_RANKS]["losses"]), f"expert: {out}")
    check(max(rel) <= PAR_TOL, f"expert: ep={EP_RANKS} against ep=1 losses {rel}")


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

    smi = phase_device(torch, _build, fa, ac, roof)
    table = phase_kernels(torch, fa)
    table_f32 = phase_kernels_f32(torch, fa)
    counts_f32 = phase_f32(torch, fa)
    phase_model(torch, fa)
    counts = phase_main(torch, fa)
    comp_err = phase_components(torch, ac, roof)
    row, comp_counts = phase_roofline(torch, fa, ac, roof)
    comp_table = component_times(torch, ac, roof, row)
    phase_resnet(torch)
    phase_windows(torch)
    phase_bert_pushsum(torch)
    phase_exact_algorithms(torch)
    phase_eager_api(torch)
    phase_hierarchical(torch)
    counts_1b = phase_llama_1b(torch, fa)
    phase_vit(torch, fa)
    counts_sp, counts_sp_f32 = phase_seq_parallel(torch, fa)
    counts_z8 = phase_zero_8b(torch, fa)
    counts_tp_f32 = phase_tensor_parallel(torch, fa)
    phase_pipeline(torch)
    phase_expert(torch)
    replaces = {"fwd": "bluefog_tpu/kernels/flash_attention.py:246",
                "dkv": "bluefog_tpu/kernels/flash_attention.py:490",
                "dq": "bluefog_tpu/kernels/flash_attention.py:575",
                "qk": "benchmarks/attention_roofline.py:136",
                "pv": "benchmarks/attention_roofline.py:150",
                "softmax_chain": "benchmarks/attention_roofline.py:167",
                "bwd_chain": "benchmarks/attention_roofline.py:221"}
    # launches: the sum over the paths that run the kernel, each read with
    # the counts set to 0 just before it (launches_by_phase)
    emit({"kernels": [
        {"name": f"flash_{k}", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/flash_attention.cu",
         "replaces": replaces[k],
         "launches": counts[k] + counts_1b[k] + counts_sp[k] + counts_z8[k],
         "launches_by_phase": {"main": counts[k], "llama_1b": counts_1b[k],
                               "seq_parallel": counts_sp[k], "zero_8b": counts_z8[k]},
         **table[k]}
        for k in ("fwd", "dkv", "dq")] + [
        {"name": f"flash_{k}_f32", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/flash_attention_f32.cu",
         "replaces": replaces[k],
         "launches": counts_f32[k] + counts_sp_f32[k] + counts_tp_f32[k],
         "launches_by_phase": {"f32_path": counts_f32[k], "seq_parallel": counts_sp_f32[k],
                               "tensor_parallel": counts_tp_f32[k]},
         **table_f32[k]}
        for k in ("fwd", "dkv", "dq")] + [
        {"name": f"{k}_component", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/attention_components.cu",
         "replaces": replaces[k], "launches": comp_counts[k],
         "launches_by_phase": {"roofline": comp_counts[k]},
         "max_abs_err": comp_err[k], **comp_table[k]}
        for k in ("qk", "pv", "softmax_chain", "bwd_chain")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
