"""Block shape and ring depth of the Hopper flash kernels, by measurement.

The flash kernels fix at compile time how many rows a block owns and how
deep their TMA rings are: ``csrc/flash_attention.cu`` (bf16: consumer
warpgroups of 64 rows) and ``csrc/flash_attention_f32.cu`` (f32: the
3xTF32 forward, dK/dV and dQ: warps of 16 rows, dK/dV's query rows and
dQ's keys a ring stage, ring depths; and ablations, each pricing one part
of a kernel).  This script
builds copies of one of the two sources with other values (one nvcc each,
side by side, into ``bluefog_tpu_torch/_build/``),
binds each like the package's own library, and times the forward, dK/dV
and dQ of every build on the same inputs by CUDA-graph replay, the builds
taken in turns over ``ROUNDS`` rounds (the least time of each kept).  The
bf16 builds run at the roofline's ``path`` and ``134m`` shapes, the f32
builds at [24, 2048, 64], [24, 2048, 128] and [32, 2048, 256], and both at
[32, 2048, 512], where the wide kernels above head dim 256 run (causal);
the ``wide_chunk_stages_*`` builds change those kernels' chunk ring.
The ``chosen`` build is the source as it stands; ``--source NAME=PATH``
adds a build of another copy of the file with the same C interface (say,
an earlier commit's), timed in the same turns.

    python -m bluefog_tpu_torch.benchmarks.flash_variants [--f32] [--source NAME=PATH]

prints one JSON line.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from typing import Dict, Optional
from unittest import mock

import torch

from bluefog_tpu_torch.benchmarks.attention_roofline import SHAPES, flash_inputs, nvidia_smi
from bluefog_tpu_torch.kernels import _build
from bluefog_tpu_torch.profiling import graph_seconds

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")

# mma_kmajor's B fragments, NB (four or two) n-tiles at a time (the source) or one
KMAJOR_B4 = """      for (int j0 = 0; j0 < N / 8; j0 += NB) {
        BFrag b0[NB], b1[NB];
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          const float4 v = lds4(b, b_rows, 8 * (j0 + jj) + g, ch);
          b0[jj] = {{split(v.x), split(v.y)}};
          b1[jj] = {{split(v.z), split(v.w)}};
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) mma_term(part, j0 + jj, a0, b0[jj], term);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) mma_term(part, j0 + jj, a1, b1[jj], term);
      }"""
KMAJOR_B1 = """      for (int j = 0; j < N / 8; ++j) {
        const float4 v = lds4(b, b_rows, 8 * j + g, ch);
        const BFrag b0 = {{split(v.x), split(v.y)}}, b1 = {{split(v.z), split(v.w)}};
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_term(part, j, a0, b0, term);
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_term(part, j, a1, b1, term);
      }"""

# name -> {source pattern: replacement}; "chosen" is the source as it stands
VARIANTS: Dict[str, Dict[str, str]] = {
    "chosen": {},
    "fwd_stages_3": {r"kFwdStages = \d+;": "kFwdStages = 3;"},
    "fwd_stages_6": {r"kFwdStages = \d+;": "kFwdStages = 6;"},
    "dkv_stages_4": {r"kDkvStages = \d+;": "kDkvStages = 4;"},
    "dq_stages_3": {r"kDqStages = \d+;": "kDqStages = 3;"},
    # the wide kernels' chunk ring (above D = 256)
    "wide_chunk_stages_2": {r"kChunkStages = \d+": "kChunkStages = 2"},
    "wide_chunk_stages_6": {r"kChunkStages = \d+": "kChunkStages = 6"},
    # one consumer warpgroup (64 rows a block), two blocks a SM
    "one_consumer": {r"kConsumers = \d+;": "kConsumers = 1;",
                     r"kConsumerRegs = \d+;": "kConsumerRegs = 232;",
                     r"__launch_bounds__\(kSm90Threads, 1\)":
                         "__launch_bounds__(kSm90Threads, 2)"},
}
F32_VARIANTS: Dict[str, Dict[str, str]] = {
    "chosen": {},
    "wide_chunk_stages_2": {r"kChunkStages = \d+": "kChunkStages = 2"},
    "wide_chunk_stages_6": {r"kChunkStages = \d+": "kChunkStages = 6"},
    # rows a block: warps of 16 rows (two blocks of four warps share a SM)
    "fwd64_warps_8": {r"kFwdWarps64 = \d+": "kFwdWarps64 = 8"},
    "fwd128_warps_4": {r"kFwdWarps128 = \d+": "kFwdWarps128 = 4"},
    "dkv64_warps_8": {r"kDkvWarps64 = \d+": "kDkvWarps64 = 8"},
    "dkv128_warps_4": {r"kDkvWarps128 = \d+": "kDkvWarps128 = 4"},
    "dq64_warps_4": {r"kDqWarps64 = \d+": "kDqWarps64 = 4"},
    # three warps a SM sub-partition (168 registers a thread)
    "fwd64_warps_12": {r"kFwdWarps64 = \d+": "kFwdWarps64 = 12"},
    "fwd128_warps_12": {r"kFwdWarps128 = \d+": "kFwdWarps128 = 12"},
    # query rows a dK/dV stage, ring depths (a build whose shared memory
    # does not fit raises at launch, a result of its own)
    "dkv_qrows_64": {r"kDkvQRows = \d+": "kDkvQRows = 64"},
    "fwd_stages_3": {r"kFwdStages = \d+;": "kFwdStages = 3;"},
    "dkv_stages_3": {r"kDkvStages = \d+;": "kDkvStages = 3;"},
    "dq64_keys_32": {r"kDqKeys64 = \d+": "kDqKeys64 = 32"},
    "dq_stages_3": {r"kDqStages = \d+;": "kDqStages = 3;"},
    # dQ at D = 128: Q and dO of eight warps take 128 KB, so eight warps
    # with a 2-stage ring of 64-key K/V tiles (256 KB) do not fit; the
    # layouts that do, all 192 KB: four warps (64 rows) with 64-key stages,
    # eight warps with 32-key stages, eight warps with one 64-key stage
    "dq128_warps_4_keys_64": {r"kDqWarps128 = \d+": "kDqWarps128 = 4",
                              r"kDqKeys128 = \d+": "kDqKeys128 = 64"},
    "dq128_keys_64_stages_1": {r"kDqKeys128 = \d+": "kDqKeys128 = 64",
                               r"kDqStages = \d+;": "kDqStages = 1;"},
    # D = 256: a 64-row block's Q (or dQ's Q + dO, dK/dV's K + V) takes 64
    # (128) KB, so the stages are short; the layouts beside the chosen one
    # that fit the 227 KB a block may hold: the forward as 4 warps with 32-
    # or 16-key stages, dQ with two 16-key stages or one 32-key stage, dK/dV
    # as 32 keys with 32-row stages or one 32-row stage (the other ring
    # depths: the *_stages_3 builds above)
    "fwd256_warps_4_keys_32": {r"kFwdWarps256 = \d+": "kFwdWarps256 = 4",
                               r"kFwdKeys256 = \d+": "kFwdKeys256 = 32"},
    "fwd256_warps_4": {r"kFwdWarps256 = \d+": "kFwdWarps256 = 4"},
    "dq256_stages_2": {r"kDqStages256 = \d+;": "kDqStages256 = 2;"},
    "dq256_keys_32_stages_1": {r"kDqKeys256 = \d+": "kDqKeys256 = 32",
                               r"kDqStages256 = \d+;": "kDqStages256 = 1;"},
    "dkv256_keys_32_qrows_32": {r"kDkvKeys256 = \d+": "kDkvKeys256 = 32",
                                r"kDkvQRows256 = \d+": "kDkvQRows256 = 32"},
    "dkv256_qrows_32_stages_1": {r"kDkvQRows256 = \d+": "kDkvQRows256 = 32",
                                 r"kDkvStages = \d+;": "kDkvStages = 1;"},
    # ablations: each computes another function (max_abs_diff_vs_chosen
    # says how far); its time prices the part it leaves out
    "ablate_split": {re.escape('asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));'):
                         "big = __float_as_uint(x);",
                     re.escape("return {big, __float_as_uint(x - __uint_as_float(big))};"):
                         "return {big, 0u};"},
    "ablate_small_products": {re.escape("for (int term = 0; term < 3; ++term)"):
                                "for (int term = 2; term < 3; ++term)"},
    "ablate_fwd_softmax": {r"online_softmax\(sc,[^;]*;": "alpha[0] = alpha[1] = 1.f;"},
    "ablate_fwd_pv": {r"mma_mnmajor<D, N>\(acc, sc, sk \+ L::kKV[^;]*;": ""},
    "ablate_dq_dp": {r"mma_kmajor<D, N>\(dp,[^;]*;": ""},
    # K-major products, tried against dQ's spills at D = 128: each B
    # fragment formed one n-tile at a time (fewer live registers), and the
    # two small products summed in a partial of their own (a shorter chain
    # of truncating tensor-core sums at the partial's full size)
    "kmajor_one_ntile": {re.escape(KMAJOR_B4): KMAJOR_B1},
    "kmajor_small_partial": {
        re.escape("float part[N / 2];\n    zero(part);"):
            "float part[N / 2], fine[N / 2];\n    zero(part);\n    zero(fine);",
        r"mma_term\(part, j0 \+ jj, (a[01]), (b[01])\[jj\], term\)":
            r"mma_term(term < 2 ? fine : part, j0 + jj, \1, \2[jj], term)",
        re.escape("acc[c] += part[c];"): "acc[c] += part[c] + fine[c];"},
}
ROUNDS = 3
TIMED_SHAPES = ("path", "134m")
WIDE_SHAPE = dict(B=8, H=4, T=2048, D=512)  # [32, 2048, 512]: chip_smoke's hidden_route_wide
F32_SHAPES = {"d64": (24, 2048, 64), "d128": (24, 2048, 128), "d256": (32, 2048, 256),
              "d512": (32, 2048, 512)}
TYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "f16"}


def variant_source(subs: Dict[str, str], source: str = "flash_attention") -> str:
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        src = f.read()
    for pattern, repl in subs.items():
        src, n = re.subn(pattern, repl, src)
        if not n:
            raise ValueError(f"pattern {pattern!r} not in {source}.cu")
    return src


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """{kernel: {"registers": n, "spill_stores": bytes}} from nvcc's
    ``-Xptxas -v`` report, a kernel named with its element type and head
    dim where it has them ("dq_f32_kernel<128>", "fwd_kernel<bf16, 64>",
    "dkv_wide_kernel<f16>", "fwd_wide_f32_kernel")."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:fwd|dkv|dq)(?:_wide)?(?:_f32)?_kernel)"
                      r"(?:I(13__nv_bfloat16|6__half)?(?:Li(\d+)E)?)?", line)
        if m:
            params = [TYPE_NAMES.get(m.group(2)), m.group(3)]
            params = [p for p in params if p]
            name = f"{m.group(1)}<{', '.join(params)}>" if params else m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[name]["spill_stores"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def build_variant(name: str, src_text: str, prefix: str = "bf_flash"):
    """Compile one variant's source beside the package's build and bind it:
    (library, ptxas_summary of its build)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"flash_variant_{prefix}_{name}.cu")
    out = os.path.join(_build.BUILD_DIR, f"libflash_variant_{prefix}_{name}.so")
    with open(src, "w") as f:
        f.write(src_text)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return fa.bind(ctypes.CDLL(out), prefix=prefix), ptxas_summary(proc.stderr)


def f32_inputs(bh: int, t: int, d: int, seed: int = 1):
    """(q, k, v, dO, lse, corr) in f32 for one causal call at [bh, t, d]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(bh, t, d, generator=gen, device="cuda") for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, scale=d ** -0.5, causal=True)
    corr = (torch.randn(bh, t, generator=gen, device="cuda") - (o * g).sum(-1)).contiguous()
    return q, k, v, g, lse, corr


def _calls(q, k, v, g, lse, corr):
    kw = dict(scale=q.shape[-1] ** -0.5, causal=True)
    return {"fwd": lambda: fa.flash_fwd(q, k, v, **kw)[0],
            "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, corr, **kw),
            "dq": lambda: fa.flash_dq(q, k, v, g, lse, corr, **kw)}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--f32", action="store_true",
                        help="time flash_attention_f32.cu's builds (default: the bf16 file's)")
    parser.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                        help="also build and time this copy of the source file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    source, prefix, lib_attr = (("flash_attention_f32", "bf_flash_f32", "_lib_f32") if args.f32
                                else ("flash_attention", "bf_flash", "_lib"))
    variants = {name: variant_source(subs, source)
                for name, subs in (F32_VARIANTS if args.f32 else VARIANTS).items()}
    subs_of = dict(F32_VARIANTS if args.f32 else VARIANTS)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            variants[name] = f.read()
        subs_of[name] = {"source": path}

    def try_build(name):
        try:
            return build_variant(name, variants[name], prefix)
        except RuntimeError as err:  # a variant the compiler refuses is a result
            return str(err)[-2000:]

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = dict(zip(variants, pool.map(try_build, variants)))
    libs = {v: b[0] for v, b in built.items() if not isinstance(b, str)}
    ptxas = {v: b[1] for v, b in built.items() if not isinstance(b, str)}
    if "chosen" not in libs:
        raise RuntimeError(f"the source as it stands does not build: {built['chosen']}")
    shapes = F32_SHAPES if args.f32 else {**{s: SHAPES[s] for s in TIMED_SHAPES},
                                          "wide": WIDE_SHAPE}
    inputs = {s: f32_inputs(*shape) if args.f32 else flash_inputs(shape)
              for s, shape in shapes.items()}
    diff_shape = next(iter(inputs))
    best: Dict[str, Dict[str, float]] = {v: {} for v in variants}
    errors: Dict[str, Dict[str, str]] = {v: {} for v in variants}
    occ, outputs = {}, {}
    for vname, lib in libs.items():  # each build's outputs at the first shape
        with mock.patch.object(fa, lib_attr, lambda lib=lib: lib):
            try:
                outputs[vname] = [fn() for fn in _calls(*inputs[diff_shape]).values()]
            except RuntimeError as err:  # a build whose blocks do not fit the card
                errors[vname]["launch"] = str(err)
    diff = {v: max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(_flat(out), _flat(outputs["chosen"])))
            for v, out in outputs.items()}
    for _ in range(ROUNDS):
        for vname, lib in libs.items():
            if vname not in outputs:
                continue
            with mock.patch.object(fa, lib_attr, lambda lib=lib: lib):
                occ[vname] = ({f"{s}_{k}": _occupancy(k, x[0].shape[-1], torch.float32)
                               for s, x in inputs.items() for k in ("fwd", "dkv", "dq")}
                              if args.f32 else
                              {f"d{d}_{k}": _occupancy(k, d, torch.bfloat16)
                               for d in (64, WIDE_SHAPE["D"]) for k in ("fwd", "dkv", "dq")})
                for sname, x in inputs.items():
                    for kname, fn in _calls(*x).items():
                        key = f"{sname}_{kname}_ms"
                        try:
                            ms = graph_seconds(fn, calls=20) * 1e3
                        except RuntimeError as err:
                            errors[vname][key] = str(err)
                            continue
                        best[vname][key] = min(best[vname].get(key, ms), ms)
    shapes = {s: list(v) for s, v in shapes.items()}
    print(json.dumps({
        "metric": "flash fwd / dK/dV / dQ ms per build variant (CUDA-graph replay, least of "
                  f"{ROUNDS} rounds in turns)",
        "source": f"bluefog_tpu_torch/csrc/{source}.cu", "shapes": shapes,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi(),
        "variants": {v: ({"subs": subs_of[v], **best[v], "occupancy": occ.get(v),
                          "ptxas": ptxas[v],
                          "max_abs_diff_vs_chosen": diff.get(v), "errors": errors[v]}
                         if v in libs else {"subs": subs_of[v], "build_error": built[v]})
                     for v in variants}}), flush=True)
    return 0


def _occupancy(kernel, d, dtype):
    """fa.occupancy, or the error of a build whose block does not fit."""
    try:
        return fa.occupancy(kernel, d, dtype)
    except RuntimeError as err:
        return str(err)


def _flat(outs):
    """Every tensor of a list of wrapper results, tuples opened."""
    return [t for x in outs for t in (x if isinstance(x, tuple) else (x,))]


if __name__ == "__main__":
    sys.exit(main())
