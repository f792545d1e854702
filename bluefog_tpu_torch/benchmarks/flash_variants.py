"""Block shape and ring depth of the Hopper flash kernels, by measurement.

The forward and dK/dV kernels of ``csrc/flash_attention.cu`` fix at compile
time how many consumer warpgroups of 64 rows share a block and how deep
their TMA rings are.  This script builds copies of the source with other
values (one nvcc each, side by side, into ``bluefog_tpu_torch/_build/``),
binds each like the package's own library, and times the forward and dK/dV
of every build on the same inputs at the roofline's ``path`` and ``134m``
shapes, by CUDA-graph replay, the builds taken in turns over ``ROUNDS``
rounds (the least time of each kept).  The ``chosen`` build is the source
as it stands.

    python -m bluefog_tpu_torch.benchmarks.flash_variants

prints one JSON line.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from typing import Dict
from unittest import mock

import torch

from bluefog_tpu_torch.benchmarks.attention_roofline import SHAPES, flash_inputs, nvidia_smi
from bluefog_tpu_torch.kernels import _build
from bluefog_tpu_torch.profiling import graph_seconds

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")

# name -> {source pattern: replacement}; "chosen" is the source as it stands
VARIANTS: Dict[str, Dict[str, str]] = {
    "chosen": {},
    "fwd_stages_3": {r"kFwdStages = \d+;": "kFwdStages = 3;"},
    "fwd_stages_6": {r"kFwdStages = \d+;": "kFwdStages = 6;"},
    "dkv_stages_4": {r"kDkvStages = \d+;": "kDkvStages = 4;"},
    # one consumer warpgroup (64 rows a block), two blocks a SM
    "one_consumer": {r"kConsumers = \d+;": "kConsumers = 1;",
                     r"kConsumerRegs = \d+;": "kConsumerRegs = 232;",
                     r"__launch_bounds__\(kSm90Threads, 1\)":
                         "__launch_bounds__(kSm90Threads, 2)"},
}
ROUNDS = 3
TIMED_SHAPES = ("path", "134m")


def variant_source(subs: Dict[str, str]) -> str:
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    for pattern, repl in subs.items():
        src, n = re.subn(pattern, repl, src)
        if not n:
            raise ValueError(f"pattern {pattern!r} not in flash_attention.cu")
    return src


def build_variant(name: str) -> ctypes.CDLL:
    """Compile one variant beside the package's build and bind it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"flash_variant_{name}.cu")
    out = os.path.join(_build.BUILD_DIR, f"libflash_variant_{name}.so")
    with open(src, "w") as f:
        f.write(variant_source(VARIANTS[name]))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return fa.bind(ctypes.CDLL(out))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1

    def try_build(name):
        try:
            return build_variant(name)
        except RuntimeError as err:  # a variant the compiler refuses is a result
            return str(err)[-2000:]

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(try_build, VARIANTS)))
    libs = {v: lib for v, lib in built.items() if not isinstance(lib, str)}
    if "chosen" not in libs:
        raise RuntimeError(f"the source as it stands does not build: {built['chosen']}")
    inputs = {s: flash_inputs(SHAPES[s]) for s in TIMED_SHAPES}
    best: Dict[str, Dict[str, float]] = {v: {} for v in VARIANTS}
    occ, outputs = {}, {}
    for vname, lib in libs.items():  # each build's outputs at the path shape
        q, k, v, g, lse, corr = inputs["path"]
        kw = dict(scale=q.shape[-1] ** -0.5, causal=True)
        with mock.patch.object(fa, "_lib", lambda lib=lib: lib):
            outputs[vname] = (fa.flash_fwd(q, k, v, **kw)[0],
                              *fa.flash_dkv(q, k, v, g, lse, corr, **kw))
    diff = {v: max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(out, outputs["chosen"])) for v, out in outputs.items()}
    for _ in range(ROUNDS):
        for vname, lib in libs.items():
            with mock.patch.object(fa, "_lib", lambda lib=lib: lib):
                occ[vname] = {k: fa.occupancy(k, 64) for k in ("fwd", "dkv")}
                for sname, (q, k, v, g, lse, corr) in inputs.items():
                    kw = dict(scale=q.shape[-1] ** -0.5, causal=True)
                    for kname, fn in (
                            ("fwd", lambda: fa.flash_fwd(q, k, v, **kw)),
                            ("dkv", lambda: fa.flash_dkv(q, k, v, g, lse, corr, **kw))):
                        ms = graph_seconds(fn, calls=20) * 1e3
                        key = f"{sname}_{kname}_ms"
                        best[vname][key] = min(best[vname].get(key, ms), ms)
    print(json.dumps({
        "metric": "flash fwd / dK/dV ms per build variant (CUDA-graph replay, least of "
                  f"{ROUNDS} rounds in turns)",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi(),
        "variants": {v: ({"subs": VARIANTS[v], **best[v], "occupancy": occ[v],
                          "max_abs_diff_vs_chosen": diff[v]} if v in libs
                         else {"subs": VARIANTS[v], "build_error": built[v]})
                     for v in VARIANTS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
