"""Counted roofline of the flash-attention kernels on one NVIDIA GPU.

Counterpart of ``benchmarks/attention_roofline.py``.  Each tile component
of the port's flash kernels (``csrc/flash_attention.cu``) is timed inside a
microkernel of its own (:mod:`bluefog_tpu_torch.kernels.attention_components`),
multiplied by the number of 64 x 64 tiles the kernels visit, and the two
bands

    serial  = tiles x (products + chain)      nothing overlaps
    overlap = tiles x max(products, chain)    tensor cores and chain side by side

are set against each flash kernel timed alone:

    fwd   1 qk + 1 pv products   + the softmax chain
    dkv   2 qk + 2 pv (S^T, dP^T; dV, dK)   + the backward chain with p in bf16
    dq    2 qk + 1 pv (S, dP; dQ)           + the backward chain with p in f32

``unexplained_pct`` is how far the measured time lies outside its band
(0 inside): above the serial edge is time no component accounts for.

A component's seconds per tile, device-wide: the microkernel runs with
enough dynamic shared memory reserved that no more blocks sit on an SM than
the flash kernel's do, on the flash kernel's grid rounded up to whole waves
of resident blocks (so its time holds no tail), and its launch time is
slope-timed over ``REPS[0]`` to ``REPS[2]`` repetitions and divided by the
tiles computed (``attention_components.TILES_PER_BLOCK`` a block).
``linearity`` is the slope over the upper half of the rep counts over the
slope over the lower half (1 when every repetition costs the same, well
below 1 if the compiler hoisted work out of the loop).  Each component
is timed once more with its product or chain removed, the dependency pass
alone (``dep_us``, ``dep_share``); the bands carry it, as the TPU's do.
The flash kernels pay no such pass, so every band, ``sched`` and
``longest_block`` is priced a second time without it (the ``_nodep``
fields): a component's tile then costs ``nodep_us = max(us - dep_us,
bound_us)``, floored at its bound because a dependency pass that overlaps
the work can leave ``us - dep_us`` near 0.

``*_pred_sched_ms`` adds the flash kernel's own tail to the serial edge: the
serial cost of each block's causal tiles, taken by the resident blocks in
launch order (``scheduled_ms`` over ``flash_attention.launch_order``, the
launchers' own order); ``*_unexplained_sched_pct`` is what the measurement
holds beyond that.  ``*_longest_block_ms`` is the serial cost of the block
with the most tiles at that same share of its SM: no schedule of these
blocks ends sooner.  ``*_longest_block_measured_ms`` times the kernel on the
rows of its longest blocks alone (``longest_block_calls``), replayed from a
CUDA graph: such a launch is shorter than its wrapper's host time, which
events around eager calls would time instead.

Every microkernel runs the flash kernels' own block: two consumer
warpgroups of 64 rows beside a producer, one block a SM; the products are
the same ``wgmma`` instructions on the same swizzled shared-memory layout,
the chains run on the accumulator's registers with ``ex2.approx``, as the
flash kernels do.  Each row says which tile each component times
(``tile_design``, ``component_tile``).  ``bound_us`` is the least time a
tile could take: the products' flops at the bf16 peak, and a chain's
instructions on the SM pipe they fill first (``bound_pipe``, see
:func:`tile_bound`).

Unlike the JAX script, nothing is subtracted from a measured time: the card
times each flash kernel alone, between CUDA events.  The script's
``BLUEFOG_FLASH_BWD_BLOCKS`` has no counterpart: the port's tile is fixed at
64 for every kernel (a forward or dK/dV block holds two such row tiles).

    python -m bluefog_tpu_torch.benchmarks.attention_roofline [--bwd] [--shapes 134m 1b path]

prints one JSON line.  Without a CUDA device it exits non-zero: the
roofline is a measurement of the card and has no CPU mode.
"""

from __future__ import annotations

import argparse
import heapq
import importlib
import json
import math
import re
import subprocess
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from bluefog_tpu_torch.kernels import _build
from bluefog_tpu_torch.kernels import attention_components as ac
from bluefog_tpu_torch.profiling import (conservative_delta, graph_seconds, paired_slope,
                                         timed_region)

# the package re-exports a function of the module's own name
fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")

SHAPES = {
    # the JAX script's two configurations (benchmarks/llama.py presets)
    "134m": dict(B=8, H=12, T=2048, D=64),
    "1b": dict(B=8, H=14, T=2048, D=128),
    # the main path: llama_pretrain "small", per-rank batch 2
    "path": dict(B=2, H=12, T=2048, D=64),
}
DEVICE = "cuda"  # the roofline measures the card; nothing here runs on the CPU
TILE = ac.TILE
REPS = (128, 512, 1024)  # slope between the ends; the middle checks linearity
ROUNDS = 3
MEASURE_ITERS = 20
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
# Instructions an SM pipe class issues a clock on compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions): f32 add, multiply and FMA 128; integer multiply-add,
# compare, min, max, shifts and bitwise operations 64; exp2 16.  The packed
# f32-to-bf16 conversion (F2FP) issues on the ALU (Nsight Compute's pipe
# descriptions) and is taken at that 64.  The f32 peak counts an FMA as two
# operations, so a pipe issues PEAK_F32_FLOPS / 2 x rate / 128 instructions
# a second, device-wide.
PIPE_RATES = {"fp32": 128, "alu": 64, "mufu": 16}
PIPE_OPS = {"fp32": ("FADD", "FMUL", "FFMA"),
            "alu": ("FMNMX", "F2FP", "SHF", "LOP3", "IMAD.U32"),
            "mufu": ("MUFU.EX2",)}
# Instructions an element and repetition of each chain on each pipe, as
# loop_pipe_counts reads them off the chain kernels' SASS
# (csrc/attention_components.cu, sm_90a, CUDA 12.8; test_torch_cuda.py
# recounts them on the card).
CHAIN_PIPES = {
    ("softmax_chain", False): {"fp32": 5.1875, "alu": 2.8125, "mufu": 1.0},
    ("bwd_chain", True): {"fp32": 5.0, "alu": 3.15625, "mufu": 1.0},
    ("bwd_chain", False): {"fp32": 5.0, "alu": 1.65625, "mufu": 1.0},
}


def loop_pipe_counts(sass: str, elements: int = 32) -> Dict[str, float]:
    """Instructions an element on each pipe (:data:`PIPE_OPS`) in the
    longest loop of one kernel's SASS (``cuobjdump -sass``): from the
    target of its longest backward branch to that branch, over the
    ``elements`` values a thread holds (32: a 64 x 64 tile on 128
    threads)."""
    ops, branches = [], []
    for m in re.finditer(r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)\s*([^;]*);", sass):
        addr, op = int(m.group(1), 16), m.group(3)
        ops.append((addr, op))
        target = re.match(r"0x([0-9a-f]+)", m.group(4))
        if op == "BRA" and m.group(2) and target and int(target.group(1), 16) < addr:
            branches.append((int(target.group(1), 16), addr))
    if not branches:
        raise ValueError("loop_pipe_counts: no backward branch in the SASS")
    lo, hi = max(branches, key=lambda b: b[1] - b[0])
    body = [op for addr, op in ops if lo <= addr <= hi]
    return {pipe: sum(op == name or op.startswith(name + ".") for op in body
                      for name in names) / elements
            for pipe, names in PIPE_OPS.items()}


MODELS = {  # flash kernel -> (qk products, pv products, (chain, its arguments))
    "fwd": (1, 1, ("softmax_chain", {})),
    "dkv": (2, 2, ("bwd_chain", {"cast_p": True})),
    "dq": (2, 1, ("bwd_chain", {"cast_p": False})),
}
WRAPPERS = {name: getattr(ac, f"{name}_component") for name in ac.PLAIN}
# What each flash kernel's tile runs on.
TILE_DESIGN = {
    "fwd": "wgmma m64n64k16 (S) + m64nDk16 (P.V, P from registers); TMA ring; "
           "2 consumer warpgroups, 128 query rows a block; longest first",
    "dkv": "wgmma m64n64k16 (S^T, dP^T) + m64nDk16 (dV, dK, A from registers); TMA "
           "ring; 2 consumer warpgroups, 128 keys a block; longest first",
    "dq": "wgmma m64n64k16 (S, dP) + m64nDk16 (dQ += dS.K, A from registers, K read "
          "MN-major); TMA ring; 2 consumer warpgroups, 128 query rows a block; longest first",
}
# What each microkernel's tile runs on (see the module docstring).
COMPONENT_TILE = {"qk": "wgmma, 2 consumer warpgroups", "pv": "wgmma, 2 consumer warpgroups",
                  "softmax_chain": "accumulator registers, ex2.approx, 2 consumer warpgroups",
                  "bwd_chain": "accumulator registers, ex2.approx, 2 consumer warpgroups"}


def tile_counts(T: int, tile: int = TILE, q_start: int = 0,
                k_start: int = 0) -> Tuple[int, int]:
    """``(interior, diagonal)`` 64 x 64 tiles per (batch, head) that the
    port's causal kernels visit for ``T`` queries and keys at global offsets
    ``q_start``/``k_start``: a tile is visited when some key in it is
    visible to some query in it (the kernels skip the rest); interior when
    every pair is visible, diagonal (masked) otherwise.  A ragged last tile
    counts as a whole one, as the kernels do its full work."""
    n = -(-T // tile)
    interior = diagonal = 0
    for qi in range(n):
        q_first = q_start + qi * tile
        q_last = q_start + min((qi + 1) * tile, T) - 1
        for kj in range(n):
            k_first = k_start + kj * tile
            k_last = k_start + min((kj + 1) * tile, T) - 1
            if k_first > q_last:
                continue
            if k_last <= q_first:
                interior += 1
            else:
                diagonal += 1
    return interior, diagonal


def block_tiles(T: int, kernel: str, tile: int = TILE) -> List[int]:
    """Tiles each 64-row slab of one (batch, head) computes, in slab order:
    a query slab of the forward or dQ walks the key tiles up to the
    diagonal, a key slab of dK/dV the query tiles from it.  Counted from
    :func:`flash_attention.launch_order`, whose forward and dK/dV blocks
    hold two slabs each.  Offsets 0; a ragged last tile counts whole."""
    blocks, _ = fa.launch_order(kernel, T, T)
    own = 1 if kernel == "dkv" else 0  # the slab index in a (query, key) pair
    per_slab = [0] * -(-T // tile)
    for _, tiles in blocks:
        for pair in tiles:
            per_slab[pair[own]] += 1
    return per_slab


def scheduled_ms(tiles_per_block: Sequence[int], slots: int, tile_s: float) -> float:
    """Milliseconds until the last block ends when ``slots`` resident
    blocks take the kernel's blocks in launch order (``launch_order``) and a
    block costs its tiles x ``tile_s`` x ``slots`` (``tile_s`` is
    device-wide, so one slot takes ``slots`` times as long).  Against ``tiles x tile_s`` it adds
    what the causal imbalance and the last, partial wave cost."""
    finish = [0.0] * slots
    for n in tiles_per_block:
        heapq.heapreplace(finish, finish[0] + n * tile_s * slots)
    return max(finish) * 1e3


def _band_gap(meas, overlap, serial):
    """How far the measurement sits OUTSIDE the [overlap, serial] band
    (0 if inside)."""
    if meas > serial:
        return (meas - serial) / serial
    if meas < overlap:
        return (meas - overlap) / overlap
    return 0.0


def tile_bound(name: str, d: int, cast_p: bool = False) -> Tuple[float, str]:
    """``(us, pipe)``: the least time the card could take for one tile of a
    component, and what binds it.  qk and pv: tensor-core flops at the bf16
    peak (``"tensor"``).  A chain (its operands never leave the SM): on
    each pipe, its instructions (:data:`CHAIN_PIPES`) over the pipe's
    device-wide rate; the slowest pipe binds."""
    if name in ("qk", "pv"):
        return 2 * TILE * TILE * d / PEAK_BF16_FLOPS * 1e6, "tensor"
    per_pipe = {pipe: n * TILE * TILE / (PEAK_F32_FLOPS / 2 * PIPE_RATES[pipe] / 128) * 1e6
                for pipe, n in CHAIN_PIPES[name, cast_p].items()}
    pipe = max(per_pipe, key=per_pipe.get)
    return per_pipe[pipe], pipe


def component_inputs(d: int, seed: int = 0) -> Dict[str, tuple]:
    """Random operands on the card, one tile each (the JAX script draws
    standard normals, and 0.1 x normal scores)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    bf = torch.bfloat16
    return {"qk": (rnd(TILE, d).to(bf), rnd(d, TILE).to(bf)),
            "pv": (rnd(TILE, TILE).to(bf), rnd(TILE, d).to(bf)),
            "softmax_chain": (rnd(TILE, TILE) * 0.1,),
            "bwd_chain": (rnd(TILE, TILE) * 0.1, rnd(TILE, TILE) * 0.1)}


def matched_smem(name: str, kw: dict, d: int, flash: Dict[str, int]) -> int:
    """Dynamic shared memory a block for microkernel ``name``: the flash
    kernel's, raised until no more blocks sit on an SM than the flash
    kernel's (whose registers may hold it below what its shared memory
    allows)."""
    def occ(smem):
        return ac.occupancy(name, d=d, smem_bytes=smem, **kw)["blocks_per_sm"]

    target, lo, hi = flash["blocks_per_sm"], flash["smem"], ac.MAX_SMEM
    if occ(lo) <= target:
        return lo
    if occ(hi) > target:
        return hi  # cannot be held that low
    while hi - lo > 16:  # occ(lo) > target >= occ(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if occ(mid) > target else (lo, mid)
    return hi


def whole_waves(grid: int, slots: int) -> int:
    """The smallest multiple of ``slots`` that is at least ``grid``."""
    return -(-grid // slots) * slots


def component_seconds(launch, tiles: int) -> Tuple[float, float]:
    """``(seconds per tile device-wide, linearity)`` of ``launch(reps)``,
    which enqueues one launch that computes ``tiles`` tiles (blocks x
    tiles a block); NaN when the slope is not positive in any round."""
    lo, mid, hi = REPS
    launch(lo)
    torch.cuda.synchronize()

    def t(reps):
        return timed_region(lambda: launch(reps), cuda=True)

    smalls, mids, bigs = [], [], []
    for _ in range(ROUNDS):
        smalls.append(t(lo))
        mids.append(t(mid))
        bigs.append(t(hi))
    delta = conservative_delta(smalls, bigs)
    lower = (min(mids) - min(smalls)) / (mid - lo)
    upper = (min(bigs) - min(mids)) / (hi - mid)
    if delta is None or lower <= 0:
        return math.nan, math.nan
    return delta / (hi - lo) / tiles, upper / lower


def measured_seconds(fn, label: str) -> Tuple[float, bool]:
    """Per-call seconds of ``fn()`` (one flash kernel launch), paired-slope
    timed between CUDA events; ``(seconds, used_fallback)``."""
    fn()
    torch.cuda.synchronize()

    def region(n):
        def run():
            for _ in range(n):
                fn()
        return timed_region(run, cuda=True)

    # events carry no host round trip, so the fallback subtracts nothing
    return paired_slope(region, MEASURE_ITERS, label, lambda: 0.0, repeats=ROUNDS)


def flash_inputs(cfg, seed: int = 1):
    """(q, k, v, dO, lse, corr) for one flash call at ``cfg``, on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bh, t, d = cfg["B"] * cfg["H"], cfg["T"], cfg["D"]
    q, k, v, g = (torch.randn(bh, t, d, generator=gen, device=DEVICE)
                  .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, scale=d ** -0.5, causal=True)
    corr = (torch.randn(bh, t, generator=gen, device=DEVICE)
            - (o.float() * g.float()).sum(-1)).contiguous()
    return q, k, v, g, lse, corr


def longest_block_calls(q, k, v, g, lse, corr, kw) -> Dict[str, object]:
    """Each flash kernel run on the rows of its longest blocks alone (one
    block a head: the last 128 query rows for the forward and dQ, the first
    128 keys for dK/dV), so its time is one longest block's, whatever the
    schedule.  Every kernel holds one block a SM, so this is also that
    block's time inside the full launch."""
    t = q.shape[1]
    q0 = -(-t // 128) * 128 - 128   # first row of the last 128-row block

    def rows(x, r0):
        return x[:, r0:].contiguous()

    fwd_in = (rows(q, q0), k, v, q0, 0)
    dkv_in = (q, k[:, :128].contiguous(), v[:, :128].contiguous(), g, lse, corr, 0, 0)
    dq_in = (rows(q, q0), k, v, rows(g, q0), rows(lse, q0), rows(corr, q0), q0, 0)
    return {"fwd": lambda: fa.flash_fwd(*fwd_in, **kw),
            "dkv": lambda: fa.flash_dkv(*dkv_in, **kw),
            "dq": lambda: fa.flash_dq(*dq_in, **kw)}


def band_fields(kname: str, comps: Dict[str, dict], cost: str, suffix: str, tiles: int,
                per_block: Sequence[int], slots: int, measured_ms: float) -> Dict[str, float]:
    """Flash kernel ``kname``'s bands priced at each component's ``cost``
    (``"us"``, or ``"nodep_us"`` without the dependency pass), under names
    ending in ``suffix``: the overlap and serial edges over ``tiles``, the
    schedule of ``per_block`` tiles on ``slots`` resident blocks, the
    longest block, and how far ``measured_ms`` lies outside the band."""
    n_qk, n_pv, (chain, _) = MODELS[kname]
    products = n_qk * comps["qk"][cost] + n_pv * comps["pv"][cost]
    chain_us = comps[chain][cost]
    overlap = tiles * max(products, chain_us) * 1e-3
    serial = tiles * (products + chain_us) * 1e-3
    tile_s = (products + chain_us) * 1e-6
    return {f"{kname}_pred_overlap{suffix}_ms": overlap,
            f"{kname}_pred_serial{suffix}_ms": serial,
            f"{kname}_pred_sched{suffix}_ms": scheduled_ms(per_block, slots, tile_s),
            f"{kname}_longest_block{suffix}_ms": max(per_block) * tile_s * slots * 1e3,
            f"{kname}_unexplained{suffix}_pct": _band_gap(measured_ms, overlap, serial) * 100}


def roofline_row(name: str, cfg: Dict[str, int], *, bwd: bool) -> dict:
    """Components, bands, measured times and gaps at one shape."""
    B, H, T, D = cfg["B"], cfg["H"], cfg["T"], cfg["D"]
    bh = B * H
    interior, diagonal = tile_counts(T)
    tiles = bh * (interior + diagonal)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = component_inputs(D)
    kernels = ("fwd", "dkv", "dq") if bwd else ("fwd",)

    flash, comps, per_block = {}, {}, {}
    for kname in kernels:
        occ = fa.occupancy(kname, D)
        blocks, rows = fa.launch_order(kname, T, T, bh=bh)
        per_block[kname] = [len(tiles) for _, tiles in blocks]
        grid = len(blocks)
        flash[kname] = {**occ, "grid": grid, "block_rows": rows,
                        "waves": grid / (occ["blocks_per_sm"] * sms)}
        chain, chain_kw = MODELS[kname][2]
        comps[kname] = {}
        for cname, kw in (("qk", {}), ("pv", {}), (chain, chain_kw)):
            smem = matched_smem(cname, kw, D, occ)
            o = ac.occupancy(cname, d=D, smem_bytes=smem, **kw)
            # whole waves: the last, partial wave is the flash kernel's
            # scheduling, which scheduled_ms models, not the component's cost
            blocks = whole_waves(grid, o["blocks_per_sm"] * sms)
            timed = {}
            for body in (True, False):
                def launch(reps, cname=cname, kw=kw, body=body, smem=smem, blocks=blocks):
                    return WRAPPERS[cname](*ops[cname], reps, body=body, blocks=blocks,
                                           smem_bytes=smem, **kw)
                timed[body] = component_seconds(launch, blocks * o["tiles_per_block"])
            if any(math.isnan(s) for s, _ in timed.values()):
                return {"shape": name, "invalid": True,
                        "reason": f"{kname} {cname}: slope not positive in any round"}
            (s, lin), (s_dep, _) = timed[True], timed[False]
            bound_us, pipe = tile_bound(cname, D, **kw)
            comps[kname][cname] = {
                "us": s * 1e6, "dep_us": s_dep * 1e6, "dep_share": s_dep / s,
                "nodep_us": max(s - s_dep, bound_us * 1e-6) * 1e6,
                "linearity": lin, "bound_us": bound_us, "bound_pipe": pipe, "blocks": blocks,
                "tiles_per_block": o["tiles_per_block"], "blocks_per_sm": o["blocks_per_sm"],
                "smem": smem, "regs": o["regs"], "component_tile": COMPONENT_TILE[cname]}

    q, k, v, g, lse, corr = flash_inputs(cfg)
    kw = dict(scale=D ** -0.5, causal=True)
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v, **kw),
             "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, corr, **kw),
             "dq": lambda: fa.flash_dq(q, k, v, g, lse, corr, **kw)}
    longest = longest_block_calls(q, k, v, g, lse, corr, kw)
    row = {"shape": name, **cfg, "grid": {k: flash[k]["grid"] for k in kernels},
           "tiles": tiles, "tiles_per_bh": {"interior": interior, "diagonal": diagonal},
           "flash": flash, "components": comps,
           "tile_design": {k: TILE_DESIGN[k] for k in kernels},
           "component_tile": {c: COMPONENT_TILE[c] for k in kernels for c in comps[k]}}
    for kname in kernels:
        meas, fb = measured_seconds(calls[kname], f"roofline-{name}-{kname}")
        meas_longest = graph_seconds(longest[kname])
        slots = flash[kname]["blocks_per_sm"] * sms
        for cost, suffix in (("us", ""), ("nodep_us", "_nodep")):
            row.update(band_fields(kname, comps[kname], cost, suffix, tiles,
                                   per_block[kname], slots, meas * 1e3))
        sched = row[f"{kname}_pred_sched_ms"]
        row.update({
            f"{kname}_longest_block_measured_ms": meas_longest * 1e3,
            f"{kname}_unexplained_sched_pct": max(0.0, meas * 1e3 - sched) / sched * 100,
            f"{kname}_measured_ms": meas * 1e3,
            f"{kname}_estimator_fallbacks": int(fb)})
    # the JAX script's field names
    row.update({"qk_us": comps["fwd"]["qk"]["us"], "pv_us": comps["fwd"]["pv"]["us"],
                "vpu_us": comps["fwd"]["softmax_chain"]["us"],
                "pred_overlap_ms": row["fwd_pred_overlap_ms"],
                "pred_serial_ms": row["fwd_pred_serial_ms"],
                "measured_ms": row["fwd_measured_ms"],
                "unexplained_pct": row["fwd_unexplained_pct"],
                "estimator_fallbacks": row["fwd_estimator_fallbacks"]})
    if bwd:
        ov = row["dkv_pred_overlap_ms"] + row["dq_pred_overlap_ms"]
        se = row["dkv_pred_serial_ms"] + row["dq_pred_serial_ms"]
        me = row["dkv_measured_ms"] + row["dq_measured_ms"]
        row.update({"bwd_vpu_dkv_us": comps["dkv"]["bwd_chain"]["us"],
                    "bwd_vpu_dq_us": comps["dq"]["bwd_chain"]["us"],
                    "bwd_pred_overlap_ms": ov, "bwd_pred_serial_ms": se,
                    "bwd_measured_ms": me,
                    "bwd_unexplained_pct": _band_gap(me, ov, se) * 100,
                    "bwd_estimator_fallbacks": row["dkv_estimator_fallbacks"]
                    + row["dq_estimator_fallbacks"]})
    return row


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


READING = ("measured inside [overlap, serial] = the time is accounted for by "
           "component throughput; above serial = time no component accounts "
           "for, worth hunting; below overlap = the model under-counts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=["134m", "1b"], choices=sorted(SHAPES))
    ap.add_argument("--bwd", action="store_true",
                    help="also model and measure the dK/dV and dQ kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_roofline: no CUDA device; the roofline measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 1
    build_s = _build.build_all(["flash_attention", "attention_components"])
    rows = [roofline_row(n, SHAPES[n], bwd=args.bwd) for n in args.shapes]
    print(json.dumps({
        "metric": "flash counted roofline (component rates x tile counts vs "
                  "measured, same run)",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi(),
        "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
        "rows": rows, "reading": READING}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
