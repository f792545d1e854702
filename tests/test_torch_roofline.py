"""The port's counted roofline and profiling estimators against the JAX
package's (``benchmarks/attention_roofline.py`` and the repo-root ``bench``
it imports) on the same numbers, tile counts against a brute-force count of
visible tiles, and the measurement path's refusal to run without a card."""

import importlib.util
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bluefog_tpu_torch import profiling
from bluefog_tpu_torch.benchmarks import attention_roofline as roof
from bluefog_tpu_torch.benchmarks import flash_variants
from bluefog_tpu_torch.kernels import attention_components as ac

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_script():
    """The JAX roofline script, loaded by path.  Importing it (and ``bench``)
    points JAX's persistent compilation cache at /tmp; both settings are put
    back so later tests in this worker compile as before."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_attention_roofline", os.path.join(REPO, "benchmarks", "attention_roofline.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return script


def _brute_tile_counts(T, tile, q_start, k_start):
    """Visible (query, key) pairs per 64 x 64 tile, counted pair by pair."""
    qpos = q_start + np.arange(T)
    kpos = k_start + np.arange(T)
    vis = kpos[None, :] <= qpos[:, None]
    interior = diagonal = 0
    for q0 in range(0, T, tile):
        for k0 in range(0, T, tile):
            block = vis[q0:q0 + tile, k0:k0 + tile]
            if block.all():
                interior += 1
            elif block.any():
                diagonal += 1
    return interior, diagonal


@pytest.mark.parametrize("T", [64, 128, 640, 2048])
def test_tile_counts_match_the_jax_script(jax_script, T):
    assert roof.tile_counts(T) == jax_script._tile_counts(T, 64)


def test_tile_counts_at_the_path_shape():
    interior, diagonal = roof.tile_counts(2048)
    assert (interior, diagonal) == (496, 32)
    cfg = roof.SHAPES["path"]
    assert cfg["B"] * cfg["H"] * (interior + diagonal) == 12672


@pytest.mark.parametrize("T,q_start,k_start", [
    (256, 0, 0), (1000, 0, 0), (200, 96, 0), (256, 0, 40), (130, 7, 3),
    (256, 0, 512), (192, 512, 0)])
def test_tile_counts_match_a_brute_force_count(T, q_start, k_start):
    assert roof.tile_counts(T, 64, q_start, k_start) == \
        _brute_tile_counts(T, 64, q_start, k_start)


@pytest.mark.parametrize("meas,overlap,serial", [
    (1.0, 0.5, 2.0), (3.0, 0.5, 2.0), (0.25, 0.5, 2.0), (2.0, 2.0, 2.0)])
def test_band_gap_matches_the_jax_script(jax_script, meas, overlap, serial):
    assert roof._band_gap(meas, overlap, serial) == \
        jax_script._band_gap(meas, overlap, serial)


@pytest.mark.parametrize("smalls,bigs", [
    ([1.0, 1.2, 0.9], [2.0, 2.5, 1.95]),   # clean rounds
    ([1.0, 3.0, 1.0], [2.0, 3.1, 2.2]),    # a stall in one small region
    ([2.0, 2.0], [1.0, 1.5]),              # no positive delta at all
    ([1.0], [1.0])])
def test_conservative_delta_matches_bench(jax_script, smalls, bigs):
    bench = sys.modules["bench"]
    assert profiling.conservative_delta(smalls, bigs) == \
        bench.conservative_delta(smalls, bigs)


def _fake_region(per_call, fixed, stall_every=0):
    """region(n) seconds: fixed cost + n calls, with a stall added to every
    ``stall_every``-th region."""
    calls = [0]

    def region(n):
        calls[0] += 1
        stall = 5.0 if stall_every and calls[0] % stall_every == 0 else 0.0
        return fixed + per_call * n + stall
    return region


@pytest.mark.parametrize("per_call,fixed,stall_every,iters,repeats", [
    (0.01, 0.2, 0, 20, 1), (0.01, 0.2, 2, 20, 3), (0.01, 0.2, 3, 20, 3),
    (-0.01, 0.2, 0, 20, 2),   # slope never positive: the RTT fallback
    (0.01, 0.2, 0, 1, 1)])    # iters too small to pair
def test_paired_slope_matches_bench(jax_script, capsys, per_call, fixed, stall_every,
                                    iters, repeats):
    bench = sys.modules["bench"]
    got = profiling.paired_slope(_fake_region(per_call, fixed, stall_every), iters,
                                 "t", lambda: 0.05, repeats=repeats)
    want = bench.paired_slope(_fake_region(per_call, fixed, stall_every), iters,
                              "t", lambda: 0.05, repeats=repeats)
    assert got == want


@pytest.mark.parametrize("total,rt,iters", [(1.0, 0.1, 10), (0.1, 0.1, 10)])
def test_subtract_rtt_matches_bench(jax_script, capsys, total, rt, iters):
    bench = sys.modules["bench"]
    assert profiling.subtract_rtt(total, rt, iters) == bench.subtract_rtt(total, rt, iters)


def test_slope_time_checks_its_span_and_runs_on_the_host_clock():
    with pytest.raises(ValueError, match="iters_hi"):
        profiling.slope_time(lambda: None, iters_lo=5, iters_hi=5)
    with pytest.raises(ValueError, match="iters_hi"):
        profiling.slope_time_fused(lambda x: x, torch.zeros(2), iters_lo=4, iters_hi=3)
    x = torch.ones(64, 64)
    assert np.isfinite(profiling.slope_time(torch.mm, (x, x), iters_lo=1, iters_hi=3))
    assert np.isfinite(profiling.slope_time_fused(lambda y: y * 0.5, x, iters_lo=1,
                                                  iters_hi=3))
    times = profiling.segment_times({"a": (torch.mm, (x, x)), "b": (torch.add, (x, x))},
                                    iters_lo=1, iters_hi=2, repeats=1)
    assert sorted(times) == ["a", "b"]


def test_roofline_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roof.main(["--bwd"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("T", [128, 1000, 2048])
@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_block_tiles_cover_the_visited_tiles(T, kernel):
    per_block = roof.block_tiles(T, kernel)
    assert len(per_block) == -(-T // 64)
    assert sum(per_block) == sum(roof.tile_counts(T))
    ordered = per_block if kernel != "dkv" else per_block[::-1]
    assert ordered == list(range(1, len(per_block) + 1))  # causal: 1, 2, ... tiles


def test_scheduled_ms_adds_the_tail_and_the_imbalance():
    # equal blocks on whole waves take tiles x tile_s
    assert roof.scheduled_ms([2] * 8, 4, 1e-3) == pytest.approx(8 * 2 * 1e-3 * 1e3)
    # one partial wave costs a whole block time
    assert roof.scheduled_ms([2] * 5, 4, 1e-3) == pytest.approx(2 * 2 * 4 * 1e-3 * 1e3)
    # a causal spread on one slot is its sum; on many, the longest block bounds it
    assert roof.scheduled_ms([1, 2, 3], 1, 1e-3) == pytest.approx(6.0)
    assert roof.scheduled_ms([1, 2, 3], 3, 1e-3) == pytest.approx(3 * 3 * 1e-3 * 1e3)
    assert roof.whole_waves(768, 660) == 1320 and roof.whole_waves(660, 660) == 660


@pytest.mark.parametrize("name", sorted(flash_variants.VARIANTS))
def test_every_flash_variant_rewrites_the_source(name):
    """Each variant's patterns are found in csrc/flash_attention.cu (a
    rename there would otherwise time the chosen build twice)."""
    src = flash_variants.variant_source(flash_variants.VARIANTS[name])
    assert ("kConsumers = 1;" in src) == (name == "one_consumer")
    if name == "chosen":
        with open(os.path.join(REPO, "bluefog_tpu_torch", "csrc", "flash_attention.cu")) as f:
            assert src == f.read()


@pytest.mark.parametrize("name", sorted(flash_variants.F32_VARIANTS))
def test_every_f32_flash_variant_rewrites_the_source(name):
    """Each f32 variant's patterns are found in csrc/flash_attention_f32.cu
    and change it; the chosen build is the file as it stands."""
    with open(os.path.join(REPO, "bluefog_tpu_torch", "csrc", "flash_attention_f32.cu")) as f:
        chosen = f.read()
    src = flash_variants.variant_source(flash_variants.F32_VARIANTS[name], "flash_attention_f32")
    assert (src == chosen) == (name == "chosen")


def test_ptxas_summary_reads_registers_and_spills_per_kernel():
    """nvcc's -Xptxas -v report, as it prints it for a variant build (the
    anonymous namespace's name carries the file's, here with "dq" in it)."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9a8d_36_flash_variant_"
        "bf_flash_f32_dq64_keys_32_cu_632a995813dq_f32_kernelILi128EEEv14CUtensorMap_st' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN55_GLOBAL__N__9a8d_dq_f32_kernelILi128E",
        "    104 bytes stack frame, 212 bytes spill stores, 204 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 104 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9a8d_13fwd_kernelEv' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ])
    assert flash_variants.ptxas_summary(log) == {
        "dq_f32_kernel<128>": {"spill_stores": 212, "registers": 255},
        "fwd_kernel": {"spill_stores": 0, "registers": 168}}


def test_tf32_mma_rate_refuses_to_run_without_a_card(monkeypatch, capsys):
    from bluefog_tpu_torch.benchmarks import tf32_mma_rate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tf32_mma_rate.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_flash_variants_refuse_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_variants.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def _fake_component_timing(monkeypatch, per_tile, dep_share):
    """Every microkernel launch timed as 3 us + reps x tiles x its per-tile
    seconds (x ``dep_share`` without the body), tiles = blocks x
    TILES_PER_BLOCK; returns the launches seen as (name, reps, body, blocks)."""
    seen = []

    def wrapper(name):
        def launch(*args, body, blocks, smem_bytes, **kw):
            seen.append((name, args[-1], body, blocks))
        return launch

    def timed_region(run, cuda):
        assert cuda
        run()
        name, reps, body, blocks = seen[-1]
        tiles = blocks * ac.TILES_PER_BLOCK[name]
        return 3e-6 + reps * tiles * per_tile[name] * (1.0 if body else dep_share)

    for name in ac.PLAIN:
        monkeypatch.setitem(roof.WRAPPERS, name, wrapper(name))
    monkeypatch.setattr(roof, "timed_region", timed_region)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return seen


PER_TILE = {"qk": 1.5e-9, "pv": 2e-9, "softmax_chain": 3e-9, "bwd_chain": 4e-9}


@pytest.mark.parametrize("name,blocks", [("qk", 396), ("pv", 3), ("softmax_chain", 396),
                                         ("bwd_chain", 5)])
def test_component_seconds_divides_the_slope_by_the_tiles(monkeypatch, name, blocks):
    """A launch of ``blocks`` blocks computes blocks x TILES_PER_BLOCK
    tiles; the per-tile time is the slope over reps divided by those."""
    seen = _fake_component_timing(monkeypatch, PER_TILE, 0.25)
    tiles = blocks * ac.TILES_PER_BLOCK[name]

    def launch(reps):
        roof.WRAPPERS[name](reps, body=True, blocks=blocks, smem_bytes=0)

    s, lin = roof.component_seconds(launch, tiles)
    assert s == pytest.approx(PER_TILE[name], rel=1e-6)
    assert lin == pytest.approx(1.0, rel=1e-6)
    assert {reps for _, reps, _, _ in seen} == set(roof.REPS)


# Fake tile bounds (us): pv's and bwd_chain's lie above 0.75 x their PER_TILE
# (us - dep_us at dep_share 0.25), so their no-dependency cost is the bound.
BOUND_US = {"qk": 1e-4, "pv": 1.8e-3, "softmax_chain": 1e-3, "bwd_chain": 3.5e-3}


@pytest.mark.parametrize("bwd", [False, True])
def test_roofline_row_prices_tiles_and_names_each_component_tile(monkeypatch, bwd):
    """roofline_row on fake timings and bounds (no card): each component's
    ``us`` and ``dep_us`` are per tile computed (two a block), its launch
    covers whole waves of the flash kernel's blocks, and the row names the
    tile each component times, once per component.  The second band pair
    prices a tile at max(us - dep_us, bound_us): overlap, serial, schedule,
    longest block and the measurement's gap, each from that cost."""
    seen = _fake_component_timing(monkeypatch, PER_TILE, 0.25)
    monkeypatch.setattr(roof, "tile_bound",
                        lambda name, d, cast_p=False: (BOUND_US[name], "fake"))
    sms, flash_smem = 3, 83016
    monkeypatch.setattr(roof, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(multi_processor_count=sms))
    monkeypatch.setattr(roof.fa, "occupancy", lambda kname, d: {
        "blocks_per_sm": 1, "smem": flash_smem, "regs": 168, "threads": 384})
    monkeypatch.setattr(roof.ac, "occupancy", lambda name, d=64, smem_bytes=0, **kw: {
        "blocks_per_sm": 1, "smem": smem_bytes, "regs": 168,
        "tiles_per_block": ac.TILES_PER_BLOCK[name]})
    monkeypatch.setattr(roof, "measured_seconds", lambda fn, label: (1e-4, False))
    monkeypatch.setattr(roof, "graph_seconds", lambda fn: 5e-5)
    cfg = dict(B=1, H=2, T=256, D=64)
    row = roof.roofline_row("tiny", cfg, bwd=bwd)
    kernels = ("fwd", "dkv", "dq") if bwd else ("fwd",)
    used = {"qk", "pv", "softmax_chain"} | ({"bwd_chain"} if bwd else set())
    assert row["component_tile"] == {c: roof.COMPONENT_TILE[c] for c in used}
    assert roof.COMPONENT_TILE["qk"] == roof.COMPONENT_TILE["pv"] == \
        "wgmma, 2 consumer warpgroups"
    for kname in kernels:
        grid = row["grid"][kname]
        for cname, c in row["components"][kname].items():
            assert c["component_tile"] == roof.COMPONENT_TILE[cname]
            assert c["tiles_per_block"] == ac.TILES_PER_BLOCK[cname]
            assert c["blocks"] == roof.whole_waves(grid, sms) and c["smem"] == flash_smem
            assert c["us"] == pytest.approx(PER_TILE[cname] * 1e6, rel=1e-6)
            assert c["dep_us"] == pytest.approx(0.25 * PER_TILE[cname] * 1e6, rel=1e-6)
            assert c["linearity"] == pytest.approx(1.0, rel=1e-6)
            nodep = max(0.75 * PER_TILE[cname] * 1e6, BOUND_US[cname])
            assert c["nodep_us"] == pytest.approx(nodep, rel=1e-6)
            assert c["bound_us"] == BOUND_US[cname] and c["bound_pipe"] == "fake"
        n_qk, n_pv, (chain, _) = roof.MODELS[kname]
        tile_us = n_qk * PER_TILE["qk"] * 1e6 + n_pv * PER_TILE["pv"] * 1e6 \
            + PER_TILE[chain] * 1e6
        assert row[f"{kname}_pred_serial_ms"] == pytest.approx(row["tiles"] * tile_us * 1e-3)
        # the floor holds pv and the backward chain at their bounds
        products = n_qk * 0.75 * PER_TILE["qk"] * 1e6 + n_pv * BOUND_US["pv"]
        chain_us = (0.75 * PER_TILE[chain] * 1e6 if chain == "softmax_chain"
                    else BOUND_US[chain])
        serial = row["tiles"] * (products + chain_us) * 1e-3
        overlap = row["tiles"] * max(products, chain_us) * 1e-3
        per_block = [len(t) for _, t in roof.fa.launch_order(kname, 256, 256, bh=2)[0]]
        tile_s = (products + chain_us) * 1e-6
        assert row[f"{kname}_pred_serial_nodep_ms"] == pytest.approx(serial)
        assert row[f"{kname}_pred_overlap_nodep_ms"] == pytest.approx(overlap)
        assert row[f"{kname}_pred_sched_nodep_ms"] == pytest.approx(
            roof.scheduled_ms(per_block, sms, tile_s))
        assert row[f"{kname}_longest_block_nodep_ms"] == pytest.approx(
            max(per_block) * tile_s * sms * 1e3)
        assert row[f"{kname}_unexplained_nodep_pct"] == pytest.approx(
            roof._band_gap(0.1, overlap, serial) * 100)
        assert row[f"{kname}_pred_serial_nodep_ms"] < row[f"{kname}_pred_serial_ms"]
    launched = {name for name, _, _, _ in seen}
    assert launched == used


@pytest.mark.parametrize("name,cast_p", sorted(roof.CHAIN_PIPES))
def test_chain_bound_is_the_slowest_pipe(name, cast_p):
    """A chain's tile bound: each pipe's instructions an element x 64 x 64
    over its device-wide rate (the f32 peak's FMA lanes, 128 a clock an SM,
    scaled to the pipe's rate); the largest binds and is named."""
    us, pipe = roof.tile_bound(name, 64, cast_p)
    per_pipe = {p: n * 64 * 64 / (67e12 / 2 * roof.PIPE_RATES[p] / 128) * 1e6
                for p, n in roof.CHAIN_PIPES[name, cast_p].items()}
    assert us == pytest.approx(max(per_pipe.values()), rel=1e-12)
    assert per_pipe[pipe] == us
    # one ex2 an element on the 16-wide MUFU pipe takes as long as 8 f32
    # instructions on the 128-wide FP32 pipe
    assert roof.PIPE_RATES["fp32"] == 8 * roof.PIPE_RATES["mufu"]


def test_tile_bound_names_the_pipe_that_binds(monkeypatch):
    monkeypatch.setitem(roof.CHAIN_PIPES, ("softmax_chain", False),
                        {"fp32": 16, "alu": 1, "mufu": 1})
    us, pipe = roof.tile_bound("softmax_chain", 64)
    assert pipe == "fp32" and us == pytest.approx(16 * 4096 / 33.5e12 * 1e6)
    monkeypatch.setitem(roof.CHAIN_PIPES, ("softmax_chain", False),
                        {"fp32": 4, "alu": 2, "mufu": 1})
    us, pipe = roof.tile_bound("softmax_chain", 64)
    assert pipe == "mufu" and us == pytest.approx(4096 / 4.1875e12 * 1e6)
    monkeypatch.setitem(roof.CHAIN_PIPES, ("softmax_chain", False),
                        {"fp32": 4, "alu": 5, "mufu": 1})
    us, pipe = roof.tile_bound("softmax_chain", 64)
    assert pipe == "alu" and us == pytest.approx(5 * 4096 / 16.75e12 * 1e6)
    for d in (64, 128):
        assert roof.tile_bound("qk", d) == (2 * 64 * 64 * d / 989e12 * 1e6, "tensor")


SASS_LOOP = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R3, R4 ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   FFMA R2, R3, 0.5, R4 ;
        /*0040*/                   MUFU.EX2 R5, R2 ;
        /*0050*/                   F2FP.BF16.F32.PACK_AB R6, R5, R2 ;
        /*0060*/                   IMAD.U32 R7, R6, 0x10000, RZ ;
        /*0070*/                   IMAD.SHL.U32 R8, R6, 0x2, RZ ;
        /*0080*/                   FMNMX R9, R7, R2, !PT ;
        /*0090*/               @P1 BRA 0x30 ;
        /*00a0*/                   FADD R2, R3, R4 ;
        /*00b0*/                   BRA 0xb0 ;
"""


def test_loop_pipe_counts_read_the_longest_loop():
    """Only the span of the longest backward branch counts (not the short
    retry loop before it, nor the trailing self-branch); IMAD.U32 (the
    bf16 widening) counts on the ALU, IMAD.SHL (addressing) nowhere."""
    got = roof.loop_pipe_counts(SASS_LOOP, elements=2)
    assert got == {"fp32": 0.5, "alu": 1.5, "mufu": 0.5}
    with pytest.raises(ValueError, match="backward branch"):
        roof.loop_pipe_counts("/*0000*/ FADD R1, R2, R3 ;")
