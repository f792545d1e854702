"""The benchmark twins of bluefog_tpu_torch (``benchmarks/llama.py``,
``attention.py``, ``attention_fwd_ab.py``, ``llama_decompose.py``,
``peaks.py``) and the estimators they share: ``robust_min`` and
``throughput_range`` against ``bench.py``'s on the reference test's cases
(``tests/test_bench_estimator.py:95-116``), the peaks harness's contract
(``tests/test_peaks.py:19-34``), one JSON line from each script at toy
sizes with ``--device cpu`` (``tests/test_examples_smoke.py:90``), and no
script without a card and without ``--device cpu`` runs (each exits
non-zero).  The numbers a CPU run prints are host numbers; only their
keys and counts are checked here."""

import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from bluefog_tpu_torch import profiling
from bluefog_tpu_torch.benchmarks import peaks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ["llama", "attention", "attention_fwd_ab", "llama_decompose", "peaks"]


# --------------------------------------------------------------------------
# the shared estimators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [[1.00, 1.02, 1.10], [0.80, 1.00, 1.01], [1.5], [1.0, 1.03],
                                [1.0, 1.031]])
def test_robust_min_is_bench_robust_min(ts, capsys):
    """The reproduced minimum stands; one not reproduced within 3% by the
    second smallest gives way to it, with a note on stderr."""
    got = profiling.robust_min(ts, "t")
    port_err = capsys.readouterr().err
    assert got == bench.robust_min(ts, "t")
    assert ("not reproduced" in port_err) == (got != min(ts))


def test_throughput_range_orders_lo_hi():
    lo, hi = profiling.throughput_range([0.5, 0.4, 0.45], scale=100.0)
    assert [lo, hi] == bench.throughput_range([0.5, 0.4, 0.45], 100.0) == [200.0, 250.0]


def test_measure_rtt_on_the_cpu_is_the_host_clock():
    assert 0.0 < profiling.measure_rtt(torch.ones(4)) < 0.1


# --------------------------------------------------------------------------
# peaks
# --------------------------------------------------------------------------


def test_matmul_peak_returns_contract_keys():
    out = peaks.matmul_peak(64, torch.float32, k_lo=2, k_hi=6, n=1, device="cpu")
    assert set(out) == {"tflops", "ms_per_matmul", "t_lo_s", "t_hi_s"}
    assert out["t_hi_s"] > 0 and out["t_lo_s"] > 0


def test_hbm_stream_returns_contract_keys_and_is_the_recurrence():
    out = peaks.hbm_stream(mb=2, k_lo=2, k_hi=6, n=1, device="cpu")
    assert set(out) == {"gbs", "ms_per_iter", "array_mb", "kernels_per_pass"}
    assert out["array_mb"] == 2.0 and out["kernels_per_pass"] is None  # counted on the card
    x = torch.linspace(-3.0, 3.0, 1000)
    want = 0.999 * x.double() + 0.5
    x.lerp_(torch.tensor(500.0), 0.001)  # one pass, as hbm_stream's
    np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_dispatch_cost_runs():
    assert peaks.dispatch_cost(n=2, device="cpu")["ms"] > 0


# --------------------------------------------------------------------------
# each script: one JSON line on the CPU, nothing without a card
# --------------------------------------------------------------------------

CPU_ARGS = {
    "llama": ["--preset", "tiny", "--iters", "3", "--passes", "2", "--warmup", "1",
              "--size", "2", "--seq", "64"],
    "attention": ["--seqs", "64", "--batch", "1", "--heads", "2", "--head-dim", "16",
                  "--iters", "4"],
    "attention_fwd_ab": ["--batch", "1", "--heads", "1", "--seq", "64", "--head-dim", "16",
                         "--chain", "2", "--group", "1", "--repeats", "1"],
    "llama_decompose": ["--preset", "tiny", "--rounds", "1"],
    "peaks": ["--quick"],
}
KEYS = {
    "llama": ("metric", "value", "unit", "vs_baseline", "estimator", "estimator_fallbacks",
              "range", "n_runs", "mfu_vs_989tf_bf16", "mfu_attn_incl", "peak_device_gb",
              "effective_attn"),
    "attention": ("metric", "value", "unit", "vs_baseline", "estimator_fallbacks", "by_seq"),
    "attention_fwd_ab": ("metric", "value", "unit", "vs_baseline", "cuda_ms", "xla_ms",
                         "sdpa_ms"),
    "llama_decompose": ("metric", "per_block_ms", "per_block_ideal_ms", "embed_head_ms",
                        "head_ideal_ms", "ideal_peaks_tf_s", "effective_attn"),
    "peaks": ("platform", "dispatch", "bf16_matmul_256", "f32_matmul_256", "hbm_stream"),
}


def _twin(name):
    return importlib.import_module(f"bluefog_tpu_torch.benchmarks.{name}")


@pytest.mark.parametrize("name", TWINS)
def test_each_twin_prints_one_json_line_on_the_cpu(name, capsys):
    assert _twin(name).main(CPU_ARGS[name] + ["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    assert "Infinity" not in lines[0] and "NaN" not in lines[0], lines[0]
    rec = json.loads(lines[0])
    for key in KEYS[name]:
        assert key in rec, (key, rec)
    if name == "llama":
        # a CPU run names no device metric
        assert rec["mfu_vs_989tf_bf16"] is None and rec["peak_device_gb"] is None
        assert rec["effective_attn"] == "plain versions (cpu)" and rec["n_runs"] == 2
        # warm-up and two passes of 1 + 3 steps, then the baseline's warm-up and one pass
        assert rec["steps"] == (1 + 2 * 4) + (1 + 4)
        # value (rounded to 0.1) is one pass's throughput, range (to 0.01) spans them
        assert rec["range"][0] - 0.05 <= rec["value"] <= rec["range"][1] + 0.05
    if name == "llama_decompose":
        assert rec["effective_attn"] == "flash (plain versions, cpu)"
        assert rec["ideal_peaks_tf_s"]["block"] == 989.0 and rec["per_block_gap_x"] is None


def test_llama_twin_runs_adafactor_on_the_blockwise_route(capsys):
    args = CPU_ARGS["llama"] + ["--device", "cpu", "--optimizer", "adafactor",
                                "--attn-impl", "xla", "--blocks", "32", "--fuse", "--passes", "1"]
    assert _twin("llama").main(args) == 0
    rec = json.loads(capsys.readouterr().out)
    assert (rec["optimizer"], rec["effective_attn"], rec["blocks"]) == \
        ("adafactor", "blockwise route (impl=xla)", 32)
    assert math.isfinite(rec["value"]) and rec["vs_baseline"] > 0


def test_llama_twin_flag_rules():
    with pytest.raises(SystemExit) as exc:  # a parser error, as the reference's
        _twin("llama").main(["--device", "cpu", "--preset", "tiny", "--remat-policy", "dots"])
    assert exc.value.code == 2
    with pytest.raises(ValueError, match="benchmarks.flash_variants"):
        _twin("llama").main(CPU_ARGS["llama"] + ["--device", "cpu", "--blocks", "32"])


@pytest.mark.parametrize("name", TWINS)
def test_each_twin_needs_the_card_unless_told_otherwise(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    assert _twin(name).main(CPU_ARGS[name]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_a_twin_process_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    proc = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.benchmarks.peaks",
                           "--quick"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == "" and "no CUDA device" in proc.stderr


def test_parallel_costs_needs_the_card(capsys):
    """``benchmarks/parallel_costs.py`` measures on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from bluefog_tpu_torch.benchmarks import parallel_costs

    assert parallel_costs.main(["--only", "ring"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_llama_pretrain_takes_adafactor():
    from bluefog_tpu_torch.examples import llama_pretrain

    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--device", "cpu", "--steps", "2", "--preset", "tiny", "--optimizer", "adafactor",
         "--seq", "64"]))
    assert out["optimizer"] == "adafactor"
    assert all(np.isfinite(out["losses"][-1])) and out["consensus_spread"] < 0.01


# --------------------------------------------------------------------------
# the import sweep reaches the new files
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rel", [f"benchmarks/{n}.py" for n in TWINS])
def test_the_import_sweep_walks_the_twins(rel):
    """``tests/test_torch_import.py`` imports every module with jax, optax,
    flax, networkx and the JAX package blocked, and parses every source
    for their imports: both walks reach each twin."""
    sweep = importlib.import_module("test_torch_import")
    path = os.path.join(sweep.PKG_DIR, rel)
    assert path in set(sweep._sources())
    assert "bluefog_tpu_torch." + rel[:-3].replace("/", ".") in sweep._modules()
