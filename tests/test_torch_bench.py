"""``bluefog_tpu_torch/bench.py``, the twin of the repo root's ``bench.py``:
its stdout contract (one line of strict JSON, the twin of
``tests/test_examples_smoke.py::test_bench_emits_strict_json``), the
headline's key set against the keys ``bench.py`` writes (read from its
source), two steps of each communication mode from the same JAX weights
against the reference's ``build``, and ``--trend`` against the reference's
``trend_main`` on synthetic corpora.  CPU numbers are host numbers; only
keys, counts and losses are checked."""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
import bluefog_tpu as jbf
import chip_smoke
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.models import ResNet18 as JaxResNet18
from bluefog_tpu.optim import CommunicationType as JaxComm
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch import bench, topology_util
from bluefog_tpu_torch.benchmarks import gossip_bandwidth, island_overlap, recovery, serving
from bluefog_tpu_torch.interop.jax_weights import resnet_state_dict
from bluefog_tpu_torch.models import ResNet18
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import replicate_for_mesh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the keys bench.py's main writes into its headline, in source order, read
# from its source
REFERENCE_KEYS = chip_smoke.reference_headline_keys(REPO)


# --------------------------------------------------------------------------
# the stdout contract
# --------------------------------------------------------------------------


@pytest.mark.parametrize("max_passes", [1, 4], ids=["degenerate-single-pass", "adaptive"])
def test_bench_emits_strict_json(max_passes):
    """Exactly one line of strict JSON with the required keys; one pass
    prints spread 0.0 (never ``Infinity``); the session ceiling is there.
    A budget of 0 s skips every optional phase and every extra pass."""
    # one thread, as this file's in-process runs (see test_torch_cost.py)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", BENCH_STEPS="2",
               BENCH_WARMUP="1",
               BENCH_MAX_PASSES=str(max_passes), BENCH_BUDGET_S="0")
    proc = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.bench", "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, proc.stdout
    rec = chip_smoke._strict_json(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "spread_pct", "passes"):
        assert key in rec, rec
    assert rec["schema"] == "bftpu-bench/1"
    assert rec["passes"] <= max_passes
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert "8 virtual ranks" in rec["metric"]
    if max_passes == 1:
        assert rec["spread_pct"] == 0.0
    assert "session_ceiling_img_s" in rec and "ratio_to_session_ceiling" in rec, rec
    # the optional phases were skipped: only the unconditional keys
    assert set(rec) == set(REFERENCE_KEYS[:REFERENCE_KEYS.index("ratio_to_session_ceiling") + 1])


def test_bench_without_a_card_fails_and_prints_nothing():
    """The card is the default: without one the run fails before any line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.bench"], env=env,
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode != 0 and not proc.stdout.strip()


# --------------------------------------------------------------------------
# the headline's key set, with every measure function stubbed
# --------------------------------------------------------------------------


class _Stub(dict):
    """A twin's result that has every field."""

    def __missing__(self, key):
        return 1.0


STUBBED = [
    (gossip_bandwidth, "measure_rank_major"), (gossip_bandwidth, "measure_islands"),
    (gossip_bandwidth, "measure_island_protocol"),
    (gossip_bandwidth, "measure_telemetry_overhead"),
    (gossip_bandwidth, "measure_tracing_overhead"),
    (gossip_bandwidth, "measure_statuspage_overhead"),
    (gossip_bandwidth, "measure_lab_probe_overhead"),
    (gossip_bandwidth, "measure_monitor_overhead"),
    (recovery, "measure_recovery"), (recovery, "measure_join"),
    (recovery, "measure_partition"), (recovery, "measure_straggler"),
    (island_overlap, "measure_overlap_hidden"), (gossip_bandwidth, "measure_tcp_chunked"),
    (serving, "measure_publish_swap"), (serving, "measure_serve_rate"),
    (serving, "measure_load"), (serving, "measure_distrib"),
    (gossip_bandwidth, "measure_wire_compression"),
]


def _stub_twins(mp):
    """Every twin the optional phases call, replaced by a recorder, and
    the knobs of a short run (4 ranks) with every phase in its budget."""
    calls = {}
    for mod, name in STUBBED:
        def stub(*args, _name=name, **kwargs):
            calls[_name] = (args, kwargs)
            return _Stub()

        mp.setattr(mod, name, stub)
    for k, v in dict(BENCH_STEPS="2", BENCH_WARMUP="1", BENCH_MAX_PASSES="4",
                     BENCH_BUDGET_S="1e9", BENCH_RANKS="4").items():
        mp.setenv(k, v)
    return calls


@pytest.fixture
def stubbed(monkeypatch):
    return _stub_twins(monkeypatch)


@pytest.fixture(scope="module")
def stubbed_run():
    """One ``bench.run`` with every twin stubbed, shared by the tests that
    read its headline: (the headline as ``main`` prints it, stderr, the
    twins' calls)."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _stub_twins(mp)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rec = bench.run("cpu")
    return json.loads(json.dumps(rec)), err.getvalue(), calls


def test_headline_keys_are_the_references(stubbed_run):
    """With every phase run, the headline holds exactly the keys
    ``bench.py:654-805`` writes, in its order; the adaptive loop ran its 4
    passes; each twin was called once, on the run's device where it takes
    one, the rank-major bandwidth with the reference's CPU payload."""
    rec, _, stubbed = stubbed_run
    assert list(rec) == REFERENCE_KEYS
    assert rec["passes"] == 4
    assert set(stubbed) == {name for _, name in STUBBED}
    assert stubbed["measure_rank_major"][0] == (4, 4.0, 10, 2, "exp2", "cpu")
    for name in ("measure_lab_probe_overhead", "measure_monitor_overhead", "measure_recovery",
                 "measure_join", "measure_partition", "measure_straggler",
                 "measure_overlap_hidden", "measure_publish_swap", "measure_serve_rate",
                 "measure_load", "measure_distrib"):
        assert stubbed[name][1]["device"] == "cpu", name
    assert stubbed["measure_overlap_hidden"][1] == dict(nprocs=2, rounds=10, mb=16.0, inner=8,
                                                        device="cpu")


def test_a_phase_that_raises_leaves_out_its_keys(stubbed, monkeypatch, capfd):
    """As the reference: the failure goes to stderr, the other keys stay."""
    def boom(**kwargs):
        raise RuntimeError("no mailbox")

    monkeypatch.setattr(recovery, "measure_join", boom)
    monkeypatch.setenv("BENCH_MAX_PASSES", "1")
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capfd.readouterr()
    rec = json.loads(out.strip())
    assert "join phase failed: RuntimeError('no mailbox')" in err
    assert list(rec) == [k for k in REFERENCE_KEYS if not k.startswith("join_")]


def test_chip_smoke_gate_reads_the_headline(stubbed_run):
    """``chip_smoke.headline_problems`` (phase ``bench_headline``'s gate)
    passes a whole headline, passes one whose last phases the budget
    skipped, and fails a failed phase, a phase with part of its keys, a
    key from outside the reference, too many passes, and a win_put
    bandwidth phase that the budget skipped (the headline's second metric
    is required)."""
    rec, err, _ = stubbed_run
    gate = lambda r, e, passes=4: chip_smoke.headline_problems(  # noqa: E731
        r, e, REFERENCE_KEYS, passes, chip_smoke.check)
    assert gate(rec, err) == []
    cut = {k: v for k, v in rec.items() if not k.startswith("wire_")}
    skip = err + "bench: wire compression phase skipped: the budget of 1 s is spent\n"
    assert gate(cut, skip) == ["wire compression"]
    no_bw = {k: v for k, v in rec.items() if not k.startswith("win_put_")}
    bw_skip = err + "bench: spmd bandwidth phase skipped: the budget of 1 s is spent\n"
    bad = [(cut, err), (rec, err + "join phase failed: RuntimeError('x')\n"),
           ({k: v for k, v in rec.items() if k != "join_metric"}, err),
           ({**rec, "extra_key": 1.0}, err), (rec, err, 3), (no_bw, bw_skip),
           ({**rec, "win_put_gossip_bandwidth_gbs": 0.0}, err)]
    for case in bad:
        with pytest.raises(AssertionError):
            gate(*case)


# --------------------------------------------------------------------------
# the train steps against the reference's build
# --------------------------------------------------------------------------

N = 4
# bf16 compute on both sides, convolutions accumulated in another order
# (XLA's CPU convolution and oneDNN's): the 2-step losses (~2.3) differ by
# up to 2.1e-3 relative on this case, under one bf16 ulp (3.9e-3 to 7.8e-3
# relative); the bound leaves 5x
BF16_RTOL = 1e-2


def _reference_losses(comm, jm, v, x, y):
    jbf.init(devices=jax.devices()[:N])
    try:
        jbf.set_topology(jtu.ExponentialTwoGraph(N))
        ctx = jbasics.context()
        params = jax_replicate(jax.tree_util.tree_map(jnp.asarray, v["params"]), N)
        stats = jax_replicate(jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), N)
        plan = ctx.plan if comm == "neighbor_allreduce" else None
        step, opt_state = ref_bench.build(JaxComm[comm], jm, ctx.mesh, plan, x, y, params, stats)
        losses = []
        for _ in range(2):
            params, stats, opt_state, loss, _ = step(params, stats, opt_state, jnp.asarray(x),
                                                     jnp.asarray(y, jnp.int32))
            losses.append(np.asarray(loss))
        return np.stack(losses)
    finally:
        jbf.shutdown()


@pytest.mark.parametrize("comm", ["neighbor_allreduce", "allreduce"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_steps_match_the_reference_build(comm, dtype):
    """ResNet-18 (small images, 8 filters), 4 ranks x batch 2, from the
    same JAX weights: per-rank losses of two steps, rtol 1e-4 in f32 and
    ``BF16_RTOL`` at the bench's bf16; ``reset`` returns the phase to its
    first step exactly."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 2, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(N, 2))
    jm = JaxResNet18(num_classes=10, num_filters=8, small_images=True, dtype=jdt)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]),
                                                   train=True))
    want = _reference_losses(comm, jm, v, x, y)

    tbf.init(topology_util.ExponentialTwoGraph(N), size=N, device="cpu")
    try:
        model = ResNet18(num_classes=10, num_filters=8, small_images=True, dtype=tdt,
                         device="cpu")
        model.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]))
        params = replicate_for_mesh(dict(model.named_parameters()), N, requires_grad=False)
        stats = replicate_for_mesh(dict(model.named_buffers()), N, requires_grad=False)
        plan = tbf.context().plan if comm == "neighbor_allreduce" else None
        step, reset = bench.build(CommunicationType[comm], model, plan, params, stats)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        got = np.stack([step(xt, yt)[0].numpy() for _ in range(2)])
        reset()
        again = np.stack([step(xt, yt)[0].numpy() for _ in range(2)])
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "f32" else BF16_RTOL)
    np.testing.assert_array_equal(again, got)
    assert not np.array_equal(got[0], got[1])  # the step trained


# --------------------------------------------------------------------------
# --trend against the reference's
# --------------------------------------------------------------------------


def _write(d, name, doc):
    with open(os.path.join(d, name), "w") as f:
        f.write(doc if isinstance(doc, str) else json.dumps(doc))


def _parsed(r, **vals):
    return {"round": r, "n": 1, "rc": 0, "parsed": vals}


def _per_headline(**vals):
    return {k: {"value": v, "unit": "x"} for k, v in vals.items()}


CORPORA = {
    "parsed_ok": [_parsed(1, value=100.0, recovery_ms=50.0),
                  _parsed(2, value=95.0, recovery_ms=55.0)],
    "per_headline_ok": [_per_headline(value=100.0, join_ms=10.0),
                        _per_headline(value=101.0, join_ms=9.0),
                        _per_headline(value=99.0, join_ms=10.0)],
    "higher_regressed": [_parsed(1, value=100.0), _parsed(2, value=120.0),
                         _parsed(3, value=70.0)],
    "lower_regressed": [_per_headline(publish_swap_ms=10.0), _per_headline(publish_swap_ms=13.0)],
    "key_missing": [_parsed(1, value=100.0), _parsed(2, tcp_chunked_gbps=1.0),
                    _parsed(3, value=90.0, tcp_chunked_gbps=0.9, serve_rate_steps_s=7.0)],
    "unreadable": [_parsed(1, value=100.0), "{not json", _parsed(3, value=85.0)],
    "one_record": [_parsed(1, value=100.0)],
    "mixed_and_old_priors": [_parsed(1, value=300.0), _parsed(2, value=100.0),
                             _per_headline(value=101.0), _parsed(4, value=102.0),
                             _per_headline(value=82.0, distrib_all_swap_ms=3.0)],
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_trend_matches_reference(corpus, tmp_path, capsys):
    """Same exit code, same stdout lines, same stderr notes."""
    d = str(tmp_path)
    for i, doc in enumerate(CORPORA[corpus], start=1):
        _write(d, f"BENCH_r{i:02d}.json", doc)
    _write(d, "BENCH_rXX.json", {"value": 1.0})  # not a round: ignored by both
    rc_ref = ref_bench.trend_main(["--dir", d])
    ref_out = capsys.readouterr()
    rc = bench.trend_main(["--dir", d])
    out = capsys.readouterr()
    assert (rc, out.out.splitlines(), out.err) == (rc_ref, ref_out.out.splitlines(), ref_out.err)
    assert rc == (1 if corpus.endswith("regressed") else 0)


def test_trend_without_dir_reads_no_record(capsys):
    """The repo's BENCH_r*.json are the TPU's frozen rounds, no prior of
    the port: without --dir nothing is gated."""
    assert bench.trend_main([]) == 0
    assert capsys.readouterr().out == "trend: 0 frozen record(s) — nothing to gate\n"


def test_trend_cli(tmp_path):
    for i, doc in enumerate(CORPORA["higher_regressed"], start=1):
        _write(str(tmp_path), f"BENCH_r{i:02d}.json", doc)
    proc = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.bench", "--trend", "--dir",
                           str(tmp_path)], env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 1
    assert proc.stdout.splitlines()[-1].startswith("trend: FAIL")


# --------------------------------------------------------------------------
# the import sweep reaches the new file
# --------------------------------------------------------------------------


def test_the_import_sweep_walks_bench():
    """``tests/test_torch_import.py`` imports every module with the JAX
    stack blocked and parses every source for its imports: both walks
    reach ``bench.py``."""
    sweep = importlib.import_module("test_torch_import")
    assert os.path.join(sweep.PKG_DIR, "bench.py") in set(sweep._sources())
    assert "bluefog_tpu_torch.bench" in sweep._modules()
