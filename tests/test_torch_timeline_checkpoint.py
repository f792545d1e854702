"""Timeline, telemetry and checkpoint of bluefog_tpu_torch: the
``BLUEFOG_TIMELINE`` Chrome trace with the op, optimizer and train-step
spans; the counters with ``BFTPU_TELEMETRY`` on, against the JAX
package's for the same calls; ``record_win_ops`` on the telemetry op
stream; ``save`` / ``restore`` / ``restore_like`` / ``save_consensus`` /
``restore_broadcast``; and the registry-only cases of
tests/test_telemetry.py run against the port's copy of the package.
Values held against the reference within rtol 1e-6 (means in other
orders); counters and traces exactly."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import checkpoint as jckpt
from bluefog_tpu import telemetry as jtelemetry
from bluefog_tpu import windows as jwindows
from bluefog_tpu_torch import checkpoint, timeline, windows
from bluefog_tpu_torch import telemetry
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.telemetry import (
    LEDGER_COLLECTED,
    LEDGER_DEPOSITS,
    Registry,
    get_registry,
    merge_snapshots,
    to_prometheus,
)
from bluefog_tpu_torch.telemetry import rules as telemetry_rules
from bluefog_tpu_torch.telemetry.__main__ import main as telemetry_cli
from bluefog_tpu_torch.training import make_decentralized_train_step, replicate_for_mesh

torch.set_num_threads(1)
N = 8


@pytest.fixture
def port():
    tbf.init(size=N, local_size=2, device="cpu")
    yield
    tbf.shutdown()


def _mlp_step(steps_per_call=1, comm="neighbor_allreduce"):
    params = replicate_for_mesh({"w": torch.ones(4, 3) * 0.1}, N)
    ctx = tbf.context()
    return make_decentralized_train_step(
        lambda s, x: x @ s["w"], params, torch.optim.SGD(list(params.values()), lr=0.1),
        communication_type=CommunicationType[comm], plan=ctx.plan,
        machine_plan=ctx.machine_plan, steps_per_call=steps_per_call)


def _xy(lead=()):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=lead + (N, 5, 4)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, size=lead + (N, 5))))


# --------------------------------------------------------------------------
# timeline
# --------------------------------------------------------------------------


def test_timeline_file_holds_op_and_train_step_spans(port, tmp_path, monkeypatch):
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("BLUEFOG_TIMELINE", str(path))
    monkeypatch.setattr(timeline, "_writer", None)
    x = torch.ones(N, 3)
    tbf.neighbor_allreduce(x)
    tbf.allreduce(x)
    tbf.allgather(x)
    tbf.hierarchical_neighbor_allreduce(x)
    tbf.win_create(x, "tl")
    tbf.win_put(x, "tl")
    tbf.win_update("tl")
    tbf.win_free("tl")
    _mlp_step()(*_xy())
    assert tbf.timeline_start_activity("epoch")
    assert tbf.timeline_end_activity("epoch")
    assert not tbf.timeline_end_activity("never_started")
    with tbf.timeline_context("user_span"):
        pass
    timeline._writer.flush()
    doc = json.loads(path.read_text())
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"neighbor_allreduce", "allreduce", "allgather", "hierarchical_neighbor_allreduce",
            "win_put", "win_update", "train_step", "optimizer_step_atc_neighbor_allreduce",
            "custom/epoch", "user_span"} <= names
    # the first span starts before the writer exists (it is made at the
    # first span's end), so its ts is negative on the writer's clock
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0
    (step,) = [ev for ev in doc["traceEvents"] if ev["name"] == "train_step"]
    (opt,) = [ev for ev in doc["traceEvents"]
              if ev["name"] == "optimizer_step_atc_neighbor_allreduce"]
    assert step["ts"] <= opt["ts"] and opt["ts"] + opt["dur"] <= step["ts"] + step["dur"]


def test_timeline_off_writes_nothing(port, monkeypatch):
    monkeypatch.delenv("BLUEFOG_TIMELINE", raising=False)
    monkeypatch.setattr(timeline, "_writer", None)
    tbf.neighbor_allreduce(torch.ones(N, 2))
    assert timeline._writer is None
    assert not tbf.timeline_start_activity("x")


def test_spans_reach_the_torch_profiler(port):
    """The same spans are ``torch.profiler`` ranges named ``bluefog/<op>``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tbf.neighbor_allreduce(torch.ones(N, 2))
        _mlp_step()(*_xy())
    names = {e.key for e in prof.key_averages()}
    assert {"bluefog/neighbor_allreduce", "bluefog/train_step",
            "bluefog/optimizer_step_atc_neighbor_allreduce"} <= names


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------


@pytest.fixture
def telemetry_on(tmp_path, monkeypatch):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


def _counters(reg):
    return {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
            for c in reg.snapshot()["counters"]}


def _drive_optimizers(bf, make_atc, make_winput):
    """Three ATC steps and three win-put steps (k = 2), then a window round."""
    make_atc(3)
    make_winput(3)
    x = (torch.ones if bf is tbf else jnp.ones)((N, 3))
    bf.win_create(x, "tc")
    bf.win_put(x, "tc")
    bf.win_update("tc")
    bf.win_free("tc")


def test_counters_match_reference(devices, telemetry_on):
    """``optim.steps{optimizer, comm}``, ``optim.gossip_rounds`` and
    ``win_ops.total{op}`` read the same on both packages for the same
    calls."""
    def port_atc(steps):
        w = torch.zeros(N, 3, requires_grad=True)
        opt = tbf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([w], lr=0.1))
        for _ in range(steps):
            w.grad = torch.ones_like(w)
            opt.step()

    def port_winput(steps):
        w = torch.zeros(N, 3, requires_grad=True)
        opt = tbf.DistributedWinPutOptimizer(torch.optim.SGD([w], lr=0.1),
                                             num_steps_per_communication=2)
        for _ in range(steps):
            w.grad = torch.ones_like(w)
            opt.step()
        opt.free()

    def jax_atc(steps):
        opt = jbf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1))
        params = {"w": jnp.zeros((N, 3))}
        state = opt.init(params)
        for _ in range(steps):
            params, state = opt.step(params, {"w": jnp.ones((N, 3))}, state)

    def jax_winput(steps):
        opt = jbf.DistributedWinPutOptimizer(optax.sgd(0.1), num_steps_per_communication=2)
        params = {"w": jnp.zeros((N, 3))}
        state = opt.init(params)
        for _ in range(steps):
            params, state = opt.step(params, {"w": jnp.ones((N, 3))}, state)
        opt.free()

    tbf.init(size=N, local_size=2, device="cpu")
    jbf.init(local_size=2)
    try:
        _drive_optimizers(tbf, port_atc, port_winput)
        _drive_optimizers(jbf, jax_atc, jax_winput)
        got, want = _counters(get_registry()), _counters(jtelemetry.get_registry())
    finally:
        tbf.shutdown()
        jbf.shutdown()
    assert got == want
    assert got[("optim.steps", (("comm", "neighbor_allreduce"), ("optimizer", "atc")))] == 3
    assert got[("optim.steps", (("optimizer", "winput"),))] == 3
    assert got[("optim.gossip_rounds", (("optimizer", "winput"),))] == 1
    assert got[("win_ops.total", (("op", "win_put"),))] == 1


def test_train_steps_counter_counts_sub_steps(port, telemetry_on):
    """``train.steps``: +1 a call, +k a call with ``steps_per_call=k``."""
    _mlp_step()(*_xy())
    _mlp_step(steps_per_call=2)(*_xy((2,)))
    got = _counters(get_registry())
    assert got[("train.steps", ())] == 3
    # the port's train step runs the eager optimizer, which counts its steps
    assert got[("optim.steps", (("comm", "neighbor_allreduce"), ("optimizer", "atc")))] == 3


def test_record_win_ops_listens_on_the_op_stream(devices, port):
    """The trace of ``record_win_ops`` comes through the telemetry listener,
    nested recorders share it, and it equals the reference's."""
    from bluefog_tpu_torch.telemetry import registry as treg

    def drive(bf, win, x):
        with win.record_win_ops() as outer:
            bf.win_create(x, "r")
            with win.record_win_ops() as inner:
                bf.win_put(x, "r")
            bf.win_update("r")
            win.note_win_op("win_get", "elsewhere")
            bf.win_free()
        assert inner is outer
        return outer

    jbf.init(local_size=2)
    try:
        want = drive(jbf, jwindows, jnp.ones((N, 2)))
    finally:
        jbf.shutdown()
    got = drive(tbf, windows, torch.ones(N, 2))
    assert got == want == [("win_create", "r"), ("win_put", "r"), ("win_update", "r"),
                           ("win_get", "elsewhere"), ("win_free", "*")]
    assert windows._op_log_listener not in treg._op_listeners
    tbf.win_create(torch.ones(N, 2), "after")
    assert got[-1] == ("win_free", "*")


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(1)
    return {"w": torch.from_numpy(rng.normal(size=(N, 3, 2)).astype(np.float32)),
            "layers": [torch.from_numpy(rng.normal(size=(N, 4)).astype(np.float32)).bfloat16(),
                       (torch.arange(N * 2, dtype=torch.int32).view(N, 2),)],
            "step": torch.tensor(7)}


def test_save_restore_all(port, tmp_path):
    tree = _tree()
    path = str(tmp_path / "all.pt")
    checkpoint.save(path, tree)
    back = checkpoint.restore(path)
    assert isinstance(back["layers"], list) and isinstance(back["layers"][1], tuple)
    for got, want in zip(tbf.ops.tree_flatten(back)[0], tbf.ops.tree_flatten(tree)[0]):
        assert got.dtype == want.dtype and got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        checkpoint.save(path, tree, mode="some")


def test_rank0_restore_broadcast(port, tmp_path):
    tree = _tree()
    path = str(tmp_path / "r0.pt")
    checkpoint.save(path, tree, mode="rank0")
    assert checkpoint.restore(path)["w"].shape == (3, 2)
    back = checkpoint.restore_broadcast(path)
    assert back["w"].shape == tree["w"].shape and back["step"].item() == 7
    for r in range(N):
        torch.testing.assert_close(back["w"][r], tree["w"][0], rtol=0, atol=0)
        torch.testing.assert_close(back["layers"][1][0][r], tree["layers"][1][0][0],
                                   rtol=0, atol=0)
    back["w"][1] += 1  # every rank's copy is its own
    assert not torch.equal(back["w"][0], back["w"][1])


def test_restore_like_takes_the_templates_dtypes(port, tmp_path):
    tree = _tree()
    path = str(tmp_path / "like.pt")
    checkpoint.save(path, tree)
    like = tbf.ops.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float64), tree)
    back = checkpoint.restore_like(path, like)
    for got, want in zip(tbf.ops.tree_flatten(back)[0], tbf.ops.tree_flatten(tree)[0]):
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want.double(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_like(path, {"w": tree["w"]})
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore_like(path, {"x": tree["w"], "layers": tree["layers"],
                                       "step": tree["step"]})


def test_save_consensus_matches_reference(devices, port, tmp_path):
    """The same numpy tree through the JAX package's ``save_consensus`` ->
    ``restore`` and the port's: the mean over ranks, float32 for int."""
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(N, 3, 2)).astype(np.float32),
            "n": np.arange(N * 3, dtype=np.int32).reshape(N, 3)}
    jbf.init(local_size=2)
    try:
        jckpt.save_consensus(str(tmp_path / "jax_ck"), {k: jnp.asarray(v) for k, v in tree.items()})
        want = jckpt.restore(str(tmp_path / "jax_ck"))
    finally:
        jbf.shutdown()
    checkpoint.save_consensus(str(tmp_path / "port.pt"),
                              {k: torch.from_numpy(v) for k, v in tree.items()})
    got = checkpoint.restore(str(tmp_path / "port.pt"))
    for k in tree:
        assert str(got[k].dtype).replace("torch.", "") == str(np.asarray(want[k]).dtype)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


# --------------------------------------------------------------------------
# the registry-only cases of tests/test_telemetry.py, on the port's copy
# --------------------------------------------------------------------------


def test_disabled_by_default_is_null(monkeypatch):
    monkeypatch.delenv("BFTPU_TELEMETRY", raising=False)
    telemetry.reset()
    reg = get_registry()
    assert not reg.enabled
    reg.counter("x").inc()
    reg.gauge("g").set(1.0)
    reg.histogram("h").observe(0.5)
    reg.journal("ev", a=1)
    assert reg.write_snapshot() is None
    telemetry.reset()


def test_counter_thread_safety_concurrent_writers():
    reg = Registry(out_dir=None, rank=0, job="t")
    c = reg.counter("hits")
    threads, per = 8, 2000

    def pound(i):
        for _ in range(per):
            c.inc()
            reg.counter("hits.labeled", worker=i).inc()

    ts = [threading.Thread(target=pound, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == threads * per
    labeled = sum(e["value"] for e in reg.snapshot()["counters"] if e["name"] == "hits.labeled")
    assert labeled == threads * per


def test_counter_rejects_negative():
    with pytest.raises(ValueError):
        Registry(out_dir=None).counter("c").add(-1)


def test_histogram_bucket_edges():
    reg = Registry(out_dir=None)
    h = reg.histogram("h", buckets=[1.0, 2.0])
    for v in (0.5, 1.0, 1.5, 2.0, 3.0):
        h.observe(v)
    (entry,) = [e for e in reg.snapshot()["histograms"] if e["name"] == "h"]
    assert entry["buckets"] == [1.0, 2.0]
    assert entry["counts"] == [2, 2, 1]
    assert entry["sum"] == pytest.approx(8.0)


def test_snapshot_passes_schema_rule_and_roundtrips(tmp_path):
    reg = Registry(out_dir=str(tmp_path), rank=3, job="t")
    reg.counter("tcp.round_trips", op="write").add(7)
    reg.histogram("tcp.rtt_s").observe(1e-3)
    snap = json.load(open(reg.write_snapshot()))
    assert telemetry_rules.check_snapshot_schema(snap) == []
    reg.counter("tcp.round_trips", op="write").add(1)
    later = reg.snapshot()
    assert telemetry_rules.check_counters_monotone([snap, later]) == []
    assert telemetry_rules.check_counters_monotone([later, snap])


def _fake_rank_snapshots(tmp_path, nranks=4):
    for r in range(nranks):
        reg = Registry(out_dir=str(tmp_path), rank=r, job="merge")
        reg.counter(LEDGER_DEPOSITS).add(10)
        reg.counter(LEDGER_COLLECTED).add(10)
        reg.counter("tcp.bytes_sent").add(1000 * (r + 1))
        reg.gauge("optim.k").set(float(r))
        reg.histogram("win.op_s", buckets=[0.001, 0.01]).observe(0.005)
        reg.write_snapshot()


def test_merge_cli_4rank_corpus(tmp_path):
    _fake_rank_snapshots(tmp_path)
    out = tmp_path / "merged.json"
    assert telemetry_cli([str(tmp_path), "--format", "both", "--out", str(out), "--check"]) == 0
    merged = json.load(open(out))
    assert merged["ranks"] == [0, 1, 2, 3]
    assert merged["ledger"]["balanced"] and merged["ledger"]["deposits"] == 40
    sent = [c for c in merged["counters"] if c["name"] == "tcp.bytes_sent"]
    assert sent[0]["value"] == 10000
    prom = open(str(out) + ".prom").read()
    assert "# TYPE bftpu_tcp_bytes_sent counter" in prom
    assert "bftpu_tcp_bytes_sent 10000" in prom
    assert 'le="+Inf"' in prom and 'agg="max"' in prom


def test_merge_cli_unbalanced_corpus_check_fails(tmp_path):
    reg = Registry(out_dir=str(tmp_path), rank=0, job="bad")
    reg.counter(LEDGER_DEPOSITS).add(5)
    reg.counter(LEDGER_COLLECTED).add(3)
    reg.write_snapshot()
    assert telemetry_cli([str(tmp_path), "--check"]) == 1


def test_prometheus_exposition_histogram_cumulative():
    reg = Registry(out_dir=None, rank=0, job="t")
    h = reg.histogram("lat", buckets=[1.0, 2.0])
    for v in (0.5, 1.5, 5.0):
        h.observe(v)
    text = to_prometheus(merge_snapshots([reg.snapshot()]))
    assert 'bftpu_lat_bucket{le="1.0"} 1' in text
    assert 'bftpu_lat_bucket{le="2.0"} 2' in text
    assert 'bftpu_lat_bucket{le="+Inf"} 3' in text
    assert "bftpu_lat_count 3" in text


def test_timeline_counter_events_roundtrip(tmp_path):
    path = str(tmp_path / "trace.json")
    w = timeline.TimelineWriter(path)
    w.record("win_put", w.now_us(), 120.0)
    w.record_counter("bftpu/tcp.round_trips", w.now_us(), 3.0)
    w.record_counter("bftpu/tcp.round_trips", w.now_us(), 7.0)
    w.flush()
    phases = {}
    for ev in json.load(open(path))["traceEvents"]:
        phases.setdefault(ev["ph"], []).append(ev)
    assert phases.get("X")
    counters = phases.get("C")
    assert counters and len(counters) == 2
    assert counters[-1]["args"]["value"] == 7.0
    assert counters[0]["name"] == "bftpu/tcp.round_trips"


def test_registry_samples_counters_into_timeline():
    class FakeWriter:
        def __init__(self):
            self.events = []

        def now_us(self):
            return 1.0

        def record_counter(self, name, ts_us, value):
            self.events.append((name, ts_us, value))

    reg = Registry(out_dir=None, rank=0, job="t", timeline_sampling=True)
    fake = FakeWriter()
    reg._timeline_writer = lambda: fake
    reg.counter("shm.deposits").inc()
    reg.snapshot()
    assert any(name.endswith("shm.deposits") and value == 1.0 for name, _, value in fake.events)
