"""Port twin of ``tests/test_tracing.py``: the same cases against
``bluefog_tpu_torch``.  The per-rank buffers, flight rings, merge CLI and trace rules of
``bluefog_tpu_torch``; the cross-package cases are in
``tests/test_torch_tracing_cli.py``.

Distributed tracing: context words, flight ring, clock estimator,
the merge/critical-path pipeline, and the np=4 e2e + SIGKILL flight
recovery (docs/OBSERVABILITY.md, Tracing section).

The load-bearing contracts: (1) tracing OFF is a shared NullTracer whose
whole surface no-ops (the < 2% bench gate depends on it); (2) a trace
context deposited through any transport resolves on the consumer side to
the same ``(origin, op_id)`` identity, so every merged flow arrow has
both endpoints; (3) critical paths walk backwards only through spans
that completed earlier (up to clock error), so reported chains are
causally monotone; (4) the flight ring survives SIGKILL and names the
op that was open when the rank died.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util, tracing
from bluefog_tpu_torch.analysis import trace_rules
from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.tracing import (
    ClockEstimator,
    FlightRing,
    NullTracer,
    Tracer,
    critical_path,
    flow_index,
    load_trace,
    merge_traces,
    pack_ctx,
    read_flight_ring,
    unpack_ctx,
)
from bluefog_tpu_torch.tracing.__main__ import main as tracing_cli
from bluefog_tpu_torch.tracing.merge import _aligned_spans


# ---------------------------------------------------------------------------
# tracer off: the NullTracer contract
# ---------------------------------------------------------------------------


def test_disabled_by_default_is_null(monkeypatch):
    monkeypatch.delenv("BFTPU_TRACING", raising=False)
    tracing.reset()
    tr = tracing.get_tracer()
    assert isinstance(tr, NullTracer)
    assert not tr.enabled
    # the whole surface must no-op, not raise
    tok = tr.begin("win_put", window="w")
    tr.end(tok, emit=[{"dst": 1, "op_id": 1}])
    tr.instant("x")
    assert tr.next_op_id() == 0
    assert tr.advance_round() == 0
    tr.resample_clock(object())
    tr.dump_flight("nope")
    assert tr.write_buffer() is None
    tr.close()
    # and be the SAME object every call (no per-op allocation)
    assert tracing.get_tracer() is tr
    tracing.reset()


# ---------------------------------------------------------------------------
# context word
# ---------------------------------------------------------------------------


def test_pack_unpack_roundtrip():
    for rnd, op, origin in [(0, 1, 0), (7, 12345, 3), (65535, 2**32 - 1,
                                                       65535)]:
        assert unpack_ctx(pack_ctx(rnd, op, origin)) == (rnd, op, origin)
    # round wraps mod 2**16; op_id mod 2**32 — identity survives
    rnd, op, origin = unpack_ctx(pack_ctx(65536 + 3, 2**32 + 9, 2))
    assert (rnd, op, origin) == (3, 9, 2)
    assert pack_ctx(0, 0, 0) == 0  # the "no context" wire word


# ---------------------------------------------------------------------------
# clock estimator
# ---------------------------------------------------------------------------


def test_clock_estimator_min_rtt():
    est = ClockEstimator()
    assert est.offset == 0.0 and est.samples == 0
    # NTP-style: offset = remote - midpoint, err = rtt/2
    assert est.add_sample(10.0, 15.001, 10.002)
    assert abs(est.offset - (15.001 - 10.001)) < 1e-12
    assert abs(est.err - 0.001) < 1e-12
    # a tighter rtt replaces the estimate; a looser one does not
    assert est.add_sample(20.0, 25.0002, 20.0004)
    assert abs(est.err - 0.0002) < 1e-12
    tight = est.offset
    assert not est.add_sample(30.0, 99.0, 30.5)
    assert est.offset == tight
    # non-positive rtt is a broken probe, never a sample
    assert not est.add_sample(5.0, 7.0, 5.0)
    assert not est.add_sample(5.0, 7.0, 4.9)
    d = est.as_dict()
    # samples counts every well-formed probe, kept or not
    assert d["samples"] == 3 and abs(d["best_rtt_s"] - 0.0004) < 1e-12


# ---------------------------------------------------------------------------
# flight ring
# ---------------------------------------------------------------------------


def test_flight_ring_roundtrip_and_dangling_b(tmp_path):
    ring = FlightRing(str(tmp_path / "r.bin"), cap=16)
    b1 = ring.append(tracing.tracer.KIND_B, "win_put", round_=2, origin=1)
    ring.append(tracing.tracer.KIND_E, "win_put", round_=2, origin=1,
                aux=b1)
    ring.append(tracing.tracer.KIND_B, "win_get", round_=3, origin=1)
    ring.append(tracing.tracer.KIND_I, "heal", origin=1, aux=7)
    ring.close()
    records, in_flight = read_flight_ring(str(tmp_path / "r.bin"))
    assert [r["kind"] for r in records] == ["B", "E", "B", "I"]
    assert records[0]["round"] == 2 and records[3]["aux"] == 7
    # the win_get B never saw its E: it is the in-flight op
    assert [r["name"] for r in in_flight] == ["win_get"]


def test_flight_ring_wraps_without_losing_recent(tmp_path):
    ring = FlightRing(str(tmp_path / "r.bin"), cap=16)
    for i in range(40):
        ring.append(tracing.tracer.KIND_I, f"ev{i}")
    ring.close()
    records, _ = read_flight_ring(str(tmp_path / "r.bin"))
    assert len(records) == 16
    assert records[-1]["name"] == "ev39"  # newest survives the wrap
    assert records[0]["name"] == "ev24"   # oldest kept is cap back


def test_read_flight_ring_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"\x00" * 256)
    with pytest.raises(ValueError):
        read_flight_ring(str(p))


# ---------------------------------------------------------------------------
# tracer buffer + merge + critical path (single process, synthetic)
# ---------------------------------------------------------------------------


def _two_rank_corpus(tmp_path):
    """Two real Tracer instances exchanging one flow per round.

    The rounds INTERLEAVE in real time (both ranks deposit, then both
    combine) so the corpus is causal: a consume's wall-clock completion
    follows its producer's, as it would in a live job."""
    trs = []
    for rank in (0, 1):
        tr = Tracer(str(tmp_path), rank=rank, job="unit")
        tr.set_identity(rank, 2, "unit")
        trs.append(tr)
    for rnd in range(2):
        for rank, peer in ((0, 1), (1, 0)):
            tr = trs[rank]
            tok = tr.begin("win_put", window="w")
            op = tr.next_op_id()
            tr.end(tok, emit=[{"dst": peer, "op_id": op}])
        for rank, peer in ((0, 1), (1, 0)):
            tr = trs[rank]
            tok = tr.begin("win_update", window="w")
            tr.end(tok, consume=[{"src": peer, "origin": peer,
                                  "op_id": rnd + 1, "round": rnd}])
            tr.advance_round()
    traces = []
    for tr in trs:
        path = tr.write_buffer()
        tr.close()
        traces.append(load_trace(path))
    return traces


def test_merge_resolves_every_flow(tmp_path):
    traces = _two_rank_corpus(tmp_path)
    spans, _ = _aligned_spans(traces)
    _, flows = flow_index(spans)
    assert len(flows) == 4
    assert all(fl["producer"] is not None for fl in flows)
    merged = merge_traces(traces)
    starts = [e for e in merged["traceEvents"] if e.get("ph") == "s"]
    finishes = [e for e in merged["traceEvents"] if e.get("ph") == "f"]
    assert len(starts) == len(finishes) == 4
    assert {e["id"] for e in starts} == {e["id"] for e in finishes}
    # and the corpus passes its own analysis rules
    assert trace_rules.check_trace_corpus(traces) == []


def test_critical_path_is_monotone(tmp_path):
    traces = _two_rank_corpus(tmp_path)
    report = critical_path(traces)
    assert len(report["rounds"]) == 2
    for rd in report["rounds"]:
        ends = [s["t_end_us"] for s in rd["path"]]
        assert ends == sorted(ends), "completion must not decrease"
        assert rd["path"][-1]["name"] == "win_update"
    total = sum(report["stragglers"]["rounds_lengthened_by_rank"].values())
    assert total == len(report["rounds"])


def test_cli_merges_and_checks(tmp_path, capsys):
    _two_rank_corpus(tmp_path)
    out = tmp_path / "merged.json"
    assert tracing_cli([str(tmp_path), "--out", str(out),
                        "--critical-path", "--check"]) == 0
    merged = json.loads(out.read_text())
    assert merged["otherData"]["ranks"] == [0, 1]
    report = json.loads(capsys.readouterr().out)
    assert report["rounds"]
    # no buffers anywhere -> distinct exit code
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tracing_cli([str(empty)]) == 2


def test_sigterm_dumps_flight_and_buffer(tmp_path):
    """A SIGTERM'd rank leaves both the flight JSON (with the open op)
    and its span buffer — the launcher-kill path."""
    code = (
        "import os, signal, time\n"
        "from bluefog_tpu_torch.tracing import tracer as T\n"
        "tr = T.get_tracer()\n"
        "tr.set_identity(0, 1, 'sig')\n"
        "tok = tr.begin('win_accumulate', window='w')\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(30)\n"
    )
    env = dict(os.environ, BFTPU_TRACING=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, timeout=60)
    assert proc.returncode != 0  # died by signal, not a clean exit
    flight = json.loads((tmp_path / "flight-sig-r0.json").read_text())
    assert flight["reason"].startswith("SIGTERM")
    assert [r["name"] for r in flight["in_flight"]] == ["win_accumulate"]
    buf = load_trace(str(tmp_path / "trace-sig-r0.json"))
    assert buf is not None and buf["spans"] == []  # span still open


def test_timeline_writer_flushes_on_sigterm(tmp_path):
    """Satellite: the chrome-trace timeline writer flushes on SIGTERM,
    not only atexit (launchers kill islands with SIGTERM)."""
    out = tmp_path / "tl.json"
    code = (
        "import os, signal, time\n"
        "from bluefog_tpu_torch.timeline import TimelineWriter\n"
        "w = TimelineWriter(os.environ['TL_PATH'])\n"
        "w.record('span', 0.0, 5.0)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(30)\n"
    )
    env = dict(os.environ, TL_PATH=str(out), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, timeout=60)
    assert proc.returncode != 0
    doc = json.loads(out.read_text())
    assert [e["name"] for e in doc["traceEvents"]] == ["span"]


# ---------------------------------------------------------------------------
# np=4 e2e: real gossip with tracing on, merge, flows, critical paths
# ---------------------------------------------------------------------------


def _worker_traced_gossip(rank, size):
    islands.set_topology(topology_util.RingGraph(size))
    x = np.full((32,), float(rank + 1), np.float32)
    islands.win_create(x, "tw")
    for _ in range(3):
        islands.win_put(x, "tw")
        islands.barrier()
        x = islands.win_update("tw")
        islands.barrier()
    islands.win_free("tw")
    return rank


@pytest.mark.island_e2e
def test_np4_e2e_traced_gossip(tmp_path, monkeypatch):
    """Four island processes gossip with tracing on; the per-rank
    buffers merge into one Chrome trace whose every flow arrow has both
    endpoints, whose per-round critical paths are causally monotone,
    and which the analysis trace rules accept."""
    monkeypatch.setenv("BFTPU_TRACING", str(tmp_path))
    res = islands.spawn(_worker_traced_gossip, 4, job="trace_e2e",
                        timeout=240.0)
    assert res == [0, 1, 2, 3]

    traces = []
    for r in range(4):
        t = load_trace(str(tmp_path / f"trace-trace_e2e-r{r}.json"))
        assert t is not None, f"rank {r} wrote no buffer"
        traces.append(t)
    assert trace_rules.check_trace_corpus(traces) == []

    spans, _ = _aligned_spans(traces)
    _, flows = flow_index(spans)
    # ring, 4 ranks, 3 rounds: each rank consumes 2 in-slots per round
    assert len(flows) == 24
    assert all(fl["producer"] is not None for fl in flows), \
        "every consumed deposit must resolve to its producing span"
    merged = merge_traces(traces)
    fids = {e["id"] for e in merged["traceEvents"] if e.get("ph") == "s"}
    assert len(fids) == 24

    report = critical_path(traces)
    assert len(report["rounds"]) == 3
    for rd in report["rounds"]:
        ends = [s["t_end_us"] for s in rd["path"]]
        assert ends == sorted(ends)
    assert report["stragglers"]["edge_latency"]
    # the CLI agrees end-to-end (merge + critical path + rules)
    assert tracing_cli([str(tmp_path), "--critical-path", "--check"]) == 0


# ---------------------------------------------------------------------------
# SIGKILL: the flight recorder is the black box
# ---------------------------------------------------------------------------


def _worker_traced_victim(rank, size):
    islands.set_topology(topology_util.RingGraph(size))
    x = np.full((8,), float(rank), np.float32)
    islands.win_create(x, "fw")
    islands.barrier()
    islands.win_put(x, "fw")
    tr = tracing.get_tracer()
    tok = tr.begin("pre_kill_update", window="fw")
    chaos.checkpoint(rank, "traced")  # the victim is SIGKILLed here
    tr.end(tok)
    # no win_free: it is an unbounded collective, and a sibling just
    # died — the tolerant spawn teardown closes the segments instead
    return rank


@pytest.mark.island_e2e
def test_sigkill_flight_recorder_names_in_flight_op(tmp_path, monkeypatch):
    """SIGKILL a traced rank mid-op: no handler ran, but the mmap ring
    survives in the page cache; the spawner's post-mortem converts it
    to a valid flight JSON naming the op that was open at death."""
    monkeypatch.setenv("BFTPU_TRACING", str(tmp_path))
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "1.0")
    size, victim = 4, 2
    chaos.schedule_kill(os.environ, rank=victim, step=1)
    try:
        res = islands.spawn(_worker_traced_victim, size, timeout=240.0,
                            allow_failures=True)
    finally:
        chaos.clear_schedule()
    assert res[victim] is None, "the victim was supposed to die"

    dumps = sorted(p for p in os.listdir(tmp_path)
                   if p.startswith("flight-") and p.endswith(
                       f"r{victim}.json"))
    assert dumps, f"no flight dump for rank {victim}: " \
                  f"{sorted(os.listdir(tmp_path))}"
    doc = json.loads((tmp_path / dumps[0]).read_text())
    assert doc["rank"] == victim
    assert doc["records"], "ring must hold the recent ops"
    in_flight = [r["name"] for r in doc["in_flight"]]
    assert "pre_kill_update" in in_flight, in_flight


# ---------------------------------------------------------------------------
# traces written by both packages: the port's merge, critical path and
# trace rules give the reference's merged file, report and findings
# ---------------------------------------------------------------------------


def _corpus_by(tmp_path, pkgs, break_flow=False):
    """Two ranks exchanging one flow a round, rank r's buffer written by
    package ``pkgs[r]``'s Tracer (``"jax"``: the reference's).  With
    ``break_flow`` rank 1 consumes an op nobody emitted."""
    from bluefog_tpu.tracing import Tracer as RefTracer

    trs = []
    for rank, pkg in enumerate(pkgs):
        cls = RefTracer if pkg == "jax" else Tracer
        tr = cls(str(tmp_path), rank=rank, job="mix")
        tr.set_identity(rank, 2, "mix")
        trs.append(tr)
    for rnd in range(3):
        for rank, peer in ((0, 1), (1, 0)):
            tok = trs[rank].begin("win_put", window="w")
            op = trs[rank].next_op_id()
            trs[rank].end(tok, emit=[{"dst": peer, "op_id": op}])
        for rank, peer in ((0, 1), (1, 0)):
            op_id = rnd + 1 + (100 if break_flow and rank == 1 else 0)
            tok = trs[rank].begin("win_update", window="w")
            trs[rank].end(tok, consume=[{"src": peer, "origin": peer,
                                         "op_id": op_id, "round": rnd}])
            trs[rank].advance_round()
    paths = []
    for tr in trs:
        paths.append(tr.write_buffer())
        tr.close()
    return paths


def _findings(fs):
    return sorted((f.rule, str(f.severity), f.subject, f.message) for f in fs)


@pytest.mark.parametrize("pkgs", [("jax", "jax"), ("torch", "torch"),
                                  ("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("break_flow", [False, True])
def test_merge_and_rules_match_the_reference_on_both_packages_traces(
        tmp_path, pkgs, break_flow):
    from bluefog_tpu.analysis import trace_rules as ref_rules
    from bluefog_tpu.tracing import critical_path as ref_critical_path
    from bluefog_tpu.tracing import load_trace as ref_load
    from bluefog_tpu.tracing import merge_traces as ref_merge

    paths = _corpus_by(tmp_path, pkgs, break_flow)
    ours = [load_trace(p) for p in paths]
    theirs = [ref_load(p) for p in paths]
    assert ours == theirs
    assert json.dumps(merge_traces(ours), sort_keys=True) == \
        json.dumps(ref_merge(theirs), sort_keys=True)
    assert critical_path(ours) == ref_critical_path(theirs)
    got = _findings(trace_rules.check_trace_corpus(ours))
    assert got == _findings(ref_rules.check_trace_corpus(theirs))
    assert bool(got) == break_flow


def test_cli_output_matches_the_reference_cli(tmp_path, capsys):
    """Both CLIs over one mixed directory: the same merged file, the same
    critical-path report, the same ``--check`` verdict."""
    from bluefog_tpu.tracing.__main__ import main as ref_cli

    _corpus_by(tmp_path, ("jax", "torch"))
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert tracing_cli([str(tmp_path), "--out", str(ours), "--critical-path",
                        "--check"]) == 0
    rep_ours = capsys.readouterr().out
    assert ref_cli([str(tmp_path), "--out", str(theirs), "--critical-path",
                    "--check"]) == 0
    rep_theirs = capsys.readouterr().out
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert json.loads(rep_ours) == json.loads(rep_theirs)
