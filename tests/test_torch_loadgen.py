"""Port twin of ``tests/test_loadgen.py``: the same cases against
``bluefog_tpu_torch`` (replicas on the CPU through ``BFTPU_SERVE_DEVICE``),
the simulator cases (campaigns, the trace latency table) included.
``test_bench_r10_serve_load_gates_frozen`` has no twin: it reads the JAX
package's frozen bench record, not code of the port.

Serve traffic observatory (docs/SERVING.md "Measuring serve latency
under churn").

- units: seeded arrival schedules (same tuple, same offsets, any host),
  the open-loop load generator charging a stall's queueing backlog to latency
  instead of omitting it, SLO violation windows gap-closing, the
  log-spaced serve latency bucket preset, the chaos env scrub of the
  ``BFTPU_LOADGEN_*``/``BFTPU_SERVE_SLO_*`` knobs, and the
  trace-fitted empirical latency sampler round-trip;
- real replica: a LoadGenerator run over a SnapshotRegion-backed
  Replica feeds the ``serve.request_latency`` histogram, journals
  per-request records that pass the merge CLI's ``--check`` schema,
  and the armed SLO monitor's violation windows join to cause events
  in ``--slo-report`` with nothing unattributed;
- sim campaigns: the virtual traffic model is event/digest-neutral
  when off, bit-identical same-seed when on, excuses a killed
  replica's backlog via its fault window, and the seeded drain-skip /
  send-re-anchor bugs are caught by the request-SLO and open-loop
  invariants;
- bench: ``bluefog_tpu_torch/benchmarks/serving.py measure_load`` returns the strict
  contract bench.py freezes, and the frozen ``BENCH_r10.json`` gates
  hold;
- chaos e2e (slow): a publisher on a 1.5 s cadence + three loaded
  replica processes, one SIGKILLed mid-load and respawned — every
  replica's p99 stays finite and every SLO violation window in the
  merged journals is attributed to a cause.
"""

import os

os.environ["BFTPU_SERVE_DEVICE"] = "cpu"  # spawned workers inherit it

import json
import math
import os
import random
import signal
import subprocess
import sys
import time
import multiprocessing as mp

import numpy as np
import pytest

from bluefog_tpu_torch import telemetry
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.serve import Replica, SnapshotRegion
from bluefog_tpu_torch.serve.loadgen import (LoadGenerator, SLOMonitor,
                                       arrival_times)
from bluefog_tpu_torch.sim import SimConfig, run_campaign
from bluefog_tpu_torch.sim.latency import EmpiricalLatency, load_trace_latency
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule
from bluefog_tpu_torch.telemetry import merge as tmerge


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def telemetry_dir(tmp_path, monkeypatch):
    """Telemetry armed into a private dir; the cached registry is reset
    both ways so neither neighbours nor this test see a stale one."""
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    telemetry.reset()
    yield str(tmp_path)
    telemetry.reset()


# ---------------------------------------------------------------------------
# arrival schedules: seeded, reproducible, rate-faithful
# ---------------------------------------------------------------------------


def test_arrival_times_seeded_deterministic():
    a = arrival_times("poisson", 200.0, 2.0, seed=7, stream=3)
    b = arrival_times("poisson", 200.0, 2.0, seed=7, stream=3)
    assert a == b and len(a) > 0
    assert a == sorted(a) and all(0 < t < 2.0 for t in a)
    # ~N(400, 20): 5 sigma keeps this deterministic in practice anyway
    assert 300 < len(a) < 500
    # per-replica streams decorrelate, other seeds decorrelate
    assert a != arrival_times("poisson", 200.0, 2.0, seed=7, stream=4)
    assert a != arrival_times("poisson", 200.0, 2.0, seed=8, stream=3)


def test_arrival_times_fixed_spacing_and_degenerate():
    out = arrival_times("fixed", 10.0, 1.0, seed=0)
    # first arrival one gap in — no synchronized t=0 burst across
    # streams (float accumulation may or may not admit the edge point)
    assert 9 <= len(out) <= 10
    assert out[:9] == pytest.approx([0.1 * i for i in range(1, 10)])
    assert arrival_times("fixed", 10.0, 0.0) == []
    assert arrival_times("poisson", 0.0, 5.0) == []


# ---------------------------------------------------------------------------
# the open loop: a stall's backlog is charged, never omitted
# ---------------------------------------------------------------------------


class _StallOnceTarget:
    """serve_step stalls hard exactly once, then is instant."""

    def __init__(self, stall_s):
        self.stall_s = stall_s
        self.calls = 0

    def serve_step(self):
        self.calls += 1
        if self.calls == 10:
            time.sleep(self.stall_s)
        return 1, None


def test_open_loop_charges_stall_to_latency():
    target = _StallOnceTarget(0.3)
    gen = LoadGenerator([target], rate_hz=100.0, schedule="fixed",
                        duration_s=0.8, seed=0)
    planned = len(arrival_times("fixed", 100.0, 0.8, seed=0))
    rpt = gen.run()
    # every scheduled arrival fired — the stall deferred none of them
    assert rpt.requests == planned == target.calls
    # the ~30 arrivals queued behind the 300 ms stall each carry their
    # queueing delay: a closed-loop generator would have reported ONE
    # slow request here (coordinated omission)
    delayed = [v for v in gen._stats[0].latencies_ms if v > 50.0]
    assert len(delayed) >= 15
    assert rpt.max_ms >= 250.0
    assert rpt.p50_ms < rpt.p99_ms <= rpt.max_ms


# ---------------------------------------------------------------------------
# SLO monitor: gap-closed windows, kinds, statuspage lamp state
# ---------------------------------------------------------------------------


def test_slo_monitor_gap_closes_windows():
    mon = SLOMonitor(3, slo_ms=50.0, gap_s=0.25)
    assert mon.state == -1                      # armed, but no traffic
    assert mon.note(0.0, 0.01) is False
    assert mon.state == 0
    # three violations inside the gap: ONE window
    assert mon.note(1.0, 1.2) is True
    assert mon.note(1.2, 1.35) is True
    assert mon.note(1.4, 1.5) is True
    assert mon.state == 1
    # a compliant completion inside the gap does NOT close the window
    assert mon.note(1.55, 1.56) is False
    assert mon.windows == []
    # ... but one past the gap does
    assert mon.note(2.0, 2.01) is False
    assert len(mon.windows) == 1
    w = mon.windows[0]
    assert w["replica"] == 3 and w["requests"] == 3
    assert w["kinds"] == ["latency"]
    assert w["t0_mono"] == 1.0 and w["t1_mono"] == 1.5
    assert w["worst_ms"] == pytest.approx(200.0)
    assert w["t1_wall"] - w["t0_wall"] == pytest.approx(0.5, abs=1e-3)
    # a second stall far away opens a SECOND window; close() flushes it
    assert mon.note(9.0, 9.2) is True
    mon.close()
    assert len(mon.windows) == 2 and mon.violations == 4
    assert mon.requests == 7


def test_slo_monitor_staleness_kind():
    mon = SLOMonitor(0, slo_ms=0.0, staleness_slo=2, gap_s=0.25)
    assert mon.armed
    assert mon.note(0.0, 0.001, lag=2) is False     # at the bound: fine
    assert mon.note(1.0, 1.001, lag=3) is True
    mon.close()
    assert mon.windows[0]["kinds"] == ["staleness"]
    disarmed = SLOMonitor(0, slo_ms=0.0, staleness_slo=0)
    assert not disarmed.armed
    assert disarmed.note(0.0, 99.0, lag=99) is False
    assert disarmed.state == -1


def test_serve_latency_buckets_log_spaced():
    b = telemetry.SERVE_LATENCY_BUCKETS_S
    assert len(b) == 30
    assert b[0] == pytest.approx(1e-4)
    assert b[-1] == pytest.approx(10 ** 0.35)
    assert all(x < y for x, y in zip(b, b[1:]))
    # constant RELATIVE resolution: every ratio is one log-step
    for x, y in zip(b, b[1:]):
        assert y / x == pytest.approx(10 ** 0.15, rel=1e-6)


def test_chaos_clear_schedule_scrubs_loadgen_env(monkeypatch):
    keys = ("BFTPU_LOADGEN_RATE_HZ", "BFTPU_LOADGEN_SCHEDULE",
            "BFTPU_LOADGEN_SEED", "BFTPU_LOADGEN_DURATION_S",
            "BFTPU_SERVE_SLO_MS", "BFTPU_SERVE_SLO_STALENESS")
    for k in keys:
        monkeypatch.setenv(k, "7")
    chaos.clear_schedule()
    for k in keys:
        assert k not in os.environ, k


# ---------------------------------------------------------------------------
# trace-fitted latency: report -> table -> sampler round-trip
# ---------------------------------------------------------------------------






# ---------------------------------------------------------------------------
# real replica: histogram + journal + SLO windows + merge CLI join
# ---------------------------------------------------------------------------


def test_loadgen_real_replica_slo_report_and_check(
        shm_dir, telemetry_dir, monkeypatch):
    # an SLO far below the per-request journal cost: every request
    # violates, so windows must open, close, and join to causes
    monkeypatch.setenv("BFTPU_SERVE_SLO_MS", "0.0001")
    x = np.arange(64, dtype=np.float64)
    region = SnapshotRegion("lg", x.nbytes)
    rep = None
    try:
        region.publish(x)
        rep = Replica("lg", 0, publish_page=False)
        assert rep.poll_swap() is True
        gen = LoadGenerator([rep], rate_hz=400.0, schedule="poisson",
                            duration_s=0.4, seed=5)
        rpt = gen.run()
        assert rpt.requests > 0
        assert rpt.outcomes == {"ok": rpt.requests}
        assert rpt.slo_violations == rpt.requests
        assert math.isfinite(rpt.p99_ms) and rpt.p99_ms >= rpt.p50_ms
    finally:
        if rep is not None:
            rep.close()
        region.close(unlink=True)
    reg = telemetry.get_registry()
    assert reg.enabled
    # per-request records landed in the journal and pass the --check
    # schema; the run brackets landed too
    events, bad = telemetry.read_journal(reg.journal_path)
    kinds = [e["event"] for e in events]
    assert bad == 0
    assert kinds.count("serve_request") == rpt.requests
    assert "loadgen_start" in kinds and "loadgen_done" in kinds
    assert "slo_violation" in kinds
    assert tmerge.check_request_records([telemetry_dir]) == []
    # the latency histogram rides the log-spaced serve preset
    h = reg.histogram("serve.request_latency",
                      buckets=telemetry.SERVE_LATENCY_BUCKETS_S,
                      replica="0")
    assert tuple(h.buckets) == telemetry.SERVE_LATENCY_BUCKETS_S
    assert sum(h.counts) == rpt.requests
    # every violation window joins to the loadgen_start cause (same
    # process, wall clocks identical): nothing unattributed
    rep_doc = tmerge.slo_report([telemetry_dir])
    assert rep_doc["schema"] == tmerge.SLO_REPORT_SCHEMA
    assert rep_doc["requests"] == rpt.requests
    assert rep_doc["total_windows"] >= 1
    assert rep_doc["unattributed"] == 0
    for w in rep_doc["windows"]:
        assert "latency" in w["kinds"]
        assert any(c["kind"] == "loadgen_start" for c in w["causes"])
    # the CLI agrees end to end (--check needs a snapshot in the corpus)
    reg.write_snapshot()
    from bluefog_tpu_torch.telemetry.__main__ import main as tmain
    assert tmain([telemetry_dir, "--slo-report", "--out",
                  os.path.join(telemetry_dir, "slo.json")]) == 0
    assert tmain([telemetry_dir, "--check", "--out",
                  os.path.join(telemetry_dir, "merged.json")]) == 0


# ---------------------------------------------------------------------------
# sim traffic model: off = silent, on = pinned, faults = excused
# ---------------------------------------------------------------------------

_SIM_KW = dict(ranks=8, rounds=16, seed=3, quiesce_rounds=10,
               serve_every=4, serve_replicas=2)










# ---------------------------------------------------------------------------
# bench: the load arm's strict contract + the frozen r10 gates
# ---------------------------------------------------------------------------


def test_measure_load_contract(shm_dir):
    from bluefog_tpu_torch.benchmarks import serving as bench_serving

    out = bench_serving.measure_load(replica_counts=(2,), rate_hz=120.0,
                                     idle_s=0.3, publish_period_s=0.3,
                                     publishes=1, payload_kb=8,
                                     device="cpu")
    assert "p99 under publish churn" in out["metric"]
    assert out["unit"] == "ms"
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert out["replica_counts"] == [2]
    for key in ("p50_idle_by_fleet_ms", "p99_idle_by_fleet_ms",
                "p50_publish_by_fleet_ms", "p99_publish_by_fleet_ms",
                "qps_by_fleet"):
        # by-fleet maps are string-keyed: strict-JSON straight through
        assert set(out[key]) == {"2"}
        assert math.isfinite(out[key]["2"]) and out[key]["2"] > 0
    assert out["value"] == out["p99_publish_by_fleet_ms"]["2"]
    json.dumps(out)   # the whole dict must be strict-JSON for bench.py




# ---------------------------------------------------------------------------
# chaos e2e: publish cadence + replica SIGKILL mid-load, all attributed
# ---------------------------------------------------------------------------

_E2E_PUB_GAP_S = 1.5


def _loadgen_e2e_worker(job, replica_id, tdir, duration_s, stall_s,
                        go_ev, q):
    os.environ["BFTPU_TELEMETRY"] = tdir
    os.environ["BLUEFOG_ISLAND_RANK"] = str(replica_id + 1)
    os.environ["BLUEFOG_ISLAND_JOB"] = job
    os.environ["BFTPU_SERVE_SLO_MS"] = "100"
    os.environ["BFTPU_SERVE_BACKOFF_S"] = "0.01"
    from bluefog_tpu_torch import telemetry as tel
    tel.reset()
    from bluefog_tpu_torch.serve import Replica as Rep, SnapshotUnavailable
    from bluefog_tpu_torch.serve.loadgen import LoadGenerator as Gen

    rep = Rep(job, replica_id, publish_page=False)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        try:
            if rep.poll_swap():
                break
        except SnapshotUnavailable:
            pass
        time.sleep(0.01)
    assert rep.version >= 1

    class _Target:
        """Track fresh versions between requests; the respawned
        incarnation stalls its first request (cold re-attach cost)."""

        def __init__(self):
            self.replica_id = replica_id
            self._stalled = False

        def serve_step(self):
            if stall_s and not self._stalled:
                self._stalled = True
                time.sleep(stall_s)
            try:
                rep.poll_swap()
            except SnapshotUnavailable:
                pass
            return rep.serve_step()

        def note_request(self, *a, **kw):
            return rep.note_request(*a, **kw)

        def close_slo(self):
            rep.close_slo()

    q.put(("up", replica_id))
    assert go_ev.wait(60.0)
    gen = Gen([_Target()], rate_hz=120.0, schedule="poisson",
              duration_s=duration_s, seed=40 + replica_id)
    rpt = gen.run()
    q.put(("done", replica_id, rpt.requests, rpt.p99_ms,
           dict(rpt.outcomes)))
    rep.close()


@pytest.mark.slow
def test_loadgen_chaos_e2e(tmp_path, monkeypatch):
    """Publisher on a 1.5 s cadence; K=3 replica processes under
    open-loop Poisson load with the 100 ms SLO armed; replica 1 is
    SIGKILLed mid-load and respawned (the parent journals the
    serve_respawn).  Every finishing replica reports a finite p99 with
    zero failed requests, the per-request journals pass the --check
    schema, and the merged --slo-report attributes every violation
    window — zero unexplained."""
    job = f"lge2e{os.getpid()}"
    tdir = str(tmp_path)
    monkeypatch.setenv("BFTPU_TELEMETRY", tdir)
    monkeypatch.setenv("BLUEFOG_ISLAND_JOB", job)
    monkeypatch.setenv("BLUEFOG_ISLAND_RANK", "0")
    telemetry.reset()
    reg = telemetry.get_registry()
    x = np.arange(2048, dtype=np.float64)
    region = SnapshotRegion(job, x.nbytes)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    go_ev = ctx.Event()
    procs = {}
    respawn = None
    try:
        version = region.publish(x)
        reg.journal("serve_publish", win=job, version=version)
        for i in range(3):
            p = ctx.Process(target=_loadgen_e2e_worker,
                            args=(job, i, tdir, 6.0, 0.0, go_ev, q))
            p.start()
            procs[i] = p
        ups = 0
        while ups < 3:
            msg = q.get(timeout=120)
            assert msg[0] == "up"
            ups += 1
        go_ev.set()
        t0 = time.monotonic()
        last_pub = t0
        killed_at = None
        done = {}
        deadline = t0 + 120.0
        while len(done) < 3 and time.monotonic() < deadline:
            now = time.monotonic()
            if now - last_pub >= _E2E_PUB_GAP_S:
                last_pub = now
                version = region.publish(x + version)
                reg.journal("serve_publish", win=job, version=version)
            if killed_at is None and now - t0 >= 2.0:
                killed_at = now
                os.kill(procs[1].pid, signal.SIGKILL)
                procs[1].join(timeout=30)
                assert procs[1].exitcode == -9
                # respawn: the fresh incarnation pays a cold re-attach
                # stall on its first request — inside the SLO window
                # the serve_respawn cause must explain
                reg.journal("serve_respawn", win=job, replica=1)
                respawn = ctx.Process(
                    target=_loadgen_e2e_worker,
                    args=(job, 1, tdir, 2.5, 0.4, go_ev, q))
                respawn.start()
            try:
                msg = q.get(timeout=0.1)
            except Exception:
                continue
            if msg[0] == "done":
                done[msg[1]] = msg[2:]
        assert len(done) == 3, done
    finally:
        for p in list(procs.values()) + ([respawn] if respawn else []):
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        region.close(unlink=True)
        telemetry.reset()
    # every finishing incarnation: traffic flowed, p99 finite, no
    # failed serve steps
    for rid, (requests, p99_ms, outcomes) in done.items():
        assert requests > 0, rid
        assert math.isfinite(p99_ms), (rid, p99_ms)
        assert set(outcomes) == {"ok"}, (rid, outcomes)
    # the SIGKILLed incarnation left a journal that still parses and
    # every serve_request record in the corpus is schema-valid
    assert tmerge.check_request_records([tdir]) == []
    # the respawn's cold-start stall violated the 100 ms SLO: windows
    # exist, and every one is attributed (serve_respawn and the
    # publish cadence are both in range) — zero unexplained
    report = tmerge.slo_report([tdir])
    assert report["requests"] > 0
    assert report["total_windows"] >= 1
    assert report["unattributed"] == 0, report["windows"]
    # widen the join slack past the respawn bootstrap (~spawn + import)
    # and the respawn cause itself must explain a replica-1 window
    wide = tmerge.slo_report([tdir], margin_s=6.0)
    assert any(c["kind"] == "serve_respawn" for w in wide["windows"]
               if w["replica"] == 1 for c in w["causes"])


# ---------------------------------------------------------------------------
# the reference's simulator cases (sim campaigns, no subprocesses unless
# marked; virtual clock)
# ---------------------------------------------------------------------------


def test_trace_latency_table_roundtrip(tmp_path):
    report = {"stragglers": {"edge_latency": {
        "0->1": {"n": 64, "p50_us": 500.0, "p99_us": 2000.0},
        "1->0": {"n": 64, "p50_us": 900.0, "p99_us": 900.0},
    }}}
    path = tmp_path / "crit.json"
    path.write_text(json.dumps(report))
    rows = load_trace_latency(str(path))
    assert rows == (("0->1", 500e-6, 2000e-6), ("1->0", 900e-6, 900e-6))
    lat = EmpiricalLatency(rows)
    assert len(lat) == 2
    # the measured anchors round-trip exactly through the inverse CDF
    assert lat.quantile(0, 1, 0.5) == pytest.approx(500e-6, abs=1e-12)
    assert lat.quantile(0, 1, 0.99) == pytest.approx(2000e-6, abs=1e-12)
    assert lat.quantile(0, 1, 0.0) == pytest.approx(250e-6, abs=1e-12)
    assert lat.quantile(0, 1, 1.0) == pytest.approx(2000e-6, abs=1e-12)
    # quantiles are monotone; a degenerate edge's tail segment is flat
    qs = [lat.quantile(0, 1, q / 100.0) for q in range(101)]
    assert qs == sorted(qs)
    assert (lat.quantile(1, 0, 0.5) == lat.quantile(1, 0, 0.99)
            == pytest.approx(900e-6, abs=1e-12))
    # an edge the trace never saw draws from the pooled fallback
    assert lat.quantile(5, 6, 0.5) in (500e-6, 900e-6)
    # sample() consumes exactly ONE rng.random() per draw — armed
    # tables stay stream-compatible with the uniform path they replace
    r1, r2 = random.Random(11), random.Random(11)
    draws = [lat.sample(0, 1, r1) for _ in range(50)]
    assert draws == [lat.quantile(0, 1, r2.random()) for _ in range(50)]
    # accepted equivalents: the stragglers sub-object and the bare map
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(report["stragglers"]["edge_latency"]))
    assert load_trace_latency(str(bare)) == rows
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps({"edge_latency": {"0->1": {"n": 1}}}))
    with pytest.raises(ValueError, match="p50_us"):
        load_trace_latency(str(broken))


def test_sim_cli_latency_from_trace(tmp_path):
    report = {"edge_latency": {
        "0->1": {"n": 8, "p50_us": 300.0, "p99_us": 1200.0}}}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(report))
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.sim", "--ranks", "8",
           "--rounds", "10", "--seed", "3",
           "--latency-from-trace", str(path)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r1 = subprocess.run(cmd, capture_output=True, text=True, env=env)
    r2 = subprocess.run(cmd, capture_output=True, text=True, env=env)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    assert "latency fitted to 1 traced edge" in r1.stdout
    assert r1.stdout == r2.stdout         # fitted campaigns stay pinned
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    r3 = subprocess.run(cmd[:-1] + [str(bad)], capture_output=True,
                        text=True, env=env)
    assert r3.returncode != 0
    assert "edge_latency" in r3.stderr


_SIM_KW = dict(ranks=8, rounds=16, seed=3, quiesce_rounds=10,
               serve_every=4, serve_replicas=2)


def test_sim_arrivals_off_is_event_neutral():
    res1 = run_campaign(SimConfig(**_SIM_KW))
    res2 = run_campaign(SimConfig(**_SIM_KW))
    assert res1.ok and res1.digest == res2.digest
    assert not any(e[1] == "serve_requests" for e in res1.event_log)
    assert "arrivals" not in res1.final


def test_sim_arrivals_deterministic_and_accounted():
    cfg = SimConfig(arrivals="poisson", arrival_rate=3.0, **_SIM_KW)
    res1 = run_campaign(cfg)
    res2 = run_campaign(cfg)
    assert res1.ok, res1.violations
    assert res1.digest == res2.digest      # bit-identical same-seed
    arr = res1.final["arrivals"]
    assert arr["process"] == "poisson" and arr["rate"] == 3.0
    assert arr["admitted"] == arr["served"] > 0
    assert arr["violations"] == 0
    assert res1.summary()["arrivals"] == arr
    assert any(e[1] == "serve_requests" for e in res1.event_log)
    # fixed arrivals are a distinct pinned schedule
    res3 = run_campaign(SimConfig(arrivals="fixed", arrival_rate=3.0,
                                  **_SIM_KW))
    assert res3.ok and res3.digest != res1.digest


def test_sim_arrivals_replica_kill_is_excused():
    cfg = SimConfig(ranks=16, rounds=24, seed=3, quiesce_rounds=12,
                    serve_every=4, serve_replicas=4,
                    arrivals="poisson", arrival_rate=3.0)
    sched = FaultSchedule([Fault(kind="serve_kill", step=2, rank=1,
                                 stop=18)])
    res = run_campaign(cfg, sched)
    assert res.ok, res.violations
    arr = res.final["arrivals"]
    # the killed replica's queued backlog missed its SLO — every one of
    # those requests is excused by the kill's fault window, none leaks
    # into a violation
    assert arr["attributed"] > 0
    assert arr["served"] <= arr["admitted"]
    assert arr["violations"] == 0
    assert arr["windows"] > 0


@pytest.mark.parametrize("bug,invariant", [
    ("slo_silent_violation", "request-slo"),
    ("loadgen_omission", "open-loop"),
])
def test_sim_seeded_traffic_bugs_caught(bug, invariant):
    cfg = SimConfig(arrivals="poisson", arrival_rate=3.0,
                    debug_bugs=(bug,), **_SIM_KW)
    res = run_campaign(cfg)
    assert not res.ok
    names = {v["name"] for v in res.violations}
    assert invariant in names, names

