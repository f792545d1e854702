"""Port twin of ``tests/test_monitor.py``: the same cases against
``bluefog_tpu_torch.monitor`` (the chaos kill/respawn e2e stays slow, as
in the reference), then the cross-package cases: the rule table, the
alert engine, the sampler and the attribution report give the
reference's results on the same inputs; a store written by either
package is read by the other; and the port's launcher runs the monitor
over a live fleet on the CPU — a clean serving run with the probe raises
no alert, and a SIGKILLed rank raises exactly ``chip_smoke.py``'s
``MONITOR_KILL_ALERTS``, each window explained by the journaled death and
heal (the set the card run is gated on).

Fleet monitor (docs/OBSERVABILITY.md "Fleet monitor").

- rules: the declarative table resolves its thresholds from the env,
  ``BFTPU_MON_RULES`` overrides/disables individual rules (inline JSON
  or a file), and the gap-closed engine folds firing samples into one
  window per incident with wall-clock bounds;
- store: the mmap'd ring-buffer time series round-trips through
  snapshot/JSON/Prometheus, downsamples raw→mid→coarse, and survives
  the writer's death — a later attach reads the same history and can
  keep appending where the dead monitor stopped;
- tailer: the incremental journal tailer rides a forced
  ``BFTPU_JOURNAL_MAX_MB`` rotation mid-tail without double-counting
  or dropping, and buffers a torn final line until its newline lands;
- chaos: ``clear_schedule`` scrubs every ``BFTPU_MON_*`` /
  ``BFTPU_CHAOS_MON_*`` key with the rest of the schedule env;
- sim twin: a seeded monitor bug raises exactly its matching alert,
  and the clean twin stays quiet while leaving the campaign digest
  bit-identical to the unmonitored run;
- daemon (in-process): scrape → sample → store + engine → v8 lamp
  page, with the ``BFTPU_CHAOS_MON_DROP_SCRAPE`` seam skipping reads;
- chaos e2e (slow): np=4 status-page writers with a live monitor
  daemon attached; rank 2 is SIGKILLed and respawned — the edge_dead
  alert fires, ``--report`` attributes every window to the journaled
  death/heal causes, and nothing else alarms.
"""

import json
import os
import signal
import subprocess
import sys
import time
import multiprocessing as mp

import pytest

from bluefog_tpu_torch import telemetry
from bluefog_tpu_torch.analysis.monitor_rules import (monitor_findings,
                                                monitored_campaign)
from bluefog_tpu_torch.introspect import statuspage as sp
from bluefog_tpu_torch.monitor import rules as mrules
from bluefog_tpu_torch.monitor import store as mstore
from bluefog_tpu_torch.monitor.__main__ import main as mon_main
from bluefog_tpu_torch.monitor.report import monitor_report
from bluefog_tpu_torch.monitor.rules import AlertEngine, AlertRule
from bluefog_tpu_torch.monitor.scraper import (MONITOR_RANK, FleetSampler,
                                         MonitorDaemon)
from bluefog_tpu_torch.monitor.tail import JournalTailer
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.sim import SimConfig, run_campaign


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def telemetry_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    telemetry.reset()
    yield str(tmp_path)
    telemetry.reset()


# ---------------------------------------------------------------------------
# rules: env thresholds, BFTPU_MON_RULES overrides, gap-closed windows
# ---------------------------------------------------------------------------


def _by_name(rules):
    return {r.name: r for r in rules}


def test_default_rules_resolve_env_thresholds(monkeypatch):
    assert _by_name(mrules.default_rules())["mass_imbalance"].threshold \
        == pytest.approx(1e-6)
    monkeypatch.setenv("BFTPU_MON_MASS_TOL", "0.5")
    monkeypatch.setenv("BFTPU_MON_SERVE_MAX_LAG", "3")
    got = _by_name(mrules.default_rules())
    assert got["mass_imbalance"].threshold == pytest.approx(0.5)
    assert got["serve_lag"].threshold == pytest.approx(3.0)


def test_load_rules_overrides_inline_file_and_garbage(tmp_path,
                                                      monkeypatch):
    spec = {"mass_imbalance": {"threshold": 2.0},
            "edge_dead": {"disabled": True},
            "no_such_rule": {"threshold": 9.0}}
    for raw in (json.dumps(spec),
                str(tmp_path / "rules.json")):
        if not raw.startswith("{"):
            (tmp_path / "rules.json").write_text(json.dumps(spec))
        monkeypatch.setenv("BFTPU_MON_RULES", raw)
        got = _by_name(mrules.load_rules())
        assert got["mass_imbalance"].threshold == pytest.approx(2.0)
        assert "edge_dead" not in got          # disabled
        assert len(got) == len(mrules.default_rules()) - 1
    # garbage / missing file / non-dict JSON all fall back to defaults
    for raw in ("{not json", "/no/such/rules.json", "[1, 2]"):
        monkeypatch.setenv("BFTPU_MON_RULES", raw)
        assert mrules.load_rules() == mrules.default_rules()


def test_alert_engine_gap_closes_one_window_per_incident():
    eng = AlertEngine(rules=[AlertRule("hot", "temp", "gt", 1.0)],
                      gap_s=2.5)
    assert eng.state == mrules.ALERT_STATE_NONE
    for t in range(12):
        val = 5.0 if 2 <= t <= 6 else 0.0
        eng.feed(float(t), [("temp", "fleet", val)], wall=100.0 + t)
        if t == 4:
            assert eng.state == mrules.ALERT_STATE_FIRING
            assert eng.last_alert == "hot"
    eng.close()
    assert eng.state == mrules.ALERT_STATE_OK
    assert [w["rule"] for w in eng.windows] == ["hot"]
    w = eng.windows[0]
    assert (w["t0_mono"], w["t1_mono"]) == (2.0, 6.0)
    assert (w["t0_wall"], w["t1_wall"]) == (102.0, 106.0)
    assert w["samples"] == 5 and w["worst"] == 5.0


# ---------------------------------------------------------------------------
# store: roundtrip, downsampling tiers, post-mortem survival
# ---------------------------------------------------------------------------


def test_store_roundtrip_downsample_and_postmortem_attach(shm_dir):
    with pytest.raises(FileNotFoundError):
        mstore.MonitorStore("never-ran")
    st = mstore.MonitorStore("mj", create=True, nslots=8, cap_raw=16)
    for i in range(25):
        st.append("a", "fleet", 100.0 + i, float(i))
    st.append("b", "r1", 200.0, 7.0)
    snap = st.snapshot()
    # raw ring capped at 16: the newest 16 of 25 points survive
    assert [v for _, v in snap["a|fleet"]["raw"]] == [
        float(i) for i in range(9, 25)]
    # two full raw buckets of 10 downsampled into the mid tier
    assert [v for _, v in snap["a|fleet"]["mid"]] == [
        pytest.approx(4.5), pytest.approx(14.5)]
    assert snap["b|r1"]["raw"] == [(200.0, 7.0)]
    doc = st.to_json()
    assert doc["schema"] == mstore.STORE_SCHEMA
    assert {s["series"] for s in doc["series"]} == {"a", "b"}
    prom = st.to_prometheus()
    assert 'bftpu_mon_a{subject="fleet"} 24' in prom
    assert 'bftpu_mon_b{subject="r1"} 7' in prom
    st.close()  # the writer dies; the segment is the history
    st2 = mstore.MonitorStore("mj")
    assert st2.caps[0] == 16  # adopted geometry, not env defaults
    assert st2.snapshot() == snap
    st2.append("a", "fleet", 130.0, 99.0)  # respawn keeps appending
    assert st2.snapshot()["a|fleet"]["raw"][-1] == (130.0, 99.0)
    st2.close(unlink=True)


# ---------------------------------------------------------------------------
# tailer: BFTPU_JOURNAL_MAX_MB rotation mid-tail, torn-line carry
# ---------------------------------------------------------------------------


def test_tailer_survives_rotation_mid_tail(tmp_path, monkeypatch):
    """Every event written across forced rotations is read exactly once
    by a tailer polling mid-stream (the scraper's cadence)."""
    monkeypatch.setenv("BFTPU_JOURNAL_MAX_MB", "0.001")  # ~1 KiB cap
    from bluefog_tpu_torch.telemetry.registry import Registry

    reg = Registry(out_dir=str(tmp_path), rank=0, job="tailj")
    tailer = JournalTailer(reg.journal_path)
    got = []
    for i in range(60):
        reg.journal("tick", seq=i, pad="x" * 64)
        if i % 3 == 0:
            got.extend(tailer.poll())
    got.extend(tailer.drain())
    reg.close()
    assert os.path.exists(reg.journal_path + ".1")  # rotation happened
    assert tailer.rotations >= 1
    assert tailer.bad_lines == 0
    assert [e["seq"] for e in got] == list(range(60))


def test_tailer_carries_torn_line_until_newline(tmp_path):
    path = str(tmp_path / "j.events.jsonl")
    tailer = JournalTailer(path)
    assert tailer.poll() == []  # not created yet
    with open(path, "a") as f:
        f.write('{"event": "a", "seq": 0}\n{"event": "b", "se')
    assert [e["event"] for e in tailer.poll()] == ["a"]
    with open(path, "a") as f:
        f.write('q": 1}\n')
    (ev,) = tailer.poll()
    assert (ev["event"], ev["seq"]) == ("b", 1)
    assert tailer.events_read == 2 and tailer.bad_lines == 0


# ---------------------------------------------------------------------------
# chaos: clear_schedule scrubs the monitor env with the rest
# ---------------------------------------------------------------------------


def test_chaos_clear_schedule_scrubs_monitor_keys(monkeypatch):
    assert "BFTPU_MONITOR" in chaos._MON_KEYS
    assert "BFTPU_CHAOS_MON_DROP_SCRAPE" in chaos._MON_KEYS
    assert "BFTPU_MON_SCRAPE_S" in chaos._MON_KEYS
    for k in chaos._MON_KEYS:
        monkeypatch.setenv(k, "1")
    chaos.clear_schedule()
    for k in chaos._MON_KEYS:
        assert k not in os.environ, k


# ---------------------------------------------------------------------------
# sampler: status pages → monitor series
# ---------------------------------------------------------------------------


def _page(balance=0.0, step=1, nranks=2, edges=(), orphan=False,
          serve=None, distrib=None, conv=None):
    return {"ledger": {"balance": balance}, "step": step, "nranks": nranks,
            "edges": list(edges), "orphan": orphan,
            "serve": serve or {"version": -1, "lag": -1, "slo_state": -1},
            "distrib": distrib or {"slot": -1},
            "conv": conv or {"round": -1, "err": -1.0}}


def test_sampler_derives_series_and_stall_state():
    s = FleetSampler()
    fleet = {0: _page(balance=1.0, step=5,
                      edges=[{"peer": 1, "state": "dead"}]),
             1: _page(balance=-3.0, step=4, orphan=True,
                      edges=[{"peer": 0, "state": "demoted"}])}
    pts = dict(((series, sub), v) for series, sub, v in s.sample(fleet, 10.0))
    # only net over-collection alarms: sum(+1, -3) = -2 → mass_err 2
    assert pts[("mass_err", "fleet")] == pytest.approx(2.0)
    assert pts[("epoch_stall_s", "fleet")] == 0.0
    assert pts[("dead_edges", "fleet")] == 1.0
    # 1 demotion vs the n=2 minority cap of 0
    assert pts[("demote_excess", "fleet")] == 1.0
    assert pts[("orphan", "r0")] == 0.0 and pts[("orphan", "r1")] == 1.0
    assert ("serve_lag", "r0") not in pts  # plane not armed = disarmed
    # no step progress for 10 s → the stall series says so
    pts2 = dict(((series, sub), v)
                for series, sub, v in s.sample(fleet, 20.0))
    assert pts2[("epoch_stall_s", "fleet")] == pytest.approx(10.0)
    assert pts2[("suspect_rate", "fleet")] == 0.0
    # a serving, tree-fed replica reports lag, staleness, and SLO state
    fleet3 = {0: _page(serve={"version": 3, "lag": 5, "slo_state": 1},
                       distrib={"slot": 2})}
    pts3 = dict(((series, sub), v)
                for series, sub, v in FleetSampler().sample(fleet3, 0.0))
    assert pts3[("serve_lag", "r0")] == 5.0
    assert pts3[("distrib_staleness", "r0")] == 5.0
    assert pts3[("request_slo", "r0")] == 1.0


# ---------------------------------------------------------------------------
# daemon (in-process): scrape → store + engine → lamp, chaos drop seam
# ---------------------------------------------------------------------------


def test_monitor_daemon_scrapes_alerts_and_lamps(shm_dir, monkeypatch):
    monkeypatch.setenv("BFTPU_MON_GAP_S", "0.05")
    job = "mond"
    page = sp.StatusPage(job, 0)
    events = []
    daemon = MonitorDaemon(job, interval=0.01,
                           journal_fn=lambda ev, **kw: events.append(
                               (ev, kw)))
    try:
        page.publish(nranks=1, step=1, epoch=1, op_id=1,
                     ledger={"deposits": 1.0},
                     edges=[(1, 2, 0.5)])  # one DEAD edge
        assert daemon.step()
        assert daemon.engine.state == mrules.ALERT_STATE_FIRING
        lamp = sp.read_status_page(sp.status_page_path(job, MONITOR_RANK))
        assert lamp["alert"] == {"state": 1, "last": "edge_dead"}
        # chaos seam: the next scrape is dropped — nothing read or fed
        monkeypatch.setenv("BFTPU_CHAOS_MON_DROP_SCRAPE", "1")
        before = daemon.engine.samples
        assert daemon.step()
        assert daemon.engine.samples == before
        monkeypatch.delenv("BFTPU_CHAOS_MON_DROP_SCRAPE")
        # the edge heals; past the gap the window closes and journals
        page.publish(nranks=1, step=2, epoch=1, op_id=2,
                     ledger={"deposits": 1.0}, edges=[(1, 0, 0.5)])
        daemon.step()
        time.sleep(0.12)
        page.publish(nranks=1, step=3, epoch=1, op_id=3,
                     ledger={"deposits": 1.0}, edges=[(1, 0, 0.5)])
        daemon.step()
    finally:
        daemon.close()
        page.close(unlink=True)
    assert [w["rule"] for w in daemon.engine.windows] == ["edge_dead"]
    assert [ev for ev, _ in events] == ["alert"]
    assert events[0][1]["rule"] == "edge_dead"
    # the store outlived the daemon: post-mortem export still reads it
    doc = mstore.export_json(job)
    series = {(s["series"], s["subject"]) for s in doc["series"]}
    assert ("dead_edges", "fleet") in series


# ---------------------------------------------------------------------------
# sim twin: seeded bug ⇒ matching alert; clean twin quiet + digest-neutral
# ---------------------------------------------------------------------------


def test_sim_monitor_seeded_mass_leak_raises_matching_alert():
    _, _, res = monitored_campaign(16, 20, 3, debug_bugs=("mass_leak",))
    mon = res.final["monitor"]
    assert mon["samples"] > 0
    assert {w["rule"] for w in mon["alerts"]} == {"mass_imbalance"}
    assert monitor_findings(res, "seeded", expect=("mass_imbalance",)) == []


def test_sim_monitor_clean_twin_quiet_and_digest_neutral():
    cfg, _, res = monitored_campaign(16, 20, 3)
    assert res.ok, res.violations
    mon = res.final["monitor"]
    assert mon["samples"] > 0 and mon["alerts"] == []
    assert monitor_findings(res, "clean") == []
    # same campaign, monitor off: bit-identical digest (the twin rides
    # the final dict, never the event log)
    off = run_campaign(SimConfig.from_dict(
        {**cfg.to_dict(), "monitor": False}))
    assert off.digest == res.digest


# ---------------------------------------------------------------------------
# attribution report: join semantics + CLI exit codes
# ---------------------------------------------------------------------------


def test_report_joins_causes_and_cli_gates_unattributed(tmp_path, capsys):
    jpath = tmp_path / "telemetry-rj-r2000.events.jsonl"
    alert = {"event": "alert", "ts": 1000.0, "rank": 2000, "rule":
             "edge_dead", "subject": "fleet", "series": "dead_edges",
             "t0_wall": 1000.0, "t1_wall": 1004.0, "samples": 5,
             "worst": 3.0}
    jpath.write_text(json.dumps(alert) + "\n")
    rep = monitor_report([str(tmp_path)])
    assert rep["total_windows"] == 1 and rep["unattributed"] == 1
    assert mon_main(["--report", str(tmp_path)]) == 1
    capsys.readouterr()
    # a death_declared inside the window (plus margin) explains it
    cause = {"event": "death_declared", "ts": 999.0, "rank": 0, "peer": 3}
    far = {"event": "heal", "ts": 2000.0, "rank": 0, "peer": 3}
    jpath.write_text(json.dumps(alert) + "\n" + json.dumps(cause) + "\n"
                     + json.dumps(far) + "\n")
    rep = monitor_report([str(tmp_path)])
    assert rep["unattributed"] == 0
    (w,) = rep["windows"]
    assert [c["kind"] for c in w["causes"]] == ["death_declared"]
    assert w["causes"][0]["peer"] == 3
    assert mon_main(["--report", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schema"] == "bftpu-monitor-report/1"


# ---------------------------------------------------------------------------
# chaos e2e (slow): np=4 writers, live daemon, SIGKILL + respawn,
# every alert window attributed, zero false alarms
# ---------------------------------------------------------------------------


def _mon_e2e_worker(job, rank, nranks, dead_ev, heal_ev, stop_ev, q):
    from bluefog_tpu_torch.introspect import statuspage as spw

    page = spw.StatusPage(job, rank)
    step = 0
    peers = [p for p in range(nranks) if p != rank]
    q.put(("up", rank))
    try:
        while not stop_ev.is_set():
            step += 1
            dead = dead_ev.is_set() and not heal_ev.is_set()
            page.publish(
                nranks=nranks, step=step, epoch=1, op_id=step,
                last_op="gossip",
                ledger={"deposits": 4.0, "collected": 2.0, "drained": 2.0},
                edges=[(p, 2 if dead and p == 2 else 0, 1.0)
                       for p in peers])
            time.sleep(0.05)
    finally:
        page.close(unlink=True)


@pytest.mark.slow
def test_monitor_chaos_e2e_kill_respawn_all_attributed(tmp_path,
                                                       monkeypatch):
    """np=4 page writers with a real monitor daemon attached (scrape
    50 ms, every 5th scrape chaos-dropped).  Rank 2 is SIGKILLed; the
    survivors mark their edge to it DEAD and the parent journals the
    death_declared; rank 2 respawns and the parent journals the heal.
    Exactly the edge_dead alert fires (one gap-closed window riding out
    the dropped scrapes), ``--report`` attributes it to the journaled
    causes with zero unattributed, and no other rule alarms."""
    job = f"mone2e{os.getpid()}"
    shm = tmp_path / "shm"
    tdir = tmp_path / "tel"
    shm.mkdir()
    tdir.mkdir()
    monkeypatch.setenv("BLUEFOG_SHM_DIR", str(shm))
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(shm))
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tdir))
    monkeypatch.setenv("BLUEFOG_ISLAND_JOB", job)
    monkeypatch.setenv("BLUEFOG_ISLAND_RANK", "0")
    telemetry.reset()
    reg = telemetry.get_registry()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    dead_ev, heal_ev, stop_ev = ctx.Event(), ctx.Event(), ctx.Event()
    procs = {}
    respawn = None
    daemon = None
    try:
        for r in range(4):
            p = ctx.Process(target=_mon_e2e_worker,
                            args=(job, r, 4, dead_ev, heal_ev, stop_ev, q))
            p.start()
            procs[r] = p
        for _ in range(4):
            assert q.get(timeout=120)[0] == "up"
        env = dict(os.environ, BFTPU_MON_SCRAPE_S="0.05",
                   BFTPU_CHAOS_MON_DROP_SCRAPE="5")
        derr = open(tmp_path / "daemon.err", "wb")
        daemon = subprocess.Popen(
            [sys.executable, "-m", "bluefog_tpu_torch.monitor", "--job", job,
             "--daemon"], env=env, stdout=subprocess.DEVNULL,
            stderr=derr)
        # wait for the daemon's lamp page: it is scraping for real
        lamp_path = sp.status_page_path(job, MONITOR_RANK)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            try:
                if sp.read_status_page(lamp_path)["alert"]["state"] >= 0:
                    break
            except (OSError, ValueError, sp.TornPageError):
                pass
            time.sleep(0.05)
        else:
            pytest.fail("monitor daemon never published its lamp page")
        time.sleep(0.6)  # a clean baseline: no rule may fire here
        os.kill(procs[2].pid, signal.SIGKILL)
        procs[2].join(timeout=30)
        assert procs[2].exitcode == -signal.SIGKILL
        reg.journal("death_declared", peer=2)
        dead_ev.set()
        time.sleep(1.0)  # several scrapes observe the DEAD edges
        # the lamp must be firing the edge_dead alert right now
        lamp = sp.read_status_page(lamp_path)
        assert lamp["alert"] == {"state": 1, "last": "edge_dead"}
        respawn = ctx.Process(target=_mon_e2e_worker,
                              args=(job, 2, 4, dead_ev, heal_ev, stop_ev,
                                    q))
        respawn.start()
        assert q.get(timeout=120)[0] == "up"
        reg.journal("heal", peer=2)
        heal_ev.set()
        time.sleep(1.2)  # quiet past the gap: the window closes
        # tear the monitor down first, while the fleet is still alive —
        # it is deterministically inside its scrape loop, so SIGTERM
        # exercises the handler path (not the linger self-exit race)
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=60)
        derr.close()
        assert rc == 0, (rc, (tmp_path / "daemon.err").read_bytes())
        stop_ev.set()
        for p in list(procs.values()) + [respawn]:
            if p.exitcode is None:
                p.join(timeout=30)
    finally:
        stop_ev.set()
        for p in list(procs.values()) + ([respawn] if respawn else []):
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        if daemon is not None and daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=30)
        telemetry.reset()
    # the store survived the daemon: the incident is in the history
    doc = mstore.export_json(job)
    dead = [s for s in doc["series"]
            if (s["series"], s["subject"]) == ("dead_edges", "fleet")]
    assert dead and max(v for _, v in dead[0]["tiers"]["raw"]) >= 1.0
    # exactly the expected alert fired, and every window is attributed
    rep = monitor_report([str(tdir)])
    assert rep["total_windows"] >= 1
    assert {w["rule"] for w in rep["windows"]} == {"edge_dead"}
    assert rep["unattributed"] == 0, rep["windows"]
    kinds = {c["kind"] for w in rep["windows"] for c in w["causes"]}
    assert "death_declared" in kinds and "heal" in kinds
    # the acceptance gate: the CLI agrees, exit 0
    assert mon_main(["--report", str(tdir)]) == 0



# ---------------------------------------------------------------------------
# cross-package: the JAX package's monitor is the reference
# ---------------------------------------------------------------------------

import random  # noqa: E402

import numpy as np  # noqa: E402

from bluefog_tpu.monitor import report as ref_report  # noqa: E402
from bluefog_tpu.monitor import rules as ref_rules  # noqa: E402
from bluefog_tpu.monitor import scraper as ref_scraper  # noqa: E402
from bluefog_tpu.monitor import store as ref_store  # noqa: E402
from bluefog_tpu.native import shm_native as ref_shm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """``chip_smoke.py`` (the repo root's): its monitor runs take a
    device argument, so the CPU runs here are the card run's gates."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _rule_rows(rules):
    return [(r.name, r.series, r.op, r.threshold, r.doc) for r in rules]


def test_rule_table_and_env_overrides_match_reference(monkeypatch):
    assert _rule_rows(mrules.default_rules()) == _rule_rows(ref_rules.default_rules())
    monkeypatch.setenv("BFTPU_MON_RULES", json.dumps(
        {"serve_lag": {"threshold": 2.0}, "orphan": {"disabled": True}}))
    monkeypatch.setenv("BFTPU_MON_CONV_PLATEAU_S", "7")
    assert _rule_rows(mrules.load_rules()) == _rule_rows(ref_rules.load_rules())
    assert mrules.mon_gap_s() == ref_rules.mon_gap_s()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alert_engine_windows_match_reference(seed):
    """A seeded stream of samples over every rule's series: the same
    firings, the same gap-closed windows, the same lamp."""
    rng = random.Random(seed)
    series = sorted({r.series for r in mrules.default_rules()})
    engines = [AlertEngine(gap_s=0.3), ref_rules.AlertEngine(gap_s=0.3)]
    for i in range(300):
        t = 0.1 * i
        pts = [(name, rng.choice(["fleet", "r0", "r1"]),
                rng.choice([0.0, 0.0, 0.0, 1.0, 5e-6, 2.0, 50.0, 120.0]))
               for name in rng.sample(series, 4)]
        for eng in engines:
            eng.feed(t, pts, wall=1000.0 + t)
        assert engines[0].state == engines[1].state
        assert engines[0].last_alert == engines[1].last_alert
    for eng in engines:
        eng.close()
    assert engines[0].windows == engines[1].windows
    assert (engines[0].samples, engines[0].firings) == (engines[1].samples,
                                                        engines[1].firings)


def _random_fleet(rng, n):
    states = ["alive", "suspect", "dead", "demoted"]
    return {r: _page(balance=float(rng.choice([0.0, 1.0, -2.0, 1e-9])),
                     step=int(rng.integers(0, 4)), nranks=n,
                     edges=[{"peer": p, "state": states[int(rng.integers(0, 4))]}
                            for p in range(n) if p != r and rng.random() < 0.5],
                     orphan=bool(rng.random() < 0.2),
                     serve={"version": int(rng.integers(-1, 5)),
                            "lag": int(rng.integers(-1, 12)),
                            "slo_state": int(rng.integers(-1, 2))},
                     distrib={"slot": int(rng.integers(-1, 3))},
                     conv={"round": int(rng.integers(-1, 30)),
                           "err": float(rng.choice([-1.0, 0.5, 0.1, 1e-3]))})
            for r in range(n)}


def test_sampler_points_match_reference():
    rng = np.random.default_rng(0)
    port, ref = FleetSampler(), ref_scraper.FleetSampler()
    for i in range(60):
        fleet = _random_fleet(rng, int(rng.integers(1, 6)))
        assert port.sample(fleet, 0.5 * i) == ref.sample(fleet, 0.5 * i)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_written_by_either_package_reads_in_the_other(tmp_path, monkeypatch,
                                                            writer):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    monkeypatch.setattr(ref_shm, "_FALLBACK_DIR", str(tmp_path))
    w_mod, r_mod = (mstore, ref_store) if writer == "port" else (ref_store, mstore)
    st = w_mod.MonitorStore("xs", create=True, nslots=8, cap_raw=16)
    for i in range(37):
        st.append("dead_edges", "fleet", 10.0 + i, float(i % 5))
        st.append("serve_lag", f"r{i % 3}", 10.0 + i, float(i))
    snap = st.snapshot()
    st.close()
    other = r_mod.MonitorStore("xs")
    try:
        assert other.snapshot() == snap
        assert other.to_json() == w_mod.MonitorStore("xs").to_json()
        assert r_mod.export_prometheus("xs") == w_mod.export_prometheus("xs")
    finally:
        other.close(unlink=True)


def test_report_matches_reference(tmp_path, capsys):
    """The same journals (alert windows, causes near and far, events
    that explain nothing) give the same attribution and text."""
    rng = random.Random(3)
    kinds = list(ref_report.MON_CAUSE_KINDS) + ["tick", "conv"] * 40
    for rank in (0, 1, 2000):
        lines = []
        for i in range(40):
            ts = 1000.0 + 7.0 * i + rng.random()
            if rank == 2000 and i % 4 == 0:
                lines.append({"event": "alert", "ts": ts, "rank": rank,
                              "rule": rng.choice(["edge_dead", "serve_lag"]),
                              "subject": "fleet", "series": "dead_edges",
                              "t0_wall": ts, "t1_wall": ts + rng.random() * 3,
                              "samples": 3, "worst": 2.0})
            else:
                lines.append({"event": rng.choice(kinds), "ts": ts, "rank": rank})
        (tmp_path / f"telemetry-rj-r{rank}.events.jsonl").write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    for margin in (0.5, 2.0):
        assert monitor_report([str(tmp_path)], margin_s=margin) \
            == ref_report.monitor_report([str(tmp_path)], margin_s=margin)
    rep = monitor_report([str(tmp_path)])
    assert rep["unattributed"] > 0
    assert ref_report.format_report(rep) == \
        __import__("bluefog_tpu_torch.monitor.report",
                   fromlist=["format_report"]).format_report(rep)
    assert mon_main(["--report", str(tmp_path)]) == 1
    capsys.readouterr()


def test_monitored_serving_run_on_the_cpu_is_quiet(monkeypatch):
    """``bftpu-torch-run --islands 2 --monitor --lab-probe
    --serve-replicas 1`` over ``examples/serve_islands`` (LeNet-5's
    window, the replica on the CPU): exit 0, >= 1 scrape, 0 alert
    windows, the export armed with serve_lag and the probe's series, a
    clean report, rank 0's conv trail journaled, no segment left —
    ``chip_smoke.py``'s (a) gates at CPU size."""
    monkeypatch.setenv("BFTPU_SERVE_DEVICE", "cpu")
    chip_smoke = _chip_smoke()
    row = chip_smoke._monitored_clean_run(REPO, device="cpu", model="lenet5")
    assert row["alert_windows"] == 0 and row["report_rc"] == 0
    assert len(row["conv_err_trail"]) == 3 * chip_smoke.SERVE_VERSIONS - 1


def test_kill_under_the_launcher_raises_exactly_the_expected_alerts():
    """``bftpu-torch-run --islands 4 --monitor`` over
    ``examples/chaos_heal`` with rank 2 SIGKILLed by the chaos schedule:
    the survivors heal to 3 ranks and the report explains every window by
    the journaled death and heal; the windows' rules are exactly
    ``chip_smoke.MONITOR_KILL_ALERTS`` — the set the card run is gated
    on."""
    chip_smoke = _chip_smoke()
    row = chip_smoke._monitored_kill_run(REPO, device="cpu")
    assert set(row["report_rules"]) == chip_smoke.MONITOR_KILL_ALERTS == {"edge_dead"}
    assert row["unattributed"] == 0 and row["report_rc"] == 0
    assert sorted(row["survivors"]) == [0, 1, 3]
