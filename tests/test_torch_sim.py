"""Port twin of ``tests/test_sim.py``: the same cases against
``bluefog_tpu_torch.sim``, then the cross-package cases — for the same
``SimConfig`` and schedule, the port's ``run_campaign`` gives the JAX
package's digest, event log, verdict and final state exactly (no
tolerance): the canonical kill + join, a seeded bug, 64 ranks, serving,
partition, traffic, distribution, lab-trace and monitored campaigns, the
rule families' own campaigns, and (slow) the 256-rank acceptance
campaign, whose digest ``chip_smoke.py`` pins.

The deterministic fleet simulator (bluefog_tpu_torch/sim/).

Three layers of coverage, all wall-clock-free except where marked:

- **fake-clock units** — the real protocol machines fire at EXACT
  virtual instants: ``FailureDetector`` declares death one tick past
  the timeout (and honors startup grace), ``EdgeHealth`` holds its
  hysteresis floor to the virtual second, ``MembershipBoard.
  wait_for_grant`` raises at the virtual deadline without sleeping;
- **shared schedule format** — JSON round-trips losslessly, the chaos
  env projection lifts back, ``clear_schedule`` scrubs the sim keys;
- **campaigns** — the canonical kill→heal→join elastic scenario (the
  deterministic port of the np=4 wall-clock e2e in
  tests/test_resilience.py), same-seed determinism at N=64, the
  shrink-to-seed repro pipeline, and (marked slow) the 256-rank
  acceptance campaign.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.resilience.detector import (
    EDGE_ALIVE, EDGE_SUSPECT, EdgeHealth, FailureDetector)
from bluefog_tpu_torch.resilience.join import MembershipBoard
from bluefog_tpu_torch.sim.campaign import (
    REPRO_SCHEMA, SimConfig, load_repro, replay, run_campaign,
    shrink_schedule, write_repro)
from bluefog_tpu_torch.sim.clock import FakeClock
from bluefog_tpu_torch.sim.events import EventLoop, VirtualClock
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule
from bluefog_tpu_torch.sim.transport import SimTransport

pytestmark = pytest.mark.sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# fake-clock units: the real machines at exact virtual deadlines
# ---------------------------------------------------------------------------


class _FakeJob:
    """Duck-typed job transport over a dict of liveness stamps."""

    def __init__(self, clock: FakeClock):
        self._clock = clock
        self.stamps = {}

    def heartbeat(self):
        self.stamps[0] = self._clock.now()

    def liveness(self, rank):
        return self.stamps.get(rank, 0.0)


def test_failure_detector_fires_at_exact_virtual_deadline():
    fc = FakeClock(start=100.0)
    job = _FakeJob(fc)
    det = FailureDetector(job, rank=0, nranks=3, timeout=1.0,
                          interval=0.05, clock=fc.now)
    job.stamps[1] = fc.now()  # peer 1 beat once at t=100

    fc.advance(1.0)  # t=101: exactly at the timeout boundary
    assert det.is_alive(1), "boundary instant is still alive (<=)"
    assert det.is_alive(2), "peer 2 rides startup grace from birth"
    assert det.dead_ranks() == set()

    fc.advance(1e-9)  # one tick past: both deadlines expire together
    assert not det.is_alive(1)
    assert not det.is_alive(2), "startup grace ends at born+timeout"
    assert det.dead_ranks() == {1, 2}

    # monotone: a late heartbeat cannot resurrect a declared corpse
    job.stamps[1] = fc.now()
    assert not det.is_alive(1)
    assert det.dead_ranks() == {1, 2}


def test_edge_health_hysteresis_floor_to_the_virtual_second():
    fc = FakeClock(start=50.0)
    eh = EdgeHealth(misses=3, clean=5, floor_s=2.0, clock=fc.now)

    assert eh.note_miss(7) == EDGE_ALIVE
    assert eh.note_miss(7) == EDGE_ALIVE
    assert eh.note_miss(7) == EDGE_SUSPECT  # third miss demotes at t=50

    # a full clean streak inside the floor must NOT promote
    fc.advance(1.999999)
    for _ in range(5):
        state = eh.note_clean(7)
    assert state == EDGE_SUSPECT, "promotion before the floor expired"

    # at exactly floor_s past the transition the next clean promotes
    fc.advance(0.000001)
    assert eh.note_clean(7) == EDGE_ALIVE
    assert fc.now() == pytest.approx(52.0)


def test_join_lease_times_out_at_exact_virtual_deadline():
    fc = FakeClock(start=0.0)
    board = MembershipBoard(f"simlease{os.getpid()}", clock=fc)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        board.wait_for_grant("req-never-granted", timeout=5.0)
    assert time.monotonic() - t0 < 1.0, "the wait must not wall-sleep"
    # the poll loop ran entirely on the fake clock and stopped at the
    # first poll instant past the 5s virtual deadline
    assert fc.now() >= 5.0
    assert fc.slept, "the grant poll never slept (busy-wait)"
    assert fc.now() - 5.0 <= max(fc.slept)


# ---------------------------------------------------------------------------
# shared fault-schedule format
# ---------------------------------------------------------------------------


def _sample_schedule() -> FaultSchedule:
    return FaultSchedule([
        Fault(kind="kill", step=3, rank=1),
        Fault(kind="suspend", step=4, rank=2, duration_s=3.0),
        Fault(kind="slow", step=5, rank=0, duration_s=0.7, stop=9),
        Fault(kind="join", step=6, rank=7),
    ], seed=12)


def test_schedule_json_roundtrip_lossless():
    sched = _sample_schedule()
    back = FaultSchedule.from_json(sched.to_json())
    assert back == sched
    assert back.seed == 12
    with pytest.raises(ValueError):
        FaultSchedule.from_json(json.dumps({"schema": "nope"}))


def test_schedule_env_roundtrip_one_per_kind():
    sched = _sample_schedule()
    env = sched.to_env({})
    lifted = FaultSchedule.from_env(env)
    # chaos env capacity is one fault per kind; our sample is exactly
    # one per kind, so the lift is lossless
    assert lifted == sched


def test_schedule_env_projection_keeps_earliest_of_each_kind():
    sched = FaultSchedule([
        Fault(kind="kill", step=3, rank=1),
        Fault(kind="kill", step=8, rank=2),
    ])
    env = sched.to_env({})
    lifted = FaultSchedule.from_env(env)
    assert len(lifted) == 1
    assert lifted.faults[0].step == 3 and lifted.faults[0].rank == 1


def test_clear_schedule_scrubs_sim_env_keys():
    os.environ["BFTPU_SIM_SEED"] = "7"
    os.environ["BFTPU_SIM_RANKS"] = "64"
    os.environ["BFTPU_SIM_SCHEDULE"] = "/tmp/nope.json"
    chaos.schedule_kill(os.environ, rank=1, step=3)
    chaos.clear_schedule()
    for k in ("BFTPU_SIM_SEED", "BFTPU_SIM_RANKS", "BFTPU_SIM_SCHEDULE",
              chaos._KILL_RANK):
        assert k not in os.environ, k


def test_generate_is_deterministic_and_bounded():
    a = FaultSchedule.generate(9, ranks=64, rounds=50)
    b = FaultSchedule.generate(9, ranks=64, rounds=50)
    assert a == b and a.to_json() == b.to_json()
    kills = [f for f in a if f.kind == "kill"]
    assert len(kills) <= 16, "kills capped at a quarter of the fleet"
    assert all(1 <= f.step <= 34 for f in a
               if f.kind != "join"), "faults land in the first 2/3"


# ---------------------------------------------------------------------------
# transport mutex contract (holder-attributed, virtual-clock timed)
# ---------------------------------------------------------------------------


def test_sim_mutex_contract():
    loop = EventLoop()
    clock = VirtualClock(loop)
    tr = SimTransport(loop, clock)
    assert tr.mutex_acquire("w", holder=1)
    assert tr.mutex_holder("w") == 1
    t0 = clock.now()
    wall0 = time.monotonic()
    assert not tr.mutex_acquire("w", holder=2, timeout_s=0.5)
    assert clock.now() - t0 >= 0.5, "contended acquire spun virtually"
    assert time.monotonic() - wall0 < 1.0, "and consumed no wall time"
    tr.mutex_release("w", holder=2)  # wrong holder: no-op
    assert tr.mutex_holder("w") == 1
    tr.mutex_release("w", holder=1)
    assert tr.mutex_holder("w") is None
    assert tr.mutex_acquire("w", holder=2)


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------


def test_kill_heal_join_sim_canonical():
    """The deterministic port of the np=4 elastic e2e: one rank is
    killed mid-gossip, survivors heal, a joiner is granted the next
    fresh global rank, every member switches epochs, and the grown
    fleet converges with a balanced ledger — bit-reproducible, no
    subprocesses, no wall clock."""
    size, victim = 4, 1
    cfg = SimConfig(ranks=size, rounds=30, seed=0, quiesce_rounds=25,
                    faults=("kill", "join"))
    sched = FaultSchedule([
        Fault(kind="kill", step=3, rank=victim),
        Fault(kind="join", step=15, rank=size),
    ], seed=0)
    res = run_campaign(cfg, sched)
    assert res.ok, res.violations[:3]

    members = set(res.final["members"])
    assert victim not in members, "the corpse must be excised"
    assert size in members, "the joiner gets the next fresh rank"
    assert members == {0, 2, 3, 4}
    assert res.final["epoch"] >= 1, "the join must switch epochs"

    led = res.final["ledger"]
    assert led["balanced"], led
    # all four members (including the joiner) agree on the estimate
    ests = res.final["estimates"]
    assert set(ests) == members
    vals = sorted(ests.values())
    assert vals[-1] - vals[0] < 1e-2 * max(1.0, abs(vals[0]))

    # the same campaign replays bit for bit
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest
    assert again.event_log == res.event_log


def test_determinism_same_seed_twice_n64():
    cfg = SimConfig(ranks=64, rounds=30, seed=11, quiesce_rounds=20)
    a = run_campaign(cfg)
    b = run_campaign(cfg)
    assert a.digest == b.digest
    assert a.event_log == b.event_log
    assert a.ok and b.ok, a.violations[:3]


def test_shrink_catches_seeded_bug_and_repro_roundtrips(tmp_path):
    cfg = SimConfig(ranks=16, rounds=20, seed=3, quiesce_rounds=10,
                    debug_bugs=("mass_leak",))
    res = run_campaign(cfg)
    assert not res.ok, "the seeded mass leak must be caught"
    assert any(v["name"] == "mass-conservation" for v in res.violations)

    minimal, viol, runs = shrink_schedule(cfg, res.schedule)
    assert viol is not None and viol["name"] == "mass-conservation"
    # a pure code bug reproduces with no faults at all: ddmin must
    # shrink the schedule to empty
    assert len(minimal) == 0, list(minimal)
    assert runs >= 2

    path = str(tmp_path / "repro.json")
    write_repro(path, cfg, minimal, viol, digest=res.digest)
    cfg2, sched2, doc = load_repro(path)
    assert doc["schema"] == REPRO_SCHEMA
    assert cfg2 == cfg and sched2 == minimal
    rr = replay(path)
    assert any(v["name"] == "mass-conservation" for v in rr.violations)


def test_campaign_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    ok = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.sim", "--ranks", "16",
         "--rounds", "20", "--seed", "3", "--quiesce-rounds", "10",
         "--repro-dir", str(tmp_path), "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert json.loads(ok.stdout)["ok"] is True

    bad = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.sim", "--ranks", "16",
         "--rounds", "20", "--seed", "3", "--quiesce-rounds", "10",
         "--debug-bug", "mass_leak", "--repro-dir", str(tmp_path),
         "--json"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    payload = json.loads(bad.stdout)
    assert payload["ok"] is False
    repro = payload["shrunk"]["repro"]
    assert os.path.exists(repro)
    rr = replay(repro)
    assert any(v["name"] == "mass-conservation" for v in rr.violations)


def test_campaign_journal_validates_with_telemetry_check(tmp_path):
    """Sim ranks with a journal dir write real telemetry journals and
    snapshots; the telemetry CLI's conservation rules accept them."""
    out = str(tmp_path / "telem")
    cfg = SimConfig(ranks=8, rounds=20, seed=1, quiesce_rounds=15,
                    journal_dir=out)
    res = run_campaign(cfg)
    assert res.ok, res.violations[:3]
    files = os.listdir(out)
    snaps = [f for f in files
             if f.startswith("telemetry-") and f.endswith(".json")]
    journals = [f for f in files if f.endswith(".events.jsonl")]
    assert len(snaps) == len(res.final["members"])
    assert journals, "sim ranks must emit event journals too"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.telemetry", out, "--check"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.slow
def test_campaign_256_acceptance():
    """The acceptance bar: a seeded 256-rank campaign (kills +
    slowdowns + joins over exp2) completes in under a minute of wall
    clock, twice, bit-identically, with a balanced ledger and
    consensus at quiesce."""
    cfg = SimConfig(ranks=256, rounds=50, seed=7, quiesce_rounds=40)
    t0 = time.monotonic()
    a = run_campaign(cfg)
    dt = time.monotonic() - t0
    assert dt < 60.0, f"campaign took {dt:.1f}s"
    assert a.ok, a.violations[:3]
    assert a.final["ledger"]["balanced"]
    kinds = {f.kind for f in a.schedule}
    assert "kill" in kinds and ("slow" in kinds or "join" in kinds)

    b = run_campaign(cfg)
    assert b.digest == a.digest
    assert b.event_log == a.event_log



# ---------------------------------------------------------------------------
# cross-package parity: the JAX package's simulator is the reference
# ---------------------------------------------------------------------------

import importlib  # noqa: E402

from bluefog_tpu.sim import campaign as ref_campaign  # noqa: E402
from bluefog_tpu.sim import schedule as ref_schedule  # noqa: E402
from bluefog_tpu_torch.sim import campaign as port_campaign  # noqa: E402
from bluefog_tpu_torch.sim import schedule as port_schedule  # noqa: E402

PACKAGES = {"ref": (ref_campaign, ref_schedule), "port": (port_campaign, port_schedule)}


def _kill_join(cm, sm):
    return (cm.SimConfig(ranks=4, rounds=30, seed=0, quiesce_rounds=25,
                         faults=("kill", "join")),
            sm.FaultSchedule([sm.Fault(kind="kill", step=3, rank=1),
                              sm.Fault(kind="join", step=15, rank=4)], seed=0))


def _serving(cm, sm):
    return (cm.SimConfig(ranks=16, rounds=24, seed=3, serve_every=3,
                         serve_replicas=3),
            sm.FaultSchedule([sm.Fault(kind="serve_kill", step=2, rank=0, stop=16)]))


def _partition(cm, sm):
    return (cm.SimConfig(ranks=16, rounds=20, seed=7, quiesce_rounds=20,
                         faults=("partition",)),
            sm.FaultSchedule([sm.Fault.partition([list(range(5))], 5, 14)], seed=7))


def _distrib(cm, sm):
    return (cm.SimConfig(ranks=16, rounds=24, seed=13, serve_every=3,
                         serve_replicas=12, distrib_fanout=3, distrib_slo=4,
                         distrib_join_round=10, distrib_join_n=4),
            sm.FaultSchedule([sm.Fault(kind="serve_kill", step=2, rank=0, stop=14),
                              sm.Fault(kind="serve_kill", step=4, rank=1)], seed=13))


def _traffic(cm, sm):
    return (cm.SimConfig(ranks=16, rounds=24, seed=7, serve_every=3,
                         serve_replicas=3, arrivals="poisson", arrival_rate=4.0),
            sm.FaultSchedule([sm.Fault(kind="serve_kill", step=2, rank=0, stop=16)]))


PARITY_CASES = {
    "kill_join": _kill_join,
    "mass_leak_n16": lambda cm, sm: (cm.SimConfig(ranks=16, rounds=20, seed=3,
                                                  quiesce_rounds=10,
                                                  debug_bugs=("mass_leak",)), None),
    "n64_seed11": lambda cm, sm: (cm.SimConfig(ranks=64, rounds=30, seed=11,
                                               quiesce_rounds=20), None),
    "serving": _serving,
    "partition": _partition,
    "distrib": _distrib,
    "traffic": _traffic,
    "monitor_n16": lambda cm, sm: (cm.SimConfig(ranks=16, rounds=20, seed=3,
                                                quiesce_rounds=10, monitor=True), None),
    "monitor_mass_leak": lambda cm, sm: (cm.SimConfig(ranks=16, rounds=20, seed=3,
                                                      quiesce_rounds=10, monitor=True,
                                                      debug_bugs=("mass_leak",)), None),
    "faults_n32": lambda cm, sm: (cm.SimConfig(ranks=32, rounds=30, seed=7,
                                               faults=("kill", "suspend", "slow",
                                                       "join")), None),
    "lab_trace": lambda cm, sm: (cm.SimConfig(ranks=8, rounds=20, seed=2,
                                              quiesce_rounds=10, lockstep=True,
                                              trace_consensus=True), None),
}


def _both(case):
    out = {}
    for name, (cm, sm) in PACKAGES.items():
        cfg, sched = PARITY_CASES[case](cm, sm)
        out[name] = cm.run_campaign(cfg, sched)
    return out["ref"], out["port"]


def _same(a, b):
    assert b.digest == a.digest
    assert b.event_log == a.event_log
    assert b.ok == a.ok
    assert b.final == a.final
    assert b.violations == a.violations
    assert b.schedule.to_json() == a.schedule.to_json()
    assert b.consensus_trace == a.consensus_trace


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_campaign_matches_reference_bit_for_bit(case):
    a, b = _both(case)
    _same(a, b)
    if case == "kill_join":
        assert a.ok and set(b.final["members"]) == {0, 2, 3, 4}
    if case.startswith("monitor"):
        assert b.final["monitor"] == a.final["monitor"]
    if case == "mass_leak_n16":
        assert not b.ok
    if case == "partition":
        assert any(e[1] == "orphan" for e in b.event_log)
    if case == "distrib":
        assert any(e[1].startswith("distrib") for e in b.event_log)
    if case == "lab_trace":
        assert b.consensus_trace


def test_shrink_matches_reference():
    cfgs = {}
    for name, (cm, sm) in PACKAGES.items():
        cfg = cm.SimConfig(ranks=16, rounds=20, seed=3, quiesce_rounds=10,
                           debug_bugs=("mass_leak",))
        res = cm.run_campaign(cfg)
        cfgs[name] = cm.shrink_schedule(cfg, res.schedule)
    (ma, va, ra), (mb, vb, rb) = cfgs["ref"], cfgs["port"]
    assert mb.to_json() == ma.to_json() and vb == va and rb == ra


def test_repro_written_by_either_package_replays_in_the_other(tmp_path):
    """A repro file is the packages' shared currency: each replays the
    other's bit for bit."""
    for src, dst in (("ref", "port"), ("port", "ref")):
        cm, _sm = PACKAGES[src]
        cfg = cm.SimConfig(ranks=16, rounds=20, seed=3, quiesce_rounds=10,
                           debug_bugs=("mass_leak",))
        res = cm.run_campaign(cfg)
        path = str(tmp_path / f"repro-{src}.json")
        cm.write_repro(path, cfg, res.schedule, res.violations[0], digest=res.digest)
        again = PACKAGES[dst][0].replay(path)
        assert again.digest == res.digest and again.event_log == res.event_log


@pytest.mark.parametrize("family,helper", [
    ("serve_rules", "selftest_serve_campaigns"),
    ("slo_rules", "selftest_slo_campaigns"),
    ("distrib_rules", "selftest_distrib_campaigns"),
])
def test_rule_family_campaigns_match_reference(family, helper):
    """The families' own pinned campaigns, run through each package's
    copy of the family: the same labels, results and findings."""
    ref = getattr(importlib.import_module(f"bluefog_tpu.analysis.{family}"), helper)()
    port = getattr(importlib.import_module(f"bluefog_tpu_torch.analysis.{family}"), helper)()
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (la, ra, fa), (lb, rb, fb) in zip(ref, port):
        _same(ra, rb)
        assert [(f.rule, f.subject, f.message) for f in fb] \
            == [(f.rule, f.subject, f.message) for f in fa]


@pytest.mark.slow
def test_campaign_256_matches_reference_and_the_chip_smoke_pin():
    """The acceptance campaign through both packages, and the digest
    ``chip_smoke.py`` holds the card's host to."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    cfgs = {n: cm.SimConfig(ranks=256, rounds=50, seed=7, quiesce_rounds=40)
            for n, (cm, _sm) in PACKAGES.items()}
    a = ref_campaign.run_campaign(cfgs["ref"])
    b = port_campaign.run_campaign(cfgs["port"])
    _same(a, b)
    assert b.ok and b.final["ledger"]["balanced"]
    assert b.digest == chip_smoke.SIM_256_DIGEST
