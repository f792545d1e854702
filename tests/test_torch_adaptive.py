"""Port twin of ``tests/test_adaptive.py``: the same cases against
``bluefog_tpu_torch``, the adaptive and plan rule families and the
fixture corpus of ``bluefog_tpu_torch.analysis`` included.

Adaptive topology: the straggler-aware gray-failure control loop
(docs/RESILIENCE.md, "Adaptive topology").

The heartbeat detector catches DEAD ranks; these tests pin the harder
contract for SLOW ones: the per-edge deadline policy (adaptive floor
over the pooled p50), the three-state EdgeHealth machine with its
hysteresis floor, the degree-capping :func:`demote_topology` (straggler
retained, never excised), the round-local ABSORB combine, and the full
np=4 live cycle — a rank slowed past the deadline is demoted WITHOUT a
death declaration, gossip converges around it, and recovery promotes it
back through its anchor.
"""

import os
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.analysis import adaptive_rules, plan_rules
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import adaptive, chaos, healing
from bluefog_tpu_torch.resilience.detector import (
    EDGE_ALIVE, EDGE_DEAD, EDGE_SUSPECT, EdgeHealth)

# ---------------------------------------------------------------------------
# EdgeHealth: the three-state machine on a fake clock
# ---------------------------------------------------------------------------


def _clocked(misses=3, clean=5, floor_s=1.0):
    now = [0.0]
    eh = EdgeHealth(misses=misses, clean=clean, floor_s=floor_s,
                    clock=lambda: now[0])
    return eh, now


def test_edge_health_demotes_on_miss_streak():
    eh, _now = _clocked(misses=3)
    assert eh.note_miss(7) == EDGE_ALIVE
    assert eh.note_miss(7) == EDGE_ALIVE
    assert eh.note_miss(7) == EDGE_SUSPECT
    assert eh.suspects() == {7}


def test_edge_health_clean_resets_miss_streak():
    """An innocent rank that keeps depositing never accumulates the
    streak — the property that absorbs the mutex-attribution error."""
    eh, _now = _clocked(misses=3)
    for _ in range(20):
        eh.note_miss(7)
        eh.note_miss(7)
        eh.note_clean(7)  # a fresh deposit wipes the streak
    assert eh.state(7) == EDGE_ALIVE


def test_edge_health_promotes_after_floor():
    eh, now = _clocked(misses=3, clean=5, floor_s=1.0)
    for _ in range(3):
        eh.note_miss(7)
    assert eh.state(7) == EDGE_SUSPECT
    # a full clean streak INSIDE the floor must not promote yet
    for _ in range(10):
        eh.note_clean(7)
    assert eh.state(7) == EDGE_SUSPECT
    now[0] = 1.5  # floor open; the streak completes the promote
    for _ in range(5):
        eh.note_clean(7)
    assert eh.state(7) == EDGE_ALIVE


def test_edge_health_flapping_cannot_thrash():
    """Alternating miss/clean as fast as observations arrive: streaks
    never complete, so the machine never transitions at all."""
    eh, now = _clocked(misses=3, clean=5, floor_s=1.0)
    for i in range(1000):
        (eh.note_miss if i % 2 else eh.note_clean)(7)
        now[0] += 0.01
    assert eh.state(7) == EDGE_ALIVE
    assert eh.transitions() == []




def test_edge_health_floor_bounds_cycle():
    """Even with thresholds at 1 (hair trigger), consecutive transitions
    for one peer are >= floor_s apart — audited by the same rule the
    analysis family runs."""
    eh, now = _clocked(misses=1, clean=1, floor_s=1.0)
    for _ in range(500):
        eh.note_miss(7)
        eh.note_clean(7)
        now[0] += 0.05
    log = eh.transitions()
    assert len(log) >= 2
    assert adaptive_rules.check_hysteresis(log, 1.0, "unit") == []


def test_edge_health_dead_is_absorbing_and_floor_exempt():
    eh, now = _clocked(misses=3, floor_s=10.0)
    for _ in range(3):
        eh.note_miss(7)
    assert eh.state(7) == EDGE_SUSPECT
    now[0] += 0.01  # way inside the floor: death is never delayed
    assert eh.note_dead(7) == EDGE_DEAD
    for _ in range(50):
        eh.note_clean(7)
    assert eh.state(7) == EDGE_DEAD
    assert eh.absolve(7) == EDGE_DEAD  # promote verdicts cannot revive




def test_edge_health_absolve_mirrors_fleet_verdict():
    eh, now = _clocked(misses=3)
    for _ in range(3):
        eh.note_miss(7)
    assert eh.state(7) == EDGE_SUSPECT
    now[0] = 5.0
    assert eh.absolve(7) == EDGE_ALIVE
    log = eh.transitions()
    assert log[-1]["adopted"] and log[-1]["to"] == EDGE_ALIVE
    assert eh.absolve(7) == EDGE_ALIVE  # idempotent: no second event
    assert len(eh.transitions()) == len(log)
    # the mirror restarts the local floor: an immediate relapse is gated
    for _ in range(3):
        eh.note_miss(7)
    assert eh.state(7) == EDGE_ALIVE
    now[0] = 6.5
    eh.note_miss(7)
    assert eh.state(7) == EDGE_SUSPECT
    assert adaptive_rules.check_hysteresis(eh.transitions(), 1.0, "unit") == []


# ---------------------------------------------------------------------------
# AdaptivePolicy: the deadline policy on a fake clock
# ---------------------------------------------------------------------------


def test_policy_warmup_has_no_deadline():
    pol = adaptive.AdaptivePolicy(floor_s=0.25, factor=8, min_obs=8)
    for _ in range(7):
        pol.note_fresh(1, 0.01)
    assert pol.gap_deadline_s() is None
    assert pol.note_stale(1, age_s=999.0) is False  # warmup: nothing misses
    pol.note_fresh(1, 0.01)
    assert pol.gap_deadline_s() is not None


def test_policy_deadline_is_floored_p50_multiple():
    pol = adaptive.AdaptivePolicy(floor_s=0.25, factor=8, min_obs=4)
    for _ in range(16):
        pol.note_fresh(1, 0.001)  # 8 x p50 ~ 6 ms: the floor wins
    assert pol.gap_deadline_s() == pytest.approx(0.25)
    pol2 = adaptive.AdaptivePolicy(floor_s=0.25, factor=8, min_obs=4)
    for _ in range(16):
        pol2.note_fresh(1, 0.1)   # interpolated p50 = 0.075: 8x wins
    assert pol2.gap_deadline_s() == pytest.approx(0.6)


def test_policy_stale_miss_drives_machine():
    pol = adaptive.AdaptivePolicy(floor_s=0.1, factor=2, min_obs=2,
                                  health=EdgeHealth(misses=2, clean=2,
                                                    floor_s=0.0))
    for _ in range(4):
        pol.note_fresh(1, 0.001)
    assert pol.note_stale(2, age_s=0.01) is False   # inside the deadline
    assert pol.note_stale(2, age_s=5.0) is True
    assert pol.note_stale(2, age_s=5.0) is True
    assert pol.health.state(2) == EDGE_SUSPECT
    assert pol.gap_misses == 2


def test_policy_acquire_never_clean():
    """Fast acquires observe the baseline but must not reset a miss
    streak — a rank sleeping OUTSIDE its critical section acquires fast
    while depositing nothing."""
    pol = adaptive.AdaptivePolicy(floor_s=0.05, factor=2, min_obs=2,
                                  health=EdgeHealth(misses=3, clean=1,
                                                    floor_s=0.0))
    pol.health.note_miss(2)
    pol.health.note_miss(2)
    for _ in range(8):
        assert pol.note_acquire(2, 0.0001) is False
    assert pol.health.note_miss(2) == EDGE_SUSPECT  # streak survived
    assert pol.note_acquire(2, 1.0) is True         # convoyed acquire
    assert pol.acquire_misses == 1


def test_policy_epoch_floor_gates_commits():
    now = [0.0]
    pol = adaptive.AdaptivePolicy(
        health=EdgeHealth(floor_s=1.0, clock=lambda: now[0]),
        clock=lambda: now[0])
    assert pol.epoch_floor_open(3)
    pol.note_epoch_change([3])
    assert not pol.epoch_floor_open(3)
    now[0] = 0.9
    assert not pol.epoch_floor_open(3)
    now[0] = 1.0
    assert pol.epoch_floor_open(3)


# ---------------------------------------------------------------------------
# demote_topology: pure properties (the corpus rule covers the sweep)
# ---------------------------------------------------------------------------






def test_demote_caps_degree_and_keeps_member():
    d = healing.demote_topology(topology_util.ExponentialTwoGraph(8), [3])
    assert d.survivors == tuple(range(8))       # nobody excised
    assert d.demoted == (3,) and d.dead == ()
    v = d.to_local[3]
    nbrs = set(d.topology.successors(v)) | set(d.topology.predecessors(v))
    nbrs.discard(v)
    assert len(nbrs) == 1                       # one anchor edge
    row, col = d.plan.stochasticity_error()
    assert row < 1e-9 and col < 1e-9
    _, gap = plan_rules.check_spectral_gap(d.plan, "exp2@8-slow3")
    assert gap > 0


def test_demote_cut_stragglers_ring_repairs_healthy_core():
    """Demoting ranks 1 and 4 of a 6-ring disconnects the healthy core
    ({2,3} from {5,0}) — the repair ring goes through HEALTHY members
    only (a ring through a straggler would re-raise its degree past the
    cap)."""
    d = healing.demote_topology(topology_util.RingGraph(6), [1, 4])
    assert d.reconnected
    for g in (1, 4):
        v = d.to_local[g]
        nbrs = (set(d.topology.successors(v))
                | set(d.topology.predecessors(v)))
        nbrs.discard(v)
        assert len(nbrs) == 1, (g, nbrs)
    report = adaptive_rules.check_demoted(d, "ring@6-slow14")
    assert report.ok, [str(f) for f in report.findings]


def test_demote_rejects_bad_straggler_sets():
    topo = topology_util.RingGraph(4)
    with pytest.raises(ValueError, match=">= 1 rank"):
        healing.demote_topology(topo, [])
    with pytest.raises(ValueError, match="not in topology"):
        healing.demote_topology(topo, [9])
    with pytest.raises(ValueError, match="every member is a straggler"):
        healing.demote_topology(topo, [0, 1, 2, 3])




def test_adaptive_rule_family_and_fixtures():
    """The verifier's adaptive family passes on the real constructions
    and every seeded-bug fixture fires."""
    import bluefog_tpu_torch.analysis as analysis
    from bluefog_tpu_torch.analysis.fixtures import FIXTURES, run_fixture

    report = analysis.run(families=["adaptive"])
    assert report.ok, [str(f) for f in report.findings[:10]]
    assert report.subjects_checked > 300
    seeded = [n for n in FIXTURES if n.startswith("adaptive-")]
    assert len(seeded) >= 3
    for name in seeded:
        assert run_fixture(name), f"fixture {name} did not fire"


# ---------------------------------------------------------------------------
# chaos.schedule_slow: the gray-failure injector
# ---------------------------------------------------------------------------


def test_schedule_slow_injects_bounded_delay():
    tag = f"slowunit{os.getpid()}"
    chaos.schedule_slow(os.environ, rank=1, step=2, delay_s=0.05, stop=4)
    try:
        t0 = time.monotonic()
        chaos.checkpoint(0, tag)                # wrong rank: no delay
        chaos.checkpoint(1, tag)                # step 1 < 2: no delay
        assert time.monotonic() - t0 < 0.04
        t0 = time.monotonic()
        chaos.checkpoint(1, tag)                # steps 2 and 3: slow
        chaos.checkpoint(1, tag)
        assert time.monotonic() - t0 >= 0.09
        t0 = time.monotonic()
        chaos.checkpoint(1, tag)                # step 4 >= stop: recovered
        assert time.monotonic() - t0 < 0.04
    finally:
        chaos.clear_schedule()


def test_clear_schedule_covers_slow_keys():
    env = chaos.schedule_slow({}, rank=0, step=1, delay_s=0.5, stop=9)
    assert sum(1 for k in env if "SLOW" in k) == 4  # rank/step/s/stop
    chaos.schedule_slow(os.environ, rank=0, step=1, delay_s=0.5, stop=9)
    chaos.clear_schedule()
    assert not any("CHAOS_SLOW" in k for k in os.environ)


# ---------------------------------------------------------------------------
# the live np=4 cycle: demote -> gossip around -> recover -> promote
# ---------------------------------------------------------------------------


def _worker_straggler_cycle(rank, size):
    """np=4 exp2 gossip with rank 3 slowed past the edge deadline for a
    window, then recovered.  Returns the epoch records this rank
    switched through, the demote switch-point ledger, and the final
    state."""
    from bluefog_tpu_torch.telemetry import registry as telem

    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank * 10), np.float64), "as")
    islands.barrier()
    t_end = time.monotonic() + 60.0
    events, ledger = [], None
    while time.monotonic() < t_end:
        chaos.checkpoint(rank, "astraggle")     # rank 3 sleeps here
        islands.win_put(islands.win_sync("as"), "as")
        islands.win_update("as")
        rec = islands.adaptive_step()
        if rec is not None:
            events.append((int(rec["epoch"]),
                           tuple(int(g) for g in rec.get("demoted", ())),
                           tuple(int(g) for g in rec.get("promoted", ()))))
            if ledger is None:
                # the demote switch-point totals, before any post-switch
                # op moves the counters (the quiesced-cut audit point)
                ledger = islands._ledger_totals(telem.get_registry())
        if len(events) >= 2 and not islands.demoted_ranks():
            break  # promoted back: cycle complete
        time.sleep(0.003)
    # drain: converge on the restored topology
    drain_end = time.monotonic() + 3.0
    while time.monotonic() < drain_end:
        islands.win_put(islands.win_sync("as"), "as")
        islands.win_update("as")
        islands.adaptive_step()
        time.sleep(0.005)
    return (rank, islands.membership_epoch(),
            tuple(sorted(islands.demoted_ranks())),
            sorted(islands.dead_ranks()), events, ledger,
            np.array(islands.win_sync("as"), copy=True))


@pytest.mark.slow
def test_straggler_demote_promote_np4(monkeypatch):
    """The adaptive acceptance e2e: np=4 over exp2, rank 3 slowed 0.6 s
    per round (gray failure: its heartbeat thread keeps beating).  The
    fleet demotes it WITHOUT a death declaration, gossips around it,
    and — once the slow window ends — its anchor promotes it back.
    Exactly one demote and one promote epoch (no flapping thrash), the
    demote switch-point mass ledger balances globally, and the fleet
    converges to consensus inside the convex hull of the starts."""
    job = f"adapt{os.getpid()}"
    monkeypatch.setenv("BFTPU_ADAPTIVE", "1")
    monkeypatch.setenv("BFTPU_TELEMETRY", "1")
    monkeypatch.setenv("BFTPU_EDGE_DEADLINE_S", "0.2")
    monkeypatch.setenv("BFTPU_SUSPECT_MISSES", "3")
    monkeypatch.setenv("BFTPU_PROMOTE_CLEAN", "5")
    monkeypatch.setenv("BFTPU_DEMOTE_FLOOR_S", "0.5")
    chaos.schedule_slow(os.environ, rank=3, step=10, delay_s=0.6, stop=25)
    try:
        res = islands.spawn(_worker_straggler_cycle, 4, job=job,
                            timeout=240.0)
    finally:
        chaos.clear_schedule()
        shm_native.unlink_all(job, ["as"])
    ledgers = []
    for rank, epoch, demoted, dead, events, ledger, out in res:
        assert dead == [], \
            f"rank {rank} declared death — gray failure must demote, " \
            f"never kill: {dead}"
        assert demoted == (), f"rank {rank} still demoted at exit"
        assert events[0][1] == (3,), (rank, events)   # demote of rank 3
        assert events[-1][2] == (3,), (rank, events)  # promote of rank 3
        assert len(events) == 2, \
            f"rank {rank} saw {len(events)} epoch switches — the " \
            f"hysteresis floor must admit exactly demote+promote: {events}"
        assert epoch == 2, (rank, epoch, events)
        ledgers.append(ledger)
    # the demote cut is quiesced: the merged ledger balances exactly
    dep = sum(l["deposits"] for l in ledgers)
    acc = sum(l["collected"] + l["drained"] + l["pending"] for l in ledgers)
    assert abs(dep - acc) < 1e-9, (dep, acc, ledgers)
    outs = np.stack([r[6] for r in res])
    assert float(outs.max() - outs.min()) < 1.0, "no consensus"
    assert outs.min() >= -1e-9 and outs.max() <= 30.0 + 1e-9, \
        "consensus left the convex hull of the starts (mass was minted)"


def _worker_absorb_bound(rank, size):
    """np=2: rank 1 goes quiet mid-run; rank 0's synchronous step is
    bounded by the ABSORB deadline instead of the straggler's nap."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(2, float(rank), np.float64), "ab")
    islands.barrier()
    if rank == 1:
        # healthy cadence, then one long nap, then recovery
        for _ in range(40):
            islands.win_put(islands.win_sync("ab"), "ab")
            islands.win_update("ab")
            time.sleep(0.005)
        time.sleep(2.5)
        for _ in range(40):
            islands.win_put(islands.win_sync("ab"), "ab")
            islands.win_update("ab")
            time.sleep(0.005)
        return (rank, None)
    absorbed_rounds, waits = 0, []
    t_end = time.monotonic() + 4.0
    while time.monotonic() < t_end:
        before = islands.get_win_version("ab")
        islands.win_put(islands.win_sync("ab"), "ab")
        t0 = time.monotonic()
        # synchronous step: wait for a fresh deposit on every in-edge,
        # counting an ABSORBED edge as handled — that is exactly the
        # bound the adaptive deadline buys a synchronous caller
        while time.monotonic() - t0 < 3.0:
            islands.win_update("ab")
            now_v = islands.get_win_version("ab")
            absorbed = set(islands.win_absorbed("ab"))
            if absorbed:
                absorbed_rounds += 1
            ctx = islands._ctx()
            pending = {s for s, v in now_v.items()
                       if v <= before.get(s, 0)
                       and ctx.members_global[s] not in absorbed}
            if not pending:
                break
            time.sleep(0.002)
        waits.append(time.monotonic() - t0)
        time.sleep(0.005)
    return (rank, (absorbed_rounds, max(waits)))


@pytest.mark.slow
def test_absorb_bounds_synchronous_step_np2(monkeypatch):
    """With a 0.2 s edge deadline, a 2.5 s straggler nap costs a
    synchronous peer at most deadline + slack per round — the ABSORB
    combine, not the straggler, bounds the step."""
    job = f"absorb{os.getpid()}"
    monkeypatch.setenv("BFTPU_ADAPTIVE", "1")
    monkeypatch.setenv("BFTPU_EDGE_DEADLINE_S", "0.2")
    monkeypatch.setenv("BFTPU_EDGE_DEADLINE_FACTOR", "4")
    monkeypatch.setenv("BFTPU_SUSPECT_MISSES", "1000000")  # no demote here
    try:
        res = islands.spawn(_worker_absorb_bound, 2, job=job, timeout=120.0)
    finally:
        shm_native.unlink_all(job, ["ab"])
    (_, stats) = res[0]
    absorbed_rounds, worst_wait = stats
    assert absorbed_rounds >= 1, "the nap never triggered an ABSORB"
    assert worst_wait < 1.0, \
        f"synchronous step waited {worst_wait:.2f}s — the ABSORB " \
        "deadline was supposed to bound it"
