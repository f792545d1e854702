"""Port twin of ``tests/test_resilience.py`` (chaos, healing and the
launcher e2e cases) against ``bluefog_tpu_torch``.  The cases that need a
module the port does not have yet (the plan and resilience rule families,
the networkx corpus) wait for ROADMAP A8.

Resilience subsystem: failure detection, topology healing, degraded
gossip, and fault-injected end-to-end runs (docs/RESILIENCE.md).

The reference BlueFog is fail-stop — one dead rank aborts the MPI job.
These tests pin the opposite contract: survivors detect the death
(heartbeat liveness words / coordinator leases), heal the topology
(induced subgraph -> symmetrize -> ring-reconnect -> Metropolis–Hastings
re-weighting -> recompiled plan), force-drain the corpse's mailbox slots
(losing no committed mass — the dead-writer-drain theorem, model-checked
in bluefog_tpu_torch.analysis.seqlock_model), and keep gossiping with
mass-conserving degraded combine rows, with every blocking wait bounded
by a deadline.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import chaos, degraded, healing
from bluefog_tpu_torch.resilience.detector import FailureDetector, PeerTimeoutError

# ---------------------------------------------------------------------------
# topology healing: pure properties over the whole named corpus
# ---------------------------------------------------------------------------






def test_heal_down_to_one_survivor():
    healed = healing.heal_topology(topology_util.RingGraph(4), dead=[0, 2, 3])
    assert healed.survivors == (1,) and healed.size == 1
    assert healed.plan.size == 1
    W = healing.healed_weight_matrix(healed)
    np.testing.assert_allclose(W, [[1.0]])


def test_heal_rejects_bad_dead_sets():
    topo = topology_util.RingGraph(4)
    with pytest.raises(ValueError, match="no survivors"):
        healing.heal_topology(topo, dead=[0, 1, 2, 3])
    with pytest.raises(ValueError, match="not in topology"):
        healing.heal_topology(topo, dead=[7])


def test_heal_rank_maps_round_trip():
    healed = healing.heal_topology(topology_util.ExponentialTwoGraph(8),
                                   dead=[2, 5])
    assert healed.to_global == (0, 1, 3, 4, 6, 7)
    for g in healed.survivors:
        assert healed.to_global[healed.to_local[g]] == g
    # in-neighbor queries answer in GLOBAL ranks and never name the dead
    for g in healed.survivors:
        nbrs = healed.local_in_neighbors(g)
        assert set(nbrs) <= set(healed.survivors)


# ---------------------------------------------------------------------------
# degraded combine rows
# ---------------------------------------------------------------------------




def test_renormalize_weights_rescales_to_one():
    sw, nw = degraded.renormalize_weights(0.25, {1: 0.25, 2: 0.25, 3: 0.25},
                                          dead=[2])
    assert sw + sum(nw.values()) == pytest.approx(1.0)
    assert 2 not in nw and set(nw) == {1, 3}
    # every neighbor dead: the rank gossips with itself
    sw, nw = degraded.renormalize_weights(0.5, {1: 0.5}, dead=[1])
    assert (sw, nw) == (1.0, {})


def test_with_deadline_retries_then_raises():
    calls = []

    def always_late(budget):
        calls.append(budget)
        raise TimeoutError("nope")

    healed = []
    with pytest.raises(degraded.DeadlineExceeded, match="probe-op"):
        degraded.with_deadline(always_late, "probe-op", deadline=0.2,
                               retries=3, backoff=0.001,
                               on_timeout=lambda: healed.append(1))
    assert len(calls) == 3 and len(healed) == 3
    # success path returns the value without retrying
    assert degraded.with_deadline(lambda b: "ok", "probe-op",
                                  deadline=0.2) == "ok"


# ---------------------------------------------------------------------------
# failure detector
# ---------------------------------------------------------------------------


class _FakeJob:
    """Duck-typed transport: controllable per-rank liveness stamps."""

    def __init__(self):
        self.stamps = {}
        self.beats = 0

    def heartbeat(self):
        self.beats += 1

    def liveness(self, rank):
        return self.stamps.get(rank, 0.0)


def test_detector_declares_and_stays_dead():
    job = _FakeJob()
    det = FailureDetector(job, rank=0, nranks=3, timeout=0.1, interval=0.02)
    now = time.monotonic()
    job.stamps = {1: now, 2: now}
    assert det.dead_ranks() == set()
    job.stamps[2] = now - 10.0  # rank 2's stamp goes stale
    time.sleep(0.12)
    job.stamps[1] = time.monotonic()  # rank 1 kept heartbeating
    assert det.dead_ranks() == {2}
    # monotone: a fresh stamp does NOT resurrect a declared-dead rank
    job.stamps[2] = time.monotonic()
    assert det.dead_ranks() == {2}
    det.declare_dead(1)
    assert det.dead_ranks() == {1, 2}
    det.stop()


def test_detector_startup_grace_then_timeout():
    job = _FakeJob()
    det = FailureDetector(job, rank=0, nranks=2, timeout=0.15, interval=0.02)
    # rank 1 never beat: alive during the startup grace...
    assert det.dead_ranks() == set()
    time.sleep(0.2)
    # ...dead once the grace (measured from detector birth) expires
    assert det.dead_ranks() == {1}
    det.stop()


def test_detector_unsupported_transport_degrades_to_alive():
    det = FailureDetector(object(), rank=0, nranks=4, timeout=0.01)
    assert not det.supported
    time.sleep(0.03)
    assert det.dead_ranks() == set()
    det.stop()


def test_detector_background_thread_beats():
    job = _FakeJob()
    with FailureDetector(job, rank=0, nranks=1, interval=0.01) as det:
        time.sleep(0.08)
        assert det.supported
    assert job.beats >= 3


# ---------------------------------------------------------------------------
# dead-writer drain on the chunk-ring slot protocol
# ---------------------------------------------------------------------------


def test_chunk_ring_dead_writer_force_drain():
    """A writer killed mid-deposit leaves a torn slot (odd wseq, odd chunk
    seqlock): readers must refuse it, and force_drain must restore a
    readable logical-zero slot without losing any COMMITTED deposit mass
    (DEPOSIT_COMMITS_AFTER_PAYLOAD: the torn deposit committed nothing)."""
    m = shm_native.ChunkRingMirror(nbytes=256, chunk=64)
    first = bytes(range(64)) * 4
    m.write(first, p=1.0)
    data, p, version = m.read()
    assert data == first and p == 1.0 and version == 1

    chaos.corrupt_chunk(m, data=b"\xff" * 256, tear_at=2)
    with pytest.raises(TimeoutError):
        m.read(retries=8)  # torn writer never publishes
    with pytest.raises(TimeoutError):
        m.read_chunk(2, retries=8)

    m.force_drain()
    data, p, version = m.read()
    assert data == b"\x00" * 256 and p == 0.0
    assert version == 1  # the torn deposit committed zero mass

    # the slot is fully live again after the drain
    second = b"\xab" * 256
    m.write(second, p=0.5)
    data, p, version = m.read()
    assert data == second and p == 0.5 and version == 2


def test_chunk_ring_frozen_writer_can_also_resume():
    """The drain is for DEAD writers; a merely-preempted writer resumes
    and publishes the full deposit (no spurious drain needed)."""
    m = shm_native.ChunkRingMirror(nbytes=128, chunk=64)
    payload = b"\x11" * 128
    m.begin_torn_write(payload, p=2.0, tear_at=1)
    m.complete_write()
    data, p, version = m.read()
    assert data == payload and p == 2.0 and version == 1


def test_window_force_drain_across_transports(tmp_path, monkeypatch):
    """window.force_drain on both shm transports: a deposited slot reads
    as logical zero afterwards and accepts fresh deposits."""
    for fallback in ("0", "1"):
        monkeypatch.setenv("BLUEFOG_SHM_FALLBACK", fallback)
        if fallback == "1":
            monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
        w = shm_native.make_window(f"fd{os.getpid()}_{fallback}", "x",
                                   rank=0, nranks=2, maxd=2,
                                   shape=(4,), dtype=np.float32)
        drain = getattr(w, "force_drain", None)
        if drain is None:
            w.close(unlink=True)
            pytest.skip("transport lacks force_drain")
        w.write(0, 1, np.arange(4, dtype=np.float32), p=1.0)
        drain(1, src=0)
        a, p, _v = w.read(1)
        np.testing.assert_allclose(a, 0.0)
        assert p == 0.0
        w.write(0, 1, np.full(4, 7.0, np.float32), p=0.25)
        a, p, _v = w.read(1)
        np.testing.assert_allclose(a, 7.0)
        assert p == 0.25
        w.close(unlink=True)


# ---------------------------------------------------------------------------
# tcp transport: bounded peer waits
# ---------------------------------------------------------------------------


def test_tcp_peer_timeout_names_the_rank(monkeypatch):
    """A request to a peer that accepts but never replies must surface as
    PeerTimeoutError naming the rank within BFTPU_PEER_TIMEOUT_S — the
    settimeout(None) unbounded hang this PR removed."""
    from bluefog_tpu_torch.native import tcp_transport as tt

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    held = []
    t = threading.Thread(
        target=lambda: held.append(srv.accept()), daemon=True)
    t.start()
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "0.3")
    peers = tt._Peers({5: f"127.0.0.1:{port}"})
    t0 = time.monotonic()
    with pytest.raises(PeerTimeoutError, match="rank 5") as ei:
        peers.request(5, tt._OP_BARRIER)
    assert ei.value.rank == 5
    assert time.monotonic() - t0 < 5.0
    srv.close()


def test_peer_timeout_env_knob(monkeypatch):
    from bluefog_tpu_torch.native.tcp_transport import peer_timeout_s

    monkeypatch.delenv("BFTPU_PEER_TIMEOUT_S", raising=False)
    assert peer_timeout_s() == 120.0
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "7.5")
    assert peer_timeout_s() == 7.5
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "0")  # 0 disables the bound
    assert peer_timeout_s() is None


# ---------------------------------------------------------------------------
# single-rank island runtime: timed waits and mutex deadlines
# ---------------------------------------------------------------------------


def test_island_timed_barrier_and_mutex_deadline(monkeypatch):
    job = f"resil1_{os.getpid()}"
    islands.init(0, 1, job)
    try:
        islands.barrier(timeout=5.0)  # single rank: completes immediately
        # a wedged mutex (holder died mid-critical-section) must bound the
        # wait: the job-level acquire is held by "someone else" here
        islands._ctx().shm_job.mutex_acquire(0)
        monkeypatch.setenv("BFTPU_OP_DEADLINE_S", "0.2")
        t0 = time.monotonic()
        with pytest.raises(degraded.DeadlineExceeded, match="win_mutex"):
            with islands.win_mutex("w", ranks=[0], for_self=True):
                pass
        assert time.monotonic() - t0 < 5.0
        islands._ctx().shm_job.mutex_release(0)
        monkeypatch.delenv("BFTPU_OP_DEADLINE_S")
        with islands.win_mutex("w", ranks=[0], for_self=True):
            pass  # released: acquires fine
    finally:
        islands.shutdown(unlink=True)


# ---------------------------------------------------------------------------
# chaos e2e: kill a rank mid-gossip, survivors heal and converge
# ---------------------------------------------------------------------------


def _worker_chaos_gossip(rank, size):
    """np=4 exp2 gossip; the chaos schedule SIGKILLs one rank mid-stream.
    Survivors: bounded barrier waits -> detect -> heal -> degraded
    async gossip to consensus.  No unbounded wait anywhere."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank * 10), np.float64), "cg")
    islands.barrier()  # everyone created; last unbounded wait in the run
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        chaos.checkpoint(rank, "gossip")  # the victim dies here
        islands.win_put(islands.win_sync("cg"), "cg")
        try:
            islands.barrier(timeout=3.0)
            islands.win_update("cg")
            islands.barrier(timeout=3.0)
        except TimeoutError:
            break  # a sibling stopped arriving
        if islands.dead_ranks():
            break
    while time.monotonic() < deadline and not islands.dead_ranks():
        time.sleep(0.05)
    dead = islands.dead_ranks()
    assert dead, "victim death never detected"
    healed = islands.heal()
    row_err, col_err = healed.plan.stochasticity_error()
    # degraded asynchronous gossip (no barriers: there is nobody to
    # coordinate the dead rank's slot) converges to consensus
    for _ in range(150):
        islands.win_put(islands.win_sync("cg"), "cg")
        islands.win_update("cg")
        time.sleep(0.002)
    out = islands.win_sync("cg").copy()
    return (sorted(dead), healed.size, bool(healed.reconnected),
            float(row_err), float(col_err), out)


def test_chaos_kill_rank_mid_gossip_survivors_heal(monkeypatch):
    """The acceptance e2e: np=4 island mode over exp2, one rank SIGKILLed
    mid win_put stream; every survivor detects the death, heals to the
    same doubly-stochastic 3-rank topology, and completes degraded gossip
    to consensus without any wait blocking past its deadline."""
    size, victim = 4, 1
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "1.0")
    chaos.schedule_kill(os.environ, rank=victim, step=3)
    try:
        res = islands.spawn(_worker_chaos_gossip, size, timeout=300.0,
                            allow_failures=True)
    finally:
        chaos.clear_schedule()
    assert res[victim] is None, "the victim was supposed to die"
    survivors = [r for r in range(size) if r != victim]
    outs = []
    for r in survivors:
        assert res[r] is not None, f"survivor {r} produced no result"
        dead, healed_size, _reconnected, row_err, col_err, out = res[r]
        assert dead == [victim]
        assert healed_size == size - 1
        # the healed survivor W is doubly stochastic on every survivor
        assert row_err < 1e-9 and col_err < 1e-9
        outs.append(out)
    flat = np.stack(outs)
    # consensus: all survivor values agree far inside the initial spread
    # (0/20/30), and stay inside the convex hull of the initial values
    assert float(flat.max() - flat.min()) < 1.0, flat
    assert flat.min() > -1e-9 and flat.max() < 30.0 + 1e-9


# ---------------------------------------------------------------------------
# launcher: grace period + first-failing exit code
# ---------------------------------------------------------------------------


def test_launcher_grace_lets_survivors_finish(tmp_path):
    """One rank exits nonzero; with the grace period the surviving rank
    gets to finish its work (and the FIRST failing code propagates)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "survivor.txt"
    script = (
        "import os, time\n"
        "from bluefog_tpu_torch import islands\n"
        "islands.init()\n"
        "if islands.rank() == 1:\n"
        "    raise SystemExit(7)\n"
        "time.sleep(1.5)\n"
        f"open({str(out)!r}, 'w').write('survived')\n"
        "islands.shutdown(unlink=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, BFTPU_LAUNCH_GRACE_S="20")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher", "--islands", "2",
         "--job", f"grace{os.getpid()}", "--", sys.executable, "-c", script],
        env=env, capture_output=True, text=True, timeout=120, cwd=repo,
    )
    assert proc.returncode == 7, (proc.returncode, proc.stderr[-800:])
    assert out.read_text() == "survived", proc.stderr[-800:]


def test_launcher_zero_grace_restores_immediate_teardown(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "survivor.txt"
    script = (
        "import os, time\n"
        "from bluefog_tpu_torch import islands\n"
        "islands.init()\n"
        "if islands.rank() == 1:\n"
        "    raise SystemExit(9)\n"
        "time.sleep(30)\n"
        f"open({str(out)!r}, 'w').write('survived')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, BFTPU_LAUNCH_GRACE_S="0")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher", "--islands", "2",
         "--job", f"grace0{os.getpid()}", "--", sys.executable, "-c", script],
        env=env, capture_output=True, text=True, timeout=120, cwd=repo,
    )
    assert proc.returncode == 9, (proc.returncode, proc.stderr[-800:])
    assert time.monotonic() - t0 < 60
    assert not out.exists()  # the sleeper was torn down, not waited for

# ---------------------------------------------------------------------------
# elastic membership: grow-side healing, the join protocol, churn
# ---------------------------------------------------------------------------


def test_grow_topology_is_doubly_stochastic_and_fresh_ranks_only():
    G = topology_util.ExponentialTwoGraph(4)
    grown = healing.grow_topology(G, [4, 5])
    assert grown.joined == (4, 5)
    assert grown.to_global == (0, 1, 2, 3, 4, 5)
    assert grown.dead == ()
    row, col = grown.plan.stochasticity_error()
    assert row < 1e-9 and col < 1e-9
    # a joiner may NOT reuse a present rank (the monotone dead-set
    # contract: a restarted rank rejoins under a FRESH global rank)
    with pytest.raises(ValueError, match="FRESH"):
        healing.grow_topology(G, [2])
    with pytest.raises(ValueError, match="joiners"):
        healing.grow_topology(G, [])




def test_membership_board_grant_roundtrip(tmp_path, monkeypatch):
    from bluefog_tpu_torch.resilience import join as join_mod

    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    board = join_mod.MembershipBoard("bjob")
    board.ensure(3)
    board.ensure(3)  # idempotent
    assert board.pending_requests() == []
    req = board.post_request()
    assert [r["req"] for r in board.pending_requests()] == [req]
    G = topology_util.ExponentialTwoGraph(3)
    windows = [{"name": "w", "shape": [2], "dtype": "float64"}]
    rec = board.grant(0, [0, 1, 2], G, windows, False, prev_epoch=0)
    assert rec["epoch"] == 1
    assert rec["members"] == [0, 1, 2, 3]
    assert rec["granted"][req] == 3  # fresh, off the monotone counter
    # a raced second sponsor finds the record present, unchanged
    rec2 = board.grant(1, [0, 1, 2], G, windows, False, prev_epoch=0)
    assert rec2 == rec
    g = board.wait_for_grant(req, timeout=1.0)
    assert (g.rank, g.epoch, g.sponsor) == (3, 1, 0)
    assert g.local_rank == 3 and g.size == 4
    # the cheap change probe moved with the commit, and is monotone
    assert shm_native.membership_epoch("bjob") == 1
    shm_native.publish_membership_epoch("bjob", 0)
    assert shm_native.membership_epoch("bjob") == 1
    # every member rebuilds the SAME dense MH-weighted graph
    H = join_mod.record_graph(rec)
    assert set(H.nodes) == {0, 1, 2, 3}
    from bluefog_tpu_torch.core.plan import compile_plan
    row, col = compile_plan(H).stochasticity_error()
    assert row < 1e-9 and col < 1e-9


def test_join_grant_timeout_names_the_cure(tmp_path, monkeypatch):
    from bluefog_tpu_torch.resilience import join as join_mod

    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    board = join_mod.MembershipBoard("tjob")
    with pytest.raises(RuntimeError, match="membership board"):
        board.post_request()  # no board: the job is not running
    board.ensure(2)
    req = board.post_request()
    with pytest.raises(TimeoutError, match="admit_pending"):
        board.wait_for_grant(req, timeout=0.2)


def test_tcp_join_rank_and_epoch_ops():
    """The coordinator-mediated rendezvous primitives for multi-host
    deployments: fresh ranks off a monotone counter seeded past the
    launch world, and a monotone membership-epoch word."""
    from bluefog_tpu_torch.native import tcp_transport as tt

    srv = tt._Server(rank=0, nranks=4, host="127.0.0.1")
    try:
        peers = tt._Peers({0: f"127.0.0.1:{srv.port}"})
        r1 = peers.request(0, tt._OP_JOIN_RANK)
        r2 = peers.request(0, tt._OP_JOIN_RANK)
        assert (r1[2], r2[2]) == (4, 5)  # never reissues, never reuses 0-3
        assert peers.request(0, tt._OP_EPOCH)[2] == 0
        assert peers.request(0, tt._OP_EPOCH, slot=3, mode=1)[2] == 3
        assert peers.request(0, tt._OP_EPOCH, slot=1, mode=1)[2] == 3  # monotone
        assert peers.request(0, tt._OP_EPOCH)[2] == 3
        peers.close()
    finally:
        srv.stop()


def _worker_admit_after_kill(rank, size):
    """exp2 gossip; chaos SIGKILLs one rank; the survivors heal,
    then admit a replacement joiner and gossip on the grown membership.
    Returns (pre-join consensus, switch-point ledger totals, post-join
    state)."""
    from bluefog_tpu_torch.telemetry import registry as telem

    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank * 10), np.float64), "ej")
    islands.barrier()
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline and not islands.dead_ranks():
        chaos.checkpoint(rank, "egossip")  # the victim dies here
        islands.win_put(islands.win_sync("ej"), "ej")
        islands.win_update("ej")
        time.sleep(0.002)
    assert islands.dead_ranks(), "victim death never detected"
    islands.heal()
    # degraded gossip to survivor consensus BEFORE the join
    for _ in range(150):
        islands.win_put(islands.win_sync("ej"), "ej")
        islands.win_update("ej")
        time.sleep(0.002)
    pre = islands.win_sync("ej").copy()
    rec = None
    while rec is None and time.monotonic() < deadline:
        rec = islands.admit_pending(timeout=30)
        if rec is None:
            time.sleep(0.02)
    assert rec is not None, "no joiner was admitted"
    # the switch-point ledger (nothing ran since the epoch switch)
    ledger = islands._ledger_totals(telem.get_registry())
    # post-join gossip on the grown membership
    for _ in range(150):
        islands.win_put(islands.win_sync("ej"), "ej")
        islands.win_update("ej")
        time.sleep(0.002)
    post = islands.win_sync("ej").copy()
    return (islands.global_rank(), islands.membership_epoch(),
            islands.members(), pre, ledger, post)


def _proc_joiner_after_kill(job, q):
    import numpy as _np

    from bluefog_tpu_torch import islands as isl
    from bluefog_tpu_torch.resilience import join as join_mod
    from bluefog_tpu_torch.telemetry import registry as telem

    board = join_mod.MembershipBoard(job)
    deadline = time.monotonic() + 60.0
    while board.read() is None and time.monotonic() < deadline:
        time.sleep(0.05)  # the members have not initialized yet
    g = isl.join(job=job, timeout=60)
    entry = _np.array(isl.win_sync("ej"))
    ledger = isl._ledger_totals(telem.get_registry())
    for _ in range(150):
        isl.win_put(isl.win_sync("ej"), "ej")
        isl.win_update("ej")
        time.sleep(0.002)
    q.put((g.rank, g.epoch, tuple(g.members), entry, ledger,
           _np.array(isl.win_sync("ej"))))
    isl.shutdown(unlink=False)


@pytest.mark.slow
def test_kill_heal_join_smoke(monkeypatch):
    """The elastic wall-clock SMOKE: np=3 over exp2, one rank SIGKILLed
    mid-gossip; survivors heal to 2 and reach consensus; a replacement
    process joins (fresh global rank 3 — never the corpse's), every
    member switches to epoch 1, and the grown 3-member job converges to
    the SAME value the survivors had agreed on: admission neither
    created nor destroyed mass.  The switch-point mass ledger balances
    globally (deposits == collected + drained + pending summed across
    members).

    This is deliberately the SMALLEST fleet that exercises kill + heal
    + join end to end over real processes and real shared memory (4
    processes total; np=4 needed 5 and flaked under 1-core CI
    contention).  The CANONICAL elastic scenario — same kill/join
    choreography, every invariant checked after every event, and
    bit-reproducible — is the deterministic port at
    tests/test_sim.py::test_kill_heal_join_sim_canonical."""
    import multiprocessing as mp

    size, victim = 3, 1
    job = f"elastic{os.getpid()}"
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "1.0")
    monkeypatch.setenv("BFTPU_TELEMETRY", "1")
    chaos.schedule_kill(os.environ, rank=victim, step=3)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    joiner = ctx.Process(target=_proc_joiner_after_kill, args=(job, q))
    joiner.start()
    try:
        res = islands.spawn(_worker_admit_after_kill, size, job=job,
                            timeout=300.0, allow_failures=True)
        jrank, jepoch, jmembers, jentry, jledger, jout = q.get(timeout=60)
    finally:
        chaos.clear_schedule()
        joiner.join(timeout=30)
        if joiner.is_alive():
            joiner.terminate()
        shm_native.unlink_all(job, ["ej"])
    assert res[victim] is None, "the victim was supposed to die"
    survivors = [r for r in range(size) if r != victim]
    pres, posts, ledgers = [], [], []
    for r in survivors:
        assert res[r] is not None, f"survivor {r} produced no result"
        grank, epoch, members, pre, ledger, post = res[r]
        assert grank == r          # stable global identity
        assert epoch == 1
        assert members == (0, 2, 3)  # corpse excised, fresh rank 3
        pres.append(pre)
        ledgers.append(ledger)
        posts.append(post)
    assert (jrank, jepoch) == (3, 1)
    assert jmembers == (0, 2, 3)
    # survivors had reached consensus before the join
    pre_flat = np.stack(pres)
    assert float(pre_flat.max() - pre_flat.min()) < 1.0, pre_flat
    pre_consensus = float(pre_flat.mean())
    # the joiner entered AT that consensus (sponsor's debiased estimate)
    assert np.allclose(jentry, pre_consensus, atol=1.0), (
        jentry, pre_consensus)
    # post-join: all three agree, at the SAME value — the join moved no mass
    all_post = np.stack(posts + [jout])
    assert float(all_post.max() - all_post.min()) < 1.0, all_post
    assert abs(float(all_post.mean()) - pre_consensus) < 1.0
    # switch-point mass ledger balances globally across the join barrier
    ledgers.append(jledger)
    dep = sum(l["deposits"] for l in ledgers)
    acc = sum(l["collected"] + l["drained"] + l["pending"] for l in ledgers)
    assert dep == pytest.approx(acc), ledgers


def _worker_flapping(rank, size):
    """np=3 gossip; rank 2 SIGSTOPs past the failure timeout, then
    resumes (the gray failure).  Survivors declare it dead and heal; the
    zombie wakes, keeps gossiping into slots nobody reads, and exits
    cleanly — absorbed, never double-counted."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(2, float(rank * 10), np.float64), "fl")
    islands.barrier()
    deadline = time.monotonic() + 60.0
    rounds = 0
    while time.monotonic() < deadline and rounds < 400:
        chaos.checkpoint(rank, "flap")  # rank 2 freezes 2.5s here
        islands.win_put(islands.win_sync("fl"), "fl")
        islands.win_update("fl")
        rounds += 1
        if islands.dead_ranks():
            break
        time.sleep(0.005)
    dead = sorted(islands.dead_ranks())
    if dead:
        islands.heal()
        for _ in range(150):
            islands.win_put(islands.win_sync("fl"), "fl")
            islands.win_update("fl")
            time.sleep(0.002)
    return (rank, dead, islands.win_sync("fl").copy())


@pytest.mark.slow
def test_flapping_rank_is_absorbed_cleanly(monkeypatch):
    """SIGSTOP/SIGCONT churn: the suspended rank is declared dead while
    stopped (monotone — it STAYS dead to the survivors), resumes, and
    the run ends cleanly: survivors converge without it, the zombie's
    late deposits land in slots nobody reads, and every process exits
    zero."""
    size, flapper = 3, 2
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "1.0")
    chaos.schedule_suspend(os.environ, rank=flapper, step=5,
                           duration_s=2.5)
    try:
        res = islands.spawn(_worker_flapping, size, timeout=300.0,
                            allow_failures=True)
    finally:
        chaos.clear_schedule()
    for r in range(size):
        assert res[r] is not None, f"rank {r} crashed"
    survivors = [r for r in range(size) if r != flapper]
    outs = []
    for r in survivors:
        rank_, dead, out = res[r]
        assert dead == [flapper], (r, dead)  # declared dead while stopped
        outs.append(out)
    # survivors converged without the flapper; values stay in the hull
    flat = np.stack(outs)
    assert float(flat.max() - flat.min()) < 1.0, flat
    assert flat.min() > -1e-9 and flat.max() < 20.0 + 1e-9
    # the zombie itself came back, saw no deaths, and exited cleanly
    _, zdead, zout = res[flapper]
    assert zdead == []
    assert np.all(np.isfinite(zout))


@pytest.mark.slow
def test_launcher_self_heal_respawns_killed_rank(tmp_path):
    """``bftpu-run --islands 3 --self-heal``: one rank SIGKILLs itself;
    the supervisor spawns a replacement joiner (BLUEFOG_ISLAND_JOINER=1
    routes its init() to join()), the survivors heal and admit it, and
    the whole run exits zero with 3 members in epoch 1."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outdir = tmp_path
    script = (
        "import os, time\n"
        "import numpy as np\n"
        "from bluefog_tpu_torch import islands\n"
        "from bluefog_tpu_torch.resilience import chaos\n"
        "islands.init()\n"
        "joiner = os.environ.get('BLUEFOG_ISLAND_JOINER') == '1'\n"
        "islands.win_create(np.full(2, 1.0 * islands.global_rank()), 'sh')\n"
        "if not joiner:\n"
        "    if islands.rank() == 1:\n"
        "        time.sleep(0.5)\n"
        "        chaos.kill_self()\n"
        "    deadline = time.monotonic() + 60.0\n"
        "    while time.monotonic() < deadline and not islands.dead_ranks():\n"
        "        islands.win_put(islands.win_sync('sh'), 'sh')\n"
        "        islands.win_update('sh')\n"
        "        time.sleep(0.005)\n"
        "    assert islands.dead_ranks(), 'death never detected'\n"
        "    islands.heal()\n"
        "    rec = None\n"
        "    while rec is None and time.monotonic() < deadline:\n"
        "        rec = islands.admit_pending(timeout=30)\n"
        "        if rec is None:\n"
        "            time.sleep(0.02)\n"
        "    assert rec is not None, 'replacement never admitted'\n"
        "assert islands.size() == 3, islands.size()\n"
        "assert islands.membership_epoch() == 1\n"
        f"open(os.path.join({str(outdir)!r}, "
        "f'done-{islands.global_rank()}'), 'w')"
        ".write(str(islands.size()))\n"
        "islands.barrier(timeout=60)\n"
        "islands.shutdown(unlink=False)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo,
               BFTPU_FAILURE_TIMEOUT_S="1.0",
               BFTPU_LAUNCH_GRACE_S="60", BFTPU_MAX_RESPAWNS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher", "--islands", "3",
         "--self-heal", "--job", f"selfheal{os.getpid()}", "--",
         sys.executable, "-c", script],
        env=env, capture_output=True, text=True, timeout=180, cwd=repo,
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert "self-heal spawned replacement joiner" in proc.stderr
    # survivors kept global ranks 0 and 2; the replacement is rank 3
    done = sorted(p.name for p in outdir.iterdir())
    assert done == ["done-0", "done-2", "done-3"], done
    for p in outdir.iterdir():
        assert p.read_text() == "3"


def test_launcher_attach_scale_admits_extra_rank(tmp_path):
    """``bftpu-run --attach JOB scale +1`` against a live islands run:
    the control socket enqueues a joiner, the members admit it, and the
    job finishes with 3 members in epoch 1."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job = f"attach{os.getpid()}"
    outdir = tmp_path
    script = (
        "import os, time\n"
        "import numpy as np\n"
        "from bluefog_tpu_torch import islands\n"
        "islands.init()\n"
        "joiner = os.environ.get('BLUEFOG_ISLAND_JOINER') == '1'\n"
        "islands.win_create(np.full(2, 1.0 * islands.global_rank()), 'at')\n"
        "if not joiner:\n"
        "    deadline = time.monotonic() + 90.0\n"
        "    rec = None\n"
        "    while rec is None and time.monotonic() < deadline:\n"
        "        islands.win_put(islands.win_sync('at'), 'at')\n"
        "        islands.win_update('at')\n"
        "        rec = islands.admit_pending(timeout=60)\n"
        "        if rec is None:\n"
        "            time.sleep(0.02)\n"
        "    assert rec is not None, 'scale request never arrived'\n"
        "assert islands.size() == 3, islands.size()\n"
        f"open(os.path.join({str(outdir)!r}, "
        "f'done-{islands.global_rank()}'), 'w')"
        ".write(str(islands.membership_epoch()))\n"
        "islands.barrier(timeout=60)\n"
        "islands.shutdown(unlink=False)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, BFTPU_LAUNCH_GRACE_S="60")
    run = subprocess.Popen(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher", "--islands", "2",
         "--job", job, "--", sys.executable, "-c", script],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=repo,
    )
    try:
        from bluefog_tpu_torch.run import launcher as ln

        sock_path = ln.control_sock_path(job)
        deadline = time.monotonic() + 60.0
        while not os.path.exists(sock_path) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.0)  # let the members reach their gossip loop
        att = subprocess.run(
            [sys.executable, "-m", "bluefog_tpu_torch.run.launcher",
             "--attach", job, "scale", "+1"],
            env=env, capture_output=True, text=True, timeout=30, cwd=repo,
        )
        assert att.returncode == 0, (att.stdout, att.stderr)
        assert '"ok": true' in att.stdout.lower().replace("'", '"')
        out, err = run.communicate(timeout=150)
    except BaseException:
        run.kill()
        run.communicate()
        raise
    assert run.returncode == 0, (run.returncode, err[-2000:])
    assert "spawned joiner" in err
    done = sorted(p.name for p in outdir.iterdir())
    assert done == ["done-0", "done-1", "done-2"], done
    for p in outdir.iterdir():
        assert p.read_text() == "1"  # everyone finished in epoch 1


# ---------------------------------------------------------------------------
# the fault schedule and the chaos env: one spelling for both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_fault_schedule_from_a_seed_gives_the_reference_json(seed):
    from bluefog_tpu.sim.schedule import FaultSchedule as RefSchedule
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    for ranks, rounds in ((4, 40), (16, 200)):
        ours = FaultSchedule.generate(seed, ranks, rounds)
        theirs = RefSchedule.generate(seed, ranks, rounds)
        assert ours.to_json() == theirs.to_json()
        # and each package reads the other's JSON and env back
        assert FaultSchedule.from_json(theirs.to_json()) == ours
        assert ours.to_env({}) == theirs.to_env({})
        # (the env carries the faults, not the seed)
        assert RefSchedule.from_env(ours.to_env({})).to_json() == \
            FaultSchedule.from_env(theirs.to_env({})).to_json()


def test_chaos_env_written_by_one_package_drives_the_other(monkeypatch):
    from bluefog_tpu.resilience import chaos as ref_chaos

    env_ours, env_theirs = {}, {}
    for c, env in ((chaos, env_ours), (ref_chaos, env_theirs)):
        c.schedule_kill(env, rank=2, step=5)
        c.schedule_slow(env, rank=1, step=3, delay_s=0.25)
        c.schedule_partition(env, group="0,1", step=4, stop=9)
        c.schedule_serve_kill(env, replica=0, swap=2)
        c.schedule_serve_pub_kill(env, publish=3, phase="flip")
    assert env_ours == env_theirs
    for k, v in env_theirs.items():
        monkeypatch.setenv(k, v)
    assert chaos.schedule_to_json() == ref_chaos.schedule_to_json()
    payload = chaos.schedule_to_json()
    assert chaos.apply_schedule_json(payload, {}) == \
        ref_chaos.apply_schedule_json(payload, {})


def test_degraded_update_weights_absorb_conserves_rows():
    """The SPMD degraded-combine helper: dead in-neighbors are dropped and
    their compiled weight is ABSORBED into self, so every row total is
    bit-identical to the healthy plan's (convexity and push-sum mass
    conservation survive the excision)."""
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.windows import degraded_update_weights

    plan = compile_plan(topology_util.ExponentialTwoGraph(8))
    W = plan.mixing_matrix()
    sw, nw = degraded_update_weights(plan, dead=[3, 6])
    for d in range(8):
        assert sw[d] + sum(nw[d].values()) == pytest.approx(
            W[d].sum(), abs=1e-15)
        if d not in (3, 6):
            assert not {3, 6} & set(nw[d])


def test_grow_after_heal_splices_into_survivor_topology():
    """Shrink (heal) then grow: the corpse stays excised, the joiner is
    spliced in, and the grown plan is doubly stochastic (the relabel the
    reference spells ``nx.relabel_nodes(..., copy=True)``)."""
    healed = healing.heal_topology(topology_util.StarGraph(6), dead=[0])
    Gg = topology_util.relabel_nodes(healed.topology,
                                     dict(enumerate(healed.to_global)), copy=True)
    grown = healing.grow_topology(Gg, [6])
    assert 0 not in grown.to_global
    assert grown.to_global == (1, 2, 3, 4, 5, 6)
    assert grown.joined == (6,)
    row, col = grown.plan.stochasticity_error()
    assert row < 1e-9 and col < 1e-9
