"""Port twin of ``tests/test_serve.py``: the same cases against
``bluefog_tpu_torch`` (replicas on the CPU through ``BFTPU_SERVE_DEVICE``),
the simulator cases included.

Serving fleet: fenced weight publication with zero-downtime hot-swap
(docs/SERVING.md).

Four layers of evidence:

- units: the double-buffered seqlock'd snapshot region (publish/read
  round-trip, persisted strictly-monotone version word, mid-flip header
  repair, crc-guarded torn reads), the replica's hot-swap/retry/lag
  machinery, the shared full-jitter backoff (seeded RNG), the v5
  status-page serving plane (and v4 decode compat), and the serve
  fault's JSON/chaos-env round-trips + env scrub;
- sim campaigns: serve-off campaigns emit zero serve events (digest
  compatibility with every pinned pre-serve campaign), clean serve
  campaigns publish monotone and converge replicas, the seeded
  ``serve_version_reset`` / ``serve_torn`` bugs are caught by the two
  standing serve invariants, and a chaos campaign replays
  bit-identically;
- np=1 publisher: ``islands.serve_publish`` commits the debiased
  push-sum estimate with the membership epoch stamped, strictly
  monotone across calls;
- np=4 chaos e2e: a real training island publishes versions while a
  replica process hot-swaps; the replica is SIGKILLed precisely
  mid-swap (between the region read and the version flip) and
  respawned, then the publisher is SIGKILLed mid-publish (payload
  phase) — survivors stay on the previous committed version torn-free,
  the successor publisher continues the version sequence gap-free, and
  the healed fleet re-converges.
"""

import os

os.environ["BFTPU_SERVE_DEVICE"] = "cpu"  # spawned workers inherit it

import multiprocessing as mp
import os
import random
import struct
import time

import numpy as np
import pytest
import torch

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.introspect import statuspage as sp
from bluefog_tpu_torch.native import shm_native, tcp_transport
from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.serve import (Replica, SnapshotRegion, SnapshotUnavailable,
                               StaleSnapshotError, TornSnapshotError,
                               full_jitter, read_committed, region_path)
from bluefog_tpu_torch.sim.schedule import (Fault, FaultSchedule, FAULT_KINDS,
                                      GENERATE_KINDS)


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


# ---------------------------------------------------------------------------
# the snapshot region: publish/read, monotone word, repair, torn reads
# ---------------------------------------------------------------------------


def test_region_publish_read_roundtrip(shm_dir):
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    region = SnapshotRegion("rt", x.nbytes)
    try:
        assert region.version == 0
        with pytest.raises(SnapshotUnavailable):
            read_committed("rt")
        assert region.publish(x, epoch=2, step=7) == 1
        ver, epoch, step, got = read_committed("rt")
        assert (ver, epoch, step) == (1, 2, 7)
        np.testing.assert_array_equal(got, x)
        assert got.dtype == x.dtype and got.shape == x.shape
        # the double buffer alternates; the committed view always wins
        assert region.publish(x + 1.0, epoch=2, step=9) == 2
        ver, _, _, got = read_committed("rt")
        assert ver == 2
        np.testing.assert_array_equal(got, x + 1.0)
    finally:
        region.close(unlink=True)


def test_region_version_word_is_strictly_monotone(shm_dir):
    x = np.zeros(4)
    region = SnapshotRegion("mono", x.nbytes)
    try:
        assert region.publish(x) == 1
        assert region.publish(x, version=5) == 5
        for bad in (5, 4, 0):
            with pytest.raises(ValueError, match="strictly monotone"):
                region.publish(x, version=bad)
        # a successor publisher continues the PERSISTED sequence
        succ = SnapshotRegion("mono", x.nbytes)
        assert succ.version == 5
        assert succ.publish(x) == 6
        succ.close()
    finally:
        region.close(unlink=True)


def test_region_rejects_capacity_and_shape_mismatch(shm_dir):
    region = SnapshotRegion("cap", 32)
    try:
        with pytest.raises(ValueError, match="payload capacity"):
            region.publish(np.zeros(64))
        with pytest.raises(ValueError, match="ndim"):
            region.publish(np.zeros((1, 1, 1, 1, 2))[..., :1])
        with pytest.raises(ValueError, match="capacity"):
            SnapshotRegion("cap", 64)  # one region, one tensor shape
    finally:
        region.close(unlink=True)


def test_region_mid_flip_death_is_repaired_on_attach(shm_dir):
    """A publisher dead mid-flip leaves the header seq odd; the next
    publisher's attach rolls the header back to the newest WHOLE buffer
    and the version sequence continues from there."""
    x = np.full(4, 3.0)
    region = SnapshotRegion("rep", x.nbytes)
    try:
        region.publish(x)
        region.publish(x * 2)
        # simulate death mid-flip: header seq odd, fields half-written
        mm = region._seg._mm
        hseq = struct.unpack_from("<Q", mm, 8)[0]
        struct.pack_into("<Q", mm, 8, hseq + 1)   # odd: flip in flight
        struct.pack_into("<Q", mm, 24, 99)        # garbage version word
        with pytest.raises(TornSnapshotError, match="header seq odd"):
            read_committed("rep", retries=2)
        succ = SnapshotRegion("rep", x.nbytes)    # attach repairs
        ver, _, _, got = read_committed("rep")
        assert ver == 2
        np.testing.assert_array_equal(got, x * 2)
        assert succ.publish(x * 3) == 3
        succ.close()
    finally:
        region.close(unlink=True)


def test_region_crc_catches_torn_payload(shm_dir):
    """Bytes that match no committed snapshot (a torn mix of two buffer
    generations) fail the crc — the reader NEVER returns them."""
    x = np.full(8, 7.0)
    region = SnapshotRegion("crc", x.nbytes)
    try:
        region.publish(x)
        mm = region._seg._mm
        # corrupt one committed payload byte behind the seqlock's back
        off = snap_buf_off(region) + 64
        mm[off] = (mm[off] + 1) % 256
        with pytest.raises(TornSnapshotError, match="crc"):
            read_committed("crc", retries=2)
    finally:
        region.close(unlink=True)


def snap_buf_off(region):
    """Offset of the ACTIVE buffer record in the region's mmap."""
    active = struct.unpack_from("<I", region._seg._mm, 16)[0]
    return 64 + (active & 1) * region._stride


def test_read_missing_region_is_unavailable(shm_dir):
    with pytest.raises(SnapshotUnavailable, match="no serve region"):
        read_committed("nosuch")


# ---------------------------------------------------------------------------
# the replica: hot-swap, monotone skip, retry, lag policy
# ---------------------------------------------------------------------------


def test_replica_hot_swap_and_monotone_skip(shm_dir):
    x = np.arange(6, dtype=np.float64)
    region = SnapshotRegion("swap", x.nbytes)
    try:
        region.publish(x)
        rep = Replica("swap", 0, publish_page=False)
        assert rep.poll_swap() is True
        assert rep.version == 1 and rep.swaps == 1
        # nothing new: no re-swap, no regression
        assert rep.poll_swap() is False
        assert rep.swaps == 1
        region.publish(x * 10)
        assert rep.poll_swap() is True
        assert rep.version == 2
        ver, y = rep.serve_step()
        assert ver == 2
        np.testing.assert_array_equal(y, x * 10)
        ver, dot = rep.serve_step(np.ones_like(x))
        assert ver == 2 and dot == pytest.approx(float(np.sum(x * 10)))
        assert rep.serve_steps == 2
    finally:
        region.close(unlink=True)


class _FlakySource:
    """Poll source that fails ``fail`` times, then serves ``items``."""

    def __init__(self, fail, items):
        self.fail = fail
        self.items = list(items)
        self.polls = 0

    def poll(self):
        self.polls += 1
        if self.fail > 0:
            self.fail -= 1
            raise SnapshotUnavailable("not yet")
        return self.items[0]


def test_replica_bounded_retry_then_install(shm_dir, monkeypatch):
    monkeypatch.setenv("BFTPU_SERVE_RETRIES", "4")
    monkeypatch.setenv("BFTPU_SERVE_BACKOFF_S", "0.001")
    src = _FlakySource(2, [(3, 0, 0, np.ones(2))])
    rep = Replica("retry", 0, source=src, rng=random.Random(0),
                  publish_page=False)
    assert rep.poll_swap() is True
    assert rep.version == 3 and rep.retries == 2 and src.polls == 3


def test_replica_degrades_to_current_snapshot_on_poll_trouble(shm_dir,
                                                              monkeypatch):
    """Once a snapshot is installed, poll trouble degrades to serving
    the current version — the zero-downtime contract; with NOTHING
    installed the error propagates (there is nothing to serve)."""
    monkeypatch.setenv("BFTPU_SERVE_RETRIES", "2")
    monkeypatch.setenv("BFTPU_SERVE_BACKOFF_S", "0.001")
    src = _FlakySource(99, [])
    rep = Replica("deg", 0, source=src, rng=random.Random(1),
                  publish_page=False)
    with pytest.raises(SnapshotUnavailable):
        rep.poll_swap()
    rep._current = (4, 0, 0, np.full(2, 2.0))
    assert rep.poll_swap() is False      # degraded, not raised
    ver, y = rep.serve_step()
    assert ver == 4
    np.testing.assert_array_equal(y, np.full(2, 2.0))


def test_replica_lag_policy_warn_and_refuse(shm_dir, monkeypatch):
    rep = Replica("lag", 0, publish_page=False)
    rep._current = (2, 0, 0, np.zeros(2))
    rep.published_version = 7            # trails the head by 5
    assert rep.lag == 5
    monkeypatch.setenv("BFTPU_SERVE_MAX_LAG", "2")
    monkeypatch.setenv("BFTPU_SERVE_STALE_POLICY", "warn")
    ver, _ = rep.serve_step()            # warn: serve stale, count it
    assert ver == 2 and rep.stale_served == 1
    monkeypatch.setenv("BFTPU_SERVE_STALE_POLICY", "refuse")
    with pytest.raises(StaleSnapshotError) as ei:
        rep.serve_step()
    assert (ei.value.lag, ei.value.max_lag) == (5, 2)
    # unbounded lag (the default): stale is fine
    monkeypatch.setenv("BFTPU_SERVE_MAX_LAG", "0")
    ver, _ = rep.serve_step()
    assert ver == 2


# ---------------------------------------------------------------------------
# full-jitter backoff — the shape shared by replica and TCP reconnect
# ---------------------------------------------------------------------------


def test_full_jitter_bounds_and_growth_seeded():
    rng = random.Random(42)
    base, cap = 0.05, 2.0
    for attempt in range(12):
        bound = min(cap, base * 2 ** attempt)
        for _ in range(50):
            d = full_jitter(attempt, base, cap, rng)
            assert 0.0 <= d <= bound, (attempt, d, bound)
    # the seeded sequence is deterministic (the test seam)
    a = [full_jitter(k, base, cap, random.Random(7)) for k in range(6)]
    b = [full_jitter(k, base, cap, random.Random(7)) for k in range(6)]
    assert a == b
    # FULL jitter: the low half of the interval is actually sampled
    # (a deterministic schedule would sit at the bound — the herd)
    lows = sum(full_jitter(5, base, cap, rng) < min(cap, base * 32) / 2
               for _ in range(200))
    assert 40 < lows < 160
    assert full_jitter(3, 0.0) == 0.0


def test_tcp_reconnect_backoff_is_full_jitter_seeded(monkeypatch):
    """The TCP reconnect path samples uniform(0, min(cap, base*2^k))
    from the module-level RNG — pinnable, bounded, and not the old
    deterministic lockstep schedule."""
    monkeypatch.setenv("BFTPU_TCP_BACKOFF_S", "0.4")
    monkeypatch.setattr(tcp_transport, "_jitter_rng", random.Random(11))
    peers = tcp_transport._Peers.__new__(tcp_transport._Peers)
    slept = []
    monkeypatch.setattr(tcp_transport.time, "sleep", slept.append)
    for attempt in range(4):
        peers._backoff(0, attempt, "t")
    expect = []
    rng = random.Random(11)
    for attempt in range(4):
        d = rng.uniform(0.0, min(0.4 * 2 ** attempt, 2.0))
        if d > 0:
            expect.append(d)
    assert slept == expect
    assert all(d <= 2.0 for d in slept)


# ---------------------------------------------------------------------------
# status page v5: the serving plane round-trips; v4 pages still decode
# ---------------------------------------------------------------------------


def test_status_page_serve_plane_roundtrip(shm_dir):
    page = sp.StatusPage("sv5", 1000)
    try:
        page.publish(nranks=0, step=3, epoch=1, op_id=2,
                     serve_version=7, serve_lag=2)
        got = sp.read_status_page(sp.status_page_path("sv5", 1000))
        assert got["version"] == sp.STATUS_VERSION
        assert got["serve"] == {"version": 7, "lag": 2, "qps": -1.0,
                                "p50_ms": -1.0, "p99_ms": -1.0,
                                "slo_state": -1}
        # v6 default: not attached through the distribution tree
        assert got["distrib"] == {"slot": -1, "parent": -1}
        # default: not part of the serve plane
        page.publish(nranks=4, step=4, epoch=1, op_id=3)
        got = sp.read_status_page(sp.status_page_path("sv5", 1000))
        assert got["serve"] == {"version": -1, "lag": -1, "qps": -1.0,
                                "p50_ms": -1.0, "p99_ms": -1.0,
                                "slo_state": -1}
    finally:
        page.close(unlink=True)


def test_status_page_v4_decodes_without_serve_plane(shm_dir):
    """A live v4 writer (mid-upgrade fleet): its pages decode with the
    serve plane defaulted, not an error."""
    path = sp.status_page_path("v4c", 0)
    seg = shm_native._FallbackSegment(path, sp.PAGE_BYTES)
    try:
        sp._HEAD.pack_into(seg._mm, 0, sp.STATUS_MAGIC, 4, 2)
        sp._FIXED_V4.pack_into(
            seg._mm, sp._HEAD.size, 0, 4, os.getpid(), 0,
            9, 1, 5, time.time(), time.monotonic(), b"op",
            1.0, 1.0, 0.0, 0.0, -1, b"", -1.0, -1, sp.FLAG_ORPHAN)
        got = sp.read_status_page(path)
        assert got["version"] == 4 and got["orphan"] is True
        assert got["serve"] == {"version": -1, "lag": -1, "qps": -1.0,
                                "p50_ms": -1.0, "p99_ms": -1.0,
                                "slo_state": -1}
    finally:
        seg.close(unlink=True)


# ---------------------------------------------------------------------------
# serve faults: JSON + chaos-env round-trips both directions, env scrub
# ---------------------------------------------------------------------------


def test_serve_kill_fault_roundtrips():
    f = Fault(kind="serve_kill", step=2, rank=1, stop=16)
    sched = FaultSchedule([f], seed=3)
    assert FaultSchedule.from_json(sched.to_json()) == sched
    env = sched.to_env({})
    assert env["BFTPU_CHAOS_SERVE_KILL_REPLICA"] == "1"
    assert env["BFTPU_CHAOS_SERVE_KILL_SWAP"] == "2"
    assert env["BFTPU_CHAOS_SERVE_KILL_STOP"] == "16"
    back = FaultSchedule.from_env(env)
    assert len(back) == 1 and back.faults[0] == f


def test_serve_pub_kill_fault_roundtrips():
    for phase in ("payload", "flip"):
        f = Fault(kind="serve_pub_kill", step=3, rank=-1, group=phase)
        sched = FaultSchedule([f])
        assert FaultSchedule.from_json(sched.to_json()) == sched
        env = sched.to_env({})
        assert env["BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH"] == "3"
        assert env["BFTPU_CHAOS_SERVE_PUB_KILL_PHASE"] == phase
        back = FaultSchedule.from_env(env)
        assert len(back) == 1 and back.faults[0] == f
    with pytest.raises(ValueError, match="phase"):
        Fault(kind="serve_pub_kill", step=1, rank=-1, group="junk")
    with pytest.raises(ValueError, match="phase"):
        chaos.schedule_serve_pub_kill({}, 1, phase="junk")


def test_serve_kinds_are_not_in_the_seeded_generator():
    """generate() draws from the classic kinds only, so every pinned
    campaign digest from before the serve kinds existed is unchanged;
    the serve kinds are opt-in via explicit schedules."""
    assert "serve_kill" in FAULT_KINDS and "serve_pub_kill" in FAULT_KINDS
    assert "serve_kill" not in GENERATE_KINDS
    assert "serve_pub_kill" not in GENERATE_KINDS
    sched = FaultSchedule.generate(seed=5, ranks=8, rounds=30)
    assert all(f.kind in GENERATE_KINDS for f in sched.faults)


def test_clear_schedule_scrubs_serve_keys():
    try:
        chaos.schedule_serve_kill(os.environ, replica=0, swap=2, stop=9)
        chaos.schedule_serve_pub_kill(os.environ, 3, phase="flip")
        os.environ["BFTPU_SERVE_MAX_LAG"] = "4"
        os.environ["BFTPU_SERVE_STALE_POLICY"] = "refuse"
        os.environ["BFTPU_SERVE_RETRIES"] = "2"
        os.environ["BFTPU_SERVE_BACKOFF_S"] = "0.01"
        os.environ["BFTPU_SERVE_REPLICAS"] = "2"
        chaos.clear_schedule()
        for key in ("BFTPU_CHAOS_SERVE_KILL_REPLICA",
                    "BFTPU_CHAOS_SERVE_KILL_SWAP",
                    "BFTPU_CHAOS_SERVE_KILL_STOP",
                    "BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH",
                    "BFTPU_CHAOS_SERVE_PUB_KILL_PHASE",
                    "BFTPU_SERVE_MAX_LAG", "BFTPU_SERVE_STALE_POLICY",
                    "BFTPU_SERVE_RETRIES", "BFTPU_SERVE_BACKOFF_S",
                    "BFTPU_SERVE_REPLICAS"):
            assert key not in os.environ, key
    finally:
        chaos.clear_schedule()


# ---------------------------------------------------------------------------
# sim serve campaigns (no subprocesses; virtual clock)
# ---------------------------------------------------------------------------














# ---------------------------------------------------------------------------
# np=1 publisher: serve_publish commits the debiased estimate
# ---------------------------------------------------------------------------


def test_serve_publish_commits_debiased_estimate_np1(shm_dir):
    job = f"svpub{os.getpid()}"
    islands.init(0, 1, job)
    try:
        islands.win_create(np.full(4, 6.0, np.float64), "w")
        v1 = islands.serve_publish("w")
        assert v1 == 1
        ver, epoch, _step, got = read_committed(job)
        assert ver == 1 and epoch == islands.membership_epoch()
        # push-sum debias: x-hat = x / p (p = 1 on a fresh window)
        np.testing.assert_allclose(got, np.full(4, 6.0))
        assert islands.serve_publish("w") == 2
        islands.win_free("w")
    finally:
        islands.shutdown(unlink=True)


# ---------------------------------------------------------------------------
# np=4 chaos e2e: replica killed mid-swap, publisher killed mid-publish
# ---------------------------------------------------------------------------

_PUB_GAP_S = 1.5         # wall time between publishes (the replica's
#                          poll cadence is ~5 ms, so it tracks every
#                          version individually — including across its
#                          own respawn, whose jax re-import eats ~10 s)
_FINAL_VERSION = 4       # the successor publisher must reach this


def _serve_train_worker(rank, size, job, q, stop_ev):
    """One training rank: gossip + heal; the lowest live global rank
    publishes a snapshot every ``_PUB_GAP_S`` seconds.  The chaos env
    (inherited) SIGKILLs rank 0 during its 4th publish — mid-payload —
    so the region must keep serving version 3."""
    islands.init(rank, size, job)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(4, float(rank * 10), np.float64), "sv")
    islands.barrier()
    q.put(("up", rank, os.getpid()))
    deadline = time.monotonic() + 180.0
    last_pub = time.monotonic()
    while not stop_ev.is_set() and time.monotonic() < deadline:
        try:
            islands.win_put(islands.win_sync("sv"), "sv")
            islands.win_update("sv")
            if islands.dead_ranks() - islands._ctx().dead:
                islands.heal()
            # the publisher is the lowest LIVE member: a crash heal
            # keeps the corpse in the epoch membership (only a merge
            # epoch-switch excises it), so subtract the dead sets
            live = (set(islands.members()) - islands.dead_ranks()
                    - islands._ctx().dead)
            if (islands.global_rank() == min(live)
                    and time.monotonic() - last_pub >= _PUB_GAP_S):
                last_pub = time.monotonic()
                v = islands.serve_publish("sv")
                q.put(("pub", islands.global_rank(), v))
        except islands.OrphanedError:
            break
        time.sleep(0.002)
    est = float(np.mean(islands.win_sync("sv")))
    q.put(("done", islands.global_rank(), est))
    islands.shutdown(unlink=False)


def _serve_replica_worker(job, replica_id, chaos_env, q, stop_ev):
    """One replica process: poll/hot-swap/serve until stopped.  The
    first incarnation runs with the mid-swap kill armed; the parent
    respawns it clean."""
    os.environ.update(chaos_env)
    os.environ["BFTPU_SERVE_BACKOFF_S"] = "0.01"
    from bluefog_tpu_torch.serve import Replica, SnapshotUnavailable

    rep = Replica(job, replica_id, publish_page=False)
    q.put(("rup", replica_id, os.getpid()))
    served = 0
    deadline = time.monotonic() + 180.0
    while not stop_ev.is_set() and time.monotonic() < deadline:
        try:
            if rep.poll_swap():
                q.put(("swap", replica_id, rep.version, served))
        except SnapshotUnavailable:
            pass
        if rep.version:
            rep.serve_step()     # any raise here = a failed serve step
            served += 1
        time.sleep(0.005)
    q.put(("rdone", replica_id, (rep.version, rep.swaps, served)))
    rep.close()


@pytest.mark.slow
def test_serve_chaos_e2e(monkeypatch):
    """np=4 training island + 1 replica process over the real region:
    >= 3 versions published and hot-swapped; the replica is SIGKILLed
    precisely mid-swap (after the region read, before the flip) and
    respawned — its served version stays strictly monotone across the
    respawn; then the publisher (rank 0) is SIGKILLed during its 4th
    publish, mid-payload — the region still serves version 3 torn-free,
    the successor (rank 1) continues the sequence gap-free at version
    4, and the healed fleet re-converges with zero failed serve
    steps."""
    size = 4
    job = f"servee2e{os.getpid()}"
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "1.0")
    monkeypatch.setenv("BFTPU_QUORUM", "majority")
    for k in ("BFTPU_CHAOS_SERVE_KILL_REPLICA",
              "BFTPU_CHAOS_SERVE_KILL_SWAP",
              "BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH",
              "BFTPU_CHAOS_SERVE_PUB_KILL_PHASE"):
        monkeypatch.delenv(k, raising=False)
    # rank 0 dies during its 4th publish, with the payload half-written
    pub_chaos = {}
    chaos.schedule_serve_pub_kill(pub_chaos, 4, phase="payload")
    for k, v in pub_chaos.items():
        monkeypatch.setenv(k, v)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    stop_ev = ctx.Event()
    rep_stop = ctx.Event()
    procs = [ctx.Process(target=_serve_train_worker,
                         args=(r, size, job, q, stop_ev))
             for r in range(size)]
    # first incarnation: SIGKILL between the read and the flip of its
    # 2nd hot-swap
    rep_chaos = {}
    chaos.schedule_serve_kill(rep_chaos, replica=0, swap=2)
    rep1 = ctx.Process(target=_serve_replica_worker,
                       args=(job, 0, rep_chaos, q, rep_stop))
    rep2 = None
    for p in procs:
        p.start()
    rep1.start()
    swaps = []           # (incarnation, version) in arrival order
    pubs = {}            # version -> publisher global rank
    done = {}
    rep_final = None
    try:
        ups = 0
        while ups < size + 1:
            kind = q.get(timeout=120)[0]
            assert kind in ("up", "rup")
            ups += 1
        deadline = time.monotonic() + 150.0
        committed_after_kill = None
        while rep_final is None and time.monotonic() < deadline:
            # the first incarnation dies mid-swap: respawn it clean
            if rep2 is None and rep1.exitcode is not None:
                assert rep1.exitcode == -9, rep1.exitcode
                rep2 = ctx.Process(
                    target=_serve_replica_worker,
                    args=(job, 0, {}, q, rep_stop))
                rep2.start()
            # the publisher dies mid-payload: the committed word and
            # payload must still read back whole (the previous version)
            if committed_after_kill is None and procs[0].exitcode is not None:
                assert procs[0].exitcode == -9, procs[0].exitcode
                committed_after_kill = read_committed(job)
            try:
                msg = q.get(timeout=0.25)
            except Exception:
                continue
            if msg[0] == "swap":
                incarnation = 2 if rep2 is not None else 1
                swaps.append((incarnation, msg[2]))
                # stop only once the respawned incarnation has tracked
                # >= 2 versions itself (its first swap legitimately
                # jumps to the newest committed head, so the jump plus
                # one tracked publish proves it is really subscribed)
                if (msg[2] >= _FINAL_VERSION and len(swaps) >= 4
                        and sum(1 for i, _ in swaps if i == 2) >= 2):
                    rep_stop.set()
            elif msg[0] == "pub":
                pubs[msg[2]] = msg[1]
            elif msg[0] == "rup":
                pass
            elif msg[0] == "rdone":
                rep_final = msg[2]
        assert rep_final is not None, (swaps, pubs)
        stop_ev.set()
        while len(done) < size - 1:
            msg = q.get(timeout=60)
            if msg[0] == "done":
                done[msg[1]] = msg[2]
    finally:
        stop_ev.set()
        rep_stop.set()
        for p in procs + [rep1] + ([rep2] if rep2 is not None else []):
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job, ["sv"])
    # >= 3 versions actually published, the sequence gap-free monotone,
    # rank 0 up to v3 and the successor (rank 1) from v4 on
    assert sorted(pubs) == list(range(1, max(pubs) + 1))
    assert max(pubs) >= _FINAL_VERSION
    assert all(pubs[v] == 0 for v in range(1, 4))
    assert pubs[4] == 1, pubs
    # the mid-payload death left the PREVIOUS version committed, whole
    # (read_committed crc-checks the payload)
    assert committed_after_kill is not None
    assert committed_after_kill[0] == 3, committed_after_kill[0]
    # the replica hot-swapped >= 3 versions, strictly monotone across
    # the mid-swap SIGKILL + respawn (never regressed, never repeated)
    versions = [v for _inc, v in swaps]
    assert versions == sorted(set(versions)), swaps
    assert len(versions) >= 3, swaps
    assert any(inc == 2 for inc, _v in swaps), \
        "the respawned incarnation never swapped"
    final_version, _final_swaps, served = rep_final
    assert final_version >= _FINAL_VERSION
    assert served > 0          # zero failed serve steps, many served
    # the healed fleet (3 survivors) re-converged
    ests = list(done.values())
    assert len(ests) == size - 1
    assert max(ests) - min(ests) < 0.5, ests


# ---------------------------------------------------------------------------
# a mixed region: each package's publisher read by the other's replica
# ---------------------------------------------------------------------------


def _torch_bytes(t):
    from bluefog_tpu_torch.progress import staging

    return staging.host_view(t.detach().cpu().contiguous()).tobytes()


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_reference_publish_is_read_byte_for_byte_by_the_port_replica(dtype):
    """The reference's ``islands.serve_publish`` (np = 1, push-sum on, so
    the debiased x / p) read by the port's Replica: same version, epoch
    and bytes (a bf16 window's estimate is f32 in both packages)."""
    import ml_dtypes

    from bluefog_tpu import islands as ref_islands
    from bluefog_tpu.native import shm_native as ref_shm
    from bluefog_tpu.serve.snapshot import read_committed as ref_read

    job = f"tsvmixr{os.getpid()}{dtype[-2:]}"
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    x = (np.arange(24, dtype=np.float64) / 7 + 1).astype(dt)
    ref_islands.init(0, 1, job)
    rep = None
    try:
        ref_islands.turn_on_win_ops_with_associated_p()
        ref_islands.win_create(x, "w")
        ref_islands.win_set_exposed("w", x, 0.75)
        for want_v in (1, 2):
            assert ref_islands.serve_publish("w") == want_v
            ver, epoch, _step, ref_arr = ref_read(job)
            if rep is None:
                rep = Replica(job, 0, publish_page=False, device="cpu")
            assert rep.poll_swap()
            got_v, snap = rep.serve_step()
            assert got_v == ver == want_v
            assert _torch_bytes(snap) == np.ascontiguousarray(ref_arr).tobytes()
            assert tuple(snap.shape) == ref_arr.shape
        assert epoch == ref_islands.membership_epoch()
        ref_islands.win_free("w")
    finally:
        if rep is not None:
            rep.close(unlink=True)
        ref_islands.shutdown(unlink=True)
        ref_shm.unlink_all(job)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_port_publish_is_read_byte_for_byte_by_the_reference_replica(dtype):
    """The port's ``islands.serve_publish`` (np = 1, push-sum on) read by
    the reference's Replica: same version and bytes, which equal the
    port's own debiased estimate."""
    from bluefog_tpu.serve import Replica as RefReplica

    job = f"tsvmixp{os.getpid()}{str(dtype)[-2:]}"
    x = (torch.arange(24, dtype=torch.float64) / 7 + 1).to(dtype)
    islands.init(0, 1, job)
    rep = None
    try:
        islands.turn_on_win_ops_with_associated_p()
        islands.win_create(x, "w")
        islands.win_set_exposed("w", x, 0.75)
        want = (x.float() / 0.75 if dtype == torch.bfloat16 else x / 0.75)
        for want_v in (1, 2):
            assert islands.serve_publish("w") == want_v
            if rep is None:
                rep = RefReplica(job, 0, publish_page=False)
            assert rep.poll_swap()
            got_v, arr = rep.serve_step()
            assert got_v == want_v
            assert np.ascontiguousarray(arr).tobytes() == _torch_bytes(want)
        islands.win_free("w")
    finally:
        if rep is not None:
            rep.close(unlink=True)
        islands.shutdown(unlink=True)
        shm_native.unlink_all(job)


# ---------------------------------------------------------------------------
# the reference's simulator cases (sim campaigns, no subprocesses unless
# marked; virtual clock)
# ---------------------------------------------------------------------------


def test_sim_serve_off_emits_no_serve_events():
    """serve_every=0 (the default) is digest-neutral: zero serve events,
    so every pinned pre-serve campaign replays unchanged."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    res = run_campaign(SimConfig(ranks=8, rounds=20, seed=3),
                       FaultSchedule())
    assert not any(e[1].startswith("serve") for e in res.event_log)
    assert "serve" not in res.final


def test_sim_serve_clean_campaign_publishes_and_converges():
    from bluefog_tpu_torch.analysis.serve_rules import (_publish_versions,
                                                  _serve_path_findings,
                                                  serve_campaign)
    from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

    _cfg, _sched, res = serve_campaign(16, 24, 3)
    assert res.violations == []
    vers = _publish_versions(res)
    assert len(vers) >= 3 and vers == sorted(set(vers))
    assert campaign_findings(res, "t") == []
    assert _serve_path_findings(res, "t") == []
    sv = res.final["serve"]
    assert all(r["version"] == sv["published"] and r["steps"] > 0
               for r in sv["replicas"].values())


def test_sim_serve_replica_kill_rejoin_reconverges_bit_identically():
    from bluefog_tpu_torch.analysis.serve_rules import (_serve_path_findings,
                                                  serve_campaign)
    from bluefog_tpu_torch.sim.campaign import run_campaign

    sched = FaultSchedule([Fault(kind="serve_kill", step=2, rank=0,
                                 stop=16)])
    cfg, _s, res = serve_campaign(16, 24, 3, schedule=sched)
    assert res.violations == []
    kinds = [e[1] for e in res.event_log]
    assert "serve_replica_kill" in kinds
    assert "serve_replica_join" in kinds
    assert _serve_path_findings(res, "t") == []
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest
    assert again.event_log == res.event_log


def test_sim_serve_pub_kill_leaves_versions_gap_free():
    """Publisher killed mid-payload: the interrupted publish commits
    NOTHING, the successor continues the sequence — versions 1..n with
    no gap and no regression; mid-flip commits forward via the repair
    (exactly one repaired commit)."""
    from bluefog_tpu_torch.analysis.serve_rules import (_publish_versions,
                                                  serve_campaign)

    sched = FaultSchedule([Fault(kind="serve_pub_kill", step=2, rank=-1,
                                 group="payload")])
    _c, _s, res = serve_campaign(16, 24, 3, schedule=sched)
    assert res.violations == []
    vers = _publish_versions(res)
    assert vers == list(range(1, len(vers) + 1)) and len(vers) >= 3
    assert [e[1] for e in res.event_log].count("serve_pub_kill") == 1

    sched = FaultSchedule([Fault(kind="serve_pub_kill", step=2, rank=-1,
                                 group="flip")])
    _c, _s, res = serve_campaign(16, 24, 3, schedule=sched)
    assert res.violations == []
    repaired = [e for e in res.event_log if e[1] == "serve_publish"
                and dict(e[3]).get("repaired")]
    assert len(repaired) == 1


def test_sim_seeded_serve_bugs_are_caught():
    """The two standing serve invariants fire on their seeded bugs:
    a publisher handoff restarting at version 1 trips serve-monotone,
    a swap that mixes two buffer generations trips serve-committed."""
    from bluefog_tpu_torch.analysis.serve_rules import serve_campaign

    _c, _s, res = serve_campaign(16, 24, 3,
                                 debug_bugs=("serve_version_reset",))
    assert "serve-monotone" in {v["name"] for v in res.violations}

    _c, _s, res = serve_campaign(16, 24, 3, debug_bugs=("serve_torn",))
    assert "serve-committed" in {v["name"] for v in res.violations}


def test_sim_orphaned_publisher_is_fenced():
    """A partition's minority-side publisher is fenced (never
    publishes): the quorum gate at the publish boundary is the same
    production arithmetic the heal uses."""
    from bluefog_tpu_torch.analysis.serve_rules import serve_campaign

    sched = FaultSchedule([Fault.partition([(0, 1, 2)], 5, 14)], seed=3)
    _c, _s, res = serve_campaign(8, 24, 3, schedule=sched,
                                 serve_every=1, serve_replicas=1,
                                 quiesce_rounds=30)
    assert res.violations == []
    fenced = [e for e in res.event_log if e[1] == "serve_fenced"]
    assert fenced, "the orphaned publisher was never denied"
    orphan_time = {}
    for e in res.event_log:
        if e[1] == "orphan":
            orphan_time.setdefault(e[2], e[0])
    for e in res.event_log:
        if e[1] == "serve_publish" and e[2] in orphan_time:
            assert e[0] < orphan_time[e[2]], \
                "an orphaned rank published a snapshot"

