"""Port twin of ``tests/test_distrib.py``: the same cases against
``bluefog_tpu_torch`` (replicas on the CPU through ``BFTPU_SERVE_DEVICE``),
the simulator cases included.

Snapshot distribution plane: delta-encoded fan-out trees feeding
cross-host replica fleets (docs/SERVING.md).

Four layers of evidence:

- units: the pure tree math (canonical heap placement at logarithmic
  depth, greedy kill repair that stays valid, the degree-cap knob the
  seeded fixture needs), the delta store (dirty map ships only touched
  chunks, horizon degrade to full resync, error-feedback canonical
  bytes, CRC/chunk-count rejection of torn generations), and the
  chaos env scrub of the new distrib keys;
- loopback e2e (threads, no subprocesses): one publisher feeds >= 8
  ``TcpSource`` subscribers through a real TCP tree — depth within the
  log bound, publisher feed sockets <= fanout, every replica
  bit-identical at bf16, steady-state polls ride the delta path, and a
  relay's death re-parents its children onto live feeds;
- sim campaigns: distrib-off stays digest-neutral, relay-kill and
  join-storm campaigns keep the tree-validity/staleness invariants
  silent and replay bit-identically (a 64-rank storm included), and
  the seeded ``distrib_degree_overflow`` / ``distrib_stall`` bugs are
  each caught by exactly their invariant;
- np=4 chaos e2e (slow): real subscriber processes; a suspended
  subscriber sleeps past the dirty-map horizon (``schedule_suspend``)
  and lands the full-resync path bit-identical, and an interior relay
  is SIGKILLed mid-fan-out — its subtree re-parents and every
  survivor's served version stays strictly monotone.
"""

import os

os.environ["BFTPU_SERVE_DEVICE"] = "cpu"  # spawned workers inherit it

import multiprocessing as mp
import os
import time
import zlib

import numpy as np
import pytest

from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.serve.distrib import delta as dd
from bluefog_tpu_torch.serve.distrib import feed as df
from bluefog_tpu_torch.serve.distrib import tree as dt
from bluefog_tpu_torch.serve.distrib.sub import TcpSource
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule


@pytest.fixture
def distrib_env(monkeypatch):
    """Small chunks + tight failure detection so the loopback trees
    exercise multi-chunk deltas and re-parent fast."""
    monkeypatch.setenv("BFTPU_DISTRIB_CHUNK_KB", "1")
    monkeypatch.setenv("BFTPU_DISTRIB_TIMEOUT_S", "2.0")
    monkeypatch.setenv("BFTPU_DISTRIB_RETRIES", "1")
    for k in ("BFTPU_CHAOS_DISTRIB_KILL_RELAY",
              "BFTPU_CHAOS_DISTRIB_KILL_SYNC"):
        monkeypatch.delenv(k, raising=False)
    yield


# ---------------------------------------------------------------------------
# tree math: canonical placement, kill repair, the degree-cap knob
# ---------------------------------------------------------------------------


def test_tree_canonical_heap_shape_is_valid_at_log_depth():
    import math

    for fanout in (2, 3, 4):
        for n in (1, 2, 7, 8, 16, 33, 64):
            parents = {k: dt.parent_of(k, fanout) for k in range(n)}
            assert dt.tree_valid(parents, fanout,
                                 root_cap=fanout) is None
            bound = (int(math.floor(math.log(max(2, n), fanout))) + 1
                     if n > 1 else 1)
            assert dt.tree_depth(parents) <= bound, (fanout, n)


def test_tree_reassign_after_kills_stays_valid():
    fanout, n = 3, 13
    parents = {k: dt.parent_of(k, fanout) for k in range(n)}
    # kill an interior relay, then one of the slots that adopted its
    # children — the tree must stay connected/acyclic/capped throughout
    for dead in (0, 1):
        parents = dt.reassign(parents, dead, fanout)
        assert dead not in parents
        assert dt.tree_valid(parents, fanout) is None
    # every surviving slot still reaches the publisher
    assert all(dt.depth_of(k, parents) >= 1 for k in parents)


def test_tree_publisher_is_root_of_last_resort():
    # no live candidate at all: the orphan lands on the publisher
    assert dt.choose_parent(5, {5: 0}, 2, dead=(0,)) == dt.PUBLISHER
    # kill every interior relay of a fanout-2 tree one by one: the
    # tree stays valid throughout and the publisher absorbs orphans
    fanout = 2
    parents = {k: dt.parent_of(k, fanout) for k in range(7)}
    for dead in (0, 1, 2, 3):
        parents = dt.reassign(parents, dead, fanout)
        assert dt.tree_valid(parents, fanout) is None
    assert parents
    assert dt.children_of(parents).get(dt.PUBLISHER), parents


def test_tree_degree_cap_off_overflows_and_is_caught():
    fanout, n = 3, 13
    parents = {k: dt.parent_of(k, fanout) for k in range(n)}
    bad = dt.reassign(parents, 1, fanout, degree_cap=False)
    err = dt.tree_valid(bad, fanout)
    assert err is not None and "fanout" in err


def test_tree_repair_never_adopts_into_the_orphan_subtree():
    fanout = 2
    parents = {0: -1, 1: -1, 2: 0, 3: 0, 4: 2, 5: 2}
    # re-place slot 2: its own subtree {2,4,5} is off-limits, so no
    # choice can close a cycle
    choice = dt.choose_parent(2, parents, fanout, dead=(0,))
    assert choice not in dt.subtree_of(2, parents)
    repaired = dt.reassign(parents, 0, fanout)
    assert dt.tree_valid(repaired, fanout) is None
    assert dt.subtree_of(2, repaired) == {2, 4, 5}  # subtree rode along


# ---------------------------------------------------------------------------
# the delta store: dirty map, horizon, error feedback, torn generations
# ---------------------------------------------------------------------------


def _pull(store, have):
    """One poll against ``store`` without sockets: the install
    arguments ``(meta, chunks, full)`` a subscriber would stage."""
    full, items, meta = store.delta_since(have)
    return meta, dict(items), full


def test_delta_ships_only_dirty_chunks(monkeypatch):
    monkeypatch.setenv("BFTPU_DISTRIB_CHUNK_KB", "1")
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "f32")
    per = 256  # 1 KiB / 4-byte f32
    x = np.arange(4 * per, dtype=np.float32)
    enc = dd.DeltaEncoder()
    enc.publish(1, 0, 0, x)
    y = x.copy()
    y[2 * per + 5] += 1.0  # touch exactly one chunk
    enc.publish(2, 0, 0, y)
    assert enc.last_dirty == 1
    full, items, _meta = enc.store.delta_since(1)
    assert not full and [i for i, _ in items] == [2]
    # a lag-1 subscriber applies the delta and lands bit-identical
    sub = dd.ChunkStore()
    meta, chunks, f = _pull(enc.store, 0)
    sub.install(meta, chunks, full=f)
    meta, chunks, f = _pull(enc.store, sub.version)
    assert not f
    got = sub.install(meta, chunks, full=f)
    np.testing.assert_array_equal(got, enc.store.decode()[1])


def test_delta_horizon_degrades_to_full_resync(monkeypatch):
    monkeypatch.setenv("BFTPU_DISTRIB_CHUNK_KB", "1")
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "f32")
    monkeypatch.setenv("BFTPU_DISTRIB_HORIZON", "2")
    per = 256
    enc = dd.DeltaEncoder()
    for v in range(1, 6):
        a = np.zeros(3 * per, np.float32)
        a[(v % 3) * per] = float(v)
        enc.publish(v, 0, 0, a)
    # lag 1: a delta.  lag past the horizon (v1 -> v5): a full resync.
    full, _, _ = enc.store.delta_since(4)
    assert not full
    full, items, meta = enc.store.delta_since(1)
    assert full and len(items) == meta.nchunks
    # ahead of the head (a previous publisher incarnation): full too
    full, _, _ = enc.store.delta_since(99)
    assert full
    sub = dd.ChunkStore()
    got = sub.install(meta, dict(items), full=True)
    np.testing.assert_array_equal(got, enc.store.decode()[1])


def test_delta_error_feedback_is_lossless_in_the_limit(monkeypatch):
    """int8 wire: one-shot quantization error is large, but the
    per-chunk sender residual folds it into the next publish, so the
    time-average of the canonical generations converges on the true
    signal — and every subscriber holds the SAME canonical bytes."""
    monkeypatch.setenv("BFTPU_DISTRIB_CHUNK_KB", "1")
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "int8")
    rng = np.random.RandomState(7)
    x = rng.randn(512).astype(np.float32)
    enc = dd.DeltaEncoder()
    sub = dd.ChunkStore()
    decoded = []
    for v in range(1, 41):
        enc.publish(v, 0, 0, x)
        meta, chunks, f = _pull(enc.store, sub.version)
        got = sub.install(meta, chunks, full=f)
        np.testing.assert_array_equal(got, enc.store.decode()[1])
        decoded.append(got)
    one_shot = float(np.abs(decoded[0] - x).max())
    avg_err = float(np.abs(np.mean(decoded, axis=0) - x).max())
    assert one_shot > 0
    assert avg_err < one_shot / 8.0, (avg_err, one_shot)


def test_store_rejects_torn_generations(monkeypatch):
    monkeypatch.setenv("BFTPU_DISTRIB_CHUNK_KB", "1")
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "f32")
    per = 256
    enc = dd.DeltaEncoder()
    enc.publish(1, 0, 0, np.arange(3 * per, dtype=np.float32))
    y = np.arange(3 * per, dtype=np.float32)
    y[0] += 1.0
    y[2 * per] += 1.0
    enc.publish(2, 0, 0, y)
    meta, chunks, full = _pull(enc.store, 1)
    assert not full and len(chunks) == 2
    sub = dd.ChunkStore()
    m1, c1, f1 = _pull(enc.store, 0)
    sub.install(m1, c1, full=f1)
    # (a) a dropped chunk: the count check fires before any flip
    short = dict(chunks)
    short.pop(sorted(short)[0])
    fresh = dd.ChunkStore()
    with pytest.raises(ValueError, match="incomplete"):
        fresh.install(meta, short, full=False)
    assert fresh.version == 0  # nothing became servable
    # (b) a corrupted payload: the canonical CRC fires before the flip
    idx = sorted(chunks)[0]
    lastmod, code, payload, scale = chunks[idx]
    bad = dict(chunks)
    bad[idx] = (lastmod, code,
                bytes([payload[0] ^ 0xFF]) + payload[1:], scale)
    with pytest.raises(ValueError, match="CRC"):
        sub.install(meta, bad, full=False)
    assert sub.version == 2  # the previous generation still serving
    # the good delta still lands
    got = sub.install(meta, chunks, full=False)
    np.testing.assert_array_equal(got, enc.store.decode()[1])


def test_clear_schedule_scrubs_distrib_keys():
    try:
        chaos.schedule_distrib_kill(os.environ, relay=1, n=2)
        chaos.schedule_distrib_kill(os.environ, sync=0, n=3)
        os.environ["BFTPU_DISTRIB_FANOUT"] = "2"
        os.environ["BFTPU_DISTRIB_HORIZON"] = "1"
        os.environ["BFTPU_DISTRIB_CHUNK_KB"] = "1"
        os.environ["BFTPU_DISTRIB_TIMEOUT_S"] = "0.5"
        os.environ["BFTPU_DISTRIB_RETRIES"] = "1"
        chaos.clear_schedule()
        for key in ("BFTPU_CHAOS_DISTRIB_KILL_RELAY",
                    "BFTPU_CHAOS_DISTRIB_KILL_SYNC",
                    "BFTPU_DISTRIB_FANOUT", "BFTPU_DISTRIB_HORIZON",
                    "BFTPU_DISTRIB_CHUNK_KB", "BFTPU_DISTRIB_TIMEOUT_S",
                    "BFTPU_DISTRIB_RETRIES"):
            assert key not in os.environ, key
    finally:
        chaos.clear_schedule()


# ---------------------------------------------------------------------------
# loopback e2e: a real TCP tree of >= 8 subscribers (threads, one process)
# ---------------------------------------------------------------------------


def _poll_all(subs):
    """Poll every subscriber in slot order (parents commit before their
    children poll — the deterministic in-process schedule)."""
    out = {}
    for s in sorted(subs, key=lambda s: s.slot if s.slot is not None
                    else 10 ** 6):
        out[s.replica_id] = s.poll()
    return out


def test_loopback_tree_feeds_eight_replicas(distrib_env, monkeypatch):
    """Acceptance shape: 8 replicas, fanout 4 — tree depth <=
    log4(8)+1 = 2, the publisher holds <= fanout persistent feed
    sockets, every replica lands bit-identical at bf16, and the
    steady-state second poll rides the delta path (no resync)."""
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "bf16")
    fanout, nsub = 4, 8
    pub = df.DistribPublisher("loop8", fanout=fanout)
    subs = []
    try:
        rng = np.random.RandomState(3)
        x = rng.randn(2048).astype(np.float32)
        pub.publish(1, 5, 50, x)
        canon = pub.store.decode()[1]
        assert canon.dtype == np.float32 and not np.array_equal(canon, x)
        subs = [TcpSource(pub.addr_str, replica_id=i)
                for i in range(nsub)]
        # join in replica order so slots are deterministic
        for s in subs:
            s.poll()
        got = _poll_all(subs)
        for i in range(nsub):
            ver, epoch, step, arr = got[i]
            assert (ver, epoch, step) == (1, 5, 50)
            np.testing.assert_array_equal(arr, canon)
        assert dt.tree_valid(pub.server.parents, fanout,
                             root_cap=fanout) is None
        assert dt.tree_depth(pub.server.parents) <= 2
        # O(fanout) publisher sockets no matter the fleet size
        assert pub.server.live_feeds <= fanout
        # steady state: a one-behind delta, not a resync
        y = canon.copy()
        y[100] += 1.0
        pub.publish(2, 5, 60, y)
        canon2 = pub.store.decode()[1]
        got = _poll_all(subs)
        for i in range(nsub):
            assert got[i][0] == 2
            np.testing.assert_array_equal(got[i][3], canon2)
        assert all(s.resyncs == 1 for s in subs)  # the bootstrap only
        assert all(s.syncs == 2 for s in subs)
    finally:
        for s in subs:
            s.close()
        pub.close()


def test_loopback_relay_death_reparents_subtree(distrib_env,
                                                monkeypatch):
    """Close an interior relay: its children's next poll fails fast,
    they re-place through the coordinator, the repaired tree stays
    valid, and versions keep flowing strictly monotone."""
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "f32")
    fanout = 2
    pub = df.DistribPublisher("loopkill", fanout=fanout)
    subs = []
    try:
        pub.publish(1, 0, 10, np.arange(512, dtype=np.float32))
        subs = [TcpSource(pub.addr_str, replica_id=i) for i in range(6)]
        for s in subs:
            s.poll()
        _poll_all(subs)
        kids = dt.children_of(pub.server.parents)
        victim_slot = next(p for p in sorted(kids)
                           if p != dt.PUBLISHER and kids[p])
        victim = next(s for s in subs if s.slot == victim_slot)
        orphan_ids = [s.replica_id for s in subs
                      if s.parent_slot == victim_slot]
        assert orphan_ids, kids
        victim.close()  # relay process death: feeds severed
        pub.publish(2, 0, 20, np.arange(512, dtype=np.float32) * 2.0)
        canon = pub.store.decode()[1]
        live = [s for s in subs if s is not victim]
        # a re-parented child may land under a relay that has not
        # itself advanced yet — poll rounds until the wave propagates
        # (exactly what real replicas' poll cadence does)
        vers = {s.replica_id: 1 for s in live}
        for _round in range(5):
            for s in sorted(live, key=lambda s: s.slot):
                ver, _, _, arr = s.poll()
                assert ver >= vers[s.replica_id]  # monotone throughout
                vers[s.replica_id] = ver
                if ver == 2:
                    np.testing.assert_array_equal(arr, canon)
            if all(v == 2 for v in vers.values()):
                break
        assert all(v == 2 for v in vers.values()), vers
        for s in live:
            if s.replica_id in orphan_ids:
                assert s.reparents >= 1
                assert s.parent_slot != victim_slot
        assert victim_slot not in pub.server.parents
        assert dt.tree_valid(pub.server.parents, fanout) is None
        assert pub.server.reparents >= 1
    finally:
        for s in subs:
            s.close()
        pub.close()


def test_replica_over_tcp_source(distrib_env, monkeypatch):
    """The death-matrix integration: a Replica driven by a TcpSource
    twin behaves like the shm one — unavailable before the first
    commit, strictly monotone hot-swaps after."""
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", "f32")
    monkeypatch.setenv("BFTPU_SERVE_BACKOFF_S", "0.01")
    from bluefog_tpu_torch.serve import Replica, SnapshotUnavailable

    pub = df.DistribPublisher("looprep")
    src = TcpSource(pub.addr_str, replica_id=0, relay=False)
    rep = Replica("looprep", 0, source=src, publish_page=False)
    try:
        with pytest.raises(SnapshotUnavailable):
            rep.poll_swap()
        x = np.arange(300, dtype=np.float32)
        pub.publish(1, 2, 30, x)
        assert rep.poll_swap() and rep.version == 1
        rep.serve_step()
        assert not rep.poll_swap()  # NOCHANGE: nothing to swap
        pub.publish(2, 2, 40, x + 1.0)
        assert rep.poll_swap() and rep.version == 2
        np.testing.assert_array_equal(rep._current[3],
                                      pub.store.decode()[1])
    finally:
        rep.close()
        src.close()
        pub.close()


# ---------------------------------------------------------------------------
# sim distrib campaigns (no subprocesses; virtual clock)
# ---------------------------------------------------------------------------














# ---------------------------------------------------------------------------
# chaos e2e (slow): suspend past the horizon; SIGKILL an interior relay
# ---------------------------------------------------------------------------

_SUB_ENV = {"BFTPU_DISTRIB_CHUNK_KB": "1", "BFTPU_DISTRIB_TIMEOUT_S":
            "2.0", "BFTPU_DISTRIB_RETRIES": "1",
            "BFTPU_SERVE_BACKOFF_S": "0.01", "BFTPU_WIRE_DTYPE": "f32"}


def _sub_worker(addr, replica_id, extra_env, q, stop_ev):
    """One subscriber process: a Replica over a TcpSource relay; every
    hot-swap is reported as ``(swap, id, version, reparents, crc,
    slot)``."""
    os.environ.update(_SUB_ENV)
    os.environ.update(extra_env)
    from bluefog_tpu_torch.serve import Replica, SnapshotUnavailable
    from bluefog_tpu_torch.serve.distrib.sub import TcpSource as _Tcp

    src = _Tcp(addr, replica_id=replica_id)
    rep = Replica(f"sub{replica_id}", replica_id, source=src,
                  publish_page=False)
    q.put(("up", replica_id, os.getpid()))
    deadline = time.monotonic() + 120.0
    while not stop_ev.is_set() and time.monotonic() < deadline:
        try:
            if rep.poll_swap():
                crc = zlib.crc32(rep._current[3].tobytes()) & 0xFFFFFFFF
                q.put(("swap", replica_id, rep.version, src.reparents,
                       crc, src.slot))
        except (SnapshotUnavailable, OSError):
            pass  # transient while bootstrapping; the loop retries
        time.sleep(0.005)
    q.put(("done", replica_id,
           (rep.version, src.reparents, src.resyncs, src.syncs)))
    rep.close()
    src.close()


def _drain_until(q, want, timeout=90.0):
    """Collect queue messages until ``want(msgs)`` holds or the
    timeout expires; returns everything collected."""
    msgs = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if want(msgs):
            return msgs
        try:
            msgs.append(q.get(timeout=0.25))
        except Exception:
            continue
    return msgs


def _swaps(msgs, rid=None, version=None):
    return [m for m in msgs if m[0] == "swap"
            and (rid is None or m[1] == rid)
            and (version is None or m[2] == version)]


@pytest.mark.slow
def test_distrib_suspend_past_horizon_full_resync_e2e(monkeypatch):
    """A subscriber process SIGSTOPs itself (``schedule_suspend`` at
    its 2nd ``distrib_sync`` checkpoint) while the publisher streams
    past the dirty-map horizon; on resume its next poll takes the
    full-resync path and lands bit-identical at the head."""
    from bluefog_tpu_torch.serve.replica import REPLICA_RANK_BASE

    chaos.clear_schedule()  # BEFORE setenv: it scrubs distrib keys
    for k, v in _SUB_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BFTPU_DISTRIB_HORIZON", "2")
    sub_env = {"BFTPU_DISTRIB_HORIZON": "2"}
    chaos.schedule_suspend(sub_env, rank=REPLICA_RANK_BASE + 0, step=2,
                           duration_s=2.0)
    pub = df.DistribPublisher("suspend", fanout=4)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    stop_ev = ctx.Event()
    x = np.arange(1024, dtype=np.float32)
    pub.publish(1, 0, 10, x)
    proc = ctx.Process(target=_sub_worker,
                       args=(pub.addr_str, 0, sub_env, q, stop_ev))
    proc.start()
    try:
        msgs = _drain_until(q, lambda m: bool(_swaps(m, version=1)))
        assert _swaps(msgs, version=1), msgs
        # the sub's 2nd sync (milliseconds after that swap) SIGSTOPs
        # it for 2 s; stream 12 versions — far past the horizon of 2
        time.sleep(0.5)
        final = 13
        for v in range(2, final + 1):
            pub.publish(v, 0, v * 10, x + float(v))
        expect = zlib.crc32(pub.store.decode()[1].tobytes()) & 0xFFFFFFFF
        msgs += _drain_until(q,
                             lambda m: bool(_swaps(m, version=final)))
        versions = [m[2] for m in _swaps(msgs)]
        assert versions == sorted(set(versions)), versions
        head = _swaps(msgs, version=final)
        assert head, msgs
        assert head[0][4] == expect  # bit-identical to the canonical
        # the post-suspend jump skipped past the horizon in one swap
        assert final - versions[versions.index(final) - 1] > 2, versions
        stop_ev.set()
        done = _drain_until(q, lambda m: any(x[0] == "done" for x in m),
                            timeout=30.0)
        fin = next(m for m in done if m[0] == "done")[2]
        # bootstrap full + the past-horizon resync = exactly 2 fulls
        assert fin[2] == 2, fin
    finally:
        stop_ev.set()
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
        pub.close()
        chaos.clear_schedule()


@pytest.mark.slow
def test_distrib_relay_sigkill_e2e(monkeypatch):
    """np=4 subscriber processes on a fanout-2 tree: slot 0 relays
    slots 2 and 3.  The relay is SIGKILLed mid-fan-out (right after
    its 2nd store flip, before its replica swap) — its subtree
    re-parents onto live feeds, every survivor's served version stays
    strictly monotone, the fleet converges bit-identical at the head,
    and the respawned victim re-joins and converges too."""
    chaos.clear_schedule()  # BEFORE setenv: it scrubs distrib keys
    for k, v in _SUB_ENV.items():
        monkeypatch.setenv(k, v)
    fanout, final = 2, 4
    pub = df.DistribPublisher("sigkill", fanout=fanout)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    stop_ev = ctx.Event()
    x = np.arange(2048, dtype=np.float32)
    pub.publish(1, 0, 10, x)
    victim_env = {}
    chaos.schedule_distrib_kill(victim_env, relay=0, n=2)
    victim = ctx.Process(target=_sub_worker,
                         args=(pub.addr_str, 0, victim_env, q, stop_ev))
    victim.start()
    others, respawn = [], None
    try:
        # the victim joins first -> slot 0 (interior once others join)
        msgs = _drain_until(q, lambda m: bool(_swaps(m, rid=0)))
        assert _swaps(msgs, rid=0), msgs
        others = [ctx.Process(target=_sub_worker,
                              args=(pub.addr_str, i, {}, q, stop_ev))
                  for i in (1, 2, 3)]
        for p in others:
            p.start()
        msgs += _drain_until(
            q, lambda m: len(_swaps(m, version=1)) >= 4)
        kids = dt.children_of(pub.server.parents)
        assert kids.get(0), f"slot 0 relays nobody: {pub.server.parents}"
        subtree_slots = set(kids[0])
        slot_of = {m[1]: m[5] for m in _swaps(msgs)}
        subtree_rids = {r for r, s in slot_of.items()
                        if s in subtree_slots}
        assert len(subtree_rids) == 2, slot_of
        # v2: the relay installs it (children may pull it first), then
        # dies mid-fan-out — before its own replica ever swaps v2
        pub.publish(2, 0, 20, x + 2.0)
        victim.join(timeout=60)
        assert victim.exitcode == -9, victim.exitcode
        pub.publish(3, 0, 30, x + 3.0)
        pub.publish(4, 0, 40, x + 4.0)
        expect = zlib.crc32(pub.store.decode()[1].tobytes()) & 0xFFFFFFFF
        msgs += _drain_until(
            q, lambda m: len(_swaps(m, version=final)) >= 3)
        # every survivor reached the head bit-identically...
        for rid in (1, 2, 3):
            heads = _swaps(msgs, rid=rid, version=final)
            assert heads, (rid, msgs)
            assert heads[0][4] == expect
            # ...with strictly monotone served versions throughout
            vers = [m[2] for m in _swaps(msgs, rid=rid)]
            assert vers == sorted(set(vers)), (rid, vers)
        # the orphaned subtree re-parented off the dead relay
        for rid in subtree_rids:
            assert max(m[3] for m in _swaps(msgs, rid=rid)) >= 1, \
                (rid, msgs)
        assert 0 not in pub.server.parents
        assert dt.tree_valid(pub.server.parents, fanout) is None
        assert pub.server.reparents >= 1
        # the victim's replacement re-joins and converges too
        respawn = ctx.Process(target=_sub_worker,
                              args=(pub.addr_str, 4, {}, q, stop_ev))
        respawn.start()
        msgs += _drain_until(
            q, lambda m: bool(_swaps(m, rid=4, version=final)))
        tail = _swaps(msgs, rid=4)
        assert tail and tail[-1][2] == final and tail[-1][4] == expect
        assert dt.tree_valid(pub.server.parents, fanout) is None
    finally:
        stop_ev.set()
        for p in others + ([respawn] if respawn is not None else []):
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        if victim.is_alive():
            victim.terminate()
        pub.close()
        chaos.clear_schedule()


# ---------------------------------------------------------------------------
# the reference's simulator cases (sim campaigns, no subprocesses unless
# marked; virtual clock)
# ---------------------------------------------------------------------------


def test_sim_distrib_off_emits_no_distrib_events():
    """distrib_fanout=0 (the default) is digest-neutral: zero distrib
    events, so every pinned pre-distrib campaign replays unchanged."""
    from bluefog_tpu_torch.analysis.serve_rules import serve_campaign

    _c, _s, res = serve_campaign(16, 24, 3)
    assert res.violations == []
    assert not any(e[1].startswith("distrib") for e in res.event_log)
    assert "distrib" not in res.final.get("serve", {})


def test_sim_distrib_clean_campaign_converges_through_the_tree():
    from bluefog_tpu_torch.analysis.distrib_rules import (_distrib_path_findings,
                                                    distrib_campaign)
    from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

    _c, _s, res = distrib_campaign(16, 24, 3)
    assert res.violations == []
    assert campaign_findings(res, "t") == []
    assert _distrib_path_findings(res, "t") == []
    d = res.final["serve"]["distrib"]
    assert d["fanout"] == 4 and d["depth"] >= 1
    assert dt.tree_valid({int(k): v for k, v in d["parents"].items()},
                         d["fanout"]) is None


def test_sim_distrib_relay_kill_reparents_and_replays():
    from bluefog_tpu_torch.analysis.distrib_rules import distrib_campaign
    from bluefog_tpu_torch.sim.campaign import run_campaign

    sched = FaultSchedule([Fault(kind="serve_kill", step=2, rank=0,
                                 stop=16)])
    cfg, _s, res = distrib_campaign(16, 24, 3, schedule=sched)
    assert res.violations == []
    kinds = [e[1] for e in res.event_log]
    assert "distrib_reparent" in kinds
    assert res.final["serve"]["distrib"]["reparents"] >= 1
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest
    assert again.event_log == res.event_log


def test_sim_distrib_join_storm_lands_as_leaves():
    from bluefog_tpu_torch.analysis.distrib_rules import distrib_campaign

    _c, _s, res = distrib_campaign(16, 32, 3, distrib_join_round=8,
                                   distrib_join_n=4)
    assert res.violations == []
    joins = [e for e in res.event_log if e[1] == "distrib_join"]
    assert len(joins) == 4
    d = res.final["serve"]["distrib"]
    assert d["joins"] == 4
    parents = {int(k): v for k, v in d["parents"].items()}
    assert len(parents) == 12  # 8 seed replicas + 4 joiners
    assert dt.tree_valid(parents, d["fanout"]) is None
    assert all(r["version"] == res.final["serve"]["published"]
               for r in res.final["serve"]["replicas"].values())


def test_sim_seeded_distrib_bugs_are_caught():
    """The two standing distrib invariants fire on their seeded bugs
    and on nothing else: uncapped repair trips tree-validity, a dead
    relay never repaired trips the staleness SLO."""
    from bluefog_tpu_torch.analysis.distrib_rules import distrib_campaign

    sched = FaultSchedule([Fault(kind="serve_kill", step=2, rank=1)])
    _c, _s, res = distrib_campaign(
        16, 24, 3, schedule=sched, serve_replicas=13, distrib_fanout=3,
        distrib_slo=0, debug_bugs=("distrib_degree_overflow",))
    assert {v["name"] for v in res.violations} == {"distrib-tree"}

    sched = FaultSchedule([Fault(kind="serve_kill", step=2, rank=0)])
    _c, _s, res = distrib_campaign(
        16, 40, 3, schedule=sched, distrib_slo=4,
        debug_bugs=("distrib_stall",))
    assert {v["name"] for v in res.violations} == {"distrib-staleness"}


def test_sim_distrib_64rank_storm_campaign_replays():
    """The acceptance campaign: >= 64 ranks, interior relay kills AND
    a join storm mid-rollout — invariants silent after every event,
    bit-identical replay."""
    from bluefog_tpu_torch.analysis.distrib_rules import (_distrib_path_findings,
                                                    _storm_schedule,
                                                    distrib_campaign)
    from bluefog_tpu_torch.analysis.sim_rules import campaign_findings
    from bluefog_tpu_torch.sim.campaign import run_campaign

    sched = _storm_schedule(40, 11)
    cfg, _s, res = distrib_campaign(64, 40, 11, schedule=sched,
                                    distrib_join_round=12,
                                    distrib_join_n=4)
    assert res.violations == []
    assert campaign_findings(res, "storm") == []
    assert _distrib_path_findings(res, "storm", expect_reparents=1,
                                  expect_joins=4) == []
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest

