"""Port twin of ``tests/test_partition.py``: the same cases against
``bluefog_tpu_torch``, the simulator cases included.

Partition-tolerant membership: quorum fence, ORPHAN quiesce, and
TCP session resume (docs/RESILIENCE.md "Orphan quiesce").

Four layers of evidence:

- units: the strict-majority arithmetic (even splits have NO quorum on
  either side), the retriable :class:`OrphanedError` contract, the v4
  status-page ORPHAN flag round-trip, the TCP retry/backoff knobs, the
  ``retiring`` field on join requests, and the partition fault's
  JSON/chaos-env round-trips;
- sim campaigns: a pinned-seed partition ORPHANs exactly the minority,
  keeps one epoch lineage, merges every orphan back, and replays
  bit-identically at acceptance scale (N=64); the seeded ``split_brain``
  bug is caught by the single-lineage standing invariant and ddmin
  shrinks the schedule to the partition fault alone;
- np=4 e2e: a real 3/1 split — the minority's heal is quorum-denied,
  the rank quiesces (win ops raise OrphanedError), merges back through
  the join machinery under a fresh global rank, and the grown fleet
  re-converges with a globally balanced mass ledger;
- np=2 chaos: a mid-chunk-stream disconnect (``BFTPU_CHAOS_DROP_CHUNK``)
  is resumed by the bounded-backoff session-resume path — the replayed
  deposit commits EXACTLY once and the committed neighbor deposit is
  untouched.
"""

import json
import multiprocessing as mp
import os
import socket
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.introspect import statuspage as sp
from bluefog_tpu_torch.native import shm_native, tcp_transport
from bluefog_tpu_torch.resilience import chaos
from bluefog_tpu_torch.resilience import quorum
from bluefog_tpu_torch.resilience.join import MembershipBoard
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

# ---------------------------------------------------------------------------
# quorum arithmetic + the OrphanedError contract
# ---------------------------------------------------------------------------


def test_majority_floor_pins():
    pins = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4, 7: 4, 8: 5, 9: 5,
            64: 33, 128: 65}
    for total, floor in pins.items():
        assert quorum.majority_floor(total) == floor, total


def test_quorum_met_is_a_strict_threshold():
    for total in range(1, 10):
        floor = quorum.majority_floor(total)
        assert quorum.quorum_met(floor, total)
        assert not quorum.quorum_met(floor - 1, total)


def test_even_split_has_no_quorum_on_either_side():
    # the defining property: an even fleet cut in half must leave BOTH
    # sides orphaned — if either half could heal, so could the other,
    # and that is split-brain
    for even in (2, 4, 8, 64, 128):
        assert not quorum.quorum_met(even // 2, even)


def test_quorum_mode_env(monkeypatch):
    monkeypatch.delenv("BFTPU_QUORUM", raising=False)
    assert quorum.quorum_mode() == "majority"
    assert quorum.quorum_enabled()
    monkeypatch.setenv("BFTPU_QUORUM", "off")
    assert quorum.quorum_mode() == "off"
    assert not quorum.quorum_enabled()
    monkeypatch.setenv("BFTPU_QUORUM", "bogus")
    assert quorum.quorum_mode() == "majority"  # unknown value -> default


def test_orphaned_error_is_retriable_and_carries_arithmetic():
    e = quorum.OrphanedError("cut", live=1, total=4, epoch=2)
    assert isinstance(e, RuntimeError)
    assert (e.live, e.total, e.epoch) == (1, 4, 2)
    assert quorum.OrphanedError("bare").live == -1
    # the public alias the training loop catches
    assert islands.OrphanedError is quorum.OrphanedError


# ---------------------------------------------------------------------------
# status page v4: the ORPHAN flag round-trips
# ---------------------------------------------------------------------------


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


def test_status_page_orphan_flag_roundtrip(shm_dir):
    page = sp.StatusPage("orf", 2)
    try:
        page.publish(nranks=4, step=9, epoch=1, op_id=3,
                     flags=sp.FLAG_ORPHAN)
        got = sp.read_status_page(sp.status_page_path("orf", 2))
        assert got["flags"] == sp.FLAG_ORPHAN
        assert got["orphan"] is True
        # flags default to 0: a healthy publish clears the verdict
        page.publish(nranks=4, step=10, epoch=1, op_id=4)
        got = sp.read_status_page(sp.status_page_path("orf", 2))
        assert got["flags"] == 0 and got["orphan"] is False
    finally:
        page.close(unlink=True)


# ---------------------------------------------------------------------------
# TCP session-resume knobs
# ---------------------------------------------------------------------------


def test_tcp_retry_knobs(monkeypatch):
    monkeypatch.delenv("BFTPU_TCP_RETRIES", raising=False)
    monkeypatch.delenv("BFTPU_TCP_BACKOFF_S", raising=False)
    assert tcp_transport.tcp_retries() == 3
    assert tcp_transport.tcp_backoff_s() == pytest.approx(0.05)
    monkeypatch.setenv("BFTPU_TCP_RETRIES", "7")
    monkeypatch.setenv("BFTPU_TCP_BACKOFF_S", "0.5")
    assert tcp_transport.tcp_retries() == 7
    assert tcp_transport.tcp_backoff_s() == pytest.approx(0.5)
    # 0 restores the old one-shot behavior; negatives clamp to it
    monkeypatch.setenv("BFTPU_TCP_RETRIES", "-4")
    assert tcp_transport.tcp_retries() == 0
    monkeypatch.setenv("BFTPU_TCP_BACKOFF_S", "-1")
    assert tcp_transport.tcp_backoff_s() == 0.0
    monkeypatch.setenv("BFTPU_TCP_RETRIES", "nope")
    monkeypatch.setenv("BFTPU_TCP_BACKOFF_S", "nope")
    assert tcp_transport.tcp_retries() == 3
    assert tcp_transport.tcp_backoff_s() == pytest.approx(0.05)


def test_chunk_drop_chaos_knob(monkeypatch):
    monkeypatch.delenv("BFTPU_CHAOS_DROP_CHUNK", raising=False)
    assert tcp_transport._chunk_drop_after() == -1
    monkeypatch.setenv("BFTPU_CHAOS_DROP_CHUNK", "2")
    assert tcp_transport._chunk_drop_after() == 2
    monkeypatch.setenv("BFTPU_CHAOS_DROP_CHUNK", "junk")
    assert tcp_transport._chunk_drop_after() == -1


# ---------------------------------------------------------------------------
# the membership board carries the retiring identity
# ---------------------------------------------------------------------------


def test_board_post_request_carries_retiring_identity(shm_dir):
    board = MembershipBoard("retjob")
    board.ensure(4)
    board.post_request(retiring=3)
    board.post_request()
    pend = board.pending_requests()
    assert len(pend) == 2
    retiring = sorted(int(r.get("retiring", -1)) for r in pend)
    assert retiring == [-1, 3]
    # a plain joiner (no orphan history) posts no retiring field at all
    assert any("retiring" not in r for r in pend)


# ---------------------------------------------------------------------------
# partition faults: JSON + chaos-env round-trips, scrub
# ---------------------------------------------------------------------------


def test_fault_partition_roundtrip():
    f = Fault.partition([[6, 11], [0, 3]], 5, 14)
    assert (f.kind, f.step, f.stop) == ("partition", 5, 14)
    assert f.groups() == ((6, 11), (0, 3))
    sched = FaultSchedule([f], seed=3)
    back = FaultSchedule.from_json(sched.to_json())
    assert back == sched and back.faults[0].groups() == f.groups()


def test_fault_partition_env_roundtrip():
    f = Fault.partition([[6, 11]], 5, 14)
    env = FaultSchedule([f]).to_env({})
    assert env["BFTPU_CHAOS_PARTITION_GROUP"] == "6,11"
    assert env["BFTPU_CHAOS_PARTITION_STEP"] == "5"
    assert env["BFTPU_CHAOS_PARTITION_STOP"] == "14"
    back = FaultSchedule.from_env(env)
    assert len(back) == 1 and back.faults[0] == f


def test_clear_schedule_scrubs_partition_keys():
    try:
        chaos.schedule_partition(os.environ, "1,2", 3, stop=9)
        assert os.environ["BFTPU_CHAOS_PARTITION_GROUP"] == "1,2"
        chaos.clear_schedule()
        for key in ("BFTPU_CHAOS_PARTITION_GROUP",
                    "BFTPU_CHAOS_PARTITION_STEP",
                    "BFTPU_CHAOS_PARTITION_STOP"):
            assert key not in os.environ
    finally:
        chaos.clear_schedule()


# ---------------------------------------------------------------------------
# sim partition campaigns (no subprocesses; virtual clock)
# ---------------------------------------------------------------------------










# ---------------------------------------------------------------------------
# np=4 e2e: quorum-denied heal -> ORPHAN quiesce -> merge-on-heal
# ---------------------------------------------------------------------------


def _partition_worker(rank, size, job, victim, cut_ev, merge_ev, q):
    """3/1 split: the victim rank declares everyone else dead (the
    minority view of a cut), is quorum-denied into ORPHAN, and merges
    back; the majority admits the merge request and gossips on."""
    from bluefog_tpu_torch.telemetry import registry as telem

    islands.init(rank, size, job)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank * 10), np.float64), "pq")
    islands.barrier()
    q.put(("up", rank, None))
    deadline = time.monotonic() + 120.0
    while not cut_ev.is_set() and time.monotonic() < deadline:
        islands.win_put(islands.win_sync("pq"), "pq")
        islands.win_update("pq")
        time.sleep(0.002)
    if rank == victim:
        pre_epoch = islands.membership_epoch()
        healed = islands.heal(dead=set(range(size)) - {victim})
        assert healed is None, "minority heal must be quorum-denied"
        assert islands.is_orphaned()
        err = None
        try:
            islands.win_put(islands.win_sync("pq"), "pq")
        except islands.OrphanedError as e:
            err = (e.live, e.total, e.epoch)
        assert err is not None, "orphaned win op did not raise"
        # the quiesce is inert: no sponsoring, no epoch movement
        assert islands.admit_pending(timeout=0.2) is None
        assert islands.membership_epoch() == pre_epoch
        reg = telem.get_registry()
        denied = reg.counter("resilience.quorum_denied",
                             op="heal").value if reg.enabled else -1
        # wait until every majority rank's LAST deposit has landed:
        # the merge probes the quiesced slots as pending, and an
        # in-flight deposit arriving after the probe would go
        # unsettled (the ledger identity holds at quiescent points)
        assert merge_ev.wait(timeout=60)
        islands.merge_orphan(timeout=60)
    else:
        q.put(("quiet", rank, None))   # my last deposit has landed
        grown = None
        while grown is None and time.monotonic() < deadline:
            grown = islands.admit_pending(timeout=30)
        assert grown is not None, "merge request never admitted"
        err, denied = None, 0
    # the switch-point ledger: nothing has gossiped since the epoch
    # switch, so every pre-switch deposit is settled (the switch probes
    # residual slot mass as pending) and the identity holds globally
    ledger = islands._ledger_totals(telem.get_registry())
    # the whole (re-merged) fleet gossips to consensus
    for _ in range(150):
        islands.win_put(islands.win_sync("pq"), "pq")
        islands.win_update("pq")
        time.sleep(0.002)
    # settle stragglers: anyone the detector flagged late
    t_end = time.monotonic() + 2.0
    while time.monotonic() < t_end:
        late = islands.dead_ranks() - islands._ctx().dead
        if late:
            islands.heal()
        islands.win_put(islands.win_sync("pq"), "pq")
        islands.win_update("pq")
        time.sleep(0.002)
    est = float(np.mean(islands.win_sync("pq")))
    q.put(("done", rank,
           (islands.global_rank(), islands.membership_epoch(),
            islands.members(), est, ledger, err, denied)))
    islands.barrier()
    islands.shutdown(unlink=False)


@pytest.mark.slow
def test_partition_orphan_merge_e2e(monkeypatch):
    """np=4 over exp2, 3/1 split: the minority rank's heal is DENIED
    (quorum fence), it quiesces as ORPHAN (win ops raise the retriable
    OrphanedError, no epoch movement), then merges back through the
    join machinery under a FRESH global rank (the old identity is
    excised at grant time, so the merge beats the detector floor).
    Every member lands on epoch 1 with members (0,1,2,size) and the
    re-merged fleet reaches consensus with a globally balanced mass
    ledger."""
    size, victim = 4, 3
    job = f"partmerge{os.getpid()}"
    monkeypatch.setenv("BFTPU_FAILURE_TIMEOUT_S", "0.5")
    monkeypatch.setenv("BFTPU_TELEMETRY", "1")
    monkeypatch.setenv("BFTPU_QUORUM", "majority")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    cut_ev = ctx.Event()
    merge_ev = ctx.Event()
    procs = [ctx.Process(target=_partition_worker,
                         args=(r, size, job, victim, cut_ev, merge_ev, q))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for _ in range(size):
            assert q.get(timeout=120)[0] == "up"
        time.sleep(0.3)  # a few rounds of healthy 4-rank gossip
        cut_ev.set()
        done, quiet = {}, 0
        while len(done) < size:
            kind, rank, payload = q.get(timeout=180)
            if kind == "quiet":
                quiet += 1
                if quiet == size - 1:
                    merge_ev.set()
                continue
            assert kind == "done", (kind, rank)
            done[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job, ["pq"])
    assert sorted(done) == list(range(size))
    ests = []
    totals = {"deposits": 0.0, "collected": 0.0, "drained": 0.0,
              "pending": 0.0}
    for rank, (grank, epoch, members, est, ledger, err,
               denied) in sorted(done.items()):
        # ONE epoch switch for everyone: the heal-excision of the
        # retiring identity and the merge admit commit together
        assert epoch == 1, (rank, epoch)
        assert members == (0, 1, 2, size), (rank, members)
        if rank == victim:
            assert grank == size, grank   # fresh rank, never the corpse's
            live, total, ep = err
            # the guard names the quiesced epoch's membership; live is
            # deliberately -1 (the guard does not recount the fleet)
            assert (live, total, ep) == (-1, size, 0), err
            assert denied >= 1, "quorum_denied counter never moved"
        else:
            assert grank == rank, (rank, grank)
            assert err is None
        ests.append(est)
        for k in totals:
            totals[k] += ledger.get(k, 0.0)
    # consensus across the re-merged fleet
    assert max(ests) - min(ests) < 0.5, ests
    # mass conservation across partition -> orphan -> merge, summed
    # over ALL members: deposits == collected + drained + pending
    balance = totals["deposits"] - (totals["collected"]
                                    + totals["drained"]
                                    + totals["pending"])
    assert abs(balance) < 1e-6 * max(1.0, totals["deposits"]), \
        (totals, {r: done[r][4] for r in sorted(done)})


# ---------------------------------------------------------------------------
# np=2 chaos: mid-chunk-stream disconnect -> session resume, exactly once
# ---------------------------------------------------------------------------

_N = 5000  # 20000 B f32 -> 5 chunks of 4096 B


def _resume_writer(job_name, coord, q):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    os.environ["BFTPU_TCP_BACKOFF_S"] = "0.02"
    # stop-and-wait so the server's chaos drop surfaces while an ack
    # is being collected, BEFORE the commit frame hits the wire — a
    # pipelined sender would have the commit in flight already, which
    # is the (correctly) non-replayable ambiguous case
    os.environ["BFTPU_TCP_WINDOW_CHUNKS"] = "1"
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow
    from bluefog_tpu_torch.telemetry import registry as telem

    job = TcpShmJob(job_name, 1, 2, coord)
    win = TcpShmWindow(job_name, "w", 1, 2, 2, (_N,), np.float32, coord)
    job.barrier()
    x = np.arange(_N, dtype=np.float32)
    win.write(0, 0, x, p=0.5)       # committed BEFORE the chaos window
    job.barrier()
    job.barrier()   # the reader armed BFTPU_CHAOS_DROP_CHUNK past here
    # the reader's server drops the connection after 2 of 5 chunk
    # frames of THIS deposit; the bounded-backoff resume must replay
    # the stream from chunk 0 and commit exactly once
    win.write(0, 1, x + 1.0, p=0.25)
    job.barrier()
    reg = telem.get_registry()
    reconnects = reg.counter("tcp.reconnects",
                             op="write_chunked").value if reg.enabled \
        else -1
    q.put(("w", reconnects))
    job.barrier()
    win.close()
    job.close()


def _resume_reader(job_name, coord, q):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    # arm the one-shot server-side disconnect only AFTER the first
    # deposit committed (the writer holds it behind a barrier)
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow
    from bluefog_tpu_torch.telemetry import registry as telem

    job = TcpShmJob(job_name, 0, 2, coord)
    win = TcpShmWindow(job_name, "w", 0, 2, 2, (_N,), np.float32, coord)
    job.barrier()
    job.barrier()   # slot-0 deposit committed past here
    os.environ["BFTPU_CHAOS_DROP_CHUNK"] = "2"
    job.barrier()   # schedule armed: release the writer
    job.barrier()   # slot-1 deposit (dropped + resumed) committed
    os.environ.pop("BFTPU_CHAOS_DROP_CHUNK", None)
    x = np.arange(_N, dtype=np.float32)
    a0, p0, _ = win.read(0, collect=True)
    a1, p1, _ = win.read(1, collect=True)
    reg = telem.get_registry()
    drains = reg.counter("tcp.mid_stream_drains").value \
        if reg.enabled else -1
    q.put(("r", float(p0), bool(np.array_equal(a0, x)),
           float(p1), bool(np.array_equal(a1, x + 1.0)), drains))
    job.barrier()
    win.close()
    job.close()


@pytest.mark.slow
def test_tcp_session_resume_mid_chunk_stream(monkeypatch, tmp_path):
    """np=2 TCP: the receiving server tears the connection after 2 of
    5 chunk frames (BFTPU_CHAOS_DROP_CHUNK).  The mid-stream drain
    restores the torn slot, the writer reconnects under the bounded
    exponential backoff and replays the UNCOMMITTED stream from chunk
    0 — the deposit commits exactly once (p=0.25, values intact, not
    doubled) and the previously committed deposit is untouched."""
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "45")
    monkeypatch.delenv("BFTPU_CHAOS_DROP_CHUNK", raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    job_name = f"tcpresume{os.getpid()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pw = ctx.Process(target=_resume_writer, args=(job_name, coord, q))
    pr = ctx.Process(target=_resume_reader, args=(job_name, coord, q))
    pr.start()
    pw.start()
    got = {}
    try:
        for _ in range(2):
            msg = q.get(timeout=120)
            got[msg[0]] = msg[1:]
    finally:
        pw.join(30)
        pr.join(30)
        for p in (pw, pr):
            if p.is_alive():
                p.terminate()
    assert pw.exitcode == 0 and pr.exitcode == 0, \
        (pw.exitcode, pr.exitcode)
    (reconnects,) = got["w"]
    p0, intact0, p1, intact1, drains = got["r"]
    # the resume really ran: a reconnect on the writer, a mid-stream
    # drain on the server whose connection was chaos-dropped
    assert reconnects >= 1, reconnects
    assert drains >= 1, drains
    # exactly-once: committed mass is the single deposit's p, values
    # are the deposit (a double-commit would accumulate/double)
    assert (p0, intact0) == (0.5, True), (p0, intact0)
    assert (p1, intact1) == (0.25, True), (p1, intact1)


# ---------------------------------------------------------------------------
# the reference's simulator cases (sim campaigns, no subprocesses unless
# marked; virtual clock)
# ---------------------------------------------------------------------------


def test_sim_partition_orphans_minority_and_merges():
    from bluefog_tpu_torch.analysis.partition_rules import (_path_findings,
                                                      partition_campaign)
    from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

    _cfg, _sched, res = partition_campaign(8, 30, 5, (6, 7))
    assert res.violations == []
    kinds = [e[1] for e in res.event_log]
    assert kinds.count("orphan") == 2
    assert kinds.count("merge_enter") == 2
    assert (res.final.get("ledger") or {}).get("balanced")
    assert campaign_findings(res, "t") == []
    assert _path_findings(res, "t", 2) == []


def test_sim_partition_campaign_bit_identical_n64():
    """The acceptance-scale determinism pin: the same seed replays the
    same 64-rank partition campaign event for event."""
    from bluefog_tpu_torch.analysis.partition_rules import partition_campaign
    from bluefog_tpu_torch.sim.campaign import run_campaign

    cfg, sched, res = partition_campaign(64, 40, 7, (9, 23, 55),
                                         quiesce_rounds=60)
    assert res.violations == []
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest
    assert again.event_log == res.event_log


def test_sim_split_brain_caught_and_shrinks_to_partition_alone():
    """``--debug-bug split_brain`` skips the fence: both sides heal,
    the single-lineage standing invariant fires, and ddmin shrinks a
    noisy schedule back to the partition fault alone."""
    from bluefog_tpu_torch.analysis.partition_rules import partition_campaign
    from bluefog_tpu_torch.sim.campaign import run_campaign, shrink_schedule

    cfg, sched, res = partition_campaign(16, 30, 3, (6, 11),
                                         debug_bugs=("split_brain",))
    names = {v["name"] for v in res.violations}
    assert "single-lineage" in names, names
    # same-seed replay reproduces the violation bit-identically
    again = run_campaign(cfg, sched)
    assert again.digest == res.digest
    # ddmin: kill + slow noise shrinks away, the partition cut remains
    noisy = FaultSchedule(
        list(sched.faults)
        + [Fault(kind="kill", step=3, rank=1),
           Fault(kind="slow", step=4, rank=2, duration_s=0.9, stop=12)],
        seed=cfg.seed)
    minimal, viol, _runs = shrink_schedule(cfg, noisy,
                                           target="single-lineage")
    assert viol is not None and viol["name"] == "single-lineage"
    assert [f.kind for f in minimal] == ["partition"]


def test_sim_quorum_off_restores_split_brain():
    """``BFTPU_SIM_QUORUM=off`` (cfg.quorum="off") is the pre-quorum
    behavior: both partition sides heal, and the single-lineage
    invariant duly reports the fork — off really means unfenced."""
    from bluefog_tpu_torch.analysis.partition_rules import partition_campaign

    _cfg, _sched, res = partition_campaign(8, 30, 5, (6, 7),
                                           quorum="off")
    names = {v["name"] for v in res.violations}
    assert "single-lineage" in names, names

