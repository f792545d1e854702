"""Port twin of ``tests/test_introspect.py``: the same cases against
``bluefog_tpu_torch``, the introspect rule family and its fixtures
included.

Live introspection plane (docs/OBSERVABILITY.md "Live introspection").

Unit level: the status page's seqlock round-trip and torn-read
rejection, the trace-control word's generation bump, the mutex holder
board's acquire/release/break lifecycle (including the raced
conditional clear), wait-time holder attribution, journal rotation
under ``BFTPU_JOURNAL_MAX_MB``, the merge CLI's truncated-snapshot
handling, and the ``introspect`` analysis family with its seeded-bug
fixtures.

E2E level (np=4, slow): ``bftpu-top --once --json`` attached from the
OUTSIDE of a live gossiping job under ``chaos.schedule_slow`` must show
the slowed rank's edges SUSPECT and name it as the lock holder — and
the adaptive demote cycle must still demote exactly the slowed rank
with the critical-path feed live (``BFTPU_TRACING`` on).
"""

import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.introspect import statuspage as sp
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import chaos

# ---------------------------------------------------------------------------
# status page: seqlock round-trip + torn-read rejection
# ---------------------------------------------------------------------------


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


def test_status_page_roundtrip(shm_dir):
    page = sp.StatusPage("tsp", 1)
    try:
        page.publish(nranks=4, step=12, epoch=1, op_id=34,
                     last_op="win_update:g",
                     ledger={"deposits": 8.0, "collected": 5.0,
                             "drained": 2.0, "pending": 1.0},
                     edges=[(0, 0, 0.2), (3, 1, 0.2), (2, 3, 0.0)])
        got = sp.read_status_page(sp.status_page_path("tsp", 1))
    finally:
        page.close(unlink=True)
    assert got["schema"] == sp.STATUS_SCHEMA
    assert got["seq"] % 2 == 0
    assert (got["rank"], got["nranks"]) == (1, 4)
    assert (got["step"], got["epoch"], got["op_id"]) == (12, 1, 34)
    assert got["last_op"] == "win_update:g"
    assert got["ledger"]["balance"] == pytest.approx(8.0 - 5.0 - 2.0)
    states = {e["peer"]: e["state"] for e in got["edges"]}
    assert states == {0: "alive", 3: "suspect", 2: "demoted"}


def test_status_page_rejects_torn_read(shm_dir):
    """A page whose seq stays odd (writer stuck mid-publish) must raise
    TornPageError rather than hand the reader a half-written struct."""
    page = sp.StatusPage("torn", 0)
    try:
        page.publish(nranks=2, step=1, epoch=0, op_id=1)
        path = sp.status_page_path("torn", 0)
        # freeze the page mid-write: force the seq word odd on disk
        with open(path, "r+b") as f:
            f.seek(8)
            f.write(struct.pack("<Q", 7))
        with pytest.raises(sp.TornPageError):
            sp.read_status_page(path, retries=3)
    finally:
        page.close(unlink=True)


def test_status_page_rejects_foreign_layout(shm_dir):
    page = sp.StatusPage("vers", 0)
    try:
        page.publish(nranks=1, step=1, epoch=0, op_id=1)
        path = sp.status_page_path("vers", 0)
        with open(path, "r+b") as f:
            f.write(struct.pack("<II", sp.STATUS_MAGIC, 99))
        with pytest.raises(ValueError, match="version"):
            sp.read_status_page(path)
    finally:
        page.close(unlink=True)


# every historical fixed-block layout, oldest first — a mid-upgrade
# fleet has live writers at any of these versions at once
_V_STRUCTS = {1: sp._FIXED_V1, 2: sp._FIXED_V2, 3: sp._FIXED_V3,
              4: sp._FIXED_V4, 5: sp._FIXED_V5, 6: sp._FIXED_V6,
              7: sp._FIXED_V7}


def _pack_legacy_page(version, seg, rank=0):
    fields = [rank, 2, os.getpid(), 0, 9, 1, 5,
              time.time(), time.monotonic(), b"op", 4.0, 2.0, 1.0, 1.0]
    if version >= 2:
        fields += [3, b"win"]          # qdepth, inflight
    if version >= 3:
        fields += [0.5, 7]             # conv_err, conv_round
    if version >= 4:
        fields += [0]                  # flags
    if version >= 5:
        fields += [11, 2]              # serve_version, serve_lag
    if version >= 6:
        fields += [1, 0]               # distrib_slot, distrib_parent
    if version >= 7:
        fields += [120.0, 1.5, 4.0, 0]  # qps, p50_ms, p99_ms, slo_state
    sp._HEAD.pack_into(seg._mm, 0, sp.STATUS_MAGIC, version, 2)
    _V_STRUCTS[version].pack_into(seg._mm, sp._HEAD.size, *fields)


@pytest.mark.parametrize("version", sorted(_V_STRUCTS))
def test_status_page_back_compat_every_version_decodes(shm_dir, version):
    """v1..v7 pages (live writers in a mid-upgrade fleet) decode with
    the fields their layout lacks defaulted — the v7 request-telemetry
    block reads as "no traffic observed" on pre-v7 pages and the v8
    alert lamp reads as "no monitor attached" on every legacy page."""
    path = sp.status_page_path("compat", version)
    seg = shm_native._FallbackSegment(path, sp.PAGE_BYTES)
    try:
        _pack_legacy_page(version, seg)
        got = sp.read_status_page(path)
        assert got["version"] == version
        assert (got["step"], got["epoch"], got["op_id"]) == (9, 1, 5)
        assert got["ledger"]["balance"] == pytest.approx(4.0 - 2.0 - 1.0)
        if version >= 7:
            assert got["serve"]["qps"] == pytest.approx(120.0)
            assert got["serve"]["p50_ms"] == pytest.approx(1.5)
            assert got["serve"]["p99_ms"] == pytest.approx(4.0)
            assert got["serve"]["slo_state"] == 0
        else:
            assert got["serve"]["qps"] == -1.0
            assert got["serve"]["p50_ms"] == -1.0
            assert got["serve"]["p99_ms"] == -1.0
            assert got["serve"]["slo_state"] == -1
        assert got["alert"] == {"state": -1, "last": ""}
        if version >= 5:
            assert (got["serve"]["version"], got["serve"]["lag"]) == (11, 2)
        else:
            assert (got["serve"]["version"], got["serve"]["lag"]) == (-1, -1)
        if version >= 6:
            assert got["distrib"] == {"slot": 1, "parent": 0}
        else:
            assert got["distrib"] == {"slot": -1, "parent": -1}
        if version >= 3:
            assert got["conv"] == {"err": 0.5, "round": 7}
    finally:
        seg.close(unlink=True)


def test_fleet_skips_foreign_version_pages(shm_dir):
    """A rank running a FUTURE build writes a page version this reader
    does not know: the fleet attach (bftpu-top) reports that rank as an
    error entry and keeps reading everyone else."""
    page = sp.StatusPage("mixv", 0)
    try:
        page.publish(nranks=2, step=1, epoch=0, op_id=1,
                     serve_version=3, qps=120.0, p50_ms=1.5, p99_ms=4.0,
                     slo_state=0)
        fpath = sp.status_page_path("mixv", 1)
        seg = shm_native._FallbackSegment(fpath, sp.PAGE_BYTES)
        sp._HEAD.pack_into(seg._mm, 0, sp.STATUS_MAGIC, 99, 2)
        fleet = sp.read_fleet("mixv")
        assert set(fleet) == {0, 1}
        assert fleet[0]["serve"]["qps"] == pytest.approx(120.0)
        assert fleet[0]["serve"]["slo_state"] == 0
        assert "error" in fleet[1] and "version" in fleet[1]["error"]
        snap = sp.collect("mixv")
        assert "error" in snap["ranks"]["1"]
        assert snap["serve"]["0"]["p99_ms"] == pytest.approx(4.0)
        seg.close(unlink=True)
    finally:
        page.close(unlink=True)


def test_trace_control_word_generation(shm_dir):
    assert sp.read_trace_control("tc") == (0, sp.TRACE_DEFAULT)
    g1 = sp.publish_trace_control("tc", sp.TRACE_ON)
    g2 = sp.publish_trace_control("tc", sp.TRACE_OFF)
    assert g2 > g1
    assert sp.read_trace_control("tc") == (g2, sp.TRACE_OFF)


# ---------------------------------------------------------------------------
# holder board: acquire sets, release clears, break clears, races no-op
# ---------------------------------------------------------------------------


def test_holder_board_lifecycle(shm_dir):
    board = shm_native.HolderBoard("hb", 4)
    try:
        assert board.snapshot() == {}
        board.set_holder(0, 2)                 # rank 2 acquires mutex 0
        assert board.holder(0) == 2
        assert board.snapshot() == {0: 2}
        board.clear(0, 2)                      # release by the holder
        assert board.holder(0) is None
        board.set_holder(1, 3)
        board.clear(1, 0)                      # raced clear by non-holder
        assert board.holder(1) == 3, \
            "a conditional clear by a non-holder must be a no-op"
        board.clear(1)                         # mutex_break: unconditional
        assert board.holder(1) is None
    finally:
        board.close(unlink=True)


def test_timed_acquire_attributes_wait_to_holder(shm_dir):
    """The wait path samples the holder word BEFORE blocking and takes
    the word over after success — the mutex-wait event names the rank
    that actually held the lock, not the window owner."""
    board = shm_native.HolderBoard("tw", 4)
    try:
        board.set_holder(0, 3)  # rank 3 asleep inside the critical section

        def acquire(rank, timeout=None):
            time.sleep(0.002)

        observed = shm_native._timed_mutex_acquire(
            acquire, 0, None, holders=board, me=1)
        assert observed == 3
        assert board.holder(0) == 1, "acquire must publish the new holder"
        # uncontended self-reacquire observes nobody
        board.clear(0, 1)
        observed = shm_native._timed_mutex_acquire(
            acquire, 0, None, holders=board, me=1)
        assert observed is None
    finally:
        board.close(unlink=True)


def test_fallback_job_holder_wiring(shm_dir, monkeypatch):
    """FallbackShmJob plumbs the board through acquire/release/break."""
    monkeypatch.setenv("BFTPU_STATUSPAGE", "1")
    j0 = shm_native.FallbackShmJob("fj", 0, 2)
    j1 = shm_native.FallbackShmJob("fj", 1, 2)
    try:
        j0.mutex_acquire(1)
        assert j0.last_wait_holder is None      # uncontended
        assert j1.mutex_holder(1) == 0          # visible from the peer
        j0.mutex_release(1)
        assert j0.mutex_holder(1) is None
        j1.mutex_acquire(1)
        j0.mutex_break(1)                       # heal path: holder died
        assert j0.mutex_holder(1) is None
    finally:
        j0.close(unlink=True)
        j1.close(unlink=False)


# ---------------------------------------------------------------------------
# journal rotation + merge-CLI truncated-snapshot handling
# ---------------------------------------------------------------------------


def test_journal_rotation_under_cap(tmp_path, monkeypatch):
    from bluefog_tpu_torch.telemetry.registry import (
        Registry, journal_max_bytes, journal_paths, read_journal)

    monkeypatch.setenv("BFTPU_JOURNAL_MAX_MB", "0.0006")  # ~600 bytes
    cap = journal_max_bytes()
    assert 0 < cap < 1000
    reg = Registry(out_dir=str(tmp_path), rank=0, job="rot")
    try:
        for i in range(30):
            reg.journal("tick", i=i)
    finally:
        reg.close()
    path = reg.journal_path
    parts = journal_paths(path)
    assert parts == [path + ".1", path]         # rotated generation first
    assert os.path.getsize(path) <= cap
    seq = []
    for p in parts:
        events, bad = read_journal(p)
        assert bad == 0
        seq.extend(e["i"] for e in events)
    assert seq == sorted(seq), "rotation must preserve event order"
    assert seq[-1] == 29, "the newest event lands in the live file"


def test_journal_unlimited_without_cap(tmp_path, monkeypatch):
    from bluefog_tpu_torch.telemetry.registry import Registry, journal_paths

    monkeypatch.delenv("BFTPU_JOURNAL_MAX_MB", raising=False)
    reg = Registry(out_dir=str(tmp_path), rank=0, job="unrot")
    try:
        for i in range(30):
            reg.journal("tick", i=i)
    finally:
        reg.close()
    assert journal_paths(reg.journal_path) == [reg.journal_path]


def test_merge_cli_flags_truncated_snapshot(tmp_path):
    """One good snapshot + one SIGKILL-torn file: the merge must emit
    the survivors' summary, warn, and fail ``--check``."""
    from bluefog_tpu_torch.telemetry.registry import Registry

    reg = Registry(out_dir=None, rank=0, job="mrg")
    reg.counter("tcp.round_trips").add(3)
    good = tmp_path / "telemetry-mrg-r0.json"
    good.write_text(json.dumps(reg.snapshot()))
    (tmp_path / "telemetry-mrg-r1.json").write_text('{"schema": "bftpu-')
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.telemetry",
         str(tmp_path), "--check"],
        capture_output=True, text=True, timeout=60)
    assert p.returncode == 1, p.stderr
    assert "telemetry.merge-skipped" in p.stderr
    merged = json.loads(p.stdout)
    assert merged["ranks"] == 1 or merged.get("ranks") == [0]


# ---------------------------------------------------------------------------
# analysis family + fixtures
# ---------------------------------------------------------------------------




def test_introspect_rule_family_and_fixtures():
    from bluefog_tpu_torch import analysis
    from bluefog_tpu_torch.analysis import fixtures as afx

    report = analysis.run(families=["introspect"])
    assert report.ok, [str(f) for f in report.findings[:10]]
    assert report.subjects_checked >= 8
    for name in ("introspect-torn-page", "introspect-ghost-holder",
                 "introspect-blame-regression"):
        findings = afx.run_fixture(name)
        assert findings, f"seeded bug {name} was not caught"


# ---------------------------------------------------------------------------
# np=4 e2e: bftpu-top attached to a live job under chaos
# ---------------------------------------------------------------------------


def _worker_introspect(rank, size):
    """exp2@4 gossip; rank 3 sleeps INSIDE its own window critical
    section at every scheduled step (the convoy shape), so an attached
    reader can observe both the SUSPECT edges and the holder word."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(2, float(rank), np.float64), "it")
    islands.barrier()
    t_end = time.monotonic() + 18.0
    while time.monotonic() < t_end:
        if rank == 3:
            with islands.win_mutex("it", for_self=True, ranks=[3]):
                chaos.checkpoint(rank, "islow")   # sleeps holding the lock
        else:
            chaos.checkpoint(rank, "islow")
        islands.win_put(islands.win_sync("it"), "it")
        islands.win_update("it")
        # NB: no adaptive_step() — this test observes the plane; the
        # demote cycle is test_adaptive_demote_with_live_feed_np4's job
        time.sleep(0.003)
    return (rank, islands.membership_epoch(),
            tuple(sorted(islands.demoted_ranks())),
            sorted(islands.dead_ranks()))


def _attach_top(job, out, stop_evt):
    while not stop_evt.is_set():
        try:
            p = subprocess.run(
                [sys.executable, "-m", "bluefog_tpu_torch.introspect",
                 "--job", job, "--once", "--json"],
                capture_output=True, text=True, timeout=30)
        except subprocess.TimeoutExpired:
            continue
        if p.returncode == 0 and p.stdout.strip():
            try:
                out.append(json.loads(p.stdout))
            except ValueError:
                pass
        time.sleep(0.25)


@pytest.mark.slow
def test_bftpu_top_sees_suspect_and_holder_np4(monkeypatch):
    """Attach ``bftpu-top --once --json`` from outside the job while
    rank 3 is slowed inside its critical section: some snapshot must
    show a healthy rank's edge to 3 as SUSPECT and name rank 3 as a
    lock holder — all without perturbing the run (no deaths, no epoch
    switches: the workers never run the demote control loop)."""
    job = f"intro{os.getpid()}"
    monkeypatch.setenv("BFTPU_ADAPTIVE", "1")
    monkeypatch.setenv("BFTPU_STATUSPAGE", "1")
    monkeypatch.setenv("BFTPU_EDGE_DEADLINE_S", "0.2")
    monkeypatch.setenv("BFTPU_SUSPECT_MISSES", "3")
    chaos.schedule_slow(os.environ, rank=3, step=5, delay_s=0.6)
    snaps, stop_evt = [], threading.Event()
    poller = threading.Thread(
        target=_attach_top, args=(job, snaps, stop_evt), daemon=True)
    poller.start()
    try:
        res = islands.spawn(_worker_introspect, 4, job=job, timeout=240.0)
    finally:
        stop_evt.set()
        poller.join(timeout=30)
        chaos.clear_schedule()
        shm_native.unlink_all(job, ["it"])
    # the observed plane: schema-valid, suspects attributed, holder named
    assert snaps, "bftpu-top never returned a snapshot from the live job"
    assert all(s["schema"] == "bftpu-top/1" for s in snaps)
    saw_suspect = any(
        e["peer"] == 3 and e["state"] == "suspect"
        for s in snaps for r, page in s["ranks"].items()
        if r != "3" and "edges" in page for e in page["edges"])
    assert saw_suspect, "no healthy rank's page ever showed edge 3 SUSPECT"
    saw_holder = any(
        holder == 3 for s in snaps for holder in s["holders"].values())
    assert saw_holder, "rank 3 was never named as a lock holder"
    # the run itself was not perturbed
    for rank, epoch, demoted, dead in res:
        assert dead == [], (rank, dead)
        assert demoted == (), (rank, demoted)
        assert epoch == 0, (rank, epoch)


def _worker_feed_cycle(rank, size):
    """The adaptive demote/promote cycle worker with the trace feed
    live; returns the epoch switch records."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank * 10), np.float64), "fd")
    islands.barrier()
    t_end = time.monotonic() + 60.0
    events = []
    while time.monotonic() < t_end:
        chaos.checkpoint(rank, "fstraggle")
        islands.win_put(islands.win_sync("fd"), "fd")
        islands.win_update("fd")
        rec = islands.adaptive_step()
        if rec is not None:
            events.append((int(rec["epoch"]),
                           tuple(int(g) for g in rec.get("demoted", ())),
                           tuple(int(g) for g in rec.get("promoted", ()))))
        if len(events) >= 2 and not islands.demoted_ranks():
            break
        time.sleep(0.003)
    return (rank, sorted(islands.dead_ranks()), events)


@pytest.mark.slow
def test_adaptive_demote_with_live_feed_np4(monkeypatch, tmp_path):
    """With ``BFTPU_TRACING`` on, demotion additionally requires
    critical-path corroboration (AdaptivePolicy.corroborated) — and the
    np=4 gray-failure cycle must still demote exactly the slowed rank."""
    job = f"feed{os.getpid()}"
    monkeypatch.setenv("BFTPU_ADAPTIVE", "1")
    monkeypatch.setenv("BFTPU_TRACING", str(tmp_path / "tr"))
    monkeypatch.setenv("BFTPU_EDGE_DEADLINE_S", "0.2")
    monkeypatch.setenv("BFTPU_SUSPECT_MISSES", "3")
    monkeypatch.setenv("BFTPU_PROMOTE_CLEAN", "5")
    monkeypatch.setenv("BFTPU_DEMOTE_FLOOR_S", "0.5")
    chaos.schedule_slow(os.environ, rank=3, step=10, delay_s=0.6, stop=25)
    try:
        res = islands.spawn(_worker_feed_cycle, 4, job=job, timeout=240.0)
    finally:
        chaos.clear_schedule()
        shm_native.unlink_all(job, ["fd"])
    for rank, dead, events in res:
        assert dead == [], (rank, dead)
        assert events, f"rank {rank} saw no epoch switch: the live " \
                       f"critical-path gate starved demotion"
        assert events[0][1] == (3,), \
            f"rank {rank}: demote was not exactly the slowed rank: {events}"


# ---------------------------------------------------------------------------
# one fleet, pages from both packages: the port's bftpu-top reads what the
# reference's reads
# ---------------------------------------------------------------------------


def test_top_snapshot_and_render_match_the_reference_on_a_mixed_fleet(
        tmp_path, monkeypatch):
    from bluefog_tpu.introspect import __main__ as ref_top
    from bluefog_tpu.introspect import statuspage as ref_sp
    from bluefog_tpu.native import shm_native as ref_shm
    from bluefog_tpu_torch.introspect import __main__ as top

    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    monkeypatch.setattr(ref_shm, "_FALLBACK_DIR", str(tmp_path))
    job = "tmixtop"
    pages = [ref_sp.StatusPage(job, 0), sp.StatusPage(job, 1),
             sp.StatusPage(job, 1000)]
    try:
        for r, page in enumerate(pages[:2]):
            page.publish(nranks=2, step=10 + r, epoch=1, op_id=20 + r,
                         last_op="win_update:w",
                         ledger={"deposits": 4.0, "collected": 3.0,
                                 "drained": 0.0, "pending": 1.0},
                         edges=[(1 - r, 0, 0.5)], serve_version=3 - r)
        pages[2].publish(nranks=0, step=7, epoch=1, op_id=2, last_op="swap",
                         serve_version=3, serve_lag=0, qps=12.5,
                         p50_ms=0.4, p99_ms=1.5)
        ours, theirs = top.snapshot(job), ref_top.snapshot(job)
        theirs["wall_ts"] = ours["wall_ts"]  # each collect stamps its clock
        assert json.dumps(ours, sort_keys=True, default=str) == \
            json.dumps(theirs, sort_keys=True, default=str)
        assert top.render(ours, {}) == ref_top.render(ours, {})
    finally:
        for page in pages:
            page.close(unlink=True)
