"""Port twin of ``tests/test_conformance.py``: the transport contract of
``bluefog_tpu_torch`` (the executable spec table, the capability lint over
the port's sources, the differential arms against ``ReferenceTransport``,
the seeded mutants, ddmin, and both np=2 chaos-kill e2e cases on the port's
fallback shm and chunked TCP windows), then the cross-package cases: the
pinned schedules and the spec table are the reference's, the native arm is
never dropped, ``--changed-only`` maps the port's own paths, and the env and
capability lints fire on a violation planted in a copy of the port's tree.
"""

import multiprocessing as mp
import os
import signal
import socket
import time

import numpy as np
import pytest

from bluefog_tpu_torch import analysis
from bluefog_tpu_torch.analysis import conformance, fixtures, interleave
from bluefog_tpu_torch.analysis import transport_spec as spec
from bluefog_tpu_torch.analysis.engine import Severity

# ---------------------------------------------------------------------------
# spec units
# ---------------------------------------------------------------------------


def test_spec_table_clean_and_pinned():
    problems = spec.evaluate_spec()
    dirty = {name: p for name, p in problems.items() if p}
    assert not dirty, dirty
    # the contract is the 13 documented rules, each pinning at least one
    # real constant or running an executable check
    assert len(spec.TRANSPORT_SPEC) >= 13
    for rule in spec.TRANSPORT_SPEC:
        assert rule.pins or rule.check is not None, rule.name


def test_capability_declarations_cover_every_transport():
    classes = spec.declared_transports()
    # all five registered tiers declare a caps record
    for name in ("shm-native", "shm-fallback", "tcp", "routed", "sim"):
        assert name in classes, sorted(classes)
    assert not spec.check_caps_declared(classes)
    assert not spec.check_caps_honest(classes)
    assert not spec.check_caps_call_sites()


def test_transport_family_runs_clean():
    report = analysis.run(families=["transport"])
    errors = [f for f in report.findings if f.severity == Severity.ERROR]
    assert report.ok, errors


# ---------------------------------------------------------------------------
# differential units (in-process arms only: fast, no native lib needed)
# ---------------------------------------------------------------------------


def test_reference_matches_sim_on_pinned_seed():
    sched = conformance.gen_schedule(conformance.EPOCH_SEEDS[0], 50,
                                     epochs=True)
    # final quiesce so the count ledgers are comparable (live == 0) —
    # same discipline as the conformance.epoch-death rule
    div = conformance.differential(["reference", "sim"],
                                   sched + [("epoch",)],
                                   compare_ledgers=True)
    assert div is None, div


def test_reference_matches_fallback_window_on_pinned_seed():
    sched = conformance.gen_schedule(conformance.SHM_SEEDS[0], 60,
                                     puts=True, drains=True)
    div = conformance.differential(["reference", "shm-fallback"], sched)
    assert div is None, div


def test_schedules_are_deterministic():
    a = conformance.gen_schedule(7, 40, puts=True, drains=True, kills=True)
    b = conformance.gen_schedule(7, 40, puts=True, drains=True, kills=True)
    assert a == b
    assert a != conformance.gen_schedule(8, 40, puts=True, drains=True,
                                         kills=True)


def test_every_seeded_mutant_is_caught():
    for make in (conformance.mutant_out_of_order_findings,
                    conformance.mutant_reseed_findings,
                    conformance.mutant_lossy_drain_findings,
                    conformance.mutant_overclaim_findings):
        assert make(), make.__name__


def test_shrinker_reduces_to_the_planted_pin():
    noise = conformance.gen_schedule(99, 24)
    pin = conformance.MUTANT_PINS["out-of-order-commit"]
    factories = dict(conformance.ARM_FACTORIES)
    factories["reference"] = conformance.ReorderingRefAdapter

    def reproduces(ops):
        return conformance.differential(
            ["reference", "sim"], ops, factories=factories) is not None

    full = noise + pin
    assert reproduces(full)
    minimal, runs = conformance.shrink_ops(full, reproduces)
    assert reproduces(minimal)
    # ddmin strips all 24 noise ops: the repro is the pin alone (or
    # smaller — 1-minimality may drop a pin op that wasn't needed)
    assert len(minimal) <= len(pin), minimal
    assert runs > 0


def test_families_for_paths_maps_known_sources():
    fams = conformance.families_for_paths(["bluefog_tpu_torch/islands.py"])
    assert set(fams) == {"protocol", "transport", "wire"}
    fams = conformance.families_for_paths(
        ["bluefog_tpu_torch/native/shm_native.py"])
    assert "conformance" in fams and "interleave" in fams
    # every mapped family really exists in the registry
    known = analysis.registry.families()
    for path, fam_tuple in conformance.FAMILY_MAP.items():
        for fam in fam_tuple:
            assert fam in known, (path, fam)
    # unknown files fail safe: run everything
    assert set(conformance.families_for_paths(["no/such/file.py"])) == \
        set(known)


def test_conformance_fixtures_registered_and_fire():
    for name in ("conformance-out-of-order-commit",
                 "conformance-capability-overclaim",
                 "conformance-drain-loses-mass",
                 "conformance-epoch-reseed-skipped"):
        assert name in fixtures.FIXTURES
        assert fixtures.run_fixture(name), name


def test_unified_explorer_agrees_with_legacy_on_seqlock():
    assert interleave.verdict(interleave.seqlock_spec()) == []
    assert interleave.verdict(interleave.seqlock_spec(bug="early_publish"))


def test_race_scan_catches_early_publish():
    assert interleave.race_scan(interleave.seqlock_spec()) == []
    assert interleave.race_scan(
        interleave.seqlock_spec(bug="early_publish"))


# ---------------------------------------------------------------------------
# np=2 e2e vs live transports under chaos SIGKILL
# ---------------------------------------------------------------------------

_SHAPE = (64,)
_DEPOSITS = ((3.0, 1.0), (2.0, 0.5), (4.0, 1.5))  # (x, p) uniform payloads


def _shm_writer(job):
    from bluefog_tpu_torch.native.shm_native import FallbackShmWindow

    win = FallbackShmWindow(job, "conf", 1, 2, 2, _SHAPE, np.float32)
    for x, p in _DEPOSITS:
        win.write(0, 1, np.full(_SHAPE, x, np.float32), p=p,
                  accumulate=True)
    # die without closing: the reader inherits a dead writer whose last
    # deposit is COMMITTED — the reference model's kill() must predict
    # exactly what the survivor can still collect
    os.kill(os.getpid(), signal.SIGKILL)


def _shm_reader(job, q):
    from bluefog_tpu_torch.native.shm_native import FallbackShmWindow

    win = FallbackShmWindow(job, "conf", 0, 2, 2, _SHAPE, np.float32)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        if win.read_version(1) >= len(_DEPOSITS):
            break
        time.sleep(0.01)
    a, p, version = win.read(1)
    vals = np.unique(a)
    torn = vals.size != 1
    a2, p2, _ = win.read(1, collect=True)
    win.force_drain(1)  # dead-writer recovery must be idempotent here
    a3, p3, _ = win.read(1)
    q.put((version, torn, float(a[0]), float(p),
           float(a2[0]), float(p2), float(a3.sum()), float(p3)))
    win.close(unlink=True)  # the killed writer never will: reader owns
    # the segments' hygiene (the "shm-clean after the demo" contract)


@pytest.mark.island_e2e
def test_e2e_shm_np2_dead_writer_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    job = f"confshm{os.getpid()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pw = ctx.Process(target=_shm_writer, args=(job,))
    pr = ctx.Process(target=_shm_reader, args=(job, q))
    pw.start()
    pr.start()
    try:
        version, torn, x, p, cx, cp, dx, dp = q.get(timeout=120)
        pw.join(30)
        pr.join(30)
    finally:
        from bluefog_tpu_torch.native import shm_native

        for suffix in ("win_conf", "trace_conf"):
            shm_native._unlink_name(shm_native.seg_name(job, suffix))
    assert pw.exitcode == -signal.SIGKILL, pw.exitcode
    assert pr.exitcode == 0, pr.exitcode
    assert not torn, "non-uniform payload visible after commit"

    # the reference model, driven through the same history, predicts the
    # survivor's exact observations (writer rank 1 died, so only its OWN
    # mailboxes are severed — rank 0's inbox keeps the committed mass)
    ref = spec.ReferenceTransport(2)
    for rx, rp in _DEPOSITS:
        ref.deposit(0, 1, rx, rp)
    ref.kill(1)
    assert version == ref.version(0, 1) == len(_DEPOSITS)
    assert (x, p) == ref.read(0, 1)[:2] == (9.0, 3.0)
    assert (cx, cp) == ref.collect(0, 1)[:2]
    assert (dx, dp) == (0.0, 0.0)  # collected + force-drained: empty
    led = ref.ledger()
    assert led["balanced"], led


_N = 5000  # 20000 B f32 -> 5 chunks of 4096 B


def _tcp_writer(job, coord):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    os.environ["BFTPU_TCP_CHUNKED"] = "1"
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow

    tjob = TcpShmJob(job, 1, 2, coord)
    win = TcpShmWindow(job, "conf", 1, 2, 2, (_N,), np.float32, coord)
    tjob.barrier()
    win.write(0, 0, np.full((_N,), 3.0, np.float32), p=0.5)
    tjob.barrier()
    # SIGKILL after 2 of 5 chunk frames of the SECOND deposit: the
    # stream dies open (wseq odd) and must be invisible to the reader
    os.environ["BFTPU_CHAOS_KILL_CHUNK"] = "1:2"
    win.write(0, 1, np.full((_N,), 7.0, np.float32), p=0.25)
    raise AssertionError("writer survived its own kill schedule")


def _tcp_reader(job, coord, q):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    os.environ["BFTPU_TCP_CHUNKED"] = "1"
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow
    from bluefog_tpu_torch.telemetry import registry as _telemetry

    tjob = TcpShmJob(job, 0, 2, coord)
    win = TcpShmWindow(job, "conf", 0, 2, 2, (_N,), np.float32, coord)
    tjob.barrier()
    tjob.barrier()  # writer's slot-0 deposit is committed past here
    reg = _telemetry.get_registry()
    deadline = time.monotonic() + 60.0
    torn = False
    while time.monotonic() < deadline:
        a1, p1, _ = win.read(1)
        torn = torn or p1 != 0.0 or bool(a1.any())
        drains = reg.counter("tcp.mid_stream_drains").value \
            if reg.enabled else 0
        if drains:
            break
        time.sleep(0.05)
    a0, p0, v0 = win.read(0, collect=True)
    vals = np.unique(a0)
    q.put((torn, float(vals[0]) if vals.size == 1 else None,
           float(p0), int(v0)))
    win.close()
    tjob.close()


@pytest.mark.island_e2e
def test_e2e_tcp_np2_chaos_kill_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "45")
    monkeypatch.delenv("BFTPU_CHAOS_KILL_CHUNK", raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    job = f"conftcp{os.getpid()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pw = ctx.Process(target=_tcp_writer, args=(job, coord))
    pr = ctx.Process(target=_tcp_reader, args=(job, coord, q))
    pr.start()
    pw.start()
    torn, x0, p0, v0 = q.get(timeout=120)
    pw.join(30)
    pr.join(30)
    assert pw.exitcode == -signal.SIGKILL, pw.exitcode
    assert pr.exitcode == 0, pr.exitcode
    assert not torn, "partial chunk stream leaked into a read"

    # reference prediction for the same history: one committed deposit,
    # then the writer dies mid-second-deposit — an uncommitted deposit
    # never happened as far as the contract is concerned
    ref = spec.ReferenceTransport(2)
    ref.put(0, 0, 3.0, 0.5)
    ref.kill(1)
    rx, rp, rfresh = ref.collect(0, 0)
    assert (x0, p0) == (rx, rp) == (3.0, 0.5)
    assert v0 >= rfresh == 1
    led = ref.ledger()
    assert led["balanced"], led


# ---------------------------------------------------------------------------
# against the reference, and the lints on the port's own tree
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_schedules_and_spec_are_the_references():
    from bluefog_tpu.analysis import conformance as ref_conf
    from bluefog_tpu.analysis import transport_spec as ref_spec

    for seed in conformance.SHM_SEEDS + conformance.TCP_SEEDS:
        assert conformance.gen_schedule(seed, 60, puts=True, drains=True, kills=True) \
            == ref_conf.gen_schedule(seed, 60, puts=True, drains=True, kills=True)
    assert conformance.CORE_ARMS == ref_conf.CORE_ARMS == (
        "reference", "sim", "shm-native", "shm-fallback", "tcp-chunked", "tcp-legacy")
    assert [r.name for r in spec.TRANSPORT_SPEC] == [r.name for r in ref_spec.TRANSPORT_SPEC]
    # the pins name the module they read: the port's, package name normalised
    def pins(table):
        return [[(p.module.replace("bluefog_tpu_torch", "bluefog_tpu"), p.attr, p.expected)
                 for p in r.pins] for r in table]

    assert pins(spec.TRANSPORT_SPEC) == pins(ref_spec.TRANSPORT_SPEC)
    assert all(p.module.startswith("bluefog_tpu_torch.")
               for r in spec.TRANSPORT_SPEC for p in r.pins)


def test_every_core_arm_runs_including_native(monkeypatch):
    """All six arms take part, and the shm rule never drops the native
    arm: a library that cannot be built raises out of the rule instead of
    a warning and a skipped arm."""
    from bluefog_tpu_torch import native
    from bluefog_tpu_torch.analysis.engine import Report

    def broken():
        raise RuntimeError("building the native library failed")

    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="native library failed"):
        conformance._rule_differential_shm(Report())
    monkeypatch.undo()
    sched = conformance.gen_schedule(conformance.SHM_SEEDS[0], 30)
    assert conformance.differential(list(conformance.CORE_ARMS), sched) is None


def test_family_map_names_the_ports_files():
    """Every mapped source exists in the port; a port analysis module
    selects its own family."""
    for rel in conformance.FAMILY_MAP:
        assert rel.startswith("bluefog_tpu_torch/"), rel
        assert os.path.exists(os.path.join(REPO, rel)), rel
    assert conformance.families_for_paths(
        ["bluefog_tpu_torch/analysis/wire_rules.py"]) == ["wire"]
    assert conformance.families_for_paths(
        ["./bluefog_tpu_torch/native/wire_codec.py"]) == ["transport", "wire"]


def _port_copy(tmp_path):
    import shutil

    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "bluefog_tpu_torch"), dst / "bluefog_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"))
    shutil.copy(os.path.join(REPO, "README.md"), dst / "README.md")
    shutil.copytree(os.path.join(REPO, "docs"), dst / "docs")
    return dst


def test_capability_lint_fires_on_a_planted_violation(tmp_path):
    """The call-site lint reads the port's files: clean on this checkout,
    and on a copy where islands.py branches on a transport class and the
    progress engine reads BFTPU_WIRE_DTYPE itself, both fire."""
    root = _port_copy(tmp_path)
    assert spec.check_caps_call_sites(str(root)) == []
    islands_py = root / "bluefog_tpu_torch" / "islands.py"
    islands_py.write_text(islands_py.read_text() +
                          "\n_PLANTED = isinstance(None, TcpShmWindow)\n")
    engine_py = root / "bluefog_tpu_torch" / "progress" / "engine.py"
    engine_py.write_text(engine_py.read_text() +
                         "\n_PLANTED = os.environ.get('BFTPU_WIRE_DTYPE')\n")
    problems = spec.check_caps_call_sites(str(root))
    assert any(p.startswith("bluefog_tpu_torch/islands.py: no transport-class")
               for p in problems), problems
    assert any(p.startswith("bluefog_tpu_torch/progress/engine.py: reads BFTPU_WIRE_DTYPE")
               for p in problems), problems


def test_env_lint_reads_the_ports_tree(tmp_path):
    """The env-var lint walks bluefog_tpu_torch/: an undocumented knob
    planted in a copy of the port fires, and the reference's tree is not
    what it reads."""
    from bluefog_tpu_torch.analysis import telemetry_rules as tr

    root = _port_copy(tmp_path)
    used = tr.scan_env_vars(str(root))
    assert not tr.check_env_documented(used, tr.documented_vars(str(root)))
    assert all(f.startswith("bluefog_tpu_torch/") for fs in used.values() for f in fs)
    planted = root / "bluefog_tpu_torch" / "serve" / "planted.py"
    planted.write_text("import os\nX = os.environ.get('BFTPU_PLANTED_KNOB')\n")
    found = tr.check_env_documented(tr.scan_env_vars(str(root)),
                                    tr.documented_vars(str(root)))
    assert [f.rule for f in found] == ["telemetry.env-documented"]
    assert "BFTPU_PLANTED_KNOB" in found[0].message
    assert "bluefog_tpu_torch/serve/planted.py" in found[0].message
