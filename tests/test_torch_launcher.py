"""Port twin of ``tests/test_launcher_hosts.py`` and
``tests/test_launcher_timeline.py``: ``bluefog_tpu_torch.run.launcher``
(``bftpu-torch-run``) against the JAX package's launcher.

``build_env``, ``parse_hosts``, ``ssh_command`` and the env whitelist are
held to the reference's for the same arguments, apart from the JAX-only
env (``JAX_*`` / ``XLA_*`` / ``TPU_*``), which the port neither sets nor
forwards.  The reference's jax.distributed cases (``-np`` / ``-H``
without ``--islands``, ``--simulate``) become the port's errors naming
ROADMAP A9; their islands counterparts run here: ``-H localhost:2`` with
the port's async example and ``--timeout`` over hung islands.  The
reference's fake-ssh case is left out: an islands rank on a second host
advertises that host's name to its TCP peers, and the shim's made-up
host name would have to be resolved.  ``--serve-replicas`` drives
``examples/serve_islands`` end to end on the CPU, and so do ``--monitor
--lab-probe``; ``--attach JOB monitor`` reads a monitor store as the
reference's attach does.
"""

import argparse
import glob
import json
import os
import subprocess
import sys

import pytest

from bluefog_tpu.run import launcher as ref
from bluefog_tpu_torch.run import launcher
from bluefog_tpu_torch.run.launcher import (
    build_env,
    env_whitelist,
    main,
    parse_hosts,
    ssh_command,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_ONLY = ("JAX_", "XLA_", "LIBTPU_", "TPU_")


def _run(args, timeout=120, env=None):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher"] + args,
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ if env is None else env, PYTHONPATH=REPO))


def _args(**kw):
    ns = argparse.Namespace(
        np=None,
        coordinator=None,
        process_id=None,
        simulate=0,
        timeline=None,
        verbose=False,
        command=["python", "x.py"],
    )
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _port_view(env: dict) -> dict:
    return {k: v for k, v in env.items() if not k.startswith(_JAX_ONLY)}


# ---------------------------------------------------------------------------
# the helpers, held to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["a:2,b:4", "single", "a:1, b:3 ,", "h"])
def test_parse_hosts_matches_reference(spec):
    assert parse_hosts(spec) == ref.parse_hosts(spec)


def test_parse_hosts():
    assert parse_hosts("a:2,b:4") == [("a", 2), ("b", 4)]
    assert parse_hosts("single") == [("single", 1)]
    assert parse_hosts("a:1, b:3 ,") == [("a", 1), ("b", 3)]


@pytest.mark.parametrize("bad", ["", ":2", "a:zero", "a:0", "a:-1"])
def test_parse_hosts_rejects(bad):
    with pytest.raises(ValueError):
        parse_hosts(bad)
    with pytest.raises(ValueError):
        ref.parse_hosts(bad)


@pytest.mark.parametrize("kw", [
    {},
    {"verbose": True, "timeline": "/tmp/t.json"},
    {"adaptive": True},
    {"np": 4, "coordinator": "h:1234", "process_id": 2},
    {"simulate": 8},
])
def test_build_env_matches_reference_apart_from_jax_env(kw):
    base = {"PATH": "/bin", "BFTPU_X": "1", "XLA_FLAGS": "--keep"}
    got = build_env(_args(**kw), base_env=base)
    want = ref.build_env(_args(**kw), base_env=base)
    assert _port_view(got) == _port_view(want)
    # the port adds no JAX env of its own (it only carries what was there)
    assert {k for k in got if k.startswith(_JAX_ONLY)} <= set(base)


def test_build_env_flags():
    env = build_env(_args(verbose=True, timeline="/tmp/t.json"), base_env={})
    assert env["BLUEFOG_LOG_LEVEL"] == "debug"
    assert env["BLUEFOG_TIMELINE"] == "/tmp/t.json"


@pytest.mark.parametrize("flag,key", [("monitor", "BFTPU_MONITOR"),
                                      ("lab_probe", "BFTPU_LAB_PROBE")])
def test_build_env_planes_match_reference(flag, key):
    base = {"PATH": "/bin"}
    got = build_env(_args(**{flag: True}), base_env=base)
    assert got == _port_view(ref.build_env(_args(**{flag: True}), base_env=base))
    assert got[key] == "1"


def test_env_whitelist_matches_reference_apart_from_jax_env():
    env = {
        "BLUEFOG_LOG_LEVEL": "debug",
        "BFTPU_TRACING": "1",
        "JAX_NUM_PROCESSES": "2",
        "XLA_FLAGS": "--foo",
        "TPU_NAME": "x",
        "PYTHONPATH": "/repo",
        "HOME": "/home/u",              # not forwarded
        "AWS_SECRET_ACCESS_KEY": "x",  # not forwarded
    }
    fwd = env_whitelist(env)
    assert fwd == _port_view(ref.env_whitelist(env))
    assert fwd == {"BLUEFOG_LOG_LEVEL": "debug", "BFTPU_TRACING": "1",
                   "PYTHONPATH": "/repo"}


def test_ssh_command_matches_reference():
    args = ("nodeb", ["python", "train.py", "--lr", "0.1 x"],
            {"BLUEFOG_ISLAND_RANK": "1", "BFTPU_X": "--a --b"}, "/work dir")
    for pidfile in (None, "/tmp/p.pid"):
        assert ssh_command(*args, pidfile=pidfile) == \
            ref.ssh_command(*args, pidfile=pidfile)
    cmd = ssh_command(*args)
    assert cmd[0] == "ssh" and "BatchMode=yes" in cmd and cmd[-2] == "nodeb"
    inner = cmd[-1]
    assert inner.startswith("cd '/work dir' && exec env ")
    assert "BFTPU_X='--a --b'" in inner
    assert inner.endswith("python train.py --lr '0.1 x'")


def test_is_local_host_matches_own_names():
    import socket

    assert launcher._is_local_host("localhost")
    assert launcher._is_local_host("127.0.0.1")
    assert launcher._is_local_host(socket.gethostname())
    assert launcher._is_local_host(socket.getfqdn())
    assert not launcher._is_local_host("definitely-not-this-machine.example.com")


def test_islands_multihost_advertises_reachable_host(monkeypatch):
    """Every rank of a multi-host islands launch gets a dialable
    BLUEFOG_ISLAND_HOST, the hostmap and the coordinator, as the
    reference's launcher gives them."""
    import socket

    seen = []

    class _FakeProc:
        pid = 0

        def poll(self):
            return 0

    def fake_spawn(host, cmd, child_env, tag, r):
        seen.append((r, host, dict(child_env)))
        return launcher._Rank(_FakeProc(), host)

    monkeypatch.setattr(launcher, "_spawn_rank", fake_spawn)
    monkeypatch.setattr(launcher, "_supervise", lambda ranks, t: 0)
    monkeypatch.setattr(launcher, "_cleanup_island_segments",
                        lambda job, by_rank: None)
    rc = launcher._run_islands(
        ["true"], {}, 2, "jobx", [("localhost", 1), ("nodeb", 1)], 0.0)
    assert rc == 0
    envs = {r: e for r, _, e in seen}
    assert envs[0]["BLUEFOG_ISLAND_HOST"] == socket.getfqdn()
    assert envs[1]["BLUEFOG_ISLAND_HOST"] == "nodeb"
    assert envs[0]["BLUEFOG_ISLAND_HOSTMAP"] == "localhost,nodeb"
    assert "BLUEFOG_ISLAND_COORD" in envs[0]


# ---------------------------------------------------------------------------
# parser errors: the modes that wait for other planes
# ---------------------------------------------------------------------------


def test_main_no_command_errors(capsys):
    with pytest.raises(SystemExit):
        main([])


@pytest.mark.parametrize("argv,needle", [
    (["-np", "3", "-H", "localhost:2", "--", "true"], "-H lists 2 slots"),
    (["--islands", "3", "-H", "localhost:2", "--", "true"], "lists 2 slots"),
    (["-np", "2", "--", "true"], "A9"),
    (["-H", "localhost:2", "--", "true"], "A9"),
    (["--simulate", "8", "--", "true"], "A9"),
    (["--serve-replicas", "1", "--", "true"], "requires --islands"),
])
def test_parser_errors(argv, needle):
    proc = _run(argv, timeout=60)
    assert proc.returncode == 2, proc.stderr
    assert needle in proc.stderr


def test_monitor_and_lab_probe_islands_run_is_clean(tmp_path):
    """``--islands 2 --monitor --lab-probe`` over the serving example on
    the CPU (no replica, the fleet held up after its last version): exit
    0, the daemon scraped and raised no alert, ``--report`` exits 0, and
    both ranks journaled the probe's trail."""
    tel = tmp_path / "tel"
    tel.mkdir()
    job = f"tlmon{os.getpid()}"
    env = dict(os.environ, BFTPU_TELEMETRY=str(tel), BFTPU_MON_SCRAPE_S="0.1")
    proc = _run(["--islands", "2", "--monitor", "--lab-probe", "--job", job, "--",
                 sys.executable, "-m", "bluefog_tpu_torch.examples.serve_islands",
                 "--device", "cpu", "--model", "lenet5", "--versions", "2",
                 "--hold", "10"],  # the daemon's start (torch's import) may take seconds
                timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " 0 alert window(s)" in proc.stderr, proc.stderr
    rep = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.monitor", "--report",
                          str(tel)], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert rep.returncode == 0, rep.stdout + rep.stderr
    for rank in (0, 1):
        with open(tel / f"telemetry-{job}-r{rank}.events.jsonl") as f:
            conv = [json.loads(line) for line in f if '"conv"' in line]
        assert [e["round"] for e in conv] == list(range(2, 7)), rank
    assert not glob.glob(f"/dev/shm/bf_{job}_*")


def test_attach_monitor_export_reads_the_store_as_the_reference(tmp_path,
                                                               monkeypatch, capsys):
    """``--attach JOB monitor --export`` prints the job's monitor store;
    over the same store it prints what the reference's attach prints."""
    from bluefog_tpu.native import shm_native as ref_shm
    from bluefog_tpu_torch.monitor import store as mstore
    from bluefog_tpu_torch.native import shm_native

    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    monkeypatch.setattr(ref_shm, "_FALLBACK_DIR", str(tmp_path))
    st = mstore.MonitorStore("attj", create=True, nslots=8, cap_raw=16)
    for i in range(12):
        st.append("dead_edges", "fleet", 5.0 + i, float(i % 2))
    st.close()
    outs = []
    for attach in (launcher.attach_main, ref.attach_main):
        assert attach("attj", ["monitor", "--export"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0]["schema"] == "bftpu-monitor/1"
    assert [s["series"] for s in outs[0]["series"]] == ["dead_edges"]
    mstore.MonitorStore("attj").close(unlink=True)


# ---------------------------------------------------------------------------
# islands runs
# ---------------------------------------------------------------------------


def test_timeout_kills_hung_children(tmp_path):
    """--timeout reaps island processes that never finish."""
    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(600)\n")
    proc = _run(["--islands", "2", "-H", "localhost:2", "--timeout", "3",
                 "--", sys.executable, str(hang)], timeout=120)
    assert proc.returncode == 124
    assert "timeout" in proc.stderr


@pytest.mark.island_e2e
def test_islands_with_hosts_single_host():
    """--islands 2 -H localhost:2: one host, so the plain shm transport;
    every rank runs the port's async example and reports convergence."""
    proc = _run(["--islands", "2", "-H", "localhost:2", "--timeout", "400",
                 "--", sys.executable, "-m",
                 "bluefog_tpu_torch.examples.async_islands", "--device", "cpu",
                 "--iters", "30", "--sleep", "0.001"], timeout=420)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}")
    assert proc.stdout.count('"ok": true') == 2, proc.stdout


@pytest.mark.island_e2e
def test_serve_replicas_install_every_published_version(tmp_path):
    """``--islands 2 --serve-replicas 1`` on the CPU: the replica installs
    each of the 4 versions rank 0 publishes, its last snapshot is the last
    published estimate byte for byte, it served between swaps, the job's
    segments are gone, and the merged trace passes ``--check``."""
    from bluefog_tpu_torch.native import shm_native

    job = f"tlserve{os.getpid()}"
    trace = tmp_path / "trace"
    trace.mkdir()
    env = dict(os.environ, BFTPU_TRACING=str(trace), BFTPU_SERVE_DEVICE="cpu")
    proc = _run(["--islands", "2", "--serve-replicas", "1",
                 "--serve-report", str(tmp_path), "--job", job,
                 "--timeout", "300", "--", sys.executable, "-m",
                 "bluefog_tpu_torch.examples.serve_islands", "--device", "cpu",
                 "--model", "lenet5", "--replicas", "1", "--record",
                 str(tmp_path / "publisher.json")], timeout=320, env=env)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}")
    pub = json.loads((tmp_path / "publisher.json").read_text())
    rep = json.loads((tmp_path / "replica-0.json").read_text())
    versions = [v for v, _, _ in rep["installs"]]
    assert versions == [1, 2, 3, 4]
    assert rep["last_sha256"] == pub["published"][-1]["sha256"]
    assert len({p["sha256"] for p in pub["published"]}) == 4
    assert rep["served"] > 0
    assert not glob.glob(os.path.join("/dev/shm", f"bf_{job}_*"))
    assert not glob.glob(os.path.join(shm_native._FALLBACK_DIR, f"bf_{job}_*"))
    assert (trace / f"merged-trace-{job}.json").exists()
    chk = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tracing", str(trace),
         "--check", "--out", str(tmp_path / "m.json")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert chk.returncode == 0, chk.stderr


def test_python_timeline_fallback(tmp_path, monkeypatch):
    """Force the pure-Python writer (native disabled) and check the JSON."""
    from bluefog_tpu_torch import timeline as tl

    path = str(tmp_path / "py_trace.json")
    monkeypatch.setenv("BLUEFOG_TIMELINE", path)
    monkeypatch.setattr(tl, "_writer", None)
    w = tl.TimelineWriter(path)
    w._native = None  # force fallback
    w.record("span_x", 1.0, 2.0)
    w.flush()
    with open(path) as f:
        data = json.load(f)
    assert data["traceEvents"][0]["name"] == "span_x"
