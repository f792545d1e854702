"""The multi-process backend (``core/distributed.py``, gloo) and the
launcher's multi-process forms: twins of ``tests/test_multihost.py`` and
of ``tests/test_launcher_hosts.py``'s two end-to-end cases, the pure
cross-process schedule, and parity of the 2-process results with the JAX
package's single-process ones.

Every spawned launch is ``bftpu-torch-run`` with ``--timeout`` under a
subprocess timeout, at most 4 processes, on the CPU (``--device cpu``),
and asserts on exit codes and output, never on wall time.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.distributed import schedule
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.examples import multihost_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8


def _launch(args, timeout=150, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BFTPU_COORDINATOR_ADDRESS", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.launcher"] + args,
        env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def _ok(proc, *lines):
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{proc.stdout[-4000:]}\n"
        f"stderr:\n{proc.stderr[-4000:]}")
    for line in lines:
        assert line in proc.stdout, proc.stdout[-4000:]


WORKER = [sys.executable, "-m", "bluefog_tpu_torch.examples.multihost_worker",
          "--device", "cpu"]
OK = ("multihost worker process 0 OK", "multihost worker process 1 OK")


# ---------------------------------------------------------------------------
# the schedule: a pure function of (sources, nprocs, pid)
# ---------------------------------------------------------------------------


def _class_schedules(topo, nprocs):
    plan = compile_plan(topo)
    return [[schedule(cls.sources(), nprocs, p) for p in range(nprocs)]
            for cls in plan.classes]


def test_ring_schedule_moves_one_row_each_way_a_class():
    """RingGraph(8) over 2 x 4: two classes (shifts 1 and 7); in each, each
    process sends exactly one row to the other and receives one."""
    scheds = _class_schedules(tu.RingGraph(SIZE), 2)
    assert len(scheds) == 2
    for per_proc in scheds:
        for s in per_proc:
            assert s.rows_out == s.rows_in == 1
            assert len(s.sends) == len(s.recvs) == 1
            assert len(s.local_dst) == 3


def test_exp2_schedule_counts_per_class():
    """ExponentialTwoGraph(8) over 2 x 4: shifts 1, 2 and 4 cross 1, 2 and 4
    rows each way a process; over 4 x 2: 1, 2 and 2 rows, each class with
    one peer."""
    for nprocs, want in ((2, [1, 2, 4]), (4, [1, 2, 2])):
        scheds = _class_schedules(tu.ExponentialTwoGraph(SIZE), nprocs)
        assert [[(s.rows_out, s.rows_in) for s in per] for per in scheds] == \
            [[(w, w)] * nprocs for w in want]
        for per in scheds:
            assert all(len(s.sends) == len(s.recvs) == 1 for s in per)


def test_schedule_is_local_in_one_process():
    (per,) = _class_schedules(tu.RingGraph(SIZE), 1)[:1]
    (s,) = per
    assert not s.sends and not s.recvs and len(s.local_dst) == SIZE


@pytest.mark.parametrize("topo", ["exp2", "ring", "star", "mesh2d", "full"])
@pytest.mark.parametrize("nprocs", [1, 2, 4, 8])
def test_schedule_gathers_every_source_and_moves_only_crossing_rows(topo, nprocs):
    """Played out by hand over all processes, every schedule delivers row
    ``src[d]`` to row ``d``; a message carries exactly the rows whose
    source lies in the sender, one batch a peer each way, and the two
    sides agree on each batch's length."""
    g = {"exp2": tu.ExponentialTwoGraph, "ring": tu.RingGraph, "star": tu.StarGraph,
         "mesh2d": tu.MeshGrid2DGraph, "full": tu.FullyConnectedGraph}[topo](SIZE)
    x = np.arange(SIZE) * 10
    b = SIZE // nprocs
    for cls in compile_plan(g).classes:
        src = cls.sources()
        per = [schedule(src, nprocs, p) for p in range(nprocs)]
        for p, s in enumerate(per):
            out = np.full(b, -1)
            out[list(s.local_dst)] = x[[p * b + i for i in s.local_src]]
            for q, rows in s.recvs:
                (sent,) = [r for peer, r in per[q].sends if peer == p]
                assert len(sent) == len(rows)
                out[list(rows)] = x[[q * b + i for i in sent]]
            assert (out == x[list(src[p * b:(p + 1) * b])]).all()
            crossing = sum(1 for d in range(p * b, (p + 1) * b) if src[d] // b != p)
            assert s.rows_in == crossing
            assert len({q for q, _ in s.sends}) == len(s.sends)


# ---------------------------------------------------------------------------
# twins of the reference's launches
# ---------------------------------------------------------------------------


def test_bftpu_run_np2_multiprocess():
    """Twin of ``test_multihost.py::test_bftpu_run_np2_multiprocess``."""
    _ok(_launch(["-np", "2", "--timeout", "130", "--"] + WORKER), *OK)


def test_bftpu_run_simulated_multislice():
    """Twin of ``test_multihost.py::test_bftpu_run_simulated_multislice``:
    ``BLUEFOG_SIMULATE_SLICES=4`` makes machines finer than processes."""
    _ok(_launch(["-np", "2", "--timeout", "130", "--", sys.executable, "-m",
                 "bluefog_tpu_torch.examples.multihost_slice_worker", "--device", "cpu"]),
        "multislice worker process 0 OK", "multislice worker process 1 OK")


def test_bftpu_run_hosts_localhost_e2e():
    """Twin of ``test_launcher_hosts.py::test_bftpu_run_hosts_localhost_e2e``."""
    _ok(_launch(["-H", "localhost:1,localhost:1", "--timeout", "130", "--"] + WORKER), *OK)


def test_bftpu_run_fake_ssh_remote_e2e(tmp_path):
    """Twin of ``test_launcher_hosts.py::test_bftpu_run_fake_ssh_remote_e2e``:
    a PATH-shimmed ``ssh`` that drops its options and host and runs the
    remote script here drives the remote spawn path (the inline env, the
    pidfile) end to end; process 1 rendezvouses with the locally forked
    process 0.  Its pidfile goes to the remote shell's ``$TMPDIR`` (here
    a directory of this test's own) under the launch's own tag, and is
    collected at teardown."""
    shim = tmp_path / "ssh"
    log = tmp_path / "ssh.log"
    shim.write_text(
        "#!/bin/sh\n"
        '# fake ssh: skip "-o value" pairs, drop the host, log and run the script\n'
        'while [ "$1" = "-o" ]; do shift 2; done\n'
        "shift\n"
        f'printf "%s\\n" "$1" >> {log}\n'
        'exec sh -c "$1"\n'
    )
    shim.chmod(0o755)
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    proc = _launch(["-H", "localhost:1,fakeremote:1", "--timeout", "130", "--"] + WORKER,
                   env_extra={"PATH": f"{tmp_path}:{os.environ['PATH']}",
                              "TMPDIR": str(tmpdir)})
    _ok(proc, *OK)
    spawn = log.read_text().splitlines()[0]
    assert spawn.startswith('echo $$ > "${TMPDIR:-/tmp}"/bftpu-torch-run-')
    assert "-r1.pid; cd " in spawn
    assert not list(tmpdir.glob("*.pid"))


def test_rendezvous_failure_raises_and_never_runs_alone():
    """A process whose peers never come fails its ``init``: it does not go
    on as one process."""
    code = ("import functools\n"
            "import bluefog_tpu_torch as bf\n"
            "from bluefog_tpu_torch.core import distributed\n"
            "distributed.init_process_group = functools.partial(\n"
            "    distributed.init_process_group, timeout=5)\n"
            "bf.init(size=8, device='cpu')\n"
            "print('went on alone')\n")
    proc = _launch(["--coordinator", "127.0.0.1:1", "-np", "2", "--process-id", "1",
                    "--", sys.executable, "-c", code], timeout=120)
    assert proc.returncode != 0
    assert "went on alone" not in proc.stdout


# ---------------------------------------------------------------------------
# parity of the 2-process results with the JAX package's single-process ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    path = tmp_path_factory.mktemp("parity")
    _ok(_launch(["-np", "2", "--timeout", "130", "--"] + WORKER + ["--parity", str(path)]),
        *OK)
    parts = [np.load(path / f"parity-{p}.npz") for p in range(2)]
    # every result stacks the ranks on axis 0, the ATC losses [step, rank]
    return {k: np.concatenate([p[k] for p in parts], axis=1 if k == "atc" else 0)
            for k in parts[0].files}


@pytest.fixture
def ref(devices):
    import bluefog_tpu as jbf

    yield jbf
    jbf.shutdown()


def _x():
    rng = np.random.default_rng(multihost_worker.PARITY_SEED)
    return rng.standard_normal((SIZE, 3, 2)).astype(np.float32)


@pytest.mark.parametrize("name", ["exp2", "ring"])
def test_neighbor_allreduce_two_processes_match_the_reference(parity, ref, name):
    from bluefog_tpu import topology_util as jtu

    ref.init()
    ref.set_topology({"exp2": jtu.ExponentialTwoGraph, "ring": jtu.RingGraph}[name](SIZE))
    want = np.asarray(ref.neighbor_allreduce(_x()))
    np.testing.assert_allclose(parity[f"nar_{name}"], want, rtol=1e-5, atol=1e-6)


def test_hierarchical_machines_are_processes_matches_the_reference(parity, ref):
    from bluefog_tpu import topology_util as jtu

    ref.init(local_size=4)  # 2 machines of 4: the processes
    ref.set_machine_topology(jtu.RingGraph(2))
    want = np.asarray(ref.hierarchical_neighbor_allreduce(_x()))
    np.testing.assert_allclose(parity["hier"], want, rtol=1e-5, atol=1e-6)


def test_window_round_two_processes_matches_the_reference(parity, ref):
    from bluefog_tpu import topology_util as jtu

    x = _x()
    ref.init()
    ref.set_topology(jtu.RingGraph(SIZE))
    ref.win_create(x, "parity")
    ref.win_put(x * 2.0, "parity")
    want = np.asarray(ref.win_update("parity"))
    ref.win_free("parity")
    np.testing.assert_allclose(parity["win"], want, rtol=1e-5, atol=1e-6)


def test_atc_losses_two_processes_match_the_reference(parity, ref):
    """The worker's 6 ATC steps against the JAX package's
    ``make_decentralized_train_step`` on the 8-device mesh."""
    import jax.numpy as jnp
    import optax
    from bluefog_tpu import topology_util as jtu
    from bluefog_tpu.core import basics as jbasics
    from bluefog_tpu.optim import CommunicationType
    from bluefog_tpu.training import make_decentralized_train_step, replicate_for_mesh

    ref.init()
    ref.set_topology(jtu.RingGraph(SIZE))

    def apply_fn(variables, xb, train=False):
        del train
        return xb @ variables["params"]["w"]

    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    params = replicate_for_mesh({"w": jnp.asarray(w0)}, SIZE)
    init_fn, step_fn = make_decentralized_train_step(
        apply_fn, optax.sgd(0.05), jbasics.context().mesh,
        communication_type=CommunicationType.neighbor_allreduce,
        plan=jbasics.context().plan, has_batch_stats=False)
    opt_state = init_fn({"w": jnp.broadcast_to(jnp.asarray(w0)[None], (SIZE, 5, 3))})
    xb = rng.normal(size=(SIZE, 16, 5)).astype(np.float32)
    yb = rng.integers(0, 3, size=(SIZE, 16)).astype(np.int32)
    want = []
    for _ in range(6):
        params, _, opt_state, loss, _ = step_fn(params, None, opt_state, xb, yb)
        want.append(np.asarray(loss))
    np.testing.assert_allclose(parity["atc"], np.stack(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# every op over 4 processes against the same ops in one process
# ---------------------------------------------------------------------------

_OPS_PROGRAM = r"""
import sys
import numpy as np, torch
import bluefog_tpu_torch as bf
from bluefog_tpu_torch import ops, topology_util as tu, windows
from bluefog_tpu_torch.core import basics, distributed
exec(open(sys.argv[1]).read().split("# --- ops ---")[-1].split("# --- end ---")[0])
bf.init(size=8, local_size=4, distributed=True, device="cpu")
res = run_ops(basics.to_rank_major_global)
np.savez(sys.argv[2] + f"/ops-{basics.process_layout().pid}.npz",
         **{k: basics.local_slice(v).double().numpy() for k, v in res.items()},
         rows_in=np.array(distributed.transfer_stats()["bytes_received"]))
print("ops OK", flush=True)
"""

# --- ops ---
def run_ops(rows):
    """The ops the 4-process run and the one-process run both take: ``rows``
    turns a full rank-major array into the process's rows."""
    import numpy as np
    import torch
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import ops, topology_util as tu, windows

    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 3, 2)).astype(np.float32)
    xs = rows(torch.from_numpy(x))
    out = {}
    bf.set_topology(tu.ExponentialTwoGraph(8))
    out["nar_bf16"] = ops.neighbor_allreduce(xs.to(torch.bfloat16)).float()
    out["nar_fused"] = ops.neighbor_allreduce_plan(
        [xs, xs[:, 0] * 3], bf.context().plan, fuse=True)[1]
    out["allreduce"] = ops.allreduce(xs)
    out["allreduce_sum_int"] = ops.allreduce(rows(torch.arange(8)[:, None] * 3),
                                             average=False).double()
    out["broadcast"] = ops.broadcast(xs, root_rank=5)
    out["allgather"] = ops.allgather(xs)
    out["nag"] = ops.neighbor_allgather(xs)
    dst = [{(r + 3) % 8: 0.5} for r in range(8)]
    out["dynamic"] = ops.neighbor_allreduce(xs, dst_weights=dst)
    out["pairwise"] = ops.pairwise_gossip(xs, [(0, 5), (5, 0), (2, 3)], size=8)
    bf.set_machine_topology(tu.RingGraph(2))
    out["hier_spanning"] = ops.hierarchical_neighbor_allreduce(xs)
    bf.set_topology(tu.RingGraph(8))
    windows.turn_on_win_ops_with_associated_p()
    windows.win_create(xs, "w")
    windows.win_accumulate(xs * 2, "w", dst_weights=[{(r + 1) % 8: 0.25} for r in range(8)])
    windows.win_get("w")
    out["win"] = windows.win_update("w")
    out["win_p"] = windows.win_associated_p("w")[:, None]
    windows.turn_off_win_ops_with_associated_p()
    windows.win_free("w")
    return out
# --- end ---


@pytest.fixture(scope="module")
def four_process_ops(tmp_path_factory):
    path = tmp_path_factory.mktemp("ops")
    proc = _launch(["-np", "4", "--timeout", "130", "--", sys.executable, "-c", _OPS_PROGRAM,
                    os.path.abspath(__file__), str(path)])
    _ok(proc)
    assert proc.stdout.count("ops OK") == 4
    parts = [np.load(path / f"ops-{p}.npz") for p in range(4)]
    got = {k: np.concatenate([p[k] for p in parts]) for k in parts[0].files
           if k != "rows_in"}
    got["rows_in"] = [int(p["rows_in"]) for p in parts]
    return got


@pytest.fixture(scope="module")
def one_process_ops():
    basics.init(size=8, local_size=4, device="cpu")
    try:
        return {k: basics.local_slice(v).double().numpy()
                for k, v in run_ops(lambda t: t).items()}
    finally:
        basics.shutdown()


@pytest.mark.parametrize("name", ["nar_bf16", "nar_fused", "allreduce", "allreduce_sum_int",
                                  "broadcast", "allgather", "nag", "dynamic", "pairwise",
                                  "hier_spanning", "win", "win_p"])
def test_four_processes_match_one_process(four_process_ops, one_process_ops, name):
    """Each op over 4 processes of 2 ranks (machines of 4 ranks span two
    processes) against the same op on 8 ranks in one process: the
    exchanged rows are copies, so gathers agree exactly; the reductions
    sum the processes' partials, within f32 rounding."""
    got, want = four_process_ops[name], one_process_ops[name]
    assert got.shape == want.shape
    if name in ("allreduce", "hier_spanning"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_four_process_run_moved_rows(four_process_ops):
    assert all(n > 0 for n in four_process_ops["rows_in"])
