"""The island runtime of bluefog_tpu_torch (``islands.py``) against the JAX
package, with real OS processes exchanging deposits through the native
shared-memory mailbox.

- **A mixed fleet**: ranks 0-1 run ``bluefog_tpu.islands`` and ranks 2-3
  ``bluefog_tpu_torch.islands`` in ONE job (started with ``multiprocessing``
  directly), for the native and the lockf transports: barriered diffusion on
  ``RingGraph(4)`` equals the analytic ``W^k x0`` to 1e-12, async push-sum
  conserves mass across packages, and ``win_mutex`` excludes across them.
- **Port-only suites**, one process set each (every spawn pays a torch
  import per child): the reference's deterministic suite with torch tensors
  (diffusion, ``win_get``, versions, ``broadcast_parameters``), push-sum
  mass conservation, the fused tree window, the async ops; the hierarchical
  hostmap ``a,a,b,b`` suite; the win-put optimizer with ``torch.optim.SGD``,
  overlap off and on; the async-islands example.

The optimizer test is built to be steady under load, unlike the reference's
``test_island_winput_optimizer_*`` (which asserts a tolerance right after a
free-running async phase, so a loaded host that desynchronizes the ranks can
fail it): after a short free-running phase the ranks step in lockstep
(a barrier a step bounds the staleness to a round or two), so every rank
contracts to the fixed point of ``w = W((1 - lr) w + lr c)``, whose mean is
``mean(c)`` whatever the staleness; then barriered ``settle`` rounds, which
preserve the mean exactly, bring consensus.  No wall time is asserted, and
the pack layout is checked deterministically against the reference's.
"""

import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import pytest
import torch

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.native import shm_native

pytestmark = pytest.mark.island_e2e


def _ring_w(size):
    return topology_util.GetWeightMatrix(topology_util.RingGraph(size))


# ---------------------------------------------------------------------------
# a mixed fleet: two JAX islands and two torch islands in one job
# ---------------------------------------------------------------------------


def _barriered_push_sum_round(isl, name):
    """A push-sum round with a barrier between the deposits and the collect
    (either package's islands): it applies the mixing matrix exactly, where
    ``push_sum_round`` + ``barrier`` lets a rank collect before a
    neighbor's deposit of the same round has landed."""
    x = np.array(isl.win_sync(name), copy=True)
    p = isl.win_associated_p(name)
    outs = isl.out_neighbor_ranks()
    share = 1.0 / (len(outs) + 1)
    isl.win_accumulate(x, name, dst_weights={d: share for d in outs})
    isl.win_set_exposed(name, x * share, p * share)
    isl.barrier()
    isl.win_update_then_collect(name)
    isl.barrier()


def _fleet_member(pkg, rank, size, job, steps, path, q):
    try:
        if pkg == "jax":
            from bluefog_tpu import islands as isl
            from bluefog_tpu import topology_util as tu
        else:
            from bluefog_tpu_torch import islands as isl
            from bluefog_tpu_torch import topology_util as tu
        isl.init(rank, size, job)
        isl.set_topology(tu.RingGraph(size))
        x = np.arange(3, dtype=np.float64) + rank
        isl.win_create(x, "d")
        for _ in range(steps):
            isl.win_put(isl.win_sync("d"), "d")
            isl.barrier()
            isl.win_update("d")
            isl.barrier()
        diffused = np.array(isl.win_sync("d"), copy=True)
        isl.win_free("d")
        # asynchronous push-sum across the two packages
        isl.turn_on_win_ops_with_associated_p()
        isl.win_create(np.full((3,), float(rank * 10), np.float64), "ps", zero_init=True)
        for _ in range(30):
            isl.push_sum_round("ps")
        isl.barrier()
        for _ in range(25):  # 3x a round on RingGraph(4)
            _barriered_push_sum_round(isl, "ps")
        isl.win_update_then_collect("ps")  # nobody deposits any more
        isl.barrier()
        p = isl.win_associated_p("ps")
        avg = np.asarray(isl.win_sync("ps")) / p
        isl.win_free("ps")
        isl.turn_off_win_ops_with_associated_p()
        # the job mutex excludes across packages
        for _ in range(10):
            with isl.win_mutex("m", ranks=[0]):
                with open(path, "a") as f:
                    f.write(f"{rank} start\n")
                    f.flush()
                    time.sleep(0.001)
                    f.write(f"{rank} end\n")
        q.put((rank, True, (diffused, avg, p)))
        isl.barrier()
        isl.shutdown(unlink=(rank == 0))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, f"{e}\n{traceback.format_exc()}"))


@pytest.mark.parametrize("fallback", ["0", "1"])
def test_mixed_fleet_jax_and_torch_islands_share_one_job(fallback, monkeypatch, tmp_path):
    monkeypatch.setenv("BLUEFOG_SHM_FALLBACK", fallback)
    monkeypatch.setenv("BFTPU_STATUSPAGE", "0")
    size, steps = 4, 7
    job = f"tmix{os.getpid()}_{fallback}"
    path = str(tmp_path / "mutex.log")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_fleet_member,
                         args=("jax" if r < 2 else "torch", r, size, job, steps, path, q))
             for r in range(size)]
    for p in procs:
        p.start()
    results, failures = {}, []
    try:
        for _ in range(size):
            r, ok, out = q.get(timeout=300)
            (results.__setitem__(r, out) if ok else failures.append(out))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job)
    assert not failures, "\n".join(failures)
    W = np.linalg.matrix_power(_ring_w(size), steps)
    x0 = np.stack([np.arange(3, dtype=np.float64) + r for r in range(size)])
    expected = W @ x0
    mean = np.mean([r * 10.0 for r in range(size)])
    for r in range(size):
        diffused, avg, p = results[r]
        np.testing.assert_allclose(diffused, expected[r], rtol=0, atol=1e-12)
        assert p > 0
        np.testing.assert_allclose(avg, np.full(3, mean), rtol=0, atol=1e-8)
    # mass conservation across the two packages: the slots are drained
    np.testing.assert_allclose(sum(results[r][2] for r in range(size)), size,
                               rtol=0, atol=1e-12)
    lines = open(path).read().splitlines()
    assert len(lines) == 2 * size * 10
    for i in range(0, len(lines), 2):
        (r0, k0), (r1, k1) = lines[i].split(), lines[i + 1].split()
        assert (k0, k1) == ("start", "end") and r0 == r1, f"interleaved at line {i}"


# ---------------------------------------------------------------------------
# port-only suites (workers are top-level: spawn pickles them by reference)
# ---------------------------------------------------------------------------


def _diffuse(rank, size, steps):
    islands.set_topology(topology_util.RingGraph(size))
    x = torch.arange(3, dtype=torch.float64) + rank
    islands.win_create(x, "d")
    for _ in range(steps):
        islands.win_put(islands.win_sync("d"), "d")
        islands.barrier()
        islands.win_update("d")
        islands.barrier()
    kind = type(islands.win_sync("d")).__name__
    out = islands.win_sync("d").clone()
    islands.win_free("d")
    return out.numpy(), kind, type(out).__name__


def _get(rank, size):
    islands.set_topology(topology_util.RingGraph(size))
    islands.win_create(np.full((2,), float(rank), np.float64), "g", zero_init=True)
    islands.barrier()
    islands.win_get("g")
    islands.barrier()
    out = islands.win_update("g")
    islands.win_free("g")
    return np.array(out, copy=True)


def _versions(rank, size):
    islands.set_topology(topology_util.RingGraph(size))
    islands.win_create(np.zeros(2), "v")
    for i in range(5):
        islands.win_put(np.full(2, float(i)), "v")
    islands.barrier()
    ver = islands.get_win_version("v")
    islands.win_free("v")
    return ver


def _pushsum(rank, size, steps):
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.turn_on_win_ops_with_associated_p()
    islands.win_create(torch.full((3,), float(rank * 10), dtype=torch.float64), "ps",
                       zero_init=True)
    rng = np.random.default_rng(rank)
    for _ in range(steps):
        islands.push_sum_round("ps")
        time.sleep(float(rng.random()) * 0.002)  # genuine desynchronization
    islands.barrier()
    for _ in range(25):  # 3x a round on ExponentialTwoGraph(4)
        _barriered_push_sum_round(islands, "ps")
    islands.win_update_then_collect("ps")  # nobody deposits any more
    islands.barrier()
    p = islands.win_associated_p("ps")
    val = islands.win_sync("ps") / p
    islands.win_free("ps")
    islands.turn_off_win_ops_with_associated_p()
    return val.numpy().copy(), p


def _fused_and_async(rank, size):
    islands.set_topology(topology_util.RingGraph(size))
    tree = {"b": torch.full((4,), float(rank)), "w": torch.full((2, 3), float(rank))}
    islands.win_create(tree, "ft")
    islands.barrier()
    islands.win_put(tree, "ft")
    islands.barrier()
    out = islands.win_update("ft")
    islands.barrier()
    sync = islands.win_sync("ft")
    fused = (float(out["w"][0, 0]), float(out["b"][0]), tuple(sync["w"].shape),
             tuple(sync["b"].shape), type(out["w"]).__name__)
    # the async surface through the progress engine: a barriered round
    hp = islands.win_put_async(out, "ft")
    hp.result(timeout=60)
    islands.barrier()
    upd = islands.win_update_async("ft").result(timeout=60)
    islands.barrier()
    islands.win_free("ft")
    return fused, float(upd["w"][1, 2])


def _deterministic_suite(rank, size, steps):
    bcast = islands.broadcast_parameters(
        {"a": torch.full((3,), float(rank)), "b": torch.arange(2.0, dtype=torch.float64) * rank,
         "n": torch.tensor([rank, 7 * rank], dtype=torch.int64),
         "h": np.full((2,), rank, np.float32)}, root=1)
    return (_diffuse(rank, size, steps), _get(rank, size), _versions(rank, size),
            {k: (np.asarray(v).tolist(), type(v).__name__, str(v.dtype))
             for k, v in bcast.items()},
            _pushsum(rank, size, 40), _fused_and_async(rank, size))


def test_port_deterministic_suite():
    """Barriered diffusion matches the analytic W^k trajectory (and comes
    back as a tensor); win_get pull-combine matches the closed form; deposit
    versions count; broadcast_parameters keeps kinds and dtypes; async
    push-sum lands on the exact average; the fused tree window gossips like
    the per-array one, synchronously and through the progress engine."""
    size, steps = 4, 7
    res = islands.spawn(_deterministic_suite, size, args=(steps,), timeout=300.0)
    topo = topology_util.RingGraph(size)
    expected = np.linalg.matrix_power(_ring_w(size), steps) @ np.stack(
        [np.arange(3, dtype=np.float64) + r for r in range(size)])
    W1 = _ring_w(size) @ np.arange(size, dtype=np.float64)
    W2 = _ring_w(size) @ W1
    mean = np.mean([r * 10.0 for r in range(size)])
    np.testing.assert_allclose(sum(r[4][1] for r in res), size, rtol=0, atol=1e-12)
    for d in range(size):
        (diffused, kind, kind2), pulled, versions, bcast, (val, p), (fused, upd) = res[d]
        np.testing.assert_allclose(diffused, expected[d], rtol=0, atol=1e-12)
        assert kind == kind2 == "Tensor"
        nbrs = sorted(topo.predecessors(d))
        u = 1.0 / (len(nbrs) + 1)
        np.testing.assert_allclose(pulled, np.full(2, u * d + sum(u * s for s in nbrs)),
                                   atol=1e-12)
        assert versions == {s: 6 for s in nbrs}, versions
        assert bcast["a"] == ([1.0] * 3, "Tensor", "torch.float32")
        assert bcast["b"] == ([0.0, 1.0], "Tensor", "torch.float64")
        assert bcast["n"] == ([1, 7], "Tensor", "torch.int64")
        assert bcast["h"] == ([1.0, 1.0], "ndarray", "float32")
        assert p > 0
        np.testing.assert_allclose(val, np.full(3, mean), rtol=0, atol=1e-8)
        w00, b0, wshape, bshape, leaf_kind = fused
        assert (wshape, bshape, leaf_kind) == ((2, 3), (4,), "Tensor")
        np.testing.assert_allclose([w00, b0], [W1[d]] * 2, rtol=1e-6)
        np.testing.assert_allclose(upd, W2[d], rtol=1e-6)


def _routed_suite(rank, size, steps):
    assert os.environ.get("BLUEFOG_ISLAND_HOSTMAP") == "a,a,b,b"
    diffused = _diffuse(rank, size, steps)[0]
    pushed = _pushsum(rank, size, 30)
    pulled = _get(rank, size)
    islands.win_create(np.zeros(2), "g", zero_init=True)
    fresh = np.array(islands.win_update("g"), copy=True)
    islands.win_free("g")
    return diffused, pushed, pulled, fresh


def test_port_hierarchical_transport_suite(monkeypatch):
    """shm intra-host + TCP inter-host in one window: the ring 0-1-2-3 has
    intra-host edges 0<->1, 2<->3 and inter-host edges 1<->2, 3<->0."""
    monkeypatch.setenv("BLUEFOG_ISLAND_HOSTMAP", "a,a,b,b")
    size, steps = 4, 6
    res = islands.spawn(_routed_suite, size, args=(steps,), timeout=300.0)
    topo = topology_util.RingGraph(size)
    expected = np.linalg.matrix_power(_ring_w(size), steps) @ np.stack(
        [np.arange(3, dtype=np.float64) + r for r in range(size)])
    mean = np.mean([r * 10.0 for r in range(size)])
    for d in range(size):
        diffused, (val, p), pulled, fresh = res[d]
        np.testing.assert_allclose(diffused, expected[d], atol=1e-12)
        assert p > 0
        np.testing.assert_allclose(val, np.full(3, mean), rtol=0, atol=1e-8)
        nbrs = sorted(topo.predecessors(d))
        u = 1.0 / (len(nbrs) + 1)
        np.testing.assert_allclose(pulled, np.full(2, u * d + sum(u * s for s in nbrs)),
                                   atol=1e-12)
        np.testing.assert_allclose(fresh, np.zeros(2), atol=0)


def _winput_opt(rank, size, free_steps, lockstep, overlap):
    """SGD on the per-rank quadratic 0.5 * (w - c_r)^2, c_r = rank, through
    the island win-put optimizer; returns (w before settle, w after settle,
    b, pending seen after a step)."""
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    c = float(rank)
    w = torch.full((3,), 10.0 + rank, dtype=torch.float32, requires_grad=True)
    b = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    opt = islands.DistributedWinPutOptimizer(
        torch.optim.SGD([w, b], lr=0.2), window_prefix=f"opt{int(overlap)}",
        num_steps_per_communication=1, overlap=overlap)
    pending_seen = True

    def one_step():
        nonlocal pending_seen
        opt.zero_grad()
        (0.5 * ((w - c) ** 2).sum() + 0.0 * b.sum()).backward()
        opt.step()
        pending_seen = pending_seen and (opt._pending is not None) == overlap

    for _ in range(free_steps):  # free-running: no barrier
        one_step()
    islands.barrier()
    for _ in range(lockstep):    # bounded staleness: one barrier a step
        one_step()
        islands.barrier()
    opt.finish()
    assert opt._pending is None
    before = w.detach().clone().numpy()
    islands.barrier()
    opt.settle(rounds=30)
    out = (before, w.detach().clone().numpy(), b.detach().clone().numpy(), pending_seen)
    opt.free()
    return out


def _winput_both(rank, size, free_steps, lockstep):
    return [_winput_opt(rank, size, free_steps, lockstep, overlap)
            for overlap in (False, True)]


def test_port_winput_optimizer_converges_overlap_off_and_on():
    size = 4
    res = islands.spawn(_winput_both, size, args=(10, 80), timeout=300.0)
    target = (size - 1) / 2.0  # mean of the per-rank optima
    for arm in (0, 1):
        before = np.stack([r[arm][0] for r in res])
        after = np.stack([r[arm][1] for r in res])
        # barriered settle rounds preserve the mean (W is doubly stochastic)
        # and contract to consensus (|lambda_2| = 1/3 on ExponentialTwoGraph(4))
        np.testing.assert_allclose(after.mean(axis=0), before.mean(axis=0), atol=1e-5)
        assert after.std(axis=0).max() < 1e-5, after
        # the lockstep phase lands on the fixed point, whose mean is mean(c)
        assert np.all(np.abs(after - target) < 0.05), (arm, after)
        for r in res:
            np.testing.assert_array_equal(r[arm][2], np.zeros(2))
            assert r[arm][3], "overlap=True leaves the round in flight after step()"


def test_winput_optimizer_pack_layout_matches_reference(monkeypatch):
    """The port packs a window group as the reference's optimizer packs it:
    groups by dtype in ``str(dtype)`` order, leaves in parameter order."""
    import optax

    from bluefog_tpu import islands as jislands

    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(dt) for s, dt in
              [((3, 2), np.float32), ((4,), np.float64), ((5,), np.float32),
               ((2, 2), np.float64), ((1,), np.float32)]]
    got, want = {}, {}
    monkeypatch.setattr(jislands, "win_create",
                        lambda t, name, zero_init=False: want.setdefault(name, np.array(t)) is not None)
    monkeypatch.setattr(islands, "win_create",
                        lambda t, name, zero_init=False: got.setdefault(
                            name, t.detach().numpy().copy()) is not None)
    jopt = jislands.DistributedWinPutOptimizer(optax.sgd(0.1), window_prefix="p")
    jopt.init(list(leaves))
    params = [torch.nn.Parameter(torch.from_numpy(l.copy())) for l in leaves]
    topt = islands.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.1),
                                              window_prefix="p")
    assert sorted(got) == sorted(want) == ["p.0", "p.1"]
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert [g[0] for g in topt._groups] == [g[0] for g in jopt._groups]


def test_async_islands_example_on_the_cpu():
    from bluefog_tpu_torch.examples import async_islands

    out = async_islands.run(nranks=4, iters=30, sleep=0.001, device="cpu")
    assert out["ok"], out
    assert max(out["consensus_err"]) < async_islands.CONSENSUS_TOL


def _worker_boom(rank, size):
    if rank == 1:
        raise ValueError("intentional")
    return True


def _worker_dies(rank, size):
    if rank == 1:
        os._exit(3)  # dies without reporting, as a child that cannot start
    return True


def _worker_hangs(rank, size):
    if rank == 1:
        time.sleep(600)  # never reports
    return True


def test_spawn_timeout_dumps_the_stacks_of_ranks_that_never_reported(capfd):
    """A rank that never reports is asked for its stacks before the spawn
    gives up: they show where it hung."""
    with pytest.raises(RuntimeError, match="timeout waiting for island results"):
        islands.spawn(_worker_hangs, 2, timeout=30.0)
    err = capfd.readouterr().err
    assert "_worker_hangs" in err and "Thread" in err, err[-2000:]


def test_spawn_surfaces_child_failure_and_death():
    with pytest.raises(RuntimeError, match="intentional"):
        islands.spawn(_worker_boom, 2, timeout=120.0)
    # a child that exits without reporting fails the spawn at once, not at
    # the end of the timeout
    with pytest.raises(RuntimeError, match="rank 1: exited with code 3"):
        islands.spawn(_worker_dies, 2, timeout=600.0)
