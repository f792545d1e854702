"""The machine hierarchy of bluefog_tpu_torch against the JAX package on the
8-device CPU mesh, 4 machines x 2 ranks: the machine API (explicit
``local_size`` and ``BLUEFOG_SIMULATE_SLICES``),
``hierarchical_neighbor_allreduce``, the ATC / AWC optimizers with
hierarchical communication, the hierarchical train step and
``steps_per_call``, and the optimizers' plans (the installed topology's at
each step, ``step(plan=)``).  Same numpy inputs on both sides; float32
within rtol 1e-5 / atol 1e-6 (sums in other orders, over a few steps),
bfloat16 within 2^-7."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.optim import CommunicationType as JComm
from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.optim import CommunicationType, one_peer_plan_schedule
from bluefog_tpu_torch.training import make_decentralized_train_step, replicate_for_mesh

torch.set_num_threads(1)
N, M, L = 8, 4, 2
HIER = "hierarchical_neighbor_allreduce"


@pytest.fixture
def contexts(devices):
    jbf.init(local_size=L)
    tbf.init(size=N, local_size=L, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _x(seed, shape=(N, 3, 4)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# the machine API
# --------------------------------------------------------------------------


def test_machine_api_matches_reference(contexts):
    assert (tbf.local_size(), tbf.machine_size()) == (L, M)
    assert (jbf.local_size(), jbf.machine_size()) == (L, M)
    assert (tbf.local_rank(), tbf.machine_rank()) == (jbf.local_rank(), jbf.machine_rank())
    assert tbf.unified_mpi_window_model_supported() is True
    assert tbf.is_machine_topo_weighted() == jbf.is_machine_topo_weighted()
    assert ttu.IsTopologyEquivalent(tbf.load_machine_topology(), ttu.ExponentialTwoGraph(M))
    for topo in ("ExponentialTwoGraph", "RingGraph", "StarGraph"):
        jbf.set_machine_topology(getattr(jtu, topo)(M))
        assert tbf.set_machine_topology(getattr(ttu, topo)(M))
        for m in range(M):
            assert tbf.in_neighbor_machine_ranks(m) == jbf.in_neighbor_machine_ranks(m)
            assert tbf.out_neighbor_machine_ranks(m) == jbf.out_neighbor_machine_ranks(m)
        assert tbf.in_neighbor_machine_ranks() == jbf.in_neighbor_machine_ranks()
    with pytest.raises(ValueError, match="machine size is 4"):
        tbf.set_machine_topology(ttu.RingGraph(N))


@pytest.mark.parametrize("slices,local_size", [("2", None), ("4", None), ("8", None),
                                               ("1", None), (None, None), ("2", 4),
                                               ("4", 1)])
def test_machine_grid_matches_reference(devices, monkeypatch, slices, local_size):
    """An explicit ``local_size`` wins; else ``BLUEFOG_SIMULATE_SLICES=k``
    makes k machines; else one machine, with no machine topology."""
    if slices is None:
        monkeypatch.delenv("BLUEFOG_SIMULATE_SLICES", raising=False)
    else:
        monkeypatch.setenv("BLUEFOG_SIMULATE_SLICES", slices)
    jbf.init(local_size=local_size)
    tbf.init(size=N, local_size=local_size, device="cpu")
    try:
        assert tbf.machine_size() == jbf.machine_size()
        assert tbf.local_size() == jbf.local_size()
        assert (tbf.load_machine_topology() is None) == (jbf.load_machine_topology() is None)
        if tbf.machine_size() == 1:
            assert tbf.in_neighbor_machine_ranks() == [] == jbf.in_neighbor_machine_ranks()
            with pytest.raises(RuntimeError, match="no machine topology"):
                tbf.hierarchical_neighbor_allreduce(torch.zeros(N, 2))
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_machine_grid_rejects_what_does_not_divide(monkeypatch):
    monkeypatch.setenv("BLUEFOG_SIMULATE_SLICES", "3")
    with pytest.raises(ValueError, match="does not divide"):
        tbf.init(size=N, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tbf.init(size=N, local_size=3, device="cpu")


# --------------------------------------------------------------------------
# hierarchical_neighbor_allreduce
# --------------------------------------------------------------------------


@pytest.mark.parametrize("self_weight", [None, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("topo", ["RingGraph", "ExponentialTwoGraph"])
def test_hierarchical_neighbor_allreduce_matches_reference(contexts, topo, dtype, self_weight):
    jbf.set_machine_topology(getattr(jtu, topo)(M))
    tbf.set_machine_topology(getattr(ttu, topo)(M))
    x = _x(1)
    if dtype == "int32":
        x = (x * 10).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tbf.hierarchical_neighbor_allreduce(tx, self_weight)
    want = jbf.hierarchical_neighbor_allreduce(jx, self_weight=self_weight)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.dtype == (torch.float32 if dtype == "int32" else tx.dtype)
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    _close(got.float(), want.astype(jnp.float32), rtol=tol, atol=tol)
    for m in range(M):  # the ranks of a machine agree exactly
        assert torch.equal(got[L * m], got[L * m + 1])


def test_hierarchical_machines_are_machine_major(contexts):
    """Machine m holds ranks 2m and 2m + 1 (a [L, M] reshape would pass at
    2 x 2 and fail here, at 4 x 2)."""
    tbf.set_machine_topology(ttu.RingGraph(M))
    x = torch.arange(N, dtype=torch.float32)[:, None].repeat(1, 3)
    out = tbf.hierarchical_neighbor_allreduce(x)
    local = np.array([2 * m + 0.5 for m in range(M)])
    want = np.repeat(ttu.GetWeightMatrix(ttu.RingGraph(M)) @ local, L)
    np.testing.assert_allclose(out[:, 0].numpy(), want, rtol=1e-6)


def test_hierarchical_tree_input(contexts):
    tree = {"a": torch.from_numpy(_x(2)), "b": [torch.from_numpy(_x(3, (N, 5)))]}
    jtree = {"a": jnp.asarray(_x(2)), "b": [jnp.asarray(_x(3, (N, 5)))]}
    got = tbf.hierarchical_neighbor_allreduce(tree)
    want = jbf.hierarchical_neighbor_allreduce(jtree)
    _close(got["a"], want["a"])
    _close(got["b"][0], want["b"][0])


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------


def _jax_opt_run(opt, w, grads, plans=None):
    params = {"w": jnp.asarray(w)}
    state = opt.init(params)
    for t, g in enumerate(grads):
        kw = {} if plans is None else {"plan": plans[t % len(plans)]}
        params, state = opt.step(params, {"w": jnp.asarray(g)}, state, **kw)
    return np.asarray(params["w"])


def _port_opt_run(cls, w, grads, plans=None, lr=0.1, **kw):
    p = torch.from_numpy(w.copy()).requires_grad_(True)
    opt = cls(torch.optim.SGD([p], lr=lr, momentum=0.9), **kw)
    for t, g in enumerate(grads):
        p.grad = torch.from_numpy(g)
        opt.step(**({} if plans is None else {"plan": plans[t % len(plans)]}))
    return p.detach().numpy()


@pytest.mark.parametrize("mode", ["atc", "awc"])
def test_hierarchical_optimizer_matches_reference(contexts, mode):
    """Three momentum-SGD steps with hierarchical communication against the
    JAX eager optimizer's, built here; the ranks of a machine agree."""
    jcls = {"atc": jbf.DistributedAdaptThenCombineOptimizer,
            "awc": jbf.DistributedAdaptWithCombineOptimizer}[mode]
    tcls = {"atc": tbf.DistributedAdaptThenCombineOptimizer,
            "awc": tbf.DistributedAdaptWithCombineOptimizer}[mode]
    jbf.set_machine_topology(jtu.RingGraph(M))
    tbf.set_machine_topology(ttu.RingGraph(M))
    w, grads = _x(4), [_x(5 + t) for t in range(3)]
    want = _jax_opt_run(jcls(optax.sgd(0.1, momentum=0.9),
                             communication_type=JComm.hierarchical_neighbor_allreduce), w, grads)
    got = _port_opt_run(tcls, w, grads, communication_type=CommunicationType[HIER])
    _close(got, want)
    if mode == "atc":
        for m in range(M):
            np.testing.assert_array_equal(got[L * m], got[L * m + 1])


def test_optimizer_without_plan_follows_set_topology(contexts):
    """C3: built with no plan, ATC reads the installed topology at each step,
    so ``set_topology`` between steps takes effect.  The reference's eager
    optimizer means to (it reads ``ctx.plan`` in ``_transform``), but its
    ``step`` keys the compiled step on the plan seen before that read and
    keeps its first plan; so the port is held against the reference's
    ``step(plan=)`` with the plan installed at that step."""
    w, grads = _x(6), [_x(7 + t) for t in range(3)]
    topos = ["ExponentialTwoGraph", "RingGraph", "StarGraph"]
    jopt = jbf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.1, momentum=0.9))
    params = {"w": jnp.asarray(w)}
    state = jopt.init(params)
    p = torch.from_numpy(w.copy()).requires_grad_(True)
    topt = tbf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([p], lr=0.1, momentum=0.9))
    for topo, g in zip(topos, grads):
        jbf.set_topology(getattr(jtu, topo)(N))
        tbf.set_topology(getattr(ttu, topo)(N))
        params, state = jopt.step(params, {"w": jnp.asarray(g)}, state,
                                  plan=jbasics.context().plan)
        before = p.detach().clone()
        p.grad = torch.from_numpy(g)
        topt.step()
        _close(p.detach().numpy(), params["w"])
        assert not torch.allclose(p.detach(), before)
    W = torch.from_numpy(ttu.GetWeightMatrix(ttu.StarGraph(N))).float()
    torch.testing.assert_close(W, torch.from_numpy(tbf.context().plan.mixing_matrix()).float())


@pytest.mark.parametrize("mode", ["atc", "awc"])
def test_step_plan_override_matches_reference(contexts, mode):
    """C3: ``step(plan=)`` over ``one_peer_plan_schedule(8)`` against the JAX
    optimizer's ``step(plan=)``, four steps."""
    jcls = {"atc": jbf.DistributedAdaptThenCombineOptimizer,
            "awc": jbf.DistributedAdaptWithCombineOptimizer}[mode]
    tcls = {"atc": tbf.DistributedAdaptThenCombineOptimizer,
            "awc": tbf.DistributedAdaptWithCombineOptimizer}[mode]
    jplans, tplans = jbf.one_peer_plan_schedule(N), one_peer_plan_schedule(N)
    assert len(jplans) == len(tplans) == 3
    for jp, tp in zip(jplans, tplans):
        np.testing.assert_array_equal(jp.mixing_matrix(), tp.mixing_matrix())
    w, grads = _x(10), [_x(11 + t) for t in range(4)]
    want = _jax_opt_run(jcls(optax.sgd(0.1, momentum=0.9)), w, grads, jplans)
    got = _port_opt_run(tcls, w, grads, tplans)
    _close(got, want)


def test_step_plan_override_checks(contexts):
    p = torch.zeros(N, 2, requires_grad=True)
    p.grad = torch.zeros_like(p)
    opt = tbf.DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([p], lr=0.1), communication_type=CommunicationType[HIER])
    with pytest.raises(ValueError, match="requires neighbor_allreduce"):
        opt.step(plan=tbf.context().plan)
    opt = tbf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([p], lr=0.1))
    with pytest.raises(ValueError, match="plan is for 4 ranks"):
        opt.step(plan=one_peer_plan_schedule(4)[0])
    with pytest.raises(ValueError, match="fuse=True"):
        tbf.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([p], lr=0.1), communication_type=CommunicationType.allreduce,
            fuse=True)


def test_reproducer_atc_with_no_plan(contexts):
    """The reproducer of C3: an ATC optimizer over a plain SGD, no plan."""
    w = torch.from_numpy(_x(15, (N, 3))).requires_grad_(True)
    before = w.detach().clone()
    opt = tbf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([w], lr=0.0))
    w.grad = torch.ones_like(w)
    opt.step()
    W = torch.from_numpy(tbf.context().plan.mixing_matrix()).float()
    torch.testing.assert_close(w.detach(), W @ before)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def _mlp_params(seed, din=8, dh=16, nclass=4):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(din, dh)) * 0.3).astype(np.float32),
            "b1": np.zeros(dh, np.float32),
            "w2": (rng.normal(size=(dh, nclass)) * 0.3).astype(np.float32),
            "b2": np.zeros(nclass, np.float32)}


def _jax_mlp(variables, x):
    p = variables["params"]
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _port_mlp(state, x):
    return torch.tanh(x @ state["w1"] + state["b1"]) @ state["w2"] + state["b2"]


def _batches(steps, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(steps, N, 8, 8)).astype(np.float32),
            rng.integers(0, 4, size=(steps, N, 8)))


def _port_step(comm, mode="atc", steps_per_call=1, seed=1):
    params = replicate_for_mesh({k: torch.from_numpy(v) for k, v in _mlp_params(seed).items()}, N)
    ctx = tbf.context()
    step = make_decentralized_train_step(
        _port_mlp, params, torch.optim.SGD(list(params.values()), lr=0.05), mode=mode,
        communication_type=CommunicationType[comm], plan=ctx.plan,
        machine_plan=ctx.machine_plan if comm == HIER else None,
        steps_per_call=steps_per_call)
    return params, step


@pytest.mark.parametrize("mode", ["atc", "awc"])
def test_hierarchical_train_step_matches_reference(contexts, mode):
    """Two steps of the MLP of tests/test_training.py on the hierarchical
    mesh against ``make_decentralized_train_step(..., ctx.hier_mesh,
    machine_plan=)``: losses and every rank's parameters."""
    ctx = jbasics.context()
    x, y = _batches(2)
    jparams = jax_replicate({k: jnp.asarray(v) for k, v in _mlp_params(1).items()}, N)
    init_fn, jstep = jax_train_step(
        _jax_mlp, optax.sgd(0.05), ctx.hier_mesh, mode=mode,
        communication_type=JComm.hierarchical_neighbor_allreduce,
        machine_plan=ctx.machine_plan, donate=False)
    state = init_fn(jparams)
    params, step = _port_step(HIER, mode)
    for s in range(2):
        jparams, _, state, jloss, _ = jstep(jparams, {}, state, jnp.asarray(x[s]),
                                            jnp.asarray(y[s], jnp.int32))
        loss, _ = step(torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        _close(loss, jloss)
    for k, v in params.items():
        _close(v.detach(), jparams[k])
    if mode == "atc":
        w1 = params["w1"].detach()
        for m in range(M):
            assert torch.equal(w1[L * m], w1[L * m + 1])


@pytest.mark.parametrize("comm", [HIER, "neighbor_allreduce", "allreduce"])
def test_steps_per_call_equals_single_steps(contexts, comm):
    """``steps_per_call=2`` on a ``[2, N, ...]`` batch gives exactly what two
    single calls give; the last sub-step's losses come back."""
    x, y = _batches(2, seed=3)
    p1, single = _port_step(comm)
    for s in range(2):
        want_loss, want_acc = single(torch.from_numpy(x[s]), torch.from_numpy(y[s]))
    p2, double = _port_step(comm, steps_per_call=2)
    loss, acc = double(torch.from_numpy(x), torch.from_numpy(y))
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=0)
    torch.testing.assert_close(acc, want_acc, rtol=0, atol=0)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"leading \[2\] sub-step axis"):
        double(torch.from_numpy(x[0]), torch.from_numpy(y[0]))


def test_steps_per_call_matches_reference(contexts):
    """``steps_per_call=2`` against the JAX train step's, on the flat mesh."""
    ctx = jbasics.context()
    x, y = _batches(2, seed=4)
    jparams = jax_replicate({k: jnp.asarray(v) for k, v in _mlp_params(1).items()}, N)
    init_fn, jstep = jax_train_step(_jax_mlp, optax.sgd(0.05), ctx.mesh, plan=ctx.plan,
                                    donate=False, steps_per_call=2)
    jparams, _, _, jloss, _ = jstep(jparams, {}, init_fn(jparams), jnp.asarray(x),
                                    jnp.asarray(y, jnp.int32))
    params, step = _port_step("neighbor_allreduce", steps_per_call=2)
    loss, _ = step(torch.from_numpy(x), torch.from_numpy(y))
    _close(loss, jloss)
    for k, v in params.items():
        _close(v.detach(), jparams[k])


def test_train_step_needs_its_plan(contexts):
    """The reference's contract: no ``plan`` for neighbor_allreduce, no
    ``machine_plan`` for the hierarchical mode, raise."""
    params = replicate_for_mesh({"w": torch.zeros(3)}, N)
    opt = torch.optim.SGD(list(params.values()), lr=0.1)
    with pytest.raises(ValueError, match="needs a CommPlan"):
        make_decentralized_train_step(_port_mlp, params, opt)
    with pytest.raises(ValueError, match="needs a machine CommPlan"):
        make_decentralized_train_step(_port_mlp, params, opt,
                                      communication_type=CommunicationType[HIER])


# --------------------------------------------------------------------------
# the slice's entry points on the CPU
# --------------------------------------------------------------------------


def test_benchmark_example_runs_every_mode(monkeypatch):
    """examples/benchmark.py at its tiny model, machines from
    BLUEFOG_SIMULATE_SLICES, as the reference's single-process run."""
    from bluefog_tpu_torch.examples import benchmark

    monkeypatch.setenv("BLUEFOG_SIMULATE_SLICES", "2")
    for mode in sorted(benchmark.MODES):
        out = benchmark.main(["--model", "tiny", "--mode", mode, "--iters", "1",
                              "--warmup", "1", "--device", "cpu"])
        assert out["machines"] == 2 and out["images_per_s"] > 0


def test_resnet_benchmark_times_the_hierarchical_mode():
    from bluefog_tpu_torch.benchmarks import resnet50

    out = resnet50.main(["--device", "cpu", "--image", "32", "--classes", "10", "--batch",
                         "2", "--filters", "8", "--steps", "1", "--warmup", "0"])
    assert out["config"]["machines"] == 2 and out["config"]["local_size"] == 2
    for mode in resnet50.MODES:
        assert len(out[mode]["images_per_s"]) == 2
        assert np.isfinite(out[mode]["last_losses"]).all()
    assert out["hierarchical_over_allreduce"] > 0
