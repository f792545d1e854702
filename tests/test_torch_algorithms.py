"""The exact algorithms (gradient tracking, EXTRA, Push-DIGing) and the
plans they and the win-put optimizer use, bluefog_tpu_torch against the
JAX package on the heterogeneous quadratics of ``tests/test_algorithms.py``
(the same numpy draws).  Iterates agree within rtol 1e-5 / atol 1e-6 after
a few steps (f32 sums in another order); the convergence cases hold the
port alone to the reference test's own tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.algorithms import column_stochastic_plan as jax_column_plan
from bluefog_tpu_torch import algorithms as talg
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core import basics as tbasics

torch.set_num_threads(1)
SIZE, DIM, LR, ITERS = 8, 6, 0.05, 600
JAX_OPT = {"gt": jbf.DistributedGradientTrackingOptimizer,
           "extra": jbf.DistributedEXTRAOptimizer,
           "pushdiging": jbf.DistributedPushDIGingOptimizer}
PORT_OPT = {"gt": tbf.DistributedGradientTrackingOptimizer,
            "extra": tbf.DistributedEXTRAOptimizer,
            "pushdiging": tbf.DistributedPushDIGingOptimizer}


def heterogeneous_quadratics(rng):
    """Per-rank f_r(w) = 0.5 (w - c_r)^T A_r (w - c_r) (the reference
    test's draws): A [SIZE, DIM, DIM], c [SIZE, DIM] f32 and the global
    optimum w* in float64."""
    As, cs = [], []
    for _ in range(SIZE):
        M = rng.normal(size=(DIM, DIM))
        As.append(M @ M.T / DIM + np.eye(DIM))
        cs.append(rng.normal(size=(DIM,)) * 3.0)
    A, c = np.stack(As), np.stack(cs)
    w_star = np.linalg.solve(A.sum(0), np.einsum("rij,rj->i", A, c))
    return A.astype(np.float32), c.astype(np.float32), w_star


def directed_irregular_graph(G):
    """A ring plus the edges 0 -> 2 and 0 -> 4 on an empty digraph ``G``."""
    G.add_nodes_from(range(SIZE))
    for r in range(SIZE):
        G.add_edge(r, (r + 1) % SIZE)
    G.add_edge(0, 2)
    G.add_edge(0, 4)
    return G


def run_port(opt, A, c, iters):
    A, c = torch.from_numpy(A), torch.from_numpy(c)
    params = {"w": torch.zeros(SIZE, DIM)}
    state = opt.init(params)
    for _ in range(iters):
        grads = {"w": torch.einsum("rij,rj->ri", A, params["w"] - c)}
        params, state = opt.step(params, grads, state)
    return params["w"].double().numpy()


def run_jax(opt, A, c, iters):
    grad_fn = jax.jit(jax.vmap(lambda w, A_r, c_r: A_r @ (w - c_r)))
    A, c = jnp.asarray(A), jnp.asarray(c)
    params = {"w": jnp.zeros((SIZE, DIM))}
    state = opt.init(params)
    for _ in range(iters):
        params, state = opt.step(params, {"w": grad_fn(params["w"], A, c)}, state)
    return np.asarray(params["w"], np.float64)


@pytest.fixture
def port():
    tbf.init(size=SIZE, device="cpu")
    yield
    tbf.shutdown()


@pytest.mark.parametrize("iters", [1, 2, 7])
@pytest.mark.parametrize("algo", sorted(JAX_OPT))
def test_iterates_match_reference(devices, algo, iters):
    A, c, _ = heterogeneous_quadratics(np.random.default_rng(0))
    jbf.init()
    try:
        jbf.set_topology(jtu.ExponentialTwoGraph(SIZE))
        want = run_jax(JAX_OPT[algo](LR), A, c, iters)
    finally:
        jbf.shutdown()
    tbf.init(ttu.ExponentialTwoGraph(SIZE), size=SIZE, device="cpu")
    try:
        got = run_port(PORT_OPT[algo](LR), A, c, iters)
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_push_diging_iterates_match_on_a_directed_graph(devices):
    import networkx as nx

    A, c, _ = heterogeneous_quadratics(np.random.default_rng(1))
    jG, tG = directed_irregular_graph(nx.DiGraph()), directed_irregular_graph(ttu.DiGraph())

    class _Jax(jbf.DistributedPushDIGingOptimizer):
        def _plan(self, ctx):
            return jax_column_plan(jG)

    class _Port(tbf.DistributedPushDIGingOptimizer):
        def _plan(self, ctx):
            return talg.column_stochastic_plan(tG)

    jbf.init()
    try:
        want = run_jax(_Jax(LR), A, c, 9)
    finally:
        jbf.shutdown()
    tbf.init(size=SIZE, device="cpu")
    try:
        got = run_port(_Port(LR), A, c, 9)
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_column_stochastic_plan_matches_reference():
    import networkx as nx

    want = jax_column_plan(directed_irregular_graph(nx.DiGraph()))
    got = talg.column_stochastic_plan(directed_irregular_graph(ttu.DiGraph()))
    np.testing.assert_allclose(got.mixing_matrix(), want.mixing_matrix(), rtol=1e-12)
    np.testing.assert_allclose(got.mixing_matrix().sum(0), 1.0, rtol=1e-12)
    assert got.in_neighbors == want.in_neighbors and got.out_neighbors == want.out_neighbors


def test_one_peer_plan_schedule_matches_reference():
    for size in (1, 5, 8):
        want = jbf.one_peer_plan_schedule(size)
        got = tbf.one_peer_plan_schedule(size)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.mixing_matrix(), w.mixing_matrix(), rtol=1e-12)
            assert len(g.classes) == len(w.classes)


@pytest.mark.parametrize("algo", ["gt", "extra"])
def test_exact_methods_reach_centralized_optimum(port, algo):
    """The reference test on the port: 600 steps on ExponentialTwoGraph(8),
    spread and distance to w* under 1e-4 (GT) and 1e-3 (EXTRA)."""
    tbf.set_topology(ttu.ExponentialTwoGraph(SIZE))
    A, c, w_star = heterogeneous_quadratics(np.random.default_rng(0))
    w = run_port(PORT_OPT[algo](LR), A, c, ITERS)
    tol = 1e-4 if algo == "gt" else 1e-3
    assert np.abs(w - w.mean(0)).max() < tol
    assert np.abs(w.mean(0) - w_star).max() < tol


def test_push_diging_reaches_optimum_on_directed_graph(port):
    G = directed_irregular_graph(ttu.DiGraph())

    class _Opt(tbf.DistributedPushDIGingOptimizer):
        def _plan(self, ctx):
            return talg.column_stochastic_plan(G)

    A, c, w_star = heterogeneous_quadratics(np.random.default_rng(1))
    w = run_port(_Opt(LR), A, c, 1200)
    assert np.abs(w - w.mean(0)).max() < 1e-3
    assert np.abs(w.mean(0) - w_star).max() < 1e-3


def test_plain_atc_plateaus_where_gt_converges(port):
    """ATC gossip at the same constant step stalls at an O(lr) bias while
    gradient tracking reaches w*."""
    tbf.set_topology(ttu.ExponentialTwoGraph(SIZE))
    A, c, w_star = heterogeneous_quadratics(np.random.default_rng(2))
    At, ct = torch.from_numpy(A), torch.from_numpy(c)
    w = torch.zeros(SIZE, DIM, requires_grad=True)
    atc = tbf.DistributedAdaptThenCombineOptimizer(torch.optim.SGD([w], lr=LR),
                                                   plan=tbasics.context().plan)
    for _ in range(ITERS):
        atc.zero_grad()
        w.grad = torch.einsum("rij,rj->ri", At, w.detach() - ct)
        atc.step()
    err_atc = np.abs(w.detach().double().numpy().mean(0) - w_star).max()
    w_gt = run_port(tbf.DistributedGradientTrackingOptimizer(LR), A, c, ITERS)
    assert err_atc > 1e-2
    assert np.abs(w_gt.mean(0) - w_star).max() < 1e-4


def test_transforms_take_trees(port):
    """The functional pairs on a dict / tuple tree: the same iterates as on
    each leaf alone."""
    A, c, _ = heterogeneous_quadratics(np.random.default_rng(4))
    At, ct = torch.from_numpy(A), torch.from_numpy(c)
    plan = tbasics.context().plan
    for make in (talg.gradient_tracking, talg.extra, talg.push_diging):
        tx = make(LR, plan)
        tree = {"a": torch.zeros(SIZE, DIM), "b": (torch.zeros(SIZE, DIM),)}
        solo = torch.zeros(SIZE, DIM)
        st, st1 = tx.init(tree), tx.init(solo)
        for _ in range(4):
            g = torch.einsum("rij,rj->ri", At, tree["a"] - ct)
            upd, st = tx.update({"a": g, "b": (g,)}, st, tree)
            tree = {"a": tree["a"] + upd["a"], "b": (tree["b"][0] + upd["b"][0],)}
            u1, st1 = tx.update(torch.einsum("rij,rj->ri", At, solo - ct), st1, solo)
            solo = solo + u1
        torch.testing.assert_close(tree["a"], solo, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(tree["b"][0], solo, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["atc", "awc", "allreduce", "gt", "extra", "pushdiging"])
def test_optimization_example_matches_reference_loss(mode):
    """The example twin on the CPU reaches the JAX example's final loss
    (0.4197 for ATC, 0.4155 AWC, 0.4204 for the rest, 500 steps), within
    1e-3."""
    from bluefog_tpu_torch.examples import optimization

    out = optimization.run(optimization._parser().parse_args(
        ["--device", "cpu", "--mode", mode]))
    want = {"atc": 0.4197, "awc": 0.4155}.get(mode, 0.4204)
    assert abs(out["final_loss"] - want) < 1e-3, out["final_loss"]


@pytest.mark.parametrize("topology", ["exp2", "ring", "full"])
def test_average_consensus_example_converges(topology):
    from bluefog_tpu_torch.examples import average_consensus

    out = average_consensus.run(average_consensus._parser().parse_args(
        ["--device", "cpu", "--topology", topology]))
    assert out["converged"] and out["max_err"] < 1e-4
