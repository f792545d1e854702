"""Rank-major collectives of bluefog_tpu_torch against the JAX package's
eager ops on a 4-device CPU mesh: the same inputs (made with numpy) give
the same outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu_torch import ops
from bluefog_tpu_torch import topology_util as ttu

torch.set_num_threads(1)
N = 4

TOPOLOGIES = {
    "exp2": "ExponentialTwoGraph",
    "ring": "RingGraph",
    "star": "StarGraph",
    "mesh": "MeshGrid2DGraph",
    "full": "FullyConnectedGraph",
}


@pytest.fixture
def contexts(devices):
    jbf.init(devices=jax.devices()[:N])
    tbf.init(size=N, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _x(seed=0, shape=(N, 3, 5), dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_neighbor_allreduce_matches_reference(contexts, topo):
    jbf.set_topology(getattr(jtu, TOPOLOGIES[topo])(N))
    tbf.set_topology(getattr(ttu, TOPOLOGIES[topo])(N))
    x = _x()
    want = np.asarray(jbf.neighbor_allreduce(jnp.asarray(x)))
    got = tbf.neighbor_allreduce(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("self_weight", [0.0, 0.25, 0.5])
def test_neighbor_allreduce_self_weight_matches_reference(contexts, self_weight):
    x = _x(1)
    want = np.asarray(jbf.neighbor_allreduce(jnp.asarray(x), self_weight=self_weight))
    got = tbf.neighbor_allreduce(torch.from_numpy(x), self_weight=self_weight)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_neighbor_allreduce_bf16_matches_reference(contexts):
    x = _x(2, shape=(N, 64))
    want = np.asarray(jbf.neighbor_allreduce(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tbf.neighbor_allreduce(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding step: XLA may keep the fused combine in f32
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


def test_neighbor_allreduce_narrow_wire_and_fuse():
    """bf16 storage averaged in f32 crosses as bf16 (the neighbor's exact
    stored value); fuse=True packs leaves per dtype and changes nothing."""
    tbf.init(size=N, device="cpu")
    try:
        plan = tbf.context().plan
        xb = torch.from_numpy(_x(3)).bfloat16()
        got = ops.neighbor_allreduce_plan(xb, plan, average_dtype=torch.float32)
        assert got.dtype == torch.float32
        W = torch.from_numpy(plan.mixing_matrix()).float()
        want = torch.einsum("ds,s...->d...", W, xb.float())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

        tree = {"a": torch.from_numpy(_x(4)), "b": [torch.from_numpy(_x(5, (N, 7))),
                                                   torch.from_numpy(_x(6, (N, 2))).double()]}
        plain = ops.neighbor_allreduce_plan(tree, plan)
        fused = ops.neighbor_allreduce_plan(tree, plan, fuse=True)
        torch.testing.assert_close(fused, plain, rtol=0, atol=1e-6)
        with pytest.raises(ValueError):
            ops.neighbor_allreduce(torch.zeros(N + 1, 2))
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("average", [True, False])
def test_allreduce_matches_reference(contexts, average):
    x = _x(7)
    want = np.asarray(jbf.allreduce(jnp.asarray(x), average=average))
    got = tbf.allreduce(torch.from_numpy(x), average=average)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("root", [0, 3])
def test_broadcast_matches_reference(contexts, root):
    x = _x(8)
    want = np.asarray(jbf.broadcast(jnp.asarray(x), root_rank=root))
    got = tbf.broadcast(torch.from_numpy(x), root_rank=root)
    np.testing.assert_array_equal(got.numpy(), want)


def test_context_queries_match_reference(contexts):
    for r in range(N):
        assert tbf.in_neighbor_ranks(r) == jbf.in_neighbor_ranks(r)
        assert tbf.out_neighbor_ranks(r) == jbf.out_neighbor_ranks(r)
    assert tbf.size() == jbf.size() and tbf.rank() == 0
    assert tbf.is_topo_weighted() == jbf.is_topo_weighted()
    assert not tbf.set_topology(ttu.ExponentialTwoGraph(N))  # unchanged
    with pytest.raises(ValueError):
        tbf.set_topology(ttu.RingGraph(N + 1))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_optimizers_communicate_every_k_steps(k):
    """num_steps_per_communication: the combine runs on steps k, 2k, ...
    (the JAX package's _every_k); with lr 0 only the combine moves w."""
    from bluefog_tpu_torch.optim import (
        DistributedAdaptThenCombineOptimizer,
        DistributedAdaptWithCombineOptimizer,
        DistributedGradientAllreduceOptimizer,
    )

    tbf.init(size=N, device="cpu")
    try:
        plan = tbf.context().plan
        W = torch.from_numpy(plan.mixing_matrix()).float()
        for cls in (DistributedAdaptThenCombineOptimizer, DistributedAdaptWithCombineOptimizer):
            w = torch.from_numpy(_x(9, (N, 3))).requires_grad_(True)
            want = w.detach().clone()
            opt = cls(torch.optim.SGD([w], lr=0.0), plan=plan, num_steps_per_communication=k)
            for step in range(1, 7):
                w.grad = torch.ones_like(w)
                opt.step()
                if step % k == 0:
                    want = W @ want
                torch.testing.assert_close(w.detach(), want, rtol=1e-6, atol=1e-6)
        # gradient allreduce averages the gradients on the same schedule
        w = torch.zeros(N, 2, requires_grad=True)
        opt = DistributedGradientAllreduceOptimizer(torch.optim.SGD([w], lr=1.0), k)
        for step in range(1, 4):
            w.grad = torch.arange(N, dtype=torch.float32)[:, None].repeat(1, 2)
            before = w.detach().clone()
            opt.step()
            g = torch.full((N, 2), 1.5) if step % k == 0 else w.grad
            torch.testing.assert_close(before - w.detach(), g)
    finally:
        tbf.shutdown()
