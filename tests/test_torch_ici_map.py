"""``parallel/ici_map.py`` of bluefog_tpu_torch against the JAX package: the
cases of ``tests/test_ici_map.py`` run through both (snake order, torus
distances, plan hop costs, assignments; equal results), and the port's
device ordering keeps the given order (a CUDA or CPU device has no torus
coords)."""

import numpy as np
import pytest
import torch

from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core.plan import compile_plan as jax_compile_plan
from bluefog_tpu.parallel import ici_map as jici
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.parallel import ici_map


@pytest.mark.parametrize("shape", [(4,), (2, 2), (4, 4), (2, 4), (4, 8), (2, 2, 2)])
def test_snake_order_consecutive_adjacent(shape):
    order = ici_map.snake_order(shape)
    assert order == jici.snake_order(shape)
    assert len(order) == int(np.prod(shape)) == len(set(order))
    for a, b in zip(order, order[1:]):
        assert ici_map.hop_distance(a, b, shape) == 1, (a, b)


@pytest.mark.parametrize("shape", [(4, 4), (2, 4), (4, 8), (2, 2, 2)])
def test_snake_cycle_closes_for_even_leading_dim(shape):
    order = ici_map.snake_order(shape)
    assert ici_map.hop_distance(order[-1], order[0], shape) == 1


def test_hop_distance_wraparound():
    for a, b, shape, want in [((0, 0), (3, 0), (4, 4), 1), ((0, 0), (2, 2), (4, 4), 4),
                              ((0,), (7,), (16,), 7)]:
        assert ici_map.hop_distance(a, b, shape) == jici.hop_distance(a, b, shape) == want


@pytest.mark.parametrize("topo", ["ring", "exp2"])
def test_plan_hop_cost_matches_reference(topo):
    shape = (4, 4)
    snake = ici_map.snake_order(shape)
    rand = [snake[i] for i in np.random.default_rng(0).permutation(16)]
    make = {"ring": "RingGraph", "exp2": "ExponentialTwoGraph"}[topo]
    plan = compile_plan(getattr(ttu, make)(16))
    jplan = jax_compile_plan(getattr(jtu, make)(16))
    for assign in (snake, rand):
        assert ici_map.plan_hop_cost(plan, assign, shape) == jici.plan_hop_cost(
            jplan, assign, shape)
    if topo == "ring":  # test_ring_on_snake_is_all_single_hop
        cost = ici_map.plan_hop_cost(plan, snake, shape)
        assert (cost["max_edge_hops"], cost["total_hops"]) == (1.0, 32.0)
    else:  # test_snake_beats_random_for_exp2
        assert (ici_map.plan_hop_cost(plan, snake, shape)["total_hops"]
                < ici_map.plan_hop_cost(plan, rand, shape)["total_hops"])


def test_assignment_from_coords_roundtrip():
    shape = (2, 4)
    coords = ici_map.snake_order(shape)
    shuffled = [coords[i] for i in np.random.default_rng(1).permutation(8)]
    order = ici_map.assignment_from_coords(shuffled, shape)
    assert order == jici.assignment_from_coords(shuffled, shape)
    assert [shuffled[i] for i in order] == ici_map.snake_order(shape)


def test_assignment_rejects_non_tiling_coords():
    with pytest.raises(ValueError, match="do not tile"):
        ici_map.assignment_from_coords([(0, 0), (0, 0)], (2, 1))


def test_order_devices_keeps_the_order_without_coords(devices):
    """test_order_devices_fallback_without_coords: the reference keeps its
    CPU devices' order; the port keeps any torch device's (none has
    coords), for the ring and for a general topology."""
    assert jici.order_devices_for_ring(list(devices)) == list(devices)
    devs = [torch.device("cuda", 0), torch.device("cpu"), torch.device("cuda", 0)]
    assert ici_map.device_coords(devs) is None
    assert ici_map.order_devices_for_ring(devs) == devs
    assert ici_map.order_devices_for_topology(devs, ttu.RingGraph(3)) == devs


def test_optimize_assignment_waits_for_the_native_annealer():
    with pytest.raises(NotImplementedError, match="native"):
        ici_map.optimize_assignment(ttu.RingGraph(4), ici_map.snake_order((2, 2)), (2, 2))
