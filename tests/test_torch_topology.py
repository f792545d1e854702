"""Topology library and comm-plan compiler of bluefog_tpu_torch against the
JAX package's: the same constructors give the same weight matrices and the
same CommPlan fields, exactly (the port's digraph keeps networkx's order)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core import plan as jplan
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core import plan as tplan

torch.set_num_threads(1)

SIZES = list(range(2, 17))
CONSTRUCTORS = {
    "exp2": lambda m, n: m.ExponentialTwoGraph(n),
    "exp3": lambda m, n: m.ExponentialGraph(n, base=3),
    "symexp": lambda m, n: m.SymmetricExponentialGraph(n),
    "ring0": lambda m, n: m.RingGraph(n, 0),
    "ring1": lambda m, n: m.RingGraph(n, 1),
    "ring2": lambda m, n: m.RingGraph(n, 2),
    "star": lambda m, n: m.StarGraph(n, center_rank=n // 2),
    "mesh": lambda m, n: m.MeshGrid2DGraph(n),
    "full": lambda m, n: m.FullyConnectedGraph(n),
}


def _plan_fields(plan):
    fields = dataclasses.asdict(plan)
    fields["classes"] = [dataclasses.asdict(c) for c in plan.classes]
    return fields


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
@pytest.mark.parametrize("size", SIZES)
def test_weight_matrix_and_plan_match_reference(name, size):
    ref = CONSTRUCTORS[name](jtu, size)
    port = CONSTRUCTORS[name](ttu, size)
    np.testing.assert_array_equal(ttu.GetWeightMatrix(port), jtu.GetWeightMatrix(ref))
    assert ttu.IsRegularGraph(port) == jtu.IsRegularGraph(ref)
    assert port.graph == ref.graph
    assert _plan_fields(tplan.compile_plan(port)) == _plan_fields(jplan.compile_plan(ref))
    for r in range(size):
        assert ttu.GetSendWeights(port, r) == jtu.GetSendWeights(ref, r)


@pytest.mark.parametrize("size", [4, 7, 8])
def test_plan_overrides_match_reference(size):
    ref, port = jtu.RingGraph(size), ttu.RingGraph(size)
    for kw in ({"self_weight": 0.5}, {"neighbor_weight": 0.2},
               {"self_weight": tuple(0.1 * i for i in range(size))}):
        assert (_plan_fields(tplan.compile_plan(port, **kw))
                == _plan_fields(jplan.compile_plan(ref, **kw)))


def test_plan_from_neighbor_lists_matches_reference():
    src = [[1, 2], [0], [3], [0, 1, 2]]
    weights = [{1: 0.25, 2: 0.25}, {0: 0.5}, {3: 0.3}, {0: 0.1, 1: 0.2, 2: 0.3}]
    for kw in ({}, {"src_weights": weights}, {"self_weights": [0.4] * 4}):
        assert (_plan_fields(tplan.plan_from_neighbor_lists(4, src, **kw))
                == _plan_fields(jplan.plan_from_neighbor_lists(4, src, **kw)))


def test_topology_equivalence_and_metropolis_hastings():
    a, b = ttu.RingGraph(6), ttu.RingGraph(6)
    assert ttu.IsTopologyEquivalent(a, b)
    assert not ttu.IsTopologyEquivalent(a, ttu.ExponentialTwoGraph(6))
    assert ttu.IsTopologyEquivalent(None, None) and not ttu.IsTopologyEquivalent(a, None)
    ttu.MetropolisHastingsWeights(b)
    ref = jtu.MetropolisHastingsWeights(jtu.RingGraph(6))
    np.testing.assert_array_equal(ttu.GetWeightMatrix(b), jtu.GetWeightMatrix(ref))


@pytest.mark.parametrize("gen", [
    "GetDynamicOnePeerSendRecvRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
])
def test_dynamic_generators_match_reference(gen):
    args = {
        "GetDynamicOnePeerSendRecvRanks": [(8, r) for r in range(8)],
        "GetInnerOuterRingDynamicSendRecvRanks": [(8, 4, r) for r in range(8)],
        "GetInnerOuterExpo2DynamicSendRecvRanks": [(16, 4, r) for r in range(16)],
        "GetExp2DynamicSendRecvMachineRanks": [(16, 4, r, r % 4) for r in range(16)],
    }[gen]
    for a in args:
        got = list(itertools.islice(getattr(ttu, gen)(*a), 12))
        want = list(itertools.islice(getattr(jtu, gen)(*a), 12))
        assert got == want


def test_rank_inference_matches_reference():
    src = [[1, 3], [0], [0, 1], [2]]
    assert ttu.InferDestinationFromSourceRanks(src) == jtu.InferDestinationFromSourceRanks(src)
    assert ttu.InferSourceFromDestinationRanks(src) == jtu.InferSourceFromDestinationRanks(src)
    with pytest.raises(ValueError):
        ttu.InferDestinationFromSourceRanks([[5]])


def test_constructors_reject_bad_sizes():
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError):
            ttu.ExponentialTwoGraph(bad)
    with pytest.raises(ValueError):
        ttu.MeshGrid2DGraph(6, shape=(4, 2))
    with pytest.raises(ValueError):
        ttu.RingGraph(4, connect_style=3)


def test_exports_match_reference():
    assert set(jtu.__all__) <= set(ttu.__all__)
