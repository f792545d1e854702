"""The collective family of ``bluefog_tpu_torch.analysis`` (the reference's
hlo family): twins of ``tests/test_analysis_hlo.py`` and the cases of
``tests/test_hlo_contract.py`` whose op the port has.

The port compiles no HLO.  Its programs run eagerly under
``common.collective_inspect.CollectiveInventory``, which files every aten op
that mixes the rank axis under the reference's opcode (``index_select`` of
a shift class's sources -> collective-permute, a reduction over the rank
axis -> all-reduce, the whole axis materialized for each rank ->
all-gather, a rank-axis transpose -> all-to-all).  Each contract case holds
the port's inventory to the budget AND to the reference program's compiled
HLO inventory on the same topology (the JAX package on an 8-device CPU
mesh).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu import ops_spmd as ref_ops_spmd
from bluefog_tpu import topology_util as ref_tu
from bluefog_tpu.analysis import hlo_corpus as ref_hlo_corpus
from bluefog_tpu.common.hlo_inspect import collective_counts as hlo_counts
from bluefog_tpu.core import basics as ref_basics
from bluefog_tpu.core.basics import LOCAL_AXIS, MACHINES_AXIS, NODES_AXIS

from bluefog_tpu_torch import algorithms, ops, topology_util as tu
from bluefog_tpu_torch.analysis import Report, collective_corpus, fixtures
from bluefog_tpu_torch.analysis.collective_rules import (
    CollectiveBudget,
    NoFullAxisAllGather,
    NoReplicatedLargeBuffer,
    assert_clean,
    check_program,
)
from bluefog_tpu_torch.common.collective_inspect import (
    CollectiveInventory,
    CollectiveOp,
    collective_counts,
    collective_ops,
    record,
)
from bluefog_tpu_torch.core.plan import compile_plan

SIZE = 8


def _gossip(topo, dtype=torch.float32):
    plan = compile_plan(topo)
    _, inv = record(ops.neighbor_allreduce_plan, torch.zeros((SIZE, 4), dtype=dtype),
                    plan, ranks=SIZE)
    return inv


# ---------------------------------------------------------------------------
# the inventory and the rules (twins of test_analysis_hlo.py)
# ---------------------------------------------------------------------------


def test_inventory_sees_the_permutes():
    inv = _gossip(tu.ExponentialTwoGraph(SIZE))
    got = collective_ops(inv)
    assert [op.opcode for op in got] == ["collective-permute"] * 3
    assert {op.aten for op in got} == {"aten.index_select.default"}
    # every recorded op carries a usable per-rank shape: [4] f32 = 16 bytes
    assert [op.result_bytes() for op in got] == [16] * 3


def test_result_bytes_arithmetic():
    op = CollectiveOp(opcode="all-gather", aten="aten.expand.default",
                      shapes=(("f32", (8, 4096, 4096)),), line="", itemsize=4)
    assert op.result_bytes() == 4 * 8 * 4096 * 4096
    # read from a real (meta) tensor: the per-rank result, the rank axis off
    x = torch.empty((SIZE, 4096, 4096), device="meta", dtype=torch.bfloat16)
    with CollectiveInventory(SIZE) as inv:
        x.unsqueeze(0).expand((SIZE,) + tuple(x.shape))
    (ag,) = inv.ops
    assert ag.opcode == "all-gather" and ag.shapes == (("bf16", (8, 4096, 4096)),)
    assert ag.result_bytes() == 2 * 8 * 4096 * 4096


def test_real_gossip_passes_the_rules():
    inv = _gossip(tu.ExponentialTwoGraph(SIZE))
    assert_clean(inv, [
        CollectiveBudget({"collective-permute": 3}, subject="exp2@8"),
        NoFullAxisAllGather(axis_size=SIZE, subject="exp2@8"),
        NoReplicatedLargeBuffer(1 << 20, subject="exp2@8"),
    ])


def test_budget_rule_fires_on_injected_all_gather():
    findings = fixtures.run_fixture("collective-injected-all-gather")
    rules_fired = {f.rule for f in findings}
    assert rules_fired == {"collective.collective-budget",
                           "collective.full-axis-all-gather"}


def test_byte_rule_fires_on_replicated_large_buffer():
    findings = fixtures.run_fixture("collective-replicated-large-buffer")
    assert [f.rule for f in findings] == ["collective.replicated-large-buffer"]
    assert "536.9 MB" in findings[0].message  # 8*4096*4096*4 bytes


def test_budget_rejects_unknown_opcode_at_construction():
    with pytest.raises(ValueError, match="unknown collective"):
        CollectiveBudget({"all-togther": 1})  # typo must fail loudly


def test_inexact_budget_is_upper_bound_only():
    inv = _gossip(tu.RingGraph(SIZE))
    assert check_program(inv, [CollectiveBudget(
        {"collective-permute": 5}, exact=False)]) == []
    assert check_program(inv, [CollectiveBudget(
        {"collective-permute": 1}, exact=False)]) != []


def test_registered_collective_corpus_rules_pass_on_seed():
    report = Report()
    collective_corpus.check_gossip_corpus(report, device="cpu")
    collective_corpus.check_window_exchange(report, device="cpu")
    assert report.ok, "\n".join(str(f) for f in report.errors())
    assert report.subjects_checked == len(collective_corpus.GOSSIP_CORPUS) + 1


def test_corpus_keeps_the_reference_subjects_and_budgets():
    assert collective_corpus.GOSSIP_CORPUS == ref_hlo_corpus.GOSSIP_CORPUS
    assert collective_corpus.SIZE == ref_hlo_corpus.SIZE
    assert collective_corpus.MAX_RESULT_BYTES == ref_hlo_corpus.MAX_RESULT_BYTES


def test_family_on_the_card_without_one_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    report = Report()
    with collective_corpus.on_device("cuda"):
        collective_corpus._run_gossip(report)
    assert not report.ok
    assert [f.rule for f in report.findings] == ["collective.environment"]


def test_row_addressed_ops_are_not_collectives():
    """Selecting one rank, writing receivers' own rows, elementwise math and
    reductions that keep the rank axis stay on their ranks."""
    x = torch.randn(SIZE, 4, 3)
    dst = torch.tensor([1, 3, 5])
    with CollectiveInventory(SIZE) as inv:
        y = x[2] * 2 + x.sum(dim=(1, 2)).view(SIZE, 1, 1).mean()[None]
        x[dst] = x[dst] + 1
        (x * x).sum(dim=-1).amax(dim=1)
        torch.stack([x[r] for r in range(SIZE)])
        # an order argument before dim, and elementwise max / min
        torch.linalg.vector_norm(x, 3, dim=1)
        x.norm(3, dim=2)
        torch.max(x, x * 2)
        torch.min(x, x * 2)
        del y
    # the one reduction over the rank axis is the .mean() of [8, 1, 1]
    assert collective_counts(inv) == {"all-reduce": 1}
    with CollectiveInventory(SIZE) as inv:
        x.norm(2)  # every axis, the rank axis among them
        torch.linalg.vector_norm(x, 3, dim=(0, 2))
        x.std(0)
        x.max(dim=0)
        x.sum()
    assert collective_counts(inv) == {"all-reduce": 5}


def test_allgather_and_rank_transpose_are_classified():
    x = torch.randn(SIZE, 4)
    _, inv = record(ops.allgather, x, ranks=SIZE)
    assert collective_counts(inv) == {"all-gather": 1}
    (ag,) = inv.ops
    assert ag.shapes == (("f32", (SIZE * 4,)),)
    y = torch.randn(SIZE, SIZE, 2)
    with CollectiveInventory(SIZE) as inv:
        y.transpose(0, 1).contiguous()
        y.permute(1, 0, 2)
        y.transpose(1, 2)  # a local transpose
    assert collective_counts(inv) == {"all-to-all": 2}


# ---------------------------------------------------------------------------
# the contract cases (test_hlo_contract.py), port against reference
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_context(devices):
    jbf.init(local_size=2)
    yield
    jbf.shutdown()


def _ref_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _ref_rank_major(spmd_fn):
    return jax.shard_map(spmd_fn, mesh=ref_basics.context().mesh,
                         in_specs=P(NODES_AXIS), out_specs=P(NODES_AXIS))


def _ref_gossip(topo=None, plan=None):
    if topo is not None:
        jbf.set_topology(topo)
        plan = ref_basics.context().plan
    fn = _ref_rank_major(functools.partial(ref_ops_spmd.neighbor_allreduce, plan=plan,
                                           axis_name=NODES_AXIS))
    return hlo_counts(_ref_text(fn, jnp.zeros((SIZE, 4))))


def _assert_contract(port_inv, ref_counts, expected):
    findings = CollectiveBudget(expected).check_counts(collective_counts(port_inv))
    assert not findings, "\n".join(str(f) for f in findings)
    assert dict(collective_counts(port_inv)) == dict(ref_counts) == expected


def test_allreduce_is_one_allreduce(ref_context):
    _, inv = record(ops.allreduce, torch.zeros((SIZE, 4)), ranks=SIZE)
    fn = _ref_rank_major(functools.partial(ref_ops_spmd.allreduce, axis_name=NODES_AXIS,
                                           average=True))
    _assert_contract(inv, hlo_counts(_ref_text(fn, jnp.zeros((SIZE, 4)))),
                     {"all-reduce": 1})


@pytest.mark.parametrize("name,classes", [("exp2", 3), ("ring", 2)])
def test_neighbor_allreduce_is_one_permute_per_class(ref_context, name, classes):
    ctor = {"exp2": "ExponentialTwoGraph", "ring": "RingGraph"}[name]
    inv = _gossip(getattr(tu, ctor)(SIZE))
    _assert_contract(inv, _ref_gossip(getattr(ref_tu, ctor)(SIZE)),
                     {"collective-permute": classes})


def test_dynamic_one_peer_is_one_permute(ref_context):
    """The one-peer exp2 rotation moves ONE hop per step."""
    from bluefog_tpu.ops import _dynamic_plan as ref_dynamic_plan

    dst = [{(r + 1) % SIZE: 1.0} for r in range(SIZE)]
    plan = ops._dynamic_plan(SIZE, None, None, dst)
    _, inv = record(ops.neighbor_allreduce_plan, torch.zeros((SIZE, 4)), plan, ranks=SIZE)
    _assert_contract(inv, _ref_gossip(plan=ref_dynamic_plan(SIZE, None, None, dst)),
                     {"collective-permute": 1})


def test_hierarchical_is_local_reduce_plus_machine_permutes(ref_context):
    """One local all-reduce (the mean over each machine's ranks) + the
    machine ring's 2 permutes; the broadcast back to the local ranks is
    free."""
    mplan = compile_plan(tu.RingGraph(4))
    _, inv = record(ops.hierarchical_neighbor_allreduce_plan, torch.zeros((SIZE, 4)),
                    mplan, ranks=SIZE, machines=4)
    jbf.set_machine_topology(ref_tu.RingGraph(4))
    ctx = ref_basics.context()

    def spmd(t):
        return ref_ops_spmd.hierarchical_neighbor_allreduce(
            t, machine_plan=ctx.machine_plan, machines_axis=MACHINES_AXIS,
            local_axis=LOCAL_AXIS)

    fn = jax.shard_map(spmd, mesh=ctx.hier_mesh,
                       in_specs=P((MACHINES_AXIS, LOCAL_AXIS)),
                       out_specs=P((MACHINES_AXIS, LOCAL_AXIS)))
    _assert_contract(inv, hlo_counts(_ref_text(fn, jnp.zeros((SIZE, 4)))),
                     {"all-reduce": 1, "collective-permute": 2})


def test_window_exchange_one_permute_per_shift_class(ref_context):
    from bluefog_tpu.windows import _build_exchange
    from bluefog_tpu_torch.windows import _exchange_body

    plan = compile_plan(tu.ExponentialTwoGraph(SIZE))
    nclasses, maxd = len(plan.classes), plan.max_in_degree
    with CollectiveInventory(SIZE) as inv:
        _exchange_body(plan, False, False, torch.zeros((SIZE, 4)),
                       torch.zeros((SIZE, maxd, 4)),
                       torch.zeros((SIZE, maxd), dtype=torch.int32), torch.ones(SIZE),
                       torch.ones((SIZE, maxd)), np.ones((nclasses, SIZE), np.float32),
                       np.ones((nclasses, SIZE), np.float32))
    jbf.set_topology(ref_tu.ExponentialTwoGraph(SIZE))
    rplan = ref_basics.context().plan
    f = _build_exchange(rplan, accumulate=False, with_p=False, donate=False)
    text = f.lower(jnp.zeros((SIZE, 4)), jnp.zeros((SIZE, maxd, 4)),
                   jnp.zeros((SIZE, maxd), jnp.int32), jnp.ones((SIZE,)),
                   jnp.ones((SIZE, maxd)), jnp.ones((nclasses, SIZE)),
                   jnp.ones((nclasses, SIZE))).compile().as_text()
    _assert_contract(inv, hlo_counts(text), {"collective-permute": nclasses})


def _ref_exact_counts(tx):
    ctx = ref_basics.context()

    def spmd(p, g):
        state = tx(ctx).init(p)
        updates, _ = tx(ctx).update(g, state, p)
        return updates

    fn = jax.shard_map(spmd, mesh=ctx.mesh, in_specs=(P(NODES_AXIS),) * 2,
                       out_specs=P(NODES_AXIS))
    x = jnp.zeros((SIZE, 4))
    return hlo_counts(_ref_text(fn, x, x))


def _port_exact_inventory(tx):
    p = torch.zeros((SIZE, 4))
    with CollectiveInventory(SIZE) as inv:
        state = tx.init(p)
        tx.update(p, state, p)
    return inv


@pytest.mark.parametrize("method", ["gradient_tracking", "extra"])
def test_exact_method_exp2_is_three_permutes(ref_context, method):
    """Exactness costs zero extra collectives: one fused round a step."""
    from bluefog_tpu import algorithms as ref_algorithms

    plan = compile_plan(tu.ExponentialTwoGraph(SIZE))
    inv = _port_exact_inventory(getattr(algorithms, method)(0.1, plan))
    jbf.set_topology(ref_tu.ExponentialTwoGraph(SIZE))
    ref_fn = getattr(ref_algorithms, f"{method}_spmd")
    _assert_contract(inv, _ref_exact_counts(lambda ctx: ref_fn(0.1, ctx.plan)),
                     {"collective-permute": 3})


def test_push_diging_directed_ring_is_one_permute(ref_context):
    """u-descent, the push-sum weight v and the tracker ride one fused
    column-stochastic round over the single shift class."""
    import networkx as nx

    from bluefog_tpu import algorithms as ref_algorithms

    G = tu.DiGraph()
    H = nx.DiGraph()
    for g in (G, H):
        g.add_nodes_from(range(SIZE))
        for r in range(SIZE):
            g.add_edge(r, (r + 1) % SIZE)
    inv = _port_exact_inventory(algorithms.push_diging(0.1, algorithms.column_stochastic_plan(G)))
    rplan = ref_algorithms.column_stochastic_plan(H)
    _assert_contract(inv, _ref_exact_counts(lambda ctx: ref_algorithms.push_diging_spmd(0.1, rplan)),
                     {"collective-permute": 1})


# ---------------------------------------------------------------------------
# the main path's contract at a small size (the card runs it at full width)
# ---------------------------------------------------------------------------


def test_llama_step_gossip_is_classes_times_leaves():
    """One ATC step of examples/llama_pretrain (tiny preset, 4 ranks) under
    the inventory: the gossip is exactly one index_select per shift class
    per leaf, and nothing else crosses the rank axis (the per-rank forward
    and backward select their rank's slices; AdamW is elementwise)."""
    from bluefog_tpu_torch.examples import llama_pretrain

    seen = {}

    def setup(params, opt):
        seen["leaves"] = len(params)
        seen["inv"] = CollectiveInventory(4)
        return seen["inv"]

    llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--steps", "1", "--attention", "dense"]),
        setup=setup)
    classes = len(compile_plan(tu.ExponentialTwoGraph(4)).classes)
    assert classes == 2 and seen["leaves"] == 21
    assert dict(seen["inv"].aten_counts()) == {
        ("collective-permute", "aten.index_select.default"): classes * seen["leaves"]}
