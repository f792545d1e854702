"""The collective inventory's per-rank shapes and rank-axis shifts, and the
parallel layers' six collective-count contracts (twins of
``tests/test_hlo_contract.py``'s ZeRO, TP, PP, EP, FSDP and ring cases).

The reference's pinned counts are read from that file's text (its PP case
fails to compile under the installed jax, "Unsupported pcast", so it is
read and not run).  The programs are
:mod:`bluefog_tpu_torch.analysis.parallel_contracts`, which the card check
runs on ``cuda`` too.
"""

import ast
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu.common.hlo_inspect import collective_ops as hlo_ops
from bluefog_tpu.core import basics as ref_basics
from bluefog_tpu.core.basics import NODES_AXIS

from bluefog_tpu_torch.analysis import parallel_contracts as pc
from bluefog_tpu_torch.common.collective_inspect import CollectiveInventory, record
from bluefog_tpu_torch.parallel import pipeline as pp
from bluefog_tpu_torch.parallel import tensor_parallel as tp

SIZE = 8
REF_TEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_hlo_contract.py")


def _reference_pins():
    """Per reference test function: the dict literal it passes to
    ``_assert_only`` and the ``counts.get(op, 0) == k`` / ``<= k`` pins."""
    tree = ast.parse(open(REF_TEST).read())
    pins = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        got = pins.setdefault(fn.name, {})
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_assert_only"
                    and isinstance(node.args[1], ast.Dict)):
                got.setdefault("only", []).append(
                    {ast.literal_eval(k): ast.unparse(v) for k, v in
                     zip(node.args[1].keys, node.args[1].values)})
            if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Call)
                    and getattr(node.left.func, "attr", "") == "get"):
                op = ast.literal_eval(node.left.args[0])
                cmp = type(node.ops[0]).__name__
                got.setdefault("get", {})[op] = (cmp, ast.literal_eval(node.comparators[0]))
    return pins


PINS = _reference_pins()


def _eval(expr: str, n: int = SIZE) -> int:
    return eval(expr, {"n": n, "SIZE": SIZE})


# ---------------------------------------------------------------------------
# C8: the per-rank shape of a reduction over the rank axis
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_context(devices):
    jbf.init(local_size=2)
    yield
    jbf.shutdown()


def test_tp_g_operator_records_the_reference_psum_shape(ref_context):
    """``reduce_from_tp_region`` of ``[8, 4, 16]`` drops the rank axis (a
    ``sum(0)`` without keepdim): its per-rank result is the reference's
    psum result, ``f32[4, 16]`` and 256 bytes, not ``f32[16]``."""
    x = torch.ones(SIZE, 4, 16)
    _, inv = record(tp.reduce_from_tp_region, x, ranks=SIZE)
    (op,) = inv.ops
    assert (op.opcode, op.shapes, op.result_bytes()) == ("all-reduce", (("f32", (4, 16)),), 256)

    fn = jax.shard_map(lambda a: jax.lax.psum(a[0], NODES_AXIS)[None],
                       mesh=ref_basics.context().mesh, in_specs=P(NODES_AXIS),
                       out_specs=P(NODES_AXIS))
    text = jax.jit(fn).lower(jnp.ones((SIZE, 4, 16))).compile().as_text()
    (ref,) = [o for o in hlo_ops(text) if o.opcode == "all-reduce"]
    assert ref.shapes == op.shapes and ref.result_bytes() == op.result_bytes()


@pytest.mark.parametrize("reduce,per_rank", [
    (lambda x: x.sum(0, keepdim=True), (4, 16)),
    (lambda x: x.sum((0, 2)), (4,)),
    (lambda x: x.mean(0), (4, 16)),
    (lambda x: x.sum(), ()),
    (lambda x: x.amax((0, 1), keepdim=True), (1, 16)),
])
def test_reduction_keeps_the_per_rank_dims(reduce, per_rank):
    _, inv = record(reduce, torch.ones(SIZE, 4, 16), ranks=SIZE)
    (op,) = inv.ops
    assert op.opcode == "all-reduce" and op.shapes == (("f32", per_rank),)


def test_machine_split_mean_keeps_the_per_machine_shape():
    x = torch.ones(2, 4, 3)  # [machines, local, ...]
    _, inv = record(lambda a: a.mean(1), x, ranks=SIZE, machines=2)
    (op,) = inv.ops
    assert op.shapes == (("f32", (3,)),)


# ---------------------------------------------------------------------------
# rank-axis shifts: roll, a cat of moved slices, and the moved cotangent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [1, -1, 3, SIZE + 2])
def test_roll_along_the_rank_axis_is_a_permute(shift):
    _, inv = record(lambda a: torch.roll(a, shift, 0), torch.ones(SIZE, 3), ranks=SIZE)
    assert dict(inv.counts()) == {"collective-permute": 1}
    assert inv.ops[0].aten == "aten.roll.default"


@pytest.mark.parametrize("shift,dims", [(0, 0), (SIZE, 0), (-SIZE, 0), (2, 1)])
def test_roll_that_keeps_every_row_is_not_a_collective(shift, dims):
    _, inv = record(lambda a: torch.roll(a, shift, dims), torch.ones(SIZE, 3), ranks=SIZE)
    assert not inv.ops


def test_stage_stream_cat_is_a_permute_forward_and_backward():
    """``pipeline.py``'s stream: a cat that moves every row one stage on,
    and, in the backward, the slice's cotangent moved back."""
    x = torch.ones(SIZE, 3, requires_grad=True)
    inv = CollectiveInventory(SIZE)
    with inv:
        s = torch.tanh(x)
        y = torch.cat([torch.zeros_like(s[:1]), s[:-1]])
        torch.autograd.grad(y, x, torch.ones_like(y))
    assert [op.aten for op in inv.ops] == ["aten.cat.default", "aten.slice_backward.default"]
    assert dict(inv.counts()) == {"collective-permute": 2}
    assert all(op.shapes == (("f32", (3,)),) for op in inv.ops)


def test_row_preserving_cat_is_not_a_collective():
    """``pipeline.py``'s injection writes row 0 and keeps rows 1.. where they
    are (a ``cat`` of ``state[1:]`` at row 1): no rank moves, forward or
    backward; nor does a cat of computed pieces."""
    state = torch.ones(SIZE, 3, requires_grad=True)
    inv = CollectiveInventory(SIZE)
    with inv:
        inject = torch.full((3,), 2.0)
        y = torch.cat([inject.unsqueeze(0), state[1:]])
        z = torch.cat([y[:3] * 2, y[3:]])
        w = torch.cat([torch.ones(4, 3), torch.zeros(4, 3)])
        torch.autograd.grad(z + w, state, torch.ones_like(z))
    assert not inv.ops, [op.line for op in inv.ops]


def test_flash_ring_assembly_is_not_a_collective():
    """The flash ring's per-hop pieces go back to their own ranks."""
    from bluefog_tpu_torch.parallel.ring_attention import _assemble

    old = torch.ones(SIZE, 3)
    inv = CollectiveInventory(SIZE)
    with inv:
        _assemble(SIZE, old, [(range(2, 5), torch.zeros(3, 3)), (range(6, 8), old[6:8] * 2)])
    assert not inv.ops


def test_accumulated_block_scatter_is_one_reduce_scatter():
    """ZeRO-1's gradient: every rank's whole vector, viewed as ``[N, k]``
    blocks, added into one rank-major accumulator is one reduce-scatter of
    ``[k]`` a rank, however many ranks add to it; a second accumulator is
    a second one."""
    vecs = [torch.full((SIZE * 3,), float(r)) for r in range(SIZE)]
    inv = CollectiveInventory(SIZE)
    with inv:
        for _ in range(2):
            g = torch.zeros(SIZE, 3)
            for v in vecs:
                g += v.view_as(g)
    assert dict(inv.counts()) == {"reduce-scatter": 2}
    assert all(op.shapes == (("f32", (3,)),) for op in inv.ops)
    assert torch.equal(g, torch.full((SIZE, 3), float(sum(range(SIZE)))))


def test_row_aligned_accumulation_is_not_a_collective():
    """Adding rank-major rows, or a folded rank-major tensor viewed back
    into its rows, into an accumulator keeps every row at its own rank."""
    x = torch.ones(SIZE, 3)
    inv = CollectiveInventory(SIZE)
    with inv:
        g = torch.zeros(SIZE, 3)
        g += x * 2
        g += x.reshape(-1).view(SIZE, 3)
        g.add_(torch.ones(3))
    assert not inv.ops, [op.line for op in inv.ops]


# ---------------------------------------------------------------------------
# the six contracts of the parallel layers
# ---------------------------------------------------------------------------


def test_reference_pins_are_the_ones_the_twins_hold():
    """The counts :mod:`parallel_contracts` holds are the reference test
    text's: its ``_assert_only`` literals and its ``counts.get`` pins."""
    zero = PINS["test_zero_packed_one_gather_one_scatter"]["get"]
    assert zero == {"all-gather": ("Eq", 1), "reduce-scatter": ("Eq", 1),
                    "all-to-all": ("Eq", 0), "collective-permute": ("Eq", 0),
                    "all-reduce": ("LtE", pc.ZERO_MAX_ALLREDUCE)}
    assert {k: v[1] for k, v in zero.items() if v[0] == "Eq"} == \
        pc.REFERENCE_COUNTS["zero_packed"]
    for name, fn in [("tp_block", "test_tp_block_is_one_allreduce"),
                     ("pp_fwd_bwd", "test_pp_fwd_bwd_is_two_permutes_one_allreduce"),
                     ("ep_fwd_bwd", "test_ep_fwd_bwd_is_three_alltoalls_one_allreduce")]:
        (only,) = PINS[fn]["only"]
        assert {k: _eval(v) for k, v in only.items()} == pc.REFERENCE_COUNTS[name], name
    fwd, fwd_bwd = PINS["test_ring_attention_sp_is_nearest_neighbor_only"]["only"]
    assert {k: _eval(v) for k, v in fwd.items()} == pc.REFERENCE_COUNTS["ring_fwd"]
    assert {k: _eval(v) for k, v in fwd_bwd.items()} == pc.REFERENCE_COUNTS["ring_fwd_bwd"]
    assert PINS["test_scan_stacked_leaves_never_gather_whole"]["get"] == {
        "collective-permute": ("GtE", 1)}


@pytest.mark.parametrize("name", pc.CONTRACTS)
def test_parallel_layer_contract(name):
    row = pc.run_contract(name, "cpu")
    assert not row["findings"], (row["counts"], row["findings"])


def test_pp_contract_maps_the_reference_scan_body_to_ticks():
    """The reference's 2 permutes are one a scan body, forward and
    backward; the port runs the body once a tick, and the last tick's
    shifted stream feeds nothing, so its backward has no permute."""
    row = pc.run_contract("pp_fwd_bwd", "cpu")
    ticks = row["ticks"]
    assert ticks == SIZE + SIZE - 1
    ref = pc.REFERENCE_COUNTS["pp_fwd_bwd"]["collective-permute"]
    assert row["counts"]["collective-permute"] == ref * ticks - 1
    assert row["counts"]["all-reduce"] == pc.REFERENCE_COUNTS["pp_fwd_bwd"]["all-reduce"]


@pytest.mark.parametrize("stages,micro", [(4, 2), (2, 6)])
def test_pp_permutes_scale_with_ticks(stages, micro):
    params = torch.ones(stages, 5, 5, requires_grad=True)
    x = torch.ones(micro * 3, 5)
    inv = CollectiveInventory(stages)
    with inv:
        y = pp.pipeline_apply(lambda p, a: torch.tanh(a @ p), params, x, num_microbatches=micro)
        torch.autograd.grad(y, params, torch.ones_like(y))
    ticks = pc.pp_ticks(micro, stages)
    assert dict(inv.counts()) == {"collective-permute": 2 * ticks - 1, "all-reduce": 1}


def test_pipeline_result_is_unchanged_by_the_masked_sum():
    """The masked sum over stages gives the last stage's banked outputs
    bit for bit: the schedule run by hand, reading row ``n - 1``."""
    gen = torch.Generator().manual_seed(0)
    n, micro = 3, 4
    params = torch.randn(n, 4, 4, generator=gen)
    x = torch.randn(micro * 2, 4, generator=gen)
    stage = lambda p, a: torch.tanh(a @ p)
    y = pp.pipeline_apply(stage, params, x, num_microbatches=micro)
    mbs = x.reshape(micro, 2, 4)
    state, outs = torch.zeros(n, 2, 4), []
    for t in range(pc.pp_ticks(micro, n)):
        state = torch.cat([(mbs[t] if t < micro else torch.zeros(2, 4))[None], state[1:]])
        state = torch.func.vmap(stage)(params, state)
        if t >= n - 1:
            outs.append(state[n - 1])
        state = torch.cat([torch.zeros(1, 2, 4), state[:-1]])
    assert torch.equal(y, torch.stack(outs).reshape(x.shape))
