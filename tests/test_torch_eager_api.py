"""The eager API of bluefog_tpu_torch against the JAX package's on the
8-device CPU mesh, 4 machines x 2 ranks on both sides: the reference's
positional signatures, integer averaging, allgather, barrier, the dynamic
neighbor_allreduce, neighbor_allgather (regular, irregular, dynamic),
pairwise_gossip and every ``_nonblocking`` form.  The same numpy inputs go
through both; float32 within rtol 1e-6 / atol 1e-6 (the sums run in other
orders), bfloat16 within 2^-7 relative and absolute (one bf16 rounding
step), integers and gathers exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import ops_spmd as jops_spmd
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.core.basics import NODES_AXIS
from bluefog_tpu_torch import ops
from bluefog_tpu_torch import topology_util as ttu

torch.set_num_threads(1)
N = 8

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


@pytest.fixture
def contexts(devices):
    jbf.init(local_size=2)
    tbf.init(size=N, local_size=2, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _both(x, dtype="float32"):
    """The numpy array as (jax array, torch tensor) of ``dtype``."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def _x(seed=0, shape=(N, 3, 5), dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-20, 20, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _check(got, want, dtype="float32"):
    """``got`` (torch) against ``want`` (jax): dtype and values."""
    want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)
    elif got.is_floating_point():
        assert str(want.dtype) == str(got.dtype).replace("torch.", ""), (want.dtype, got.dtype)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        assert str(want.dtype) == str(got.dtype).replace("torch.", ""), (want.dtype, got.dtype)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# C4 and C5: the reference's positional signatures and integer averaging
# --------------------------------------------------------------------------


@pytest.mark.parametrize("self_weight", [0.5, 0.0])
def test_neighbor_allreduce_takes_self_weight_positionally(contexts, self_weight):
    """``neighbor_allreduce(x, 0.5)``: the second argument is the self
    weight, as in the reference (it was a plan, and raised)."""
    jx, tx = _both(_x(1))
    _check(tbf.neighbor_allreduce(tx, self_weight),
           jbf.neighbor_allreduce(jx, self_weight))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("average", [True, False])
def test_allreduce_takes_average_positionally(contexts, dtype, average):
    """``allreduce(x, average)``: the mean of an integer tensor is float32,
    the sum keeps int32, as the reference's."""
    jx, tx = _both(_x(2, dtype=dtype), dtype)
    got, want = tbf.allreduce(tx, average), jbf.allreduce(jx, average)
    if dtype == "int32":
        assert got.dtype == (torch.float32 if average else torch.int32)
    _check(got, want, dtype)


def test_allreduce_int32_rank_tensor_matches_reference(contexts):
    """The reproducer: rank-major arange gives float32 3.5 (mean) and int32
    28 (sum) on 8 ranks."""
    x = np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, 4)).copy()
    jx, tx = _both(x, "int32")
    mean, total = tbf.allreduce(tx), tbf.allreduce(tx, False)
    assert mean.dtype == torch.float32 and total.dtype == torch.int32
    _check(mean, jbf.allreduce(jx))
    _check(total, jbf.allreduce(jx, False), "int32")
    assert mean[0, 0].item() == 3.5 and total[0, 0].item() == 28


@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_takes_root_positionally(contexts, root):
    jx, tx = _both(_x(3))
    _check(tbf.broadcast(tx, root), jbf.broadcast(jx, root))


# --------------------------------------------------------------------------
# allgather and barrier
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_allgather_matches_reference(contexts, dtype):
    jx, tx = _both(_x(4, shape=(N, 2, 3), dtype=dtype), dtype)
    got = tbf.allgather(tx)
    assert got.shape == (N, N * 2, 3) and got.dtype == tx.dtype
    want = jbf.allgather(jx)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_barrier_runs(contexts):
    assert tbf.barrier() is None


# --------------------------------------------------------------------------
# the dynamic neighbor_allreduce
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dynamic_src_weights_match_reference(contexts, dtype):
    """One-peer dynamic ring: every rank averages with its left neighbor."""
    src = [{(r - 1) % N: 0.5} for r in range(N)]
    jx, tx = _both(_x(5, dtype=dtype), dtype)
    got = tbf.neighbor_allreduce(tx, self_weight=0.5, src_weights=src)
    if dtype == "int32":
        assert got.dtype == torch.float32
    _check(got, jbf.neighbor_allreduce(jx, self_weight=0.5, src_weights=src), dtype)


def test_dynamic_dst_weights_match_reference(contexts):
    """dst_weights at the sender: rank r sends 0.5 x to r + 1 and r + 3."""
    dst = [{(r + 1) % N: 0.5, (r + 3) % N: 0.25} for r in range(N)]
    jx, tx = _both(_x(6))
    _check(tbf.neighbor_allreduce(tx, dst_weights=dst),
           jbf.neighbor_allreduce(jx, dst_weights=dst))


def test_dynamic_src_and_dst_weights_multiply(contexts):
    """Both sides given: edge s -> d weighs src_weights[d][s] x
    dst_weights[s][d], with the self weight per rank."""
    src = [{(r - 1) % N: 0.5, (r - 2) % N: 0.25} for r in range(N)]
    dst = [{(s + 1) % N: 2.0, (s + 2) % N: 1.0} for s in range(N)]
    sw = [0.1 * (r + 1) for r in range(N)]
    x = _x(7)
    jx, tx = _both(x)
    got = tbf.neighbor_allreduce(tx, self_weight=sw, src_weights=src, dst_weights=dst)
    _check(got, jbf.neighbor_allreduce(jx, self_weight=sw, src_weights=src, dst_weights=dst))
    want = np.stack([sw[d] * x[d] + 1.0 * x[(d - 1) % N] + 0.25 * x[(d - 2) % N]
                     for d in range(N)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dynamic_mismatched_edges_raise(contexts):
    src = [{(r - 1) % N: 0.5} for r in range(N)]
    dst = [{(s + 2) % N: 0.5} for s in range(N)]
    tx = torch.zeros(N, 2)
    with pytest.raises(ValueError, match="different edge sets"):
        tbf.neighbor_allreduce(tx, src_weights=src, dst_weights=dst)
    with pytest.raises(ValueError, match="different edge sets"):
        jbf.neighbor_allreduce(jnp.zeros((N, 2)), src_weights=src, dst_weights=dst)
    with pytest.raises(ValueError, match="length-8"):
        tbf.neighbor_allreduce(tx, src_weights=src[:3])


@pytest.mark.parametrize("topo", ["RingGraph", "ExponentialTwoGraph"])
def test_per_rank_self_weight_static_matches_reference(contexts, topo):
    """A per-rank ``self_weight`` on the installed topology."""
    jbf.set_topology(getattr(jtu, topo)(N))
    tbf.set_topology(getattr(ttu, topo)(N))
    sw = [0.5, 0.25, 0.5, 0.75, 0.5, 0.0, 1.0, 0.5]
    jx, tx = _both(_x(8))
    _check(tbf.neighbor_allreduce(tx, self_weight=sw), jbf.neighbor_allreduce(jx, self_weight=sw))


def test_dynamic_rotation_matches_one_peer_generator(contexts):
    """Three rounds of the exp-2 one-peer rotation from
    ``GetDynamicOnePeerSendRecvRanks``: equal to the reference each round,
    and the global mean is kept."""
    jgens = [jtu.GetDynamicOnePeerSendRecvRanks(N, r) for r in range(N)]
    tgens = [ttu.GetDynamicOnePeerSendRecvRanks(N, r) for r in range(N)]
    x = _x(9, shape=(N, 4))
    jout, tout = _both(x)
    for _ in range(3):
        jsrc = [{p[1][0]: 0.5} for p in (next(g) for g in jgens)]
        tsrc = [{p[1][0]: 0.5} for p in (next(g) for g in tgens)]
        assert jsrc == tsrc
        jout = jbf.neighbor_allreduce(jout, self_weight=0.5, src_weights=jsrc)
        tout = tbf.neighbor_allreduce(tout, self_weight=0.5, src_weights=tsrc)
        _check(tout, jout)
    np.testing.assert_allclose(tout.numpy().mean(0), x.mean(0), rtol=1e-5, atol=1e-6)


def test_dynamic_tree_input(contexts):
    """A dict of tensors goes through leaf by leaf, each in its own dtype's
    weights."""
    src = [{(r + 1) % N: 0.25} for r in range(N)]
    a, b = _x(10, shape=(N, 3)), _x(11, shape=(N, 2, 2), dtype="int32")
    got = tbf.neighbor_allreduce({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                                 src_weights=src)
    want = jbf.neighbor_allreduce({"a": jnp.asarray(a), "b": jnp.asarray(b)}, src_weights=src)
    _check(got["a"], want["a"])
    _check(got["b"], want["b"])


def test_dynamic_plans_are_cached_by_value(contexts):
    """A dynamic call builds a new plan object each time; equal plans share
    one entry of the per-plan tensor cache (CommPlan hashes by value)."""
    src = [{(r - 1) % N: 0.5} for r in range(N)]
    tx = torch.from_numpy(_x(12))
    ops._plan_tensors.cache_clear()
    for _ in range(3):
        tbf.neighbor_allreduce(tx, self_weight=0.5, src_weights=src)
    info = ops._plan_tensors.cache_info()
    assert info.misses == 1 and info.hits == 2


# --------------------------------------------------------------------------
# neighbor_allgather
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("topo", ["RingGraph", "ExponentialTwoGraph", "StarGraph",
                                  "MeshGrid2DGraph"])
def test_neighbor_allgather_matches_reference(contexts, topo, dtype):
    """Regular topologies concatenate ``[N, D * n0, ...]``; the star and the
    2-D mesh are irregular and give ``[N, maxD, n0, ...]`` zero-padded."""
    jbf.set_topology(getattr(jtu, topo)(N))
    tbf.set_topology(getattr(ttu, topo)(N))
    jx, tx = _both(_x(13, shape=(N, 2, 3), dtype=dtype), dtype)
    got, want = tbf.neighbor_allgather(tx), jbf.neighbor_allgather(jx)
    assert got.dtype == tx.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_neighbor_allgather_irregular_padding(contexts):
    """StarGraph(8): the center gathers ranks 1..7, each leaf the center
    then zeros."""
    tbf.set_topology(ttu.StarGraph(N))
    x = torch.arange(N, dtype=torch.float32)[:, None].repeat(1, 2) + 1
    out = tbf.neighbor_allgather(x)
    assert out.shape == (N, N - 1, 2)
    torch.testing.assert_close(out[0, :, 0], torch.arange(2, N + 1, dtype=torch.float32))
    assert (out[1:, 0] == 1).all() and (out[1:, 1:] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_neighbor_allgather_dynamic_matches_reference(contexts, dtype):
    """Per-call neighbor lists: src_ranks, dst_ranks inferred, both
    consistent; inconsistent lists raise."""
    jx, tx = _both(_x(14, shape=(N, 2), dtype=dtype), dtype)
    src = [[(r + 2) % N, (r + 5) % N] for r in range(N)]
    dst = [[(s - 2) % N, (s - 5) % N] for s in range(N)]
    for kw in ({"src_ranks": src}, {"dst_ranks": dst}, {"src_ranks": src, "dst_ranks": dst}):
        got, want = tbf.neighbor_allgather(tx, **kw), jbf.neighbor_allgather(jx, **kw)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    irregular = [[(r + 1) % N] if r % 2 else [] for r in range(N)]
    got = tbf.neighbor_allgather(tx, src_ranks=irregular)
    want = jbf.neighbor_allgather(jx, src_ranks=irregular)
    assert got.shape == want.shape == (N, 1, 2)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    bad = [[(s + 3) % N] for s in range(N)]
    with pytest.raises(ValueError, match="different edge sets"):
        tbf.neighbor_allgather(tx, src_ranks=[[(r + 1) % N] for r in range(N)], dst_ranks=bad)


# --------------------------------------------------------------------------
# pairwise_gossip
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("send_to", [((0, 1), (1, 0), (2, 3), (3, 2)),
                                     tuple((r, (r + 1) % N) for r in range(N))])
def test_pairwise_gossip_matches_reference(contexts, send_to, dtype):
    """The one-peer step against ``ops_spmd.pairwise_gossip`` inside
    ``shard_map``: receivers mix 0.3 / 0.7, the rest keep 1.0 x."""
    ctx = jbasics.context()
    jx, tx = _both(_x(15, shape=(N, 4), dtype=dtype), dtype)
    fn = jax.shard_map(
        lambda t: jops_spmd.pairwise_gossip(t, send_to, N, NODES_AXIS, self_weight=0.3,
                                            peer_weight=0.7),
        mesh=ctx.mesh, in_specs=P(NODES_AXIS), out_specs=P(NODES_AXIS))
    got = ops.pairwise_gossip(tx, send_to, N, self_weight=0.3, peer_weight=0.7)
    assert got.dtype == torch.float32
    _check(got, fn(jx))


# --------------------------------------------------------------------------
# nonblocking forms
# --------------------------------------------------------------------------


def test_nonblocking_forms_match_blocking_and_reference(contexts):
    """Each ``_nonblocking`` collective returns a Handle whose synchronize
    gives the blocking op's value, and the reference's."""
    jbf.set_machine_topology(jtu.RingGraph(4))
    tbf.set_machine_topology(ttu.RingGraph(4))
    jx, tx = _both(_x(16, shape=(N, 3)))
    src = [{(r - 1) % N: 0.5} for r in range(N)]
    cases = [
        ("allreduce_nonblocking", (False,), {}),
        ("broadcast_nonblocking", (2,), {}),
        ("allgather_nonblocking", (), {}),
        ("neighbor_allgather_nonblocking", (), {}),
        ("neighbor_allreduce_nonblocking", (), {}),
        ("neighbor_allreduce_nonblocking", (0.5, src), {}),
        ("hierarchical_neighbor_allreduce_nonblocking", (), {"self_weight": 0.25}),
    ]
    for name, args, kw in cases:
        h = getattr(tbf, name)(tx, *args, **kw)
        assert isinstance(h, tbf.Handle) and tbf.poll(h)
        got = tbf.synchronize(h)
        blocking = getattr(tbf, name.replace("_nonblocking", ""))(tx, *args, **kw)
        torch.testing.assert_close(got, blocking, rtol=0, atol=0)
        _check(got, jbf.synchronize(getattr(jbf, name)(jx, *args, **kw)))
        assert tbf.wait(h) is got
