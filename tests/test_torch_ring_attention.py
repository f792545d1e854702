"""Ring attention in bluefog_tpu_torch against the JAX package, on the
8-device CPU mesh of ``tests/conftest.py``: the striped layout, the dense
f32 ring and the ring on the flash kernels' plain versions (the JAX
kernel in interpret mode, under ``check_vma=False`` as
``tests/test_ring_flash_attention.py`` runs it), contiguous and striped,
causal and not, and ``Tq != Tk``.

The port runs the 8 ranks rank-major (``[8*B, T_local, H, D]``) and the
reference under ``shard_map``; inputs are made with numpy.  Tolerances:
the forward within 2e-5 abs in f32, as the reference's own tests hold it;
dq/dk/dv against ``jax.grad`` of the reference's ``dense_attention`` on
the unsharded sequence within 1e-4 of the largest reference entry (two
f32 computations of the same gradient in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.core.basics import NODES_AXIS
from bluefog_tpu.models.transformer import dense_attention as jax_dense
from bluefog_tpu.parallel import ring_attention as jring
from bluefog_tpu_torch.parallel import ring_attention as tring
from bluefog_tpu_torch.parallel._util import resolve_axis_size

torch.set_num_threads(1)
SIZE = 8
FWD_ATOL, GRAD_REL = 2e-5, 1e-4

# (causal, striped, Tq, Tk) global lengths; T_local = T / 8
CASES = {
    "contiguous_causal": (True, False, 32, 32),
    "contiguous_full": (False, False, 32, 32),
    "striped_causal": (True, True, 32, 32),
    "tq_ne_tk_causal": (True, False, 64, 128),
    "tq_ne_tk_full": (False, False, 128, 64),
}


@pytest.fixture(autouse=True)
def fresh_context(devices):
    jbf.init()
    yield
    jbf.shutdown()


def _qkv(seed, tq, tk, b=2, h=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, tk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _layout(x, striped):
    """numpy [B, T, ...] -> the sharded layout's global order."""
    return np.asarray(jring.stripe_blocks(jnp.asarray(x), SIZE)) if striped else x


def _jax_ring(q, k, v, *, flash, causal, striped):
    mesh = jbasics.context().mesh
    if flash:
        fn = lambda q, k, v: jring.ring_flash_attention(  # noqa: E731
            q, k, v, NODES_AXIS, SIZE, causal=causal, striped=striped,
            block_q=q.shape[1], block_k=k.shape[1], interpret=True)
    else:
        fn = lambda q, k, v: jring.ring_attention(  # noqa: E731
            q, k, v, NODES_AXIS, SIZE, causal=causal, striped=striped)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(None, NODES_AXIS),
                              out_specs=P(None, NODES_AXIS), check_vma=not flash))
    return np.asarray(f(*(jnp.asarray(x) for x in (q, k, v))))


def _port_ring(q, k, v, *, flash, causal, striped, grad_out=None):
    """Output [B, T, H, D] of the port's ring (inputs already in the
    sharded layout's global order) and, with ``grad_out``, dq, dk, dv."""
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    fn = tring.ring_flash_attention if flash else tring.ring_attention
    out = tring.gather_sequence(
        fn(*(tring.shard_sequence(x, SIZE) for x in xs), SIZE, causal=causal,
           striped=striped), SIZE)
    if grad_out is None:
        return out.detach().numpy()
    out.backward(torch.tensor(grad_out))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_forward_matches_the_reference(case, flash):
    causal, striped, tq, tk = CASES[case]
    q, k, v = (_layout(x, striped) for x in _qkv(0, tq, tk))
    want = _jax_ring(q, k, v, flash=flash, causal=causal, striped=striped)
    got = _port_ring(q, k, v, flash=flash, causal=causal, striped=striped)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_gradients_match_dense_autodiff_on_the_whole_sequence(case, flash):
    """dq/dk/dv of <out, g> through the port's ring (hops, merges, the lse
    cotangent) against jax.grad of the reference's dense attention on the
    unsharded sequence (causal masks on global positions from 0 are the
    dense lower triangle, also for Tq != Tk)."""
    causal, striped, tq, tk = CASES[case]
    q, k, v = _qkv(1, tq, tk)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_dense(q, k, v, causal=causal) * g),
                   argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    lay = (lambda x: _layout(x, striped))
    _, grads = _port_ring(lay(q), lay(k), lay(v), flash=flash, causal=causal,
                          striped=striped, grad_out=lay(g))
    for name, got, want in zip("qkv", grads, ref):
        want = np.asarray(want)
        if striped:
            got = np.asarray(jring.unstripe_blocks(jnp.asarray(got), SIZE))
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("striped", [False, True])
def test_ring_takes_bf16_inputs(striped, flash):
    """As ``tests/test_ring_attention.py::test_ring_attention_bf16_inputs``:
    bf16 in, bf16 out, within 0.05 of the f32 dense reference on the
    bf16-rounded inputs, and within the same of the reference's own dense
    ring on those inputs."""
    q, k, v = _qkv(3, 32, 32)
    q16, k16, v16 = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
                     for x in (q, k, v))
    ref = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q16, k16, v16)), causal=True))
    lay = (lambda x: _layout(x, striped))
    xs = [torch.tensor(lay(x)).bfloat16() for x in (q16, k16, v16)]
    fn = tring.ring_flash_attention if flash else tring.ring_attention
    out = fn(*(tring.shard_sequence(x, SIZE) for x in xs), SIZE, causal=True, striped=striped)
    assert out.dtype == torch.bfloat16
    got = tring.gather_sequence(out, SIZE).float().numpy()
    if striped:
        got = np.asarray(jring.unstripe_blocks(jnp.asarray(got), SIZE))
    np.testing.assert_allclose(got, ref, atol=0.05)
    jax16 = _jax_ring(*(jnp.asarray(lay(x)).astype(jnp.bfloat16) for x in (q16, k16, v16)),
                      flash=False, causal=True, striped=striped).astype(np.float32)
    if striped:
        jax16 = np.asarray(jring.unstripe_blocks(jnp.asarray(jax16), SIZE))
    np.testing.assert_allclose(got, jax16, atol=0.05)


def _split_per_rank(hops):
    return [tring.Hop(range(r, r + 1), h.q_start, h.k_start, h.causal)
            for h in hops for r in h.ranks]


@pytest.mark.parametrize("case", sorted(CASES))
def test_folding_ranks_by_offset_equals_one_call_per_rank(case, monkeypatch):
    """The ranks of a hop that share (q_start, k_start, causal) run in one
    flash call; splitting every call into one a rank gives the same
    output and gradients (to f32 roundoff), and the folded ring makes
    n calls a forward (contiguous), 2n - 1 (striped), n x n (Tq != Tk,
    causal) or n (not causal)."""
    from bluefog_tpu_torch import kernels

    causal, striped, tq, tk = CASES[case]
    q, k, v = (_layout(x, striped) for x in _qkv(4, tq, tk))
    g = _layout(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32), striped)
    calls = []
    real = kernels.flash_attention_with_lse

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, "flash_attention_with_lse", counted)
    folded = _port_ring(q, k, v, flash=True, causal=causal, striped=striped, grad_out=g)
    want_calls = {"contiguous_causal": SIZE, "contiguous_full": SIZE,
                  "striped_causal": 2 * SIZE - 1, "tq_ne_tk_causal": SIZE * SIZE,
                  "tq_ne_tk_full": SIZE}[case]
    assert len(calls) == want_calls
    plan = tring.hop_launches
    monkeypatch.setattr(tring, "hop_launches",
                        lambda *a, **kw: _split_per_rank(plan(*a, **kw)))
    calls.clear()
    per_rank = _port_ring(q, k, v, flash=True, causal=causal, striped=striped, grad_out=g)
    assert len(calls) == sum(len(h.ranks) for s in range(SIZE)
                             for h in plan(s, SIZE, tq // SIZE, tk // SIZE, causal=causal,
                                           striped=striped))
    for a, b in zip([folded[0]] + folded[1], [per_rank[0]] + per_rank[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_hop_plan_is_the_reference_dispatch():
    """Every rank of every step is served by exactly the mask the
    reference's dispatch picks (diagonal, visible, masked = no launch;
    striped delta 0 / 1; global offsets for Tq != Tk)."""
    n = 4
    for step in range(n):
        served = {r: h for h in tring.hop_launches(step, n, 8, 8, causal=True, striped=False)
                  for r in h.ranks}
        for idx in range(n):
            if step == 0:
                assert served[idx][1:] == (0, 0, True)
            elif step > idx:
                assert idx not in served
            else:
                assert served[idx][1:] == (0, 0, False)
        served = {r: h for h in tring.hop_launches(step, n, 8, 8, causal=True, striped=True)
                  for r in h.ranks}
        for idx in range(n):
            j = (idx - step) % n
            assert served[idx][1:] == (0, 0 if step == 0 or j <= idx else 1, True)
        served = {r: h for h in tring.hop_launches(step, n, 8, 16, causal=True, striped=False)
                  for r in h.ranks}
        for idx in range(n):
            assert served[idx][1:] == (idx * 8, ((idx - step) % n) * 16, True)


def test_stripe_blocks_and_positions_match_the_reference():
    x = np.arange(2 * 32 * 3).reshape(2, 32, 3).astype(np.float32)
    for n, axis in ((4, 1), (8, 1), (2, 2)):
        if x.shape[axis] % n:
            continue
        want = np.asarray(jring.stripe_blocks(jnp.asarray(x), n, axis=axis))
        got = tring.stripe_blocks(torch.from_numpy(x), n, axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tring.unstripe_blocks(got, n, axis=axis).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        tring.stripe_blocks(torch.zeros(1, 6), 4)
    # the reference's striped_positions, one device a row
    mesh = jbasics.context().mesh
    pos = jax.jit(jax.shard_map(
        lambda x: jring.striped_positions(4, NODES_AXIS)[None]
        + 0 * x[:, :1, 0, 0].astype(jnp.int32),
        mesh=mesh, in_specs=P(None, NODES_AXIS), out_specs=P(None, NODES_AXIS),
    ))(jnp.zeros((1, SIZE * 4, 1, 1)))
    np.testing.assert_array_equal(tring.striped_positions(4, SIZE).numpy(),
                                  np.asarray(pos).reshape(SIZE, 4))


def test_shard_sequence_is_the_shard_map_layout():
    """Rank r's rows of the rank-major form are what ``P(None, axis)``
    hands device r, and gather_sequence is what the out spec assembles."""
    x = np.random.default_rng(6).standard_normal((2, 32, 3)).astype(np.float32)
    mesh = jbasics.context().mesh
    per_device = jax.jit(jax.shard_map(lambda a: a[None], mesh=mesh,
                                       in_specs=P(None, NODES_AXIS),
                                       out_specs=P(NODES_AXIS)))(jnp.asarray(x))
    got = tring.shard_sequence(torch.from_numpy(x), SIZE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(per_device).reshape(SIZE * 2, 4, 3))
    np.testing.assert_array_equal(tring.gather_sequence(got, SIZE).numpy(), x)


@pytest.mark.parametrize("striped", [False, True])
def test_shard_inputs_give_each_row_its_shard_and_global_positions(striped):
    """shard_inputs: every row holds the global ids at its positions, the
    positions are those the reference's ``run_seq_parallel`` computes on
    each device (``idx*T_local + arange``, or ``striped_positions``), and
    gather_outputs puts the rows back into sequence order."""
    b, t = 2, 32
    tl = t // SIZE
    ids = np.random.default_rng(7).integers(0, 1000, size=(b, t))
    x, pos = tring.shard_inputs(torch.from_numpy(ids), SIZE, striped)
    assert x.shape == pos.shape == (SIZE * b, tl)
    rows = np.repeat(np.arange(b)[None], SIZE, 0).reshape(-1)
    np.testing.assert_array_equal(x.numpy(), ids[rows[:, None], pos.numpy()])

    def device_positions(a):
        idx = jax.lax.axis_index(NODES_AXIS)
        p = (jring.striped_positions(tl, NODES_AXIS) if striped
             else idx * tl + jnp.arange(tl))
        return p[None] + 0 * a[:1, :1]

    per_device = jax.jit(jax.shard_map(
        device_positions, mesh=jbasics.context().mesh, in_specs=P(None, NODES_AXIS),
        out_specs=P(NODES_AXIS)))(jnp.zeros((1, t), jnp.int32))
    want = np.repeat(np.asarray(per_device).reshape(SIZE, tl), b, axis=0)
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(tring.gather_outputs(x, SIZE, striped).numpy(), ids)


def test_ring_size_is_checked():
    with pytest.raises(ValueError, match="ring size"):
        resolve_axis_size(None, 8)
    with pytest.raises(ValueError, match="does not divide"):
        tring.ring_attention(*(torch.zeros(6, 4, 1, 8) for _ in range(3)), 4)
    with pytest.raises(ValueError, match="positive int"):
        resolve_axis_size(0, 8)
    with pytest.raises(ValueError, match="equal q/k shard lengths"):
        tring.ring_flash_attention(torch.zeros(8, 4, 1, 8), torch.zeros(8, 2, 1, 8),
                                   torch.zeros(8, 2, 1, 8), 4, striped=True)
