"""Ulysses sequence parallelism in bluefog_tpu_torch against the JAX
package's ``ulysses_attention`` on the 8-device CPU mesh: the forward
(dense, and flash on the kernels' plain versions against the JAX kernel
in interpret mode), the gradients against ``jax.grad`` of dense attention
on the unsharded sequence, the stacked and the separate re-shard, the
indivisible-heads error, and agreement with the ring.  Tolerances as in
``tests/test_torch_ring_attention.py``: forward 2e-5 abs in f32,
gradients 1e-4 of the largest reference entry."""

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
from bluefog_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from bluefog_tpu_torch.parallel.ring_attention import (
    gather_sequence,
    ring_attention,
    ring_flash_attention,
    shard_sequence,
)
from bluefog_tpu_torch.parallel.ulysses import make_ulysses_attention_fn, ulysses_attention

torch.set_num_threads(1)
SIZE = 8
FWD_ATOL, GRAD_REL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def fresh_context(devices):
    jbf.init()
    yield
    jbf.shutdown()


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(q, k, v, **kw):
    mesh = jbasics.context().mesh
    f = jax.jit(jax.shard_map(
        lambda q, k, v: jax_ulysses(q, k, v, NODES_AXIS, SIZE, **kw), mesh=mesh,
        in_specs=P(None, NODES_AXIS), out_specs=P(None, NODES_AXIS),
        check_vma=not kw.get("flash", False)))
    return np.asarray(f(*(jnp.asarray(x) for x in (q, k, v))))


def _port(q, k, v, **kw):
    xs = [shard_sequence(torch.from_numpy(x), SIZE) for x in (q, k, v)]
    return gather_sequence(ulysses_attention(*xs, SIZE, **kw), SIZE).numpy()


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_forward_matches_the_reference(causal, flash):
    q, k, v = _arrays(0, *[(2, 64, 8, 8)] * 3)
    jax_kw = dict(block_q=64, block_k=64, interpret=True) if flash else {}
    want = _jax(q, k, v, causal=causal, flash=flash, **jax_kw)
    np.testing.assert_allclose(_port(q, k, v, causal=causal, flash=flash), want,
                               atol=FWD_ATOL)


def test_cross_attention_reshards_each_operand_alone():
    """Tk != Tq (no causal mask) takes the separate re-shard of q, k and v
    in both packages, with the same result."""
    q, k, v = _arrays(1, (2, 32, 8, 8), (2, 64, 8, 8), (2, 64, 8, 8))
    want = _jax(q, k, v, causal=False)
    np.testing.assert_allclose(_port(q, k, v, causal=False), want, atol=FWD_ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_ulysses_gradients_match_dense_autodiff_on_the_whole_sequence(flash):
    q, k, v, g = _arrays(2, *[(2, 32, 8, 4)] * 4)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_dense(q, k, v, causal=True) * g),
                   argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = gather_sequence(ulysses_attention(*(shard_sequence(x, SIZE) for x in xs), SIZE,
                                            causal=True, flash=flash), SIZE)
    out.backward(torch.from_numpy(g))
    for name, x, want in zip("qkv", xs, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(), err_msg=f"d{name}")


def test_ulysses_rejects_indivisible_heads_with_the_reference_message():
    q = jnp.ones((1, 4, 2, 4))  # H = 2 < n = 8
    with pytest.raises(ValueError) as ref:
        jax_ulysses(q, q, q, NODES_AXIS, SIZE)
    t = torch.ones(SIZE, 4, 2, 4)
    with pytest.raises(ValueError, match="divisible") as got:
        ulysses_attention(t, t, t, SIZE)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("flash", [False, True])
def test_ulysses_and_ring_are_the_same_operator(flash):
    """Same layout, same answer: the two strategies are interchangeable,
    in the port as in the reference (``test_ulysses_matches_ring``)."""
    q, k, v = _arrays(3, *[(2, 64, 8, 8)] * 3)
    xs = [shard_sequence(torch.from_numpy(x), SIZE) for x in (q, k, v)]
    ring = (ring_flash_attention if flash else ring_attention)(*xs, SIZE, causal=True)
    uly = make_ulysses_attention_fn(SIZE, flash=flash)(*xs)
    np.testing.assert_allclose(uly.numpy(), ring.numpy(), atol=FWD_ATOL)


def test_ulysses_bf16_inputs_keep_their_dtype():
    q, k, v = _arrays(4, *[(2, 64, 8, 8)] * 3)
    xs = [shard_sequence(torch.from_numpy(x).bfloat16(), SIZE) for x in (q, k, v)]
    out = ulysses_attention(*xs, SIZE, flash=True)
    assert out.dtype == torch.bfloat16 and out.shape == xs[0].shape
    ref = np.asarray(jax_dense(*(jnp.asarray(x.float().numpy()) for x in
                                 (gather_sequence(y, SIZE) for y in xs)), causal=True))
    np.testing.assert_allclose(gather_sequence(out, SIZE).float().numpy(), ref, atol=0.05)
