"""The flash ``impl`` switch of bluefog_tpu_torch against the JAX package:
``impl="xla"`` (the blockwise route, both its triangular and its general
branch) against the reference's ``impl="xla"``, alone and as the hop
compute of the ring, the striped ring and Ulysses on the 8-device CPU
mesh, and the rules of the switch (unknown names, ``block_q`` /
``block_k`` on the kernel route, ``interpret=True``).

Inputs are made with numpy, f32.  Tolerances as the reference's own tests
hold its XLA route (``tests/test_flash_attention.py``): o and lse within
2e-5 abs (lse on rows with a visible key), dq, dk and dv within 3e-5;
the rings' forward within 2e-5 and their gradients within 1e-4 of the
largest reference entry, as ``tests/test_torch_ring_attention.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.core.basics import NODES_AXIS
from bluefog_tpu.kernels.flash_attention import flash_attention_with_lse as jax_flash
from bluefog_tpu.models.transformer import dense_attention as jax_dense
from bluefog_tpu.parallel import ring_attention as jring
from bluefog_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from bluefog_tpu_torch.kernels import flash_attention, flash_attention_with_lse
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.parallel import ring_attention as tring
from bluefog_tpu_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(1)
fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
SIZE = 8
FWD_ATOL, GRAD_ATOL, RING_GRAD_REL = 2e-5, 3e-5, 1e-4


def _arrays(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, tk, h, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((b, h, tq)).astype(np.float32)
    return q, k, v, g, g_lse


@pytest.fixture
def no_kernel_route(monkeypatch):
    """Every entry of the kernel route raises: what runs under it took the
    blockwise route."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route ran")

    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        monkeypatch.setattr(fa, name, refuse)


# (causal, q_start, k_start, Tq, Tk, the branch the port must take)
XLA_CASES = {
    "aligned_causal": (True, 0, 0, 32, 32, "triangular"),
    "key_ahead_8": (True, 8, 16, 32, 32, "triangular"),
    "key_behind": (True, 16, 8, 32, 32, "general"),
    "tq_ne_tk": (True, 8, 0, 32, 48, "general"),
    "full": (False, 0, 0, 32, 32, "general"),
    "full_offsets": (False, 8, 16, 32, 32, "general"),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_xla_route_matches_the_reference_xla_impl(case, no_kernel_route, monkeypatch):
    """o, lse and the gradients of <o, g> + <lse, g_lse> (a non-zero lse
    cotangent) at block_k 16, so two or three key blocks run."""
    causal, qs, ks, tq, tk, branch = XLA_CASES[case]
    q, k, v, g, g_lse = _arrays(3, 2, tq, tk, 3, 16)

    def jloss(q, k, v):
        o, lse = jax_flash(q, k, v, q_start=qs, k_start=ks, causal=causal, block_q=16,
                           block_k=16, impl="xla")
        return jnp.sum(o * g) + jnp.sum(lse * g_lse), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    taken = []
    real = fa._triangular
    monkeypatch.setattr(fa, "_triangular", lambda *a: taken.append(real(*a)) or taken[-1])
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*xs, q_start=qs, k_start=ks, causal=causal,
                                      block_q=16, block_k=16, impl="xla")
    ((o * torch.tensor(g)).sum() + (lse * torch.tensor(g_lse)).sum()).backward()
    assert taken == [branch == "triangular"] * 2  # the forward's and the backward's
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=FWD_ATOL)
    jlse = np.asarray(jlse)
    visible = jlse > -1e29
    assert (lse.detach().numpy()[~visible] < -1e29).all()
    np.testing.assert_allclose(lse.detach().numpy()[visible], jlse[visible], rtol=0,
                               atol=FWD_ATOL)
    for name, x, want in zip("qkv", xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("block_k", [None, 16])
def test_xla_route_blocks_fit_the_sequence(block_k):
    """The reference's block rules: 512 below T = 2048, else 1024, capped
    at T and halved until it divides T (a requested 16 runs as 8 at
    T = 40, five blocks); the result is dense attention's (the reference's
    ``test_flash_gradients_indivisible_length``)."""
    assert fa.key_blocks(40, 40) == (40, 1) and fa.key_blocks(64, 2048) == (1024, 2)
    assert fa.key_blocks(1024, 1024) == (512, 2) and fa.key_blocks(40, 40, 16) == (8, 5)
    with pytest.raises(ValueError, match="no block size >= 8"):
        fa.fit_block(37, 16)
    q, k, v, g, _ = _arrays(4, 1, 40, 40, 2, 8)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got = flash_attention(*xs, causal=True, block_k=block_k, impl="xla")
    got.backward(torch.tensor(g))
    jx = [jnp.asarray(x) for x in (q, k, v)]
    want = jax_dense(*jx, causal=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    ref = jax.grad(lambda a, b, c: jnp.sum(jax_dense(a, b, c, causal=True) * g),
                   argnums=(0, 1, 2))(*jx)
    for name, x, w in zip("qkv", xs, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


# --------------------------------------------------------------------------
# the rings and Ulysses
# --------------------------------------------------------------------------


@pytest.fixture
def mesh(devices):
    jbf.init()
    yield jbasics.context().mesh
    jbf.shutdown()


RING_CASES = {  # (causal, striped, Tq, Tk) global lengths; T_local = T / 8
    "contiguous_causal": (True, False, 128, 128),
    "striped_causal": (True, True, 128, 128),
    "tq_ne_tk_causal": (True, False, 64, 128),
    "contiguous_full": (False, False, 128, 128),
}


def _layout(x, striped):
    return np.asarray(jring.stripe_blocks(jnp.asarray(x), SIZE)) if striped else x


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_with_xla_impl_runs_the_blockwise_route(case, mesh, no_kernel_route):
    """The reference's ``impl="xla"`` ring (``tests/test_ring_flash_attention.py:51``,
    ``tests/test_striped_ring.py:82``) against the port's, which must not
    touch the kernel route; then the port's gradients against jax.grad of
    dense attention on the whole sequence (``tests/test_striped_ring.py:101``)."""
    causal, striped, tq, tk = RING_CASES[case]
    q, k, v, g, _ = _arrays(5, 2, tq, tk, 2, 8)
    lay = [_layout(x, striped) for x in (q, k, v, g)]
    kw = dict(causal=causal, striped=striped, block_q=8, block_k=8)  # two key blocks a hop
    fn = jax.jit(jax.shard_map(
        lambda a, b, c: jring.ring_flash_attention(a, b, c, NODES_AXIS, SIZE, interpret=False,
                                                   impl="xla", **kw),
        mesh=mesh, in_specs=P(None, NODES_AXIS), out_specs=P(None, NODES_AXIS)))
    want = np.asarray(fn(*(jnp.asarray(x) for x in lay[:3])))
    xs = [torch.tensor(x, requires_grad=True) for x in lay[:3]]
    out = tring.gather_sequence(tring.ring_flash_attention(
        *(tring.shard_sequence(x, SIZE) for x in xs), SIZE, impl="xla", **kw), SIZE)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=FWD_ATOL)
    out.backward(torch.tensor(lay[3]))
    ref = jax.grad(lambda a, b, c: jnp.sum(jax_dense(a, b, c, causal=causal) * g),
                   argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for name, x, w in zip("qkv", xs, ref):
        got = x.grad.numpy()
        if striped:
            got = np.asarray(jring.unstripe_blocks(jnp.asarray(got), SIZE))
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0, atol=RING_GRAD_REL * np.abs(w).max(),
                                   err_msg=f"d{name}")


def test_ring_kernel_route_is_the_default(monkeypatch):
    """Without ``impl`` the ring's hops go to the kernel route (its plain
    versions on CPU tensors), one forward a hop group."""
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, _, _ = _arrays(6, 1, 32, 32, 2, 8)
    tring.ring_flash_attention(*(tring.shard_sequence(torch.tensor(x), SIZE)
                                 for x in (q, k, v)), SIZE, causal=True)
    groups = sum(len(tring.hop_launches(s, SIZE, 4, 4, causal=True, striped=False))
                 for s in range(SIZE))
    assert len(calls) == groups == SIZE


def test_ulysses_with_xla_impl_runs_the_blockwise_route(mesh, no_kernel_route):
    q, k, v, _, _ = _arrays(7, 2, 64, 64, 8, 8)
    fn = jax.jit(jax.shard_map(
        lambda a, b, c: jax_ulysses(a, b, c, NODES_AXIS, SIZE, causal=True, flash=True,
                                    block_q=16, block_k=16, interpret=False, impl="xla"),
        mesh=mesh, in_specs=P(None, NODES_AXIS), out_specs=P(None, NODES_AXIS)))
    want = np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v))))
    got = tring.gather_sequence(ulysses_attention(
        *(tring.shard_sequence(torch.tensor(x), SIZE) for x in (q, k, v)), SIZE, causal=True,
        flash=True, block_q=16, block_k=16, impl="xla"), SIZE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


# --------------------------------------------------------------------------
# the switch's rules
# --------------------------------------------------------------------------


def _small():
    return [torch.zeros(1, 16, 2, 8) for _ in range(3)]


def _ring(**kw):
    return tring.ring_flash_attention(*(torch.zeros(SIZE, 4, 2, 8) for _ in range(3)), SIZE,
                                      **kw)


def _ulysses(**kw):
    return ulysses_attention(*(torch.zeros(SIZE, 4, 8, 8) for _ in range(3)), SIZE,
                             flash=True, **kw)


CALLS = {"flash_attention_with_lse": lambda **kw: flash_attention_with_lse(*_small(), **kw),
         "flash_attention": lambda **kw: flash_attention(*_small(), **kw),
         "make_flash_attention_fn": lambda **kw: make_flash_attention_fn(**kw),
         "ring_flash_attention": _ring, "ulysses_attention": _ulysses}


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_the_switch_rules(entry):
    """An unknown ``impl`` raises as the reference's does; ``block_k`` (or
    ``block_q``) other than the built tile raises on the kernel route and
    names the variants benchmark, the tile itself is accepted; any block
    is accepted on the blockwise route; ``interpret=True`` raises."""
    call = CALLS[entry]
    with pytest.raises(ValueError, match="impl must be auto/pallas/cuda/xla"):
        call(impl="mosaic")
    for impl in ("auto", "pallas", "cuda"):
        with pytest.raises(ValueError, match="benchmarks.flash_variants"):
            call(impl=impl, block_k=16)
        with pytest.raises(ValueError, match="block_q=256"):
            call(impl=impl, block_q=256)
    with pytest.raises(ValueError, match="interpret=True"):
        call(interpret=True)
    call(block_q=128, block_k=64, impl="cuda")
    call(block_q=8, block_k=8, impl="xla", interpret=False)
