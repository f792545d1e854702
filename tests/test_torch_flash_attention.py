"""Flash attention of bluefog_tpu_torch against the JAX package's Pallas
kernels (interpret mode on the CPU): forward (o, lse) and gradients through
``jax.vjp`` with a nonzero lse cotangent.  On the CPU the port's wrappers run
their plain versions; the CUDA kernels are held against those plain
versions on the card (``chip_smoke.py`` and ``test_torch_cuda.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.kernels.flash_attention import flash_attention_with_lse as jax_flash
from bluefog_tpu_torch.kernels import flash_attention_with_lse, make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import dense_attention

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
torch.set_num_threads(1)

B, T, H, D = 2, 64, 4, 16
ATOL = 2e-5  # f32 on both sides; sums in a different order


def _inputs(seed, t=T, d=D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, t, H, d)).astype(np.float32) for _ in range(4))
    g_lse = rng.normal(size=(B, H, t)).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_ref(q, k, v, g, g_lse, q_start, k_start, causal):
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, q_start=q_start, k_start=k_start, causal=causal,
                         block_q=16, block_k=16, interpret=True, impl="pallas")

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return [np.asarray(x) for x in (o, lse, *grads)]


def _port(q, k, v, g, g_lse, q_start, k_start, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, q_start=q_start, k_start=k_start,
                                      causal=causal)
    grads = torch.autograd.grad((o, lse), (qt, kt, vt),
                                (torch.from_numpy(g), torch.from_numpy(g_lse)))
    return [x.detach().numpy() for x in (o, lse, *grads)]


CASES = {
    "causal": (0, 0, True),
    "non_causal": (0, 0, False),
    "q_ahead": (40, 0, True),          # a ring hop: queries after the keys
    "k_ahead_small": (0, 4, True),     # static key-ahead delta (tri path)
    "partly_masked": (16, 48, True),   # some rows see no key at all
    "fully_masked": (0, 64, True),     # a hop whose keys all lie ahead
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_fwd_and_grads_match_pallas_kernel(case):
    q_start, k_start, causal = CASES[case]
    args = _inputs(sorted(CASES).index(case))
    want = _jax_ref(*args, q_start, k_start, causal)
    got = _port(*args, q_start, k_start, causal)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if name == "lse":  # masked rows hold the -1e30 sentinel on both sides
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_flash_matches_dense_attention():
    q, k, v, _, _ = _inputs(3)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out = make_flash_attention_fn()(qt, kt, vt)
    ref = dense_attention(qt, kt, vt, causal=True)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [40, 104])
def test_plain_versions_cover_ragged_lengths(t):
    """Lengths that are not a multiple of the 64-row tile (the kernels mask
    the ragged edge; the plain versions step over it)."""
    q, k, v, g, g_lse = _inputs(5, t=t)
    want = _jax_ref(q, k, v, g, g_lse, 0, 0, True)
    got = _port(q, k, v, g, g_lse, 0, 0, True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_wrappers_count_only_kernel_launches():
    """CPU tensors run the plain versions, which are not counted."""
    fa.reset_launches()
    q, k, v, g, g_lse = _inputs(6)
    _port(q, k, v, g, g_lse, 0, 0, True)
    assert fa.launches == {"fwd": 0, "dkv": 0, "dq": 0}


def test_wrappers_reject_mixed_devices():
    x = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError):
        fa._on_cuda(x, torch.zeros(2, 64, 64, device="meta"))
