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


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_head_dim_padding_is_exact(kernel, d):
    """pad_head_dim, which the CUDA wrappers run a head dim the kernels are
    not built for through (zero-padded to 64 or 128, results cut back),
    gives the unpadded result: run here through the plain versions, every
    output within 1e-6 of the largest (f32 sums over the zero columns in
    another order), and the sliced outputs have the unpadded shape."""
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(3, 96, d)).astype(np.float32))
                  for _ in range(4))
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, 8, 0, **kw)
    corr = torch.from_numpy(rng.normal(size=(3, 96)).astype(np.float32)) \
        - (o * g).sum(-1)
    args = {"fwd": (q, k, v, 8, 0), "dkv": (q, k, v, g, lse, corr, 8, 0),
            "dq": (q, k, v, g, lse, corr, 8, 0)}[kernel]
    plain = getattr(fa, f"flash_{kernel}_plain")
    want = plain(*args, **kw)
    got = fa.pad_head_dim(plain, *args, **kw)
    want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), (a - b).abs().max()


def _inputs_cross(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, tq, H, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, tk, H, d)).astype(np.float32) for _ in range(2))
    g_lse = rng.normal(size=(B, H, tq)).astype(np.float32)
    return q, k, v, g, g_lse


F32_CASES = {  # tq, tk, d, q_start, k_start, causal: the f32 kernels' head dims and shapes
    "d64": (64, 64, 64, 0, 0, True),
    "d128": (64, 64, 128, 0, 0, True),
    "cross_hop": (32, 96, 64, 64, 0, True),       # tq != tk, queries after the keys
    "cross_non_causal": (96, 32, 128, 0, 0, False),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_route_matches_pallas_kernel_in_f32(case):
    """The port's f32 route (on the CPU its plain versions, which the f32
    CUDA kernels are held against on the card) against the JAX kernel in
    f32, interpret mode, at the f32 kernels' head dims 64 and 128 and with
    tq != tk: o, lse and all three gradients within ATOL (f32 on both
    sides, sums in another order)."""
    tq, tk, d, q_start, k_start, causal = F32_CASES[case]
    args = _inputs_cross(sorted(F32_CASES).index(case) + 20, tq, tk, d)
    want = _jax_ref(*args, q_start, k_start, causal)
    got = _port(*args, q_start, k_start, causal)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, rtol=1e-6 if name == "lse" else 0, atol=ATOL,
                                   err_msg=name)


def test_check_takes_f32_or_bf16_of_one_dtype():
    """The wrappers' check accepts f32 and bf16 inputs (each dtype has its
    kernels) and rejects q, k, v and dO of mixed dtypes, or another dtype."""
    lse = torch.zeros(2, 64)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros(2, 64, 64, dtype=dt)
        assert fa._check("flash_fwd", q, q, q) == (2, 64, 64, 64)
        assert fa._check("flash_dkv", q, q, q, (q,), (lse, lse)) == (2, 64, 64, 64)
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="share one dtype"):
        fa._check("flash_fwd", q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="share one dtype"):
        fa._check("flash_dq", q, q, q, (q.bfloat16(),), (lse, lse))
    with pytest.raises(ValueError, match="bf16 or float32"):
        fa._check("flash_fwd", q.half(), q.half(), q.half())


def test_each_dtype_launches_its_own_kernel(monkeypatch):
    """bf16 inputs reach csrc/flash_attention.cu's launchers and count in
    ``launches``; f32 inputs reach csrc/flash_attention_f32.cu's and count
    in ``launches_f32``."""
    from types import SimpleNamespace

    names = ("fwd", "bwd_dkv", "bwd_dq")
    bf16 = SimpleNamespace(**{f"bf_flash_{n}": f"bf16 {n}" for n in names})
    f32 = SimpleNamespace(**{f"bf_flash_f32_{n}": f"f32 {n}" for n in names})
    monkeypatch.setattr(fa, "_lib", lambda: bf16)
    monkeypatch.setattr(fa, "_lib_f32", lambda: f32)
    for n in names:
        assert fa._kernel(torch.bfloat16, n) == (f"bf16 {n}", fa.launches)
        assert fa._kernel(torch.float32, n) == (f"f32 {n}", fa.launches_f32)
    fa.reset_launches()
    assert fa.launches == fa.launches_f32 == {"fwd": 0, "dkv": 0, "dq": 0}
