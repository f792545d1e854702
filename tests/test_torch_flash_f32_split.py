"""The numerical design of the f32 flash kernels, on the CPU.

The f32 forward, dK/dV and dQ kernels (``csrc/flash_attention_f32.cu``)
run every product on the tensor cores as three TF32 products (3xTF32): each
operand x is split into big = tf32(x), rounded to nearest with ties away
from zero, and small = x - big, and a.b becomes small_a.big_b +
big_a.small_b + big_a.big_b.  Here that arithmetic is emulated in torch
f32 through the port's plain versions (the same 64-key tiles and online
softmax the kernels run) and held against the JAX package's
``flash_attention_with_lse`` and its VJP in f32, the Pallas kernel in
interpret mode, under the tolerance the f32 kernels are held to on the
card (``chip_smoke.py``): 2^-14 (|ref| + rms(ref)) per element, lse within
2e-5.  A negative control shows that the tolerance tells the designs
apart: one TF32 product (big.big alone) fails it.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.kernels.flash_attention import flash_attention_with_lse as jax_flash

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
torch.set_num_threads(1)

F32_ELEM, F32_LSE_ABS = 2.0 ** -14, 2e-5  # chip_smoke.py's f32 tolerance
B, H = 1, 2


def _tensor_core_read(x):
    """A .tf32 operand as the tensor cores read it: its 13 low mantissa
    bits dropped (small's, where the split leaves any)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def bmm_3xtf32(a, b):
    """a.b as the kernels compute it: three TF32 products into f32."""
    (a_big, a_small), (b_big, b_small) = fa.split_tf32(a), fa.split_tf32(b)
    a_small, b_small = _tensor_core_read(a_small), _tensor_core_read(b_small)
    return torch.bmm(a_small, b_big) + torch.bmm(a_big, b_small) + torch.bmm(a_big, b_big)


def bmm_1xtf32(a, b):
    """a.b as one TF32 product: the design the tolerance must reject."""
    return torch.bmm(fa.split_tf32(a)[0], fa.split_tf32(b)[0])


# tq, tk, d, q_start, k_start, causal: both head dims the kernels are built
# for, causal with offsets, tq != tk both ways
CASES = {
    "d64_causal": (128, 128, 64, 0, 0, True),
    "d128_offsets": (128, 128, 128, 40, 8, True),
    "cross_hop": (64, 192, 64, 128, 0, True),
    "cross_d128_non_causal": (192, 64, 128, 0, 0, False),
}


def _inputs(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, tq, H, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, tk, H, d)).astype(np.float32) for _ in range(2))
    g_lse = rng.normal(size=(B, H, tq)).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_ref(q, k, v, g, g_lse, q_start, k_start, causal):
    """{o, lse, dq, dk, dv} of the JAX kernel in f32 with the lse cotangent."""
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, q_start=q_start, k_start=k_start, causal=causal,
                         block_q=32, block_k=32, interpret=True, impl="pallas")

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return {n: np.asarray(x) for n, x in zip(("o", "lse", "dq", "dk", "dv"),
                                             (o, lse, dq, dk, dv))}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(inputs, the JAX reference) of one case: the Pallas interpret VJP
    runs once a case, whichever test asks first."""
    tq, tk, d, q_start, k_start, causal = CASES[case]
    args = _inputs(sorted(CASES).index(case) + 40, tq, tk, d)
    return args, _jax_ref(*args, q_start, k_start, causal)


def _fold(x):  # [B, T, H, D] -> [B*H, T, D]
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, x.shape[1], -1)


def _unfold(x):  # [B*H, T, D] -> [B, T, H, D]
    return x.reshape(B, H, x.shape[1], -1).permute(0, 2, 1, 3).numpy()


def _emulate(bmm, case):
    """{o, lse, dq, dk, dv} of the port's plain forward, dK/dV and dQ on
    ``case``'s inputs with every product computed by ``bmm``, corr formed
    as the wrapper forms it."""
    (q, k, v, g, g_lse), _ = _case(case)
    _, _, _, q_start, k_start, causal = CASES[case]
    qf, kf, vf, gf = (_fold(x).contiguous() for x in (q, k, v, g))
    kw = dict(scale=1.0 / np.sqrt(q.shape[-1]), causal=causal, bmm=bmm)
    o, lse = fa.flash_fwd_plain(qf, kf, vf, q_start, k_start, **kw)
    corr = torch.from_numpy(g_lse).reshape(B * H, -1) - (o * gf).sum(-1)
    dk, dv = fa.flash_dkv_plain(qf, kf, vf, gf, lse, corr, q_start, k_start, **kw)
    dq = fa.flash_dq_plain(qf, kf, vf, gf, lse, corr, q_start, k_start, **kw)
    return {"o": _unfold(o), "lse": lse.reshape(B, H, -1).numpy(), "dq": _unfold(dq),
            "dk": _unfold(dk), "dv": _unfold(dv)}


def _tol_ratio(got, ref):
    """Worst |got - ref| / (2^-14 (|ref| + rms(ref))) over the elements."""
    err = np.abs(got.astype(np.float64) - ref)
    tol = F32_ELEM * (np.abs(ref) + np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    return float(np.max(err / tol))


def _lse_err(got, ref):
    visible = ref > -1e29
    assert (got[~visible] < -1e29).all(), "lse lost its sentinel"
    return float(np.max(np.abs(got - ref)[visible])) if visible.any() else 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_forward_and_dkv_hold_the_f32_tolerance_and_1xtf32_does_not(case):
    _, want = _case(case)
    three, one = _emulate(bmm_3xtf32, case), _emulate(bmm_1xtf32, case)
    assert _lse_err(three["lse"], want["lse"]) <= F32_LSE_ABS
    ratio3 = {n: _tol_ratio(three[n], want[n]) for n in ("o", "dk", "dv")}
    ratio1 = {n: _tol_ratio(one[n], want[n]) for n in ("o", "dk", "dv")}
    assert max(ratio3.values()) <= 1.0, ratio3
    # one TF32 product moves every output past the tolerance
    assert min(ratio1.values()) > 1.0, ratio1


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_dq_holds_the_f32_tolerance_and_1xtf32_does_not(case):
    """dQ as the dQ kernel computes it (S = Q.K^T, dP = dO.V^T and dS.K in
    3xTF32, after the 3xTF32 forward that gives its lse) against the JAX
    kernel's dQ; with one TF32 product it fails the same rule."""
    _, want = _case(case)
    ratio3 = _tol_ratio(_emulate(bmm_3xtf32, case)["dq"], want["dq"])
    ratio1 = _tol_ratio(_emulate(bmm_1xtf32, case)["dq"], want["dq"])
    assert ratio3 <= 1.0 < ratio1, (ratio3, ratio1)


def test_split_tf32_reconstructs_x_with_a_ten_bit_big():
    """Over random f32 bit patterns of every sign and mantissa and binary
    exponents -100..100 (normal numbers, as the kernels' operands are):
    big + small is x, big keeps at most 10 mantissa bits, small is at most
    half a TF32 step (2^-11 |x|), and big never flips x's sign."""
    rng = np.random.default_rng(7)
    n = 200_000
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exponent = rng.integers(127 - 100, 127 + 101, n).astype(np.uint32) << 23
    mantissa = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    # every rounding boundary: low 13 bits just under, at and over half
    mantissa[:3000] = (mantissa[:3000] & ~np.uint32(0x1FFF)) | np.repeat(
        np.array([0x0FFF, 0x1000, 0x1001], np.uint32), 1000)
    x = torch.from_numpy((sign | exponent | mantissa).view(np.float32))
    big, small = fa.split_tf32(x)
    xd, bd, sd = (t.double() for t in (x, big, small))
    assert ((bd + sd - xd).abs() <= 2.0 ** -22 * xd.abs()).all()
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert (sd.abs() <= 2.0 ** -11 * xd.abs()).all()
    assert (torch.sign(big) == torch.sign(x)).all()


def test_split_tf32_rounds_ties_away_from_zero():
    one_and_half_step = 1.0 + 2.0 ** -11  # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one_and_half_step, -one_and_half_step, 1.0 + 2.0 ** -12])
    big, small = fa.split_tf32(x)
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert (big + small == x).all()


def _round_toward_zero(x64):
    """float64 to f32, rounded toward zero."""
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


@pytest.mark.parametrize("product,tile", [("dv_over_2048_queries", 32),
                                          ("dq_over_2048_keys", 64)])
def test_a_fresh_partial_sum_per_tile_keeps_truncating_sums_inside_the_tolerance(product, tile):
    """A model of the tensor cores' f32 accumulation, sums rounded toward
    zero after each m16n8k8 product (the readings on the card point to it:
    PERF.md), in 3xTF32 over a contraction of 2048: dV = P^T.dO over the
    queries (dK/dV's 32-query stage), and dQ = dS.K over the keys (the dQ
    kernel's 64-key stage at D = 64; dS = p (dP + corr), signed).  One
    chain of products into one accumulator drifts the same way at every
    step and spends a quarter or more of the f32 tolerance; a zeroed
    partial sum per tile, folded in by a round-to-nearest add (what the
    kernels do), stays under a tenth of it."""
    rng = np.random.default_rng(11)
    t, d = 2048, 64
    logits = torch.from_numpy(rng.normal(size=(2, 64, t)) * 2)
    a = torch.softmax(logits, -1).float()  # 64 rows x t: p over one axis
    if product == "dq_over_2048_keys":
        a = a * torch.from_numpy(rng.normal(size=(2, 64, t)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, t, d)).astype(np.float32))
    ref = a.double() @ b.double()

    def tensor_cores(tile):
        acc = part = torch.zeros(2, 64, d)
        for k0 in range(0, t, 8):
            (a_big, a_small), (b_big, b_small) = (fa.split_tf32(x) for x in (
                a[..., k0:k0 + 8], b[:, k0:k0 + 8]))
            a_small, b_small = _tensor_core_read(a_small), _tensor_core_read(b_small)
            for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = _round_toward_zero(part.double() + x.double() @ y.double())
            if tile and (k0 + 8) % tile == 0:
                acc, part = acc + part, torch.zeros_like(part)
        return acc + part

    one_chain = _tol_ratio(tensor_cores(0).numpy(), ref.numpy())
    per_tile = _tol_ratio(tensor_cores(tile).numpy(), ref.numpy())
    assert per_tile < 0.1 < 0.25 < one_chain, (per_tile, one_chain)
