"""Flash attention above head dim 128 and in float16, the JAX kernel's range:
the port's ``flash_attention_with_lse`` against the JAX package's Pallas
kernel (interpret mode on the CPU), forward (o, lse) and gradients through
``jax.vjp`` with a nonzero lse cotangent, at D = 160, 192 and 256 in bf16,
f16 and f32.  On the CPU the port's wrappers run their plain versions; the
CUDA kernels (bf16 and f16 up to D = 256) are held against those plain
versions on the card (``chip_smoke.py`` phase ``kernel_times_d256``).

f32 is held to the JAX kernel at ``ATOL``, as in
``test_torch_flash_attention.py``.  In bf16 and f16 both sides round p, dS
and the outputs to the input dtype at their own points, so each is held to a
float64 dense attention of the same (rounded) inputs instead: the port no
farther from it than the JAX kernel is, plus one unit in the last place of
the dtype at the output's scale."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bluefog_tpu.kernels.flash_attention import flash_attention_with_lse as jax_flash
from bluefog_tpu_torch.kernels import flash_attention_with_lse

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
torch.set_num_threads(1)

B, T, H = 1, 64, 2
ATOL = 2e-5  # f32 on both sides; sums in a different order
BLOCK = 32  # the JAX kernel's block_q and block_k
MANTISSA = {"bfloat16": 7, "float16": 10}  # explicit mantissa bits
CASES = {  # q_start, k_start, causal
    "causal": (0, 0, True),
    "non_causal": (0, 0, False),
    "offset": (32, 0, True),  # a ring hop: the queries 32 positions after the keys
}


def _inputs(seed, d, dtype):
    """q, k, v, dO [B, T, H, d] in ``dtype``'s values (as f32 numpy) and the
    lse cotangent [B, H, T] f32."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, T, H, d)).astype(np.float32) for _ in range(4)]
    xs = [torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy() for x in xs]
    return (*xs, rng.normal(size=(B, H, T)).astype(np.float32))


def _jax(q, k, v, g, g_lse, q_start, k_start, causal, dtype):
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, q_start=q_start, k_start=k_start, causal=causal,
                         block_q=BLOCK, block_k=BLOCK, interpret=True, impl="pallas")

    cast = (lambda x: jnp.asarray(x, dtype=getattr(jnp, dtype)))
    (o, lse), vjp = jax.vjp(f, cast(q), cast(k), cast(v))
    grads = vjp((cast(g), jnp.asarray(g_lse)))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (o, lse, *grads)]


def _port(q, k, v, g, g_lse, q_start, k_start, causal, dtype):
    ts = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*ts, q_start=q_start, k_start=k_start, causal=causal)
    torch.autograd.backward((o, lse), (torch.from_numpy(g).to(o.dtype),
                                       torch.from_numpy(g_lse)))
    return [x.detach().float().numpy() for x in (o, lse, *(t.grad for t in ts))]


def _dense64(q, k, v, g, g_lse, q_start, k_start, causal):
    """(o, lse, dq, dk, dv) of dense softmax attention in float64."""
    ts = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in ts)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        qpos = q_start + torch.arange(T)[:, None]
        kpos = k_start + torch.arange(T)[None, :]
        s = s.masked_fill(kpos > qpos, -math.inf)
    lse = torch.logsumexp(s, -1)
    o = (torch.softmax(s, -1) @ vh).permute(0, 2, 1, 3)
    torch.autograd.backward((o, lse), (torch.from_numpy(g).double(),
                                       torch.from_numpy(g_lse).double()))
    return [x.detach().numpy() for x in (o, lse, *(t.grad for t in ts))]


def _ulp(dtype, scale):
    """One unit in the last place of ``dtype`` at magnitude ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - MANTISSA[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_flash_above_head_dim_128_matches_the_pallas_kernel(d, dtype, case):
    q_start, k_start, causal = CASES[case]
    args = _inputs(d + len(case), d, dtype)
    want = _jax(*args, q_start, k_start, causal, dtype)
    got = _port(*args, q_start, k_start, causal, dtype)
    names = ("o", "lse", "dq", "dk", "dv")
    if dtype == "float32":
        for name, a, b in zip(names, got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6 if name == "lse" else 0, atol=ATOL,
                                       err_msg=name)
        return
    truth = _dense64(*args, q_start, k_start, causal)
    for name, a, b, t in zip(names, got, want, truth):
        scale = float(np.abs(t).max())
        port_err = float(np.abs(a - t).max())
        jax_err = float(np.abs(b - t).max())
        assert port_err <= jax_err + _ulp(dtype, scale), (name, port_err, jax_err, scale)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_head_dim_160_pads_to_256_exactly(kernel):
    """pad_head_dim takes D = 160 to the kernels' 256 (zero columns, results
    cut back): through the plain versions every output is within 1e-6 of
    the largest of the unpadded result (f32 sums over the zero columns in
    another order), in the unpadded shape."""
    rng = np.random.default_rng(160)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 96, 160)).astype(np.float32))
                  for _ in range(4))
    kw = dict(scale=160 ** -0.5, causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, 8, 0, **kw)
    corr = torch.from_numpy(rng.normal(size=(2, 96)).astype(np.float32)) - (o * g).sum(-1)
    args = {"fwd": (q, k, v, 8, 0), "dkv": (q, k, v, g, lse, corr, 8, 0),
            "dq": (q, k, v, g, lse, corr, 8, 0)}[kernel]
    plain = getattr(fa, f"flash_{kernel}_plain")
    seen = []

    def spy(*a, **kw_):
        seen.append(a[0].shape[-1])
        return plain(*a, **kw_)

    want = plain(*args, **kw)
    got = fa.pad_head_dim(spy, *args, **kw)
    assert seen == [256]
    want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), (a - b).abs().max()


def _dense_rounding(q, k, v, g, lse, corr, scale, rounding):
    """o, dK, dV, dQ of causal attention in f32 dense products, p and dS
    rounded to ``rounding`` before their products (the forward's p relative
    to the row's max, the backward's from lse), the outputs in q's dtype."""
    t = q.shape[1]
    s = (q.float() @ k.float().transpose(1, 2) * scale).masked_fill(
        torch.ones(t, t, dtype=torch.bool).triu(1), -math.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e.to(rounding).float() @ v.float()) / e.sum(-1, keepdim=True)
    p = torch.exp(s - lse[..., None])
    ds = (p * (g.float() @ v.float().transpose(1, 2) + corr[..., None])).to(rounding).float()
    dv = p.to(rounding).float().transpose(1, 2) @ g.float()
    dk = ds.transpose(1, 2) @ q.float() * scale
    dq = ds @ k.float() * scale
    return {name: x.to(q.dtype) for name, x in (("o", o), ("dk", dk), ("dv", dv), ("dq", dq))}


@pytest.mark.parametrize("d", [64, 256])
def test_f16_rule_fails_p_and_ds_rounded_to_bf16(d):
    """chip_smoke.py's f16 rule, which holds the f16 kernels to their plain
    versions on the card: a dense version that rounds p and dS to f16 as the
    kernels do passes it against the plain versions (their rounding points
    differ, as the kernels' do), and one that rounds them to bf16 fails its
    norm gate at every output."""
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(4, 256, d)).astype(np.float32)).half()
                  for _ in range(4))
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, 0, 0, **kw)
    corr = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)) \
        - (o.float() * g.float()).sum(-1)
    dk, dv = fa.flash_dkv_plain(q, k, v, g, lse, corr, 0, 0, **kw)
    dq = fa.flash_dq_plain(q, k, v, g, lse, corr, 0, 0, **kw)
    plain = {"o": o, "dk": dk, "dv": dv, "dq": dq}
    rule = (chip_smoke.F16_ELEM_REL, chip_smoke.F16_ELEM_RMS)
    for rounding, passes in ((torch.float16, True), (torch.bfloat16, False)):
        got = _dense_rounding(q, k, v, g, lse, corr, kw["scale"], rounding)
        for name, ref in plain.items():
            _, ratio, norm = chip_smoke.compare(got[name], ref, *rule)
            if passes:
                assert ratio <= 1.0 and norm <= chip_smoke.F16_NORM_REL, (name, ratio, norm)
            else:
                assert norm > chip_smoke.F16_NORM_REL, (name, norm)
