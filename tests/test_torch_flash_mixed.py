"""Flash attention on q, k, v of mixed float dtypes, which the JAX kernel
takes: the wrappers' promotion rule (a pure function, and the CUDA route's
dtype plumbing with the launchers replaced by recorders), and the port's
``flash_attention_with_lse`` against the JAX package's Pallas kernel
(interpret mode on the CPU), forward and gradients through ``jax.vjp`` with
a nonzero lse cotangent.

Every mix of bf16, f16 and f32 promotes to f32, so on the card the f32
kernels run, rounding p and dS where the JAX kernel rounds them (p to v's
dtype before P.V, to dO's before P^T.dO, dS to q's); on the CPU the
wrappers' plain versions round at the same points.  Outputs come back in
the JAX kernel's dtypes: o and dQ in q's, dK in k's, dV in v's.  The
tolerance is the rule of the narrowest dtype present, bf16's in all four
mixes here (``chip_smoke.py``'s: per element |err| <= 2^-7 |ref| + 2^-6
rms(ref), ||err|| <= 1e-2 ||ref||), as both sides round p, dS and the
outputs to bf16 at the same points and may land on either side of a
rounding boundary; lse is f32 on both sides and never rounded: within
2e-5 (``F32_LSE_ABS``) on rows with a visible key."""

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
BLOCK = 32  # the JAX kernel's block_q and block_k
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# (q, k, v) dtypes -> the f32 kernels' rounding arguments of the forward,
# dK/dV and dQ: p to v's dtype (forward) and to dO's = q's (dK/dV), dS to q's
MIXES = {
    "bf16-f32-f32": ((BF16, F32, F32), (0, 1 | 1 << 2, 1 << 2)),
    "f32-bf16-bf16": ((F32, BF16, BF16), (1, 0, 0)),
    "bf16-bf16-f32": ((BF16, BF16, F32), (0, 1 | 1 << 2, 1 << 2)),
    "f16-bf16-bf16": ((F16, BF16, BF16), (1, 2 | 2 << 2, 2 << 2)),
}


def test_kernel_dtype_is_the_promoted_type():
    for dt in (BF16, F16, F32):
        assert fa.kernel_dtype(dt, dt, dt, dt) == dt
    for dtypes, _ in MIXES.values():
        assert fa.kernel_dtype(*dtypes) == F32
    assert fa.kernel_dtype(BF16, F16) == F32
    assert fa.rounding() == 0 and fa.rounding(p=F32, ds=F32) == 0


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_dtypes_run_the_f32_kernels_and_return_the_jax_kernel_dtypes(mix, monkeypatch):
    """The CUDA route of each wrapper with its launcher replaced by a
    recorder: every operand reaches the launcher in f32 with the rounding
    the JAX kernel applies, and each output leaves in its JAX dtype."""
    (dq_t, dk_t, dv_t), want_rounding = MIXES[mix]
    seen = []

    def record(name, n_out):
        def launch(*args, scale, causal, rounding):
            tensors = [a for a in args if isinstance(a, torch.Tensor) and a.dim() == 3]
            seen.append((name, {a.dtype for a in tensors}, rounding))
            outs = tuple(torch.zeros_like(tensors[0]) for _ in range(n_out))
            if name == "fwd":
                return outs[0], torch.zeros(tensors[0].shape[:2])
            return outs if n_out > 1 else outs[0]
        return launch

    monkeypatch.setattr(fa, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(fa, "_launch_fwd", record("fwd", 1))
    monkeypatch.setattr(fa, "_launch_dkv", record("dkv", 2))
    monkeypatch.setattr(fa, "_launch_dq", record("dq", 1))
    q, k, v = (torch.zeros(2, 64, 64, dtype=dt) for dt in (dq_t, dk_t, dv_t))
    g = torch.zeros(2, 64, 64, dtype=dq_t)  # dO in o's dtype, as autograd gives it
    lse = corr = torch.zeros(2, 64)
    kw = dict(scale=0.125, causal=True)
    o, lse_out = fa.flash_fwd(q, k, v, **kw)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, corr, **kw)
    dq = fa.flash_dq(q, k, v, g, lse, corr, **kw)
    assert [s[0] for s in seen] == ["fwd", "dkv", "dq"]
    assert all(s[1] == {F32} for s in seen), seen
    assert tuple(s[2] for s in seen) == want_rounding
    assert (o.dtype, lse_out.dtype, dq.dtype, dk.dtype, dv.dtype) == (dq_t, F32, dq_t, dk_t, dv_t)


def _inputs(seed, d, dtypes):
    """q, k, v, dO [B, T, H, d] as f32 numpy holding values of their
    dtypes (dO q's), and the lse cotangent [B, H, T] f32."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, T, H, d)).astype(np.float32) for _ in range(4)]
    xs = [torch.from_numpy(x).to(dt).float().numpy()
          for x, dt in zip(xs, (*dtypes, dtypes[0]))]
    return (*xs, rng.normal(size=(B, H, T)).astype(np.float32))


def _jax(q, k, v, g, g_lse, dtypes):
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=True, block_q=BLOCK, block_k=BLOCK,
                         interpret=True, impl="pallas")

    cast = [jnp.asarray(x, dtype=getattr(jnp, str(dt)[6:])) for x, dt in zip((q, k, v), dtypes)]
    (o, lse), vjp = jax.vjp(f, *cast)
    grads = vjp((jnp.asarray(g, dtype=o.dtype), jnp.asarray(g_lse)))
    return [(str(x.dtype), np.asarray(jnp.asarray(x, jnp.float32))) for x in (o, lse, *grads)]


def _port(q, k, v, g, g_lse, dtypes):
    ts = [torch.from_numpy(x).to(dt).requires_grad_() for x, dt in zip((q, k, v), dtypes)]
    o, lse = flash_attention_with_lse(*ts, causal=True)
    torch.autograd.backward((o, lse), (torch.from_numpy(g).to(o.dtype), torch.from_numpy(g_lse)))
    return [(str(x.dtype)[6:], x.detach().float().numpy())
            for x in (o, lse, *(t.grad for t in ts))]


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_dtypes_match_the_pallas_kernel(mix, d):
    dtypes, _ = MIXES[mix]
    args = _inputs(d + sorted(MIXES).index(mix), d, dtypes)
    want = _jax(*args, dtypes)
    got = _port(*args, dtypes)
    names = ("o", "lse", "dq", "dk", "dv")
    assert [w[0] for w in want] == [g[0] for g in got], (want, got)
    (_, lse), (_, lse_ref) = got[1], want[1]
    assert np.abs(lse - lse_ref).max() <= chip_smoke.F32_LSE_ABS
    for name, (_, a), (_, b) in zip(names, got, want):
        if name == "lse":
            continue
        err, ratio, norm_rel = chip_smoke.compare(torch.tensor(a), torch.tensor(b))
        assert ratio <= 1.0 and norm_rel <= chip_smoke.NORM_REL, (name, err, ratio, norm_rel)
        assert math.isfinite(err)


@pytest.mark.parametrize("mix", ["bf16-f32-f32", "bf16-bf16-f32"])
def test_promotion_without_the_jax_roundings_leaves_the_bf16_rule(mix):
    """Why the f32 kernels round p and dS on mixed inputs: at the mixed
    cases' shape on the card ([8, 1024, 64], causal), the promoted inputs'
    attention with p and dS left in f32 (the plain versions on the inputs
    cast to f32, outputs cast back) leaves the bf16 rule of the plain
    version, which rounds them as the JAX kernel does, at some element."""
    dtypes, _ = MIXES[mix]
    gen = torch.Generator().manual_seed(64)
    q, k, v = (torch.randn(8, 1024, 64, generator=gen).to(dt) for dt in dtypes)
    g = torch.randn(8, 1024, 64, generator=gen).to(dtypes[0])
    kw = dict(scale=0.125, causal=True)
    o_ref, lse = fa.flash_fwd_plain(q, k, v, **kw)
    corr = (torch.randn(8, 1024, generator=gen) - (o_ref.float() * g.float()).sum(-1))
    want = (*fa.flash_dkv_plain(q, k, v, g, lse, corr, **kw),
            fa.flash_dq_plain(q, k, v, g, lse, corr, **kw))
    f = [x.float() for x in (q, k, v, g)]
    dk, dv = fa.flash_dkv_plain(*f, lse, corr, **kw)
    got = (dk.to(k.dtype), dv.to(v.dtype), fa.flash_dq_plain(*f, lse, corr, **kw).to(q.dtype))
    ratios = [chip_smoke.compare(a, b)[1] for a, b in zip(got, want)]
    assert max(ratios) > 1.0, ratios
