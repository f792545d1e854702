"""The CUDA kernels of bluefog_tpu_torch on the card, against their plain
versions.  Every test here needs a CUDA device and skips without one.
This file imports neither jax nor the JAX package, so it runs on a machine
that has only torch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import importlib

import pytest
import torch

from bluefog_tpu_torch.kernels import flash_attention_with_lse

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    """Per element |err| <= 2^-7 |want| + 2^-6 rms(want), and ||err|| <=
    1e-2 ||want||: one bf16 step of the value itself (both versions round
    their f32 sums to bf16 once), plus a few bf16 steps of p or dS that
    round differently inside the sums.  Each value is held to its own size."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = 2.0 ** -7 * want.abs() + 2.0 ** -6 * want.pow(2).mean().sqrt()
    assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())
    assert err.norm() <= 1e-2 * want.norm(), (err.norm() / want.norm()).item()


def _close_lse(got, want):
    """lse is f32 and never rounded to bf16: within 1e-3 on rows with a
    visible key, the sentinel on rows without one."""
    visible = want > -1e29
    assert (got[~visible] < -1e29).all()
    err = (got - want)[visible].abs()
    assert err.numel() == 0 or err.max() <= 1e-3, err.max().item()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_start,k_start,causal", [(0, 0, True), (96, 0, True),
                                                     (0, 0, False), (0, 512, True)])
def test_kernels_match_plain_versions(cuda_device, d, q_start, k_start, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(d + q_start + k_start)
    q, k, v, g = (torch.randn(4, 320, d, generator=gen, device=cuda_device)
                  .bfloat16() for _ in range(4))
    g_lse = torch.randn(4, 320, generator=gen, device=cuda_device)
    kw = dict(scale=d ** -0.5, causal=causal)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, q_start, k_start, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, q_start, k_start, **kw)
    corr = (g_lse - (o_ref.float() * g.float()).sum(-1)).contiguous()
    dk, dv = fa.flash_dkv(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dq = fa.flash_dq(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dq_ref = fa.flash_dq_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    _close_lse(lse, lse_ref)
    for got, want in ((o, o_ref), (dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
        _close(got, want)
    assert {n: fa.launches[n] - before[n] for n in before} == {"fwd": 1, "dkv": 1, "dq": 1}


def test_autograd_on_the_card_matches_the_cpu_plain_path(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x = [torch.randn(2, 192, 4, 64, generator=gen).bfloat16() for _ in range(3)]
    g = torch.randn(2, 192, 4, 64, generator=gen).bfloat16()
    g_lse = torch.randn(2, 4, 192, generator=gen)
    outs = []
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_(True) for t in x]
        o, lse = flash_attention_with_lse(*leaves, q_start=0, k_start=0, causal=True)
        grads = torch.autograd.grad((o, lse), leaves, (g.to(dev), g_lse.to(dev)))
        outs.append([t.detach().cpu() for t in (o, lse, *grads)])
    (o, lse, *grads), (o_ref, lse_ref, *grads_ref) = outs
    _close_lse(lse, lse_ref)
    for got, want in zip([o, *grads], [o_ref, *grads_ref]):
        _close(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(),
                     q[..., :32].contiguous(), scale=1.0, causal=True)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_fwd(q.float(), q.float(), q.float(), scale=1.0, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        fa.flash_fwd(t, t, t, scale=1.0, causal=True)
