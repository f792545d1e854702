"""The CUDA kernels of bluefog_tpu_torch on the card, against their plain
versions.  Every test here needs a CUDA device and skips without one.
This file imports neither jax nor the JAX package, so it runs on a machine
that has only torch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import importlib
import re

import pytest
import torch

from bluefog_tpu_torch import profiling
from bluefog_tpu_torch.benchmarks import attention_roofline as roof
from bluefog_tpu_torch.kernels import _build
from bluefog_tpu_torch.kernels import attention_components as ac
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
@pytest.mark.parametrize("tq,tk,q_start,k_start,causal", [
    (320, 320, 0, 0, True), (320, 320, 96, 0, True), (320, 320, 0, 0, False),
    (320, 320, 0, 512, True),
    (320, 192, 128, 0, True), (192, 448, 0, 0, False),    # tq != tk
    (200, 200, 0, 0, True), (40, 40, 0, 0, True),          # T % 128 != 0, T < 64
    (200, 200, 37, 0, True), (256, 320, 0, 45, True),      # offsets not on a tile
    (600, 600, 0, 0, True)])                               # 10 key tiles: rings wrap
def test_kernels_match_plain_versions(cuda_device, d, tq, tk, q_start, k_start, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(d + tq + tk + q_start + k_start)
    q, g = (torch.randn(4, tq, d, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    k, v = (torch.randn(4, tk, d, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    g_lse = torch.randn(4, tq, generator=gen, device=cuda_device)
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


def test_redesigned_kernels_run_on_wgmma_and_tma(cuda_device):
    """Every flash kernel's SASS holds warpgroup products (HGMMA) and TMA
    tile loads (UTMALDG) at both head dims, and no mma.sync (HMMA)."""
    funcs = _build.sass("flash_attention")
    if funcs is None:
        pytest.skip("cuobjdump not found")
    for kernel in ("fwd_kernel", "dkv_kernel", "dq_kernel"):
        bodies = [body for name, body in funcs.items() if kernel in name]
        assert len(bodies) == 2, sorted(funcs)  # D = 64 and 128
        for body in bodies:
            assert "HGMMA" in body and "UTMALDG" in body
            assert not re.search(r"\bHMMA\b", body)


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


@pytest.mark.parametrize("body", [True, False])
@pytest.mark.parametrize("name,d,kw", ac.INSTANCES)
def test_components_match_plain_versions(cuda_device, name, d, kw, body):
    """Each roofline microkernel against its plain version at reps 1 (the
    body) and 2 (the fed-back row), on several blocks; the rule is
    attention_components.compare."""
    args = roof.component_inputs(d, seed=3)[name]
    before = ac.launches[name]
    for reps in (1, 2):
        got = roof.WRAPPERS[name](*args, reps, body=body, blocks=5, **kw)
        ref = ac.PLAIN[name](*args, reps, body=body, blocks=5, **kw)
        assert bool((got == got[:1]).all())
        res = ac.compare(name, got, ref, args, reps, body=body, **kw)
        assert res["ok"], res
    assert ac.launches[name] - before == 2


def test_matched_smem_holds_the_flash_kernels_blocks_per_sm(cuda_device):
    for kname, d in (("fwd", 64), ("dkv", 64), ("dq", 128)):
        flash = fa.occupancy(kname, d)
        assert flash["blocks_per_sm"] >= 1 and flash["regs"] > 0
        assert flash["threads"] == 384
        chain, kw = roof.MODELS[kname][2]
        for name, ckw in (("qk", {}), ("pv", {}), (chain, kw)):
            smem = roof.matched_smem(name, ckw, d, flash)
            occ = ac.occupancy(name, d=d, smem_bytes=smem, **ckw)
            assert occ["smem"] >= flash["smem"]
            assert occ["blocks_per_sm"] <= flash["blocks_per_sm"]


def test_graph_seconds_reads_the_device_time_of_a_short_launch(cuda_device):
    """A forward over 128 keys takes a few microseconds on the card, less
    than its wrapper's host time: replayed from a graph it reads below what
    events around eager calls read."""
    q, k, v = (torch.randn(24, 128, 64, device=cuda_device).bfloat16() for _ in range(3))
    fn = lambda: fa.flash_fwd(q, k, v, scale=0.125, causal=True)  # noqa: E731
    graph = profiling.graph_seconds(fn, calls=20)
    eager = roof.measured_seconds(fn, "short")[0]
    assert 0 < graph < 1e-3 and graph <= eager
