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


@pytest.mark.parametrize("d", [64, 128, 16, 96])  # 16 and 96 run zero-padded
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
    wide = torch.zeros(2, 64, 160, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(wide, wide, wide, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="bf16 or float32"):
        fa.flash_fwd(q.half(), q.half(), q.half(), scale=1.0, causal=True)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, q.float(), q, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        fa.flash_fwd(t, t, t, scale=1.0, causal=True)


@pytest.mark.parametrize("body", [True, False])
@pytest.mark.parametrize("name,d,kw", ac.INSTANCES)
def test_components_match_plain_versions(cuda_device, name, d, kw, body):
    """Each roofline microkernel against its plain version at reps 1 (the
    body), 2 (the fed-back row) and 3 (for qk and pv a shared-memory
    operand rewritten over a rewritten one; for every component a row
    published into the ping-pong buffer reps 1 used), on several blocks,
    every slice (both warpgroups of every block) equal; the rule is
    attention_components.compare."""
    args = roof.component_inputs(d, seed=3)[name]
    before = ac.launches[name]
    all_reps = (1, 2, 3)
    for reps in all_reps:
        got = roof.WRAPPERS[name](*args, reps, body=body, blocks=5, **kw)
        ref = ac.PLAIN[name](*args, reps, body=body, blocks=5, **kw)
        assert got.shape[0] == 5 * ac.TILES_PER_BLOCK[name]
        assert bool((got == got[:1]).all())
        res = ac.compare(name, got, ref, args, reps, body=body, **kw)
        assert res["ok"], res
    assert ac.launches[name] - before == len(all_reps)


def test_product_microkernels_run_on_wgmma(cuda_device):
    """qk and pv with their body hold warpgroup products (HGMMA) at both
    head dims; no instance holds mma.sync (HMMA)."""
    funcs = _build.sass("attention_components")
    if funcs is None:
        pytest.skip("cuobjdump not found")
    for name in ("qk", "pv"):
        for d in (64, 128):
            for body in (1, 0):
                found = [b for f, b in funcs.items()
                         if re.search(rf"{name}_kernelILi{d}ELb{body}E", f)]
                assert len(found) == 1, sorted(funcs)
                assert ("HGMMA" in found[0]) == bool(body)
                assert not re.search(r"\bHMMA\b", found[0])


def test_chain_microkernels_run_ex2_without_mma(cuda_device):
    """The chains with their body hold MUFU.EX2 (ex2.approx); no instance
    holds mma.sync (HMMA)."""
    funcs = _build.sass("attention_components")
    if funcs is None:
        pytest.skip("cuobjdump not found")
    patterns = ["softmax_chain_kernelILb{body}E"] + [
        f"bwd_chain_kernelILb{cast_p}ELb{{body}}E" for cast_p in (1, 0)]
    for pattern in patterns:
        for body in (1, 0):
            found = [b for f, b in funcs.items() if re.search(pattern.format(body=body), f)]
            assert len(found) == 1, sorted(funcs)
            assert ("MUFU.EX2" in found[0]) == bool(body)
            assert not re.search(r"\bHMMA\b", found[0])


@pytest.mark.parametrize("name,cast_p", sorted(roof.CHAIN_PIPES))
def test_chain_bound_counts_match_the_sass(cuda_device, name, cast_p):
    """The instructions an element per pipe that the chains' bound prices
    (attention_roofline.CHAIN_PIPES) are those of the built kernels' loop."""
    funcs = _build.sass("attention_components")
    if funcs is None:
        pytest.skip("cuobjdump not found")
    pattern = ("softmax_chain_kernelILb1E" if name == "softmax_chain"
               else f"bwd_chain_kernelILb{int(cast_p)}ELb1E")
    found = [b for f, b in funcs.items() if pattern in f]
    assert len(found) == 1, sorted(funcs)
    assert roof.loop_pipe_counts(found[0]) == roof.CHAIN_PIPES[name, cast_p]


@pytest.mark.parametrize("name,d,kw", ac.INSTANCES)
def test_microkernel_occupancy_reports_tiles_per_block(cuda_device, name, d, kw):
    """Every microkernel runs the flash block: one a SM (by registers, at
    the least shared memory) and two tiles a block."""
    for body in (True, False):
        occ = ac.occupancy(name, d=d, body=body, **kw)
        assert occ["tiles_per_block"] == ac.TILES_PER_BLOCK[name] == 2
        assert occ["blocks_per_sm"] == 1 and occ["regs"] >= 128, occ


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


def test_tiny_example_trains_on_the_card(cuda_device):
    """The example's tiny preset (head dim 16) with its defaults, flash
    attention on the card, for two steps: finite losses, and every flash
    kernel launched."""
    from bluefog_tpu_torch.examples import llama_pretrain

    fa.reset_launches()
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "tiny", "--steps", "2"]))
    losses = [x for step in out["losses"] for x in step]
    assert len(losses) == 2 * 4 and all(torch.isfinite(torch.tensor(losses)))
    assert all(n > 0 for n in fa.launches.values()), fa.launches


def _close_f32(got, want):
    """f32 kernel against its plain version, both f32 throughout:
    |err| <= 2^-14 (|want| + rms(want)) per element (the same products
    summed in another order move a value by a few f32 steps)."""
    err = (got - want).abs()
    tol = 2.0 ** -14 * (want.abs() + want.pow(2).mean().sqrt())
    assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())


@pytest.mark.parametrize("d", [64, 128, 16])  # 16 runs zero-padded to 64
@pytest.mark.parametrize("tq,tk,q_start,k_start,causal", [
    (320, 320, 0, 0, True), (320, 320, 96, 0, True), (320, 320, 0, 0, False),
    (320, 320, 0, 512, True), (320, 192, 128, 0, True), (192, 448, 0, 0, False),
    (200, 200, 37, 0, True), (256, 320, 0, 45, True), (40, 40, 0, 0, True)])
def test_f32_kernels_match_plain_versions(cuda_device, d, tq, tk, q_start, k_start, causal):
    _check_f32_kernels(cuda_device, 4, d, tq, tk, q_start, k_start, causal)


@pytest.mark.parametrize("bh,t,d", [(24, 2048, 64), (8, 1024, 128), (24, 2048, 128)])
def test_f32_kernels_match_plain_versions_at_full_size(cuda_device, bh, t, d):
    """The f32 path's own shape (batch 2 x 12 heads, T = 2048, D = 64), and
    D = 128 at T = 1024, where dK/dV's shared memory is fullest, and at
    T = 2048, where a dQ row sums the most keys: many blocks a SM in turn,
    every ring wrapping 8 to 32 times."""
    _check_f32_kernels(cuda_device, bh, d, t, t, 0, 0, True)


def _check_f32_kernels(cuda_device, bh, d, tq, tk, q_start, k_start, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(d + tq + tk + q_start + k_start)
    q, g = (torch.randn(bh, tq, d, generator=gen, device=cuda_device) for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=gen, device=cuda_device) for _ in range(2))
    g_lse = torch.randn(bh, tq, generator=gen, device=cuda_device)
    kw = dict(scale=d ** -0.5, causal=causal)
    before, before_bf16 = dict(fa.launches_f32), dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, q_start, k_start, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, q_start, k_start, **kw)
    corr = (g_lse - (o_ref * g).sum(-1)).contiguous()
    dk, dv = fa.flash_dkv(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dq = fa.flash_dq(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    dq_ref = fa.flash_dq_plain(q, k, v, g, lse_ref, corr, q_start, k_start, **kw)
    visible = lse_ref > -1e29
    assert (lse[~visible] < -1e29).all()
    assert ((lse - lse_ref)[visible].abs() <= 2e-5).all()
    for got, want in ((o, o_ref), (dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
        assert got.dtype == torch.float32
        _close_f32(got, want)
    assert {n: fa.launches_f32[n] - before[n] for n in before} == {"fwd": 1, "dkv": 1, "dq": 1}
    assert fa.launches == before_bf16


def test_f32_fwd_dkv_and_dq_run_on_tf32_tensor_cores(cuda_device):
    """The three f32 kernels (3xTF32) hold TF32 tensor-core products in
    their SASS at both head dims (mma.sync: HMMA.1688.F32.TF32, or wgmma:
    HGMMA ... TF32)."""
    funcs = _build.sass("flash_attention_f32")
    if funcs is None:
        pytest.skip("cuobjdump not found")
    tf32 = re.compile(r"\bHMMA\.\w+\.F32\.TF32\b|\bHGMMA\.\S*TF32")
    for kernel in ("fwd_f32_kernel", "dkv_f32_kernel", "dq_f32_kernel"):
        bodies = [body for name, body in funcs.items() if kernel in name]
        assert len(bodies) == 2, sorted(funcs)  # D = 64 and 128
        for body in bodies:
            assert tf32.search(body), kernel


def test_f32_autograd_on_the_card_matches_the_cpu_plain_path(cuda_device):
    gen = torch.Generator().manual_seed(1)
    x = [torch.randn(2, 192, 4, 64, generator=gen) for _ in range(3)]
    g = torch.randn(2, 192, 4, 64, generator=gen)
    g_lse = torch.randn(2, 4, 192, generator=gen)
    outs = []
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_(True) for t in x]
        o, lse = flash_attention_with_lse(*leaves, q_start=0, k_start=0, causal=True)
        grads = torch.autograd.grad((o, lse), leaves, (g.to(dev), g_lse.to(dev)))
        outs.append([t.detach().cpu() for t in (o, lse, *grads)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_f32_llama_with_flash_trains_on_the_card(cuda_device):
    """LlamaLM(dtype=float32) with flash attention: the example's tiny
    preset in f32 (head dim 16, zero-padded), two steps on 4 ranks, every
    f32 kernel launched layers x ranks x steps times and no bf16 kernel."""
    from bluefog_tpu_torch.examples import llama_pretrain

    fa.reset_launches()
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "tiny", "--dtype", "f32", "--steps", "2"]))
    losses = [x for step in out["losses"] for x in step]
    assert len(losses) == 2 * 4 and all(torch.isfinite(torch.tensor(losses)))
    assert fa.launches_f32 == {k: out["layers"] * 4 * 2 for k in ("fwd", "dkv", "dq")}
    assert not any(fa.launches.values()), fa.launches


@pytest.mark.parametrize("head_chunks", [0, 4])
def test_bf16_head_tracks_the_f32_head_on_the_card(cuda_device, head_chunks):
    """head_dtype=bf16 rounds the head's operands (and its cotangent) to
    bf16 and accumulates in f32: on the card the loss stays within rtol
    5e-3 of the f32 head's and every gradient within 2e-2, the tolerance
    the reference's own bf16-head test holds; the logits stay f32."""
    from bluefog_tpu_torch.models.transformer import LlamaLM

    torch.backends.cuda.matmul.allow_tf32 = False
    ids = torch.randint(0, 97, (2, 64), generator=torch.Generator().manual_seed(1))
    ids = ids.to(cuda_device)
    results = []
    for head_dtype in (torch.float32, torch.bfloat16):
        model = LlamaLM(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, dff=128,
                        dtype=torch.float32, head_chunks=head_chunks, head_dtype=head_dtype,
                        device="cpu", generator=torch.Generator().manual_seed(0)).to(cuda_device)
        assert model(ids).dtype == torch.float32
        loss = model(ids, labels=ids)
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (want, g_want), (got, g_got) = results
    assert abs(got - want) <= 5e-3 * abs(want)
    for name, g in g_got.items():
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, g_want[name], rtol=2e-2, atol=2e-2, msg=name)


def _flax_resnet_tree(model):
    """A flax-shaped (params, batch_stats) tree of numpy arrays holding a
    port ResNet's weights, for resnet_state_dict to carry back."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, stats = {}, {}

    def norm(src, dst_name, tree_p, tree_s):
        tree_p[dst_name] = {"scale": sd[src + ".scale"], "bias": sd[src + ".bias"]}
        tree_s[dst_name] = {"mean": sd[src + ".mean"], "var": sd[src + ".var"]}

    params["conv_init"] = {"kernel": sd["conv_init.weight"].transpose(2, 3, 1, 0)}
    norm("bn_init", "bn_init", params, stats)
    for i, block in enumerate(model.blocks):
        name = f"{type(block).__name__}_{i}"
        params[name], stats[name] = {}, {}
        for j in range(len(block.convs)):
            w = sd[f"blocks.{i}.convs.{j}.weight"]
            params[name][f"Conv_{j}"] = {"kernel": w.transpose(2, 3, 1, 0)}
            norm(f"blocks.{i}.norms.{j}", f"BatchNorm_{j}", params[name], stats[name])
    params["Dense_0"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}
    return params, stats


def test_resnet_state_dict_gives_the_same_logits_on_the_card(cuda_device):
    """Weights carried by resnet_state_dict into a bf16 ResNet-18 give the
    same logits on the card (cuDNN) as on the CPU, in training mode (batch
    statistics) and in eval mode: ||err|| <= 2^-5 ||ref||, a few bf16 steps
    (2^-8 each) compounded over the layers."""
    from bluefog_tpu_torch.interop.jax_weights import resnet_state_dict
    from bluefog_tpu_torch.models import ResNet18

    src = ResNet18(num_classes=10, num_filters=8, small_images=True, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # nonzero last-norm scales and statistics
        for name, t in src.state_dict().items():
            if name.endswith((".scale", ".var")):
                t.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    sd = resnet_state_dict(*_flax_resnet_tree(src))
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    for train in (True, False):
        logits = []
        for dev in ("cpu", cuda_device):
            model = ResNet18(num_classes=10, num_filters=8, small_images=True, device="cpu")
            model.load_state_dict(sd)
            model.to(dev).train(train)
            logits.append(model(x.to(dev)).detach().cpu())
        want, got = logits
        assert (got - want).norm() <= 2.0 ** -5 * want.norm(), (train, (got - want).norm())


def test_mnist_example_trains_on_the_card(cuda_device):
    """examples/torch_mnist (LeNet-5, 4 ranks, gossip) on the card: the
    train loss falls from the first epoch to the second."""
    from bluefog_tpu_torch.examples import torch_mnist

    out = torch_mnist.run(torch_mnist._parser().parse_args(
        ["--epochs", "2", "--train-size", "1024"]))
    assert out["device"].startswith("cuda")
    first, last = (out["epochs"][i]["train_loss"] for i in (0, -1))
    assert last < first, (first, last)


def _window_sequence(device, dtype):
    """One pass over every window op on 4 ranks of ExponentialTwoGraph(4),
    associated p on; returns everything the ops hand back, on the CPU."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology_util as tu

    gen = torch.Generator().manual_seed(3)
    x, x2 = (torch.randn(4, 1000, generator=gen).to(dtype) for _ in range(2))
    bf.init(tu.ExponentialTwoGraph(4), size=4, device=device)
    try:
        bf.turn_on_win_ops_with_associated_p()
        out = {}
        x, x2 = x.to(device), x2.to(device)
        bf.win_create(x, "w", zero_init=True)
        h = bf.win_put_nonblocking(x, "w", dst_weights=[{1: 2.0}, {}, {}, {}])
        assert h.poll() in (True, False)
        h.wait()
        bf.win_accumulate(x2, "w")
        bf.win_get("w", src_weights=[{s: 0.25 for s in bf.in_neighbor_ranks(d)}
                                     for d in range(4)])
        out["update"] = bf.win_update("w", self_weight=0.5, reset=True)
        out["p"] = bf.win_associated_p("w")
        out["put_update"] = bf.win_put_update(x2, "w")
        tree = {"a": x[:, :600].reshape(4, 20, 30), "b": x[:, 600:]}
        bf.win_create(tree, "f")
        bf.win_put(tree, "f")
        fused = bf.win_update("f", clone=True)
        out["fused_a"], out["fused_b"] = fused["a"], fused["b"]
        out["versions"] = torch.tensor([list(v.values()) for v in bf.get_win_version("w")])
        return {k: v.cpu() for k, v in out.items()}
    finally:
        bf.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_ops_on_the_card_match_the_cpu(cuda_device, dtype):
    """The same window-op sequence on the card and on the CPU (the CPU route
    is held against the JAX package in test_torch_windows.py): f32 within
    1e-6, bf16 within one bf16 step of the value."""
    want = _window_sequence("cpu", dtype)
    got = _window_sequence("cuda", dtype)
    for k, w in want.items():
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(got[k].double(), w.double(), rtol=tol, atol=tol, msg=k)


def test_bert_pushsum_round_on_the_card(cuda_device):
    """One push-sum round of the tiny BERT preset on 4 ranks, eager and
    device flows from the same state: finite losses, equal parameters
    (within Adam's 2 x 1.004 x lr bound for one round), sum p = 4."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.benchmarks import bert_pushsum as bp

    bf.init(size=4)
    try:
        (params, opt), eager_step, device_rounds, meta = bp.build_flows(bp.PRESETS["tiny"], 4)
        dstate = meta["device_init"](params, opt)
        params, opt, loss = eager_step(params, opt)
        dstate, dloss = device_rounds(dstate, 1)
        assert params["pos_embedding"].is_cuda
        assert torch.isfinite(loss).all() and torch.isfinite(dloss).all()
        for k in params:
            torch.testing.assert_close(dstate["params"][k], params[k], rtol=0,
                                       atol=2 * 1.004 * bp.LR)
        p_mass = torch.stack(meta["p_mass"])
        torch.testing.assert_close(p_mass, torch.full_like(p_mass, 4.0))
    finally:
        bf.shutdown()


def _eager_sequence(device, dtype):
    """The eager API of slice 11 on 8 ranks (4 machines x 2) on ``device``:
    every result, on the CPU."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import ops, topology_util as tu

    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 300, generator=g).to(dtype)
    bf.init(size=8, local_size=2, device=device)
    try:
        x = x.to(device)
        src = [{(r - 1) % 8: 0.5, (r + 3) % 8: 0.25} for r in range(8)]
        dst = [{(s + 1) % 8: 0.5} for s in range(8)]
        out = {"allgather": bf.allgather(x), "allreduce_int": bf.allreduce(x.int()),
               "dyn_src": bf.neighbor_allreduce(x, src_weights=src),
               "dyn_dst": bf.neighbor_allreduce(x, 0.5, dst_weights=dst),
               "hier": bf.hierarchical_neighbor_allreduce(x),
               "pairwise": ops.pairwise_gossip(x, [(r, r ^ 1) for r in range(8)]),
               "nb_hier": bf.synchronize(bf.hierarchical_neighbor_allreduce_nonblocking(x))}
        bf.set_topology(tu.StarGraph(8))
        out["gather_star"] = bf.neighbor_allgather(x)
        out["gather_dyn"] = bf.neighbor_allgather(x, src_ranks=[[(r + 2) % 8] for r in range(8)])
        bf.barrier()
        return {k: v.cpu() for k, v in out.items()}
    finally:
        bf.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_ops_on_the_card_match_the_cpu(cuda_device, dtype):
    """allgather, integer allreduce, the dynamic neighbor_allreduce,
    hierarchical_neighbor_allreduce, pairwise_gossip, neighbor_allgather
    and a nonblocking form on the card against the CPU route (held against
    the JAX package in test_torch_eager_api.py and test_torch_hierarchical.py):
    gathers exactly, f32 within 1e-6, bf16 within one bf16 step."""
    want = _eager_sequence("cpu", dtype)
    got = _eager_sequence("cuda", dtype)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        tol = 0 if "gather" in k else (1e-6 if dtype == torch.float32 else 2.0 ** -7)
        torch.testing.assert_close(got[k].double(), w.double(), rtol=tol, atol=tol, msg=k)


def test_hierarchical_train_step_on_the_card(cuda_device):
    """A small ResNet-18 with batch statistics, 8 ranks = 4 machines x 2,
    ATC hierarchical gossip: finite losses, the two ranks of each machine
    hold bit-equal parameters, and ``steps_per_call=2`` runs."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.benchmarks import resnet50 as rb
    from bluefog_tpu_torch.models import ResNet18
    from bluefog_tpu_torch.training import make_classifier_apply_fn, make_decentralized_train_step

    bf.init(size=8, local_size=2)
    try:
        model = ResNet18(num_classes=10, num_filters=8, small_images=True, device="cpu",
                         generator=torch.Generator().manual_seed(0)).cuda()
        x, y = rb.synthetic_batch(8, 4, 16, 10, "cuda", seed=0)
        params, stats = rb.rank_major_state(model, 8)
        step, _ = rb.make_step(model, params, stats, "hierarchical_neighbor_allreduce")
        for _ in range(2):
            loss, _ = step(x, y)
            assert torch.isfinite(loss).all()
            for p in params.values():
                assert torch.equal(p[0::2], p[1::2])
        params, stats = rb.rank_major_state(model, 8)
        step2 = make_decentralized_train_step(
            make_classifier_apply_fn(model), params,
            torch.optim.SGD(list(params.values()), lr=0.1),
            communication_type=bf.CommunicationType.hierarchical_neighbor_allreduce,
            machine_plan=bf.context().machine_plan, batch_stats=stats, steps_per_call=2)
        loss, _ = step2(torch.stack([x, x]), torch.stack([y, y]))
        assert loss.shape == (8,) and torch.isfinite(loss).all()
    finally:
        bf.shutdown()


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch", "attn"])
def test_remat_launches_the_flash_forward_twice_a_layer(cuda_device, policy, scan):
    """A 3-layer bf16 LlamaLM with GQA at D = 128 under remat, one forward
    and backward with the chunked loss: the backward recomputes each
    block's forward, flash forward included, whatever the policy, so the
    forward kernel launches 2 x layers times and dK/dV and dQ once a layer;
    without remat the forward launches once a layer."""
    from bluefog_tpu_torch.kernels import make_flash_attention_fn
    from bluefog_tpu_torch.models.transformer import LlamaLM

    layers = 3
    ids = torch.randint(0, 97, (2, 256), generator=torch.Generator().manual_seed(0)).cuda()
    for remat in (False, True):
        model = LlamaLM(vocab_size=97, hidden_size=512, num_layers=layers, num_heads=4,
                        num_kv_heads=2, dff=256, attention_fn=make_flash_attention_fn(),
                        head_chunks=4, remat=remat, remat_policy=policy, scan_layers=scan,
                        device="cpu", generator=torch.Generator().manual_seed(1)).cuda()
        fa.reset_launches()
        model(ids, labels=ids).backward()
        torch.cuda.synchronize()
        want = {"fwd": (1 + remat) * layers, "dkv": layers, "dq": layers}
        assert dict(fa.launches) == want, (remat, policy, dict(fa.launches))
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("kvh", [1, 2, 7])
def test_gqa_through_the_bf16_kernels_at_d128_matches_the_plain_version(cuda_device, kvh):
    """Grouped-query attention as LlamaLM lays it out for the kernels, at
    D = 128 and 14 query heads: k and v on ``kvh`` heads, repeated in place
    and folded to ``[B x 14, T, D]``, through the bf16 kernels against
    their plain versions on the same inputs (lse and the row correction
    from the plain forward, as in chip_smoke.py).  o, lse, dq and each
    repeated head's dk and dv within the kernels' rule; the gradients of
    the unrepeated k and v (the sum over each kv head's 14 / kvh query
    heads, which autograd forms) within the sum of the terms' rules."""
    gen = torch.Generator(device=cuda_device).manual_seed(kvh)
    b, t, h, d = 2, 384, 14, 128
    rep = h // kvh

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).bfloat16()

    q, g = rnd(b, t, h, d), rnd(b, t, h, d)
    k, v = (rnd(b, t, kvh, d).repeat_interleave(rep, dim=2) for _ in range(2))
    qf, kf, vf, gf = (fa._fold(x) for x in (q, k, v, g))
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = fa.flash_fwd(qf, kf, vf, 0, 0, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(qf, kf, vf, 0, 0, **kw)
    corr = (-(o_ref.float() * gf.float()).sum(-1)).contiguous()
    dk, dv = fa.flash_dkv(qf, kf, vf, gf, lse_ref, corr, 0, 0, **kw)
    dq = fa.flash_dq(qf, kf, vf, gf, lse_ref, corr, 0, 0, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(qf, kf, vf, gf, lse_ref, corr, 0, 0, **kw)
    dq_ref = fa.flash_dq_plain(qf, kf, vf, gf, lse_ref, corr, 0, 0, **kw)
    _close_lse(lse, lse_ref)
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, want)
    for got, want in ((dk, dk_ref), (dv, dv_ref)):
        terms = want.float().view(b, kvh, rep, t, d)
        summed, summed_ref = got.float().view(b, kvh, rep, t, d).sum(2), terms.sum(2)
        tol = (2.0 ** -7 * terms.abs() + 2.0 ** -6 * terms.pow(2).mean().sqrt()).sum(2)
        err = (summed - summed_ref).abs()
        assert (err <= tol).all(), (err.max().item(), (err / tol).max().item())


def _plain_kernels(monkeypatch):
    """Route the flash wrappers to their plain versions, on the card."""
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        monkeypatch.setattr(fa, name, getattr(fa, f"{name}_plain"))


@pytest.mark.parametrize("striped", [False, True])
def test_ring_flash_on_the_kernels_matches_the_ring_on_the_plain_versions(
        cuda_device, striped, monkeypatch):
    """Ring flash attention (4 ranks x 2 rows, 256 tokens a shard, 2
    heads, D = 64, bf16) through the CUDA kernels against the same ring
    through the kernels' plain versions on the card: o, dq, dk and dv
    under a seeded cotangent within the kernels' rule.  Every hop runs
    the kernels with non-zero offsets (striped: k_start 1) and, in the
    backward, the lse cotangent of the merge."""
    from bluefog_tpu_torch.parallel import ring_attention as ring

    n, gen = 4, torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, g = (torch.randn(n * 2, 256, 2, 64, generator=gen, device=cuda_device).bfloat16()
                  for _ in range(4))

    def run():
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring.ring_flash_attention(*xs, n, causal=True, striped=striped)
        out.backward(g)
        return [out.detach()] + [x.grad for x in xs]

    fa.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = 2 * n - 1 if striped else n
    assert dict(fa.launches) == {"fwd": launches, "dkv": launches, "dq": launches}
    _plain_kernels(monkeypatch)
    want = run()
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("mode", ["ring", "ring_striped", "ulysses"])
def test_sequence_parallel_llama_launches_per_layer(cuda_device, mode):
    """A 3-layer bf16 LlamaLM on 4 sequence shards, one forward and
    backward: the flash kernels launch n times a layer (contiguous ring),
    2n - 1 (striped) or once (Ulysses), each of fwd, dK/dV and dQ."""
    from bluefog_tpu_torch.models.transformer import LlamaLM
    from bluefog_tpu_torch.parallel import ring_attention as ring
    from bluefog_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

    n, layers, b, t = 4, 3, 2, 1024
    fn = (make_ulysses_attention_fn(n, flash=True) if mode == "ulysses" else
          ring.make_ring_attention_fn(n, flash=True, striped=mode == "ring_striped"))
    model = LlamaLM(vocab_size=97, hidden_size=256, num_layers=layers, num_heads=4, dff=256,
                    attention_fn=fn, device="cpu",
                    generator=torch.Generator().manual_seed(1)).cuda()
    ids = torch.randint(0, 97, (b, t), generator=torch.Generator().manual_seed(0))
    x, pos = ring.shard_inputs(ids.cuda(), n, mode == "ring_striped")
    fa.reset_launches()
    logits = model(x, pos)
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    per_layer = {"ring": n, "ring_striped": 2 * n - 1, "ulysses": 1}[mode]
    want = {k: layers * per_layer for k in ("fwd", "dkv", "dq")}
    assert dict(fa.launches) == want, (mode, dict(fa.launches))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_fsdp_gossip_step_on_the_card_launches_per_machine_layer(cuda_device):
    """The FSDP + machine-gossip step of benchmarks/zero_8b at toy widths
    (GQA, remat, scan, spmd_vocab, the hooks with bf16 gradients) on 2
    machines x 2: each machine's batch is one forward a layer, recomputed
    under remat: forward 2 x layers x machines x steps launches, dK/dV and
    dQ half that; finite losses, f32 masters and bf16 momenta."""
    import os

    from bluefog_tpu_torch.benchmarks import zero_8b

    states = []
    os.environ["ZERO8B_MESH"] = "2x2"
    try:
        fa.reset_launches()
        out = zero_8b.run(zero_8b._parser().parse_args(["--toy", "--steps", "2"]),
                          setup=states.append)
    finally:
        del os.environ["ZERO8B_MESH"]
    assert dict(fa.launches) == {"fwd": 2 * 2 * 2 * 2, "dkv": 2 * 2 * 2, "dq": 2 * 2 * 2}
    assert all(torch.isfinite(torch.tensor(l)).all() for l in out["machine_losses"])
    assert {l.dtype for l in states[0]["master"].values()} == {torch.float32}
    assert {l.dtype for l in states[0]["opt"][0].values()} == {torch.bfloat16}


def test_tensor_parallel_block_on_the_f32_kernels(cuda_device):
    """A tp = 2 block with the flash ``attention_fn`` on the f32 kernels
    (one launch a direction for both shards) against the same block with
    the plain f32 dense attention: outputs and gradients within 2^-14 of
    the largest entry (the f32 kernels' rule: 3xTF32 products against f32
    FFMA)."""
    from bluefog_tpu_torch.kernels import make_flash_attention_fn
    from bluefog_tpu_torch.parallel import tensor_parallel as tpp

    torch.backends.cuda.matmul.allow_tf32 = False
    full = tpp.init_tp_block_params(128, 4, 256, seed=0, device="cuda")
    x = torch.randn(2, 256, 128, generator=torch.Generator("cuda").manual_seed(0), device="cuda")

    def run(attention_fn):
        repl, shard = tpp.split_tp_params({k: (v.clone() if not isinstance(v, dict) else
                                               {kk: vv.clone() for kk, vv in v.items()})
                                           for k, v in full.items()}, tpp.TP_BLOCK_SHARD_AXES)
        p = tpp.merge_tp_params(repl, tpp.shard_tp_params(shard, tpp.TP_BLOCK_SHARD_AXES, 2))
        p["attn"]["wq"].requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        y = tpp.tp_transformer_block(xi, p, causal=True, attention_fn=attention_fn)
        y.square().sum().backward()
        return y.detach(), xi.grad, p["attn"]["wq"].grad

    fa.reset_launches()
    flash = run(make_flash_attention_fn())
    assert dict(fa.launches_f32) == {"fwd": 1, "dkv": 1, "dq": 1}
    dense = run(None)
    for a, b in zip(flash, dense):
        assert (a - b).abs().max() <= 2.0 ** -14 * b.abs().max(), ((a - b).abs().max(),
                                                                  b.abs().max())


def test_staging_a_cuda_tensor_through_pinned_memory_equals_the_cpu_path(cuda_device):
    """The island runtime stages a CUDA tensor through a pinned host buffer
    on a side stream: the host array equals the CPU tensor's bit for bit,
    and a snapshot taken at submit is unaffected by a later in-place
    update of the original."""
    import numpy as np

    from bluefog_tpu_torch.progress import staging

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn(3, 1000, 7, device=cuda_device, generator=gen)
    host = staging.stage(t, "pinned_case")
    assert isinstance(host, np.ndarray) and host.shape == (3, 1000, 7)
    np.testing.assert_array_equal(host, staging.stage(t.cpu()))
    snap = staging.snapshot(t)
    before = t.cpu().numpy().copy()
    t.mul_(2.0)  # the next optimizer.step(), in place
    np.testing.assert_array_equal(staging.stage(snap, "pinned_case"), before)
    np.testing.assert_array_equal(staging.to_device(before, cuda_device).cpu().numpy(),
                                  before)
    staging.release("pinned_case")


def _island_cuda_worker(rank, size):
    from bluefog_tpu_torch import islands, topology_util

    islands.set_topology(topology_util.RingGraph(size))
    x = torch.arange(5, dtype=torch.float64, device="cuda") + rank
    islands.win_create(x, "c")
    islands.win_put(x, "c")
    islands.barrier()
    out = islands.win_update("c")
    islands.barrier()
    h = islands.win_update_async("c").result(timeout=60)
    islands.win_free("c")
    # the win-put optimizer with overlap on CUDA parameters
    c = float(rank)
    w = torch.full((4,), 10.0 + rank, device="cuda", requires_grad=True)
    opt = islands.DistributedWinPutOptimizer(torch.optim.SGD([w], lr=0.2), overlap=True)
    for _ in range(40):
        opt.zero_grad()
        (0.5 * ((w - c) ** 2).sum()).backward()
        opt.step()
        islands.barrier()
    opt.finish()
    islands.barrier()
    opt.settle(rounds=30)
    final = w.detach().cpu().numpy().copy()
    opt.free()
    return (out.device.type, out.cpu().numpy(), h.device.type, h.cpu().numpy(), final,
            w.device.type)


def test_island_win_update_and_overlap_optimizer_on_the_card(cuda_device):
    import numpy as np

    from bluefog_tpu_torch import islands

    size = 4
    res = islands.spawn(_island_cuda_worker, size, timeout=300.0)
    W = np.zeros((size, size))
    for d in range(size):
        for s in (d, (d - 1) % size, (d + 1) % size):
            W[d, s] = 1.0 / 3
    x0 = np.stack([np.arange(5, dtype=np.float64) + r for r in range(size)])
    for d, (dev, out, hdev, h, _, wdev) in enumerate(res):
        assert dev == hdev == wdev == "cuda"
        np.testing.assert_allclose(out, (W @ x0)[d], rtol=0, atol=1e-12)
        # the async combine: my combined value with the slots' first deposits
        want = ((W @ x0)[d] + x0[(d - 1) % size] + x0[(d + 1) % size]) / 3
        np.testing.assert_allclose(h, want, rtol=0, atol=1e-12)
    finals = np.stack([r[4] for r in res])
    assert finals.std(axis=0).max() < 1e-5
    assert np.all(np.abs(finals - (size - 1) / 2.0) < 0.05), finals


def _busy(n=100):
    """Queue ~0.1-0.2 s of matmuls on the current stream and return at once."""
    a = torch.full((4096, 4096), 1e-3, device="cuda")
    for _ in range(n):
        a = torch.tanh(a @ a)
    return a


def _island_busy_update_worker(rank, size):
    from bluefog_tpu_torch import islands, topology_util

    islands.set_topology(topology_util.RingGraph(size))
    n = 1 << 20
    # equal byte sizes, so the two results' blocks are interchangeable
    x32 = (torch.arange(2 * n, device="cuda") % 7 + rank).to(torch.float32)
    x64 = torch.arange(n, dtype=torch.float64, device="cuda") + 1000.0 * rank
    islands.win_create(x32, "a")
    islands.win_create(x64, "b")
    islands.win_put(x32, "a")
    islands.win_put(x64, "b")
    islands.barrier()
    # back-to-back updates while the card is busy: each copy_ from a result
    # waits behind the matmuls, after the result itself was dropped
    dst32, dst64 = torch.empty_like(x32), torch.empty_like(x64)
    _busy()
    dst32.copy_(islands.win_update("a"))
    dst64.copy_(islands.win_update("b"))
    torch.cuda.synchronize()
    islands.win_free("a")
    islands.win_free("b")
    # the same through a two-dtype optimizer's settle on a busy card
    w32 = torch.full((2 * n,), 1.0 + rank, device="cuda", requires_grad=True)
    w64 = torch.full((n,), 100.0 + rank, dtype=torch.float64, device="cuda",
                     requires_grad=True)
    opt = islands.DistributedWinPutOptimizer(torch.optim.SGD([w32, w64], lr=0.0))
    islands.barrier()
    _busy()
    opt.settle(rounds=2)
    torch.cuda.synchronize()
    out = (dst32.cpu().numpy(), dst64.cpu().numpy(),
           [float(w32.min()), float(w32.max())], [float(w64.min()), float(w64.max())])
    opt.free()
    return out


def test_island_updates_back_to_back_on_a_busy_card(cuda_device):
    """``win_update`` hands back a tensor that the caller reads on its own
    stream; two updates in a row (as ``settle`` makes them, one a dtype
    group) must not let the second reuse the first's memory before the
    caller's queued copy from it has run."""
    import numpy as np

    from bluefog_tpu_torch import islands

    size = 4
    res = islands.spawn(_island_busy_update_worker, size, timeout=300.0)
    W = np.zeros((size, size))
    for d in range(size):
        for s in (d, (d - 1) % size, (d + 1) % size):
            W[d, s] = 1.0 / 3
    n = 1 << 20
    x32 = np.stack([(np.arange(2 * n) % 7 + r).astype(np.float32) for r in range(size)])
    x64 = np.stack([np.arange(n, dtype=np.float64) + 1000.0 * r for r in range(size)])
    c32 = np.arange(size) + 1.0
    c64 = np.arange(size) + 100.0
    W2 = W @ W
    for d, (a, b, r32, r64) in enumerate(res):
        np.testing.assert_allclose(a, (W @ x32.astype(np.float64))[d], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b, (W @ x64)[d], rtol=0, atol=1e-9)
        np.testing.assert_allclose(r32, [(W2 @ c32)[d]] * 2, rtol=1e-6)
        np.testing.assert_allclose(r64, [(W2 @ c64)[d]] * 2, rtol=0, atol=1e-12)


def test_bf16_island_window_round_with_rank0_on_the_card(cuda_device):
    """A bf16 window whose rank 0 tensor is on the card: one deposit and
    the default combine give every rank, bit for bit, the plain bf16
    combine of ``examples/bf16_window``, rank 0's result back on the
    card as ``torch.bfloat16``."""
    from bluefog_tpu_torch.examples import bf16_window

    out = bf16_window.run(nranks=2, n=1 << 18, device="cuda")
    assert out["rank0_device"] == "cuda", out
    assert out["dtypes"] == ["torch.bfloat16"], out
    assert not any(out["mismatched_elems"].values()), out


def test_replica_installs_each_version_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The replica's device path: a publish from a card tensor (staged to
    the host by the region) is installed into the standby device buffer
    byte for byte, the two buffers alternate, and ``serve_step`` computes
    on the card."""
    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.serve import Replica, SnapshotRegion

    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    job = f"cudarep{id(tmp_path) % 100000}"
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    region = SnapshotRegion(job, x.numel() * 4)
    rep = Replica(job, 0, publish_page=False, device="cuda")
    try:
        bufs = []
        for v in (1, 2, 3):
            assert region.publish(x * v) == v
            assert rep.poll_swap()
            ver, snap = rep.serve_step()
            assert ver == v and snap.is_cuda
            assert torch.equal(snap, x * v)
            bufs.append(snap.data_ptr())
            _, y = rep.serve_step(torch.ones(4096, device="cuda"))
            assert y.is_cuda and float(y) == float((x * v).sum())
        assert bufs[0] == bufs[2] != bufs[1]
    finally:
        rep.close()
        region.close(unlink=True)
