"""The slice as a whole: LlamaLM and the decentralized train step of
bluefog_tpu_torch against the JAX package on the same weights (carried
across by ``interop.jax_weights``) and the same token batches (numpy)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.kernels import make_flash_attention_fn as jax_flash_fn
from bluefog_tpu.models.transformer import LlamaLM as JaxLlama
from bluefog_tpu.optim import CommunicationType as JaxComm
from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
from bluefog_tpu.training import make_lm_loss_fns as jax_lm_loss_fns
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch.interop.jax_weights import llama_state_dict
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

torch.set_num_threads(1)
N = 4
CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4, dff=128)
T = 64


def _jax_model(flash, head_chunks=0):
    fn = jax_flash_fn(block_q=16, block_k=16, interpret=True) if flash else None
    return JaxLlama(**CFG, dtype=jnp.float32, attention_fn=fn, head_chunks=head_chunks)


def _port_model(flash, head_chunks=0, params=None):
    model = LlamaLM(**CFG, dtype=torch.float32, head_chunks=head_chunks, device="cpu",
                    attention_fn=make_flash_attention_fn() if flash else None)
    if params is not None:
        model.load_state_dict(llama_state_dict(params, CFG["num_layers"]))
    return model


@pytest.fixture(scope="module")
def jax_params():
    ids0 = jnp.zeros((1, T), jnp.int32)
    params = _jax_model(False).init(jax.random.PRNGKey(0), ids0)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=shape)


@pytest.mark.parametrize("flash", [False, True])
def test_llama_logits_match_reference(jax_params, flash):
    ids = _ids(0, (2, T))
    want = np.asarray(_jax_model(flash).apply({"params": jax_params}, jnp.asarray(ids)))
    got = _port_model(flash, params=jax_params)(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("head_chunks", [0, 4])
def test_llama_loss_matches_reference(jax_params, head_chunks):
    ids = _ids(1, (2, T))
    model = _jax_model(True, head_chunks)
    if head_chunks:
        want = model.apply({"params": jax_params}, jnp.asarray(ids), labels=jnp.asarray(ids))
    else:
        logits = model.apply({"params": jax_params}, jnp.asarray(ids))
        want = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(ids)[:, 1:]).mean()
    t_ids = torch.from_numpy(ids)
    got = _port_model(True, head_chunks, jax_params)(t_ids, labels=t_ids)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_port_initializer_mirrors_flax_distributions(jax_params):
    gen = torch.Generator().manual_seed(0)
    model = LlamaLM(**CFG, dtype=torch.float32, device="cpu", generator=gen)
    ref = llama_state_dict(jax_params, CFG["num_layers"])
    for name, p in model.state_dict().items():
        assert p.shape == ref[name].shape, name
        if name.endswith("scale"):
            assert torch.equal(p, ref[name])
        elif p.numel() >= 4096:  # std within 10% of flax's draw
            assert abs(p.std().item() / ref[name].std().item() - 1) < 0.1, name


def _train_both(jax_params, jax_opt, torch_opt_fn, steps, flash=True, head_chunks=4,
                mode="atc", communication_type="neighbor_allreduce"):
    """Run both train steps from the same weights on the same batches, with
    the same ``mode`` and ``communication_type`` (a ``CommunicationType``
    member's name); return (jax losses, port losses, jax params per rank,
    port params)."""
    batches = _ids(2, (steps, N, 2, T))
    jbf.init(devices=jax.devices()[:N])
    try:
        ctx = jbasics.context()
        model = _jax_model(flash, head_chunks)
        lm_apply, lm_loss = jax_lm_loss_fns(model)
        init_fn, step_fn = jax_train_step(
            lm_apply, jax_opt, ctx.mesh, communication_type=JaxComm[communication_type],
            plan=ctx.plan, mode=mode, loss_fn=lm_loss, donate=False)
        params = jax_replicate(jax.tree_util.tree_map(jnp.asarray, jax_params), N)
        state = init_fn(params)
        jl = []
        for s in range(steps):
            bx = jnp.asarray(batches[s], jnp.int32)
            params, _, state, loss, _ = step_fn(params, {}, state, bx, bx)
            jl.append(np.asarray(loss))
        jparams = jax.tree_util.tree_map(np.asarray, params)
    finally:
        jbf.shutdown()

    tbf.init(size=N, device="cpu")
    try:
        model = _port_model(flash, head_chunks, jax_params)
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, torch_opt_fn(list(params.values())),
            communication_type=CommunicationType[communication_type],
            plan=tbf.context().plan, mode=mode, loss_fn=loss_fn)
        tl = []
        for s in range(steps):
            bx = torch.from_numpy(batches[s])
            tl.append(step_fn(bx, bx)[0].numpy())
    finally:
        tbf.shutdown()
    return jl, tl, jparams, params


def _per_rank_state(jparams, r):
    return llama_state_dict(jax.tree_util.tree_map(lambda a: a[r], jparams),
                            CFG["num_layers"])


@pytest.mark.parametrize("mode,comm", [("atc", "neighbor_allreduce"),
                                       ("awc", "neighbor_allreduce"),
                                       ("atc", "allreduce")])
def test_train_step_sgd_momentum_matches_reference(jax_params, mode, comm):
    """3 steps of momentum SGD with flash attention and the chunked loss,
    in each mode of the train step: losses and every rank's parameters
    within rtol 1e-4."""
    lr = 0.1
    jl, tl, jparams, params = _train_both(
        jax_params, optax.sgd(lr, momentum=0.9),
        lambda leaves: torch.optim.SGD(leaves, lr=lr, momentum=0.9, dampening=0.0), 3,
        mode=mode, communication_type=comm)
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-4)
    for r in range(N):
        want = _per_rank_state(jparams, r)
        for name, leaf in params.items():
            np.testing.assert_allclose(leaf[r].detach().numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {name}")


def test_train_step_adamw_matches_reference(jax_params):
    """1 ATC step of AdamW (wd 1e-4 on both sides: optax's default, set
    explicitly in torch), dense attention (the flash path is held by the
    SGD test).  Adam's first update is ~lr * sign(g), so a gradient near
    zero whose sign differs by roundoff moves a weight by up to 2 * lr:
    parameters must agree within 1e-5 on 99.9% of entries and within
    2 * lr + 1e-5 everywhere; losses within rtol 1e-4."""
    lr = 1e-3
    jl, tl, jparams, params = _train_both(
        jax_params, optax.adamw(lr, weight_decay=1e-4),
        lambda leaves: torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4), 1, flash=False)
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-4)
    close = total = 0
    for r in range(N):
        want = _per_rank_state(jparams, r)
        for name, leaf in params.items():
            diff = np.abs(leaf[r].detach().numpy() - want[name].numpy())
            assert diff.max() <= 2 * lr + 1e-5, name
            close += int((diff <= 1e-5).sum())
            total += diff.size
    assert close >= 0.999 * total


@pytest.mark.parametrize("mode,comm,fuse", [("atc", "neighbor_allreduce", False),
                                            ("atc", "neighbor_allreduce", True),
                                            ("awc", "neighbor_allreduce", False),
                                            ("atc", "allreduce", False)])
def test_train_step_modes_train_and_mix(mode, comm, fuse):
    """Every mode lowers the loss on a learnable stream and keeps ranks
    close (allreduce keeps them identical)."""
    from bluefog_tpu_torch.examples.llama_pretrain import make_streams

    tbf.init(size=N, device="cpu")
    try:
        gen = torch.Generator().manual_seed(0)
        model = LlamaLM(**CFG, dtype=torch.float32, device="cpu", generator=gen)
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step_fn = make_decentralized_train_step(
            apply_fn, params, torch.optim.Adam(list(params.values()), lr=3e-3),
            communication_type=CommunicationType[comm], plan=tbf.context().plan,
            mode=mode, loss_fn=loss_fn, comm_fuse=fuse)
        toks = make_streams(np.random.default_rng(0), CFG["vocab_size"], N * 2, 33 * 8)
        data = torch.from_numpy(toks).view(N, 2, 8, 33).permute(2, 0, 1, 3)
        losses = [step_fn(data[s], data[s])[0].mean().item() for s in range(8)]
        assert losses[-1] < losses[0] - 0.1, losses
        spread = max(v.std(dim=0).max().item() for v in params.values())
        assert spread < (1e-6 if comm == "allreduce" else 0.05)
    finally:
        tbf.shutdown()


def test_train_step_rejects_foreign_optimizer():
    params = replicate_for_mesh({"w": torch.zeros(3)}, N)
    other = torch.optim.SGD([torch.zeros(N, 3, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError):
        make_decentralized_train_step(lambda p, x, labels=None: x, params, other)


def test_example_runs_on_the_cpu_and_profiles():
    """The entry point end to end at the tiny preset with the plain
    attention versions, the last step traced."""
    from bluefog_tpu_torch.examples import llama_pretrain

    out = llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--steps", "2", "--profile"]))
    assert out["ranks"] == N and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"][-1]))
    assert out["consensus_spread"] < 0.01
    assert set(out["profile"]) == {"wall_ms", "device_ops",
                                   "device_union_busy_ms", "device_span_ms",
                                   "idle_share", "flash_ms_launches", "gemm_ms_launches",
                                   "top"}
    # the plain versions run no device operation on the CPU
    assert out["profile"]["device_ops"] == 0 and out["profile"]["idle_share"] is None
    assert out["profile"]["flash_ms_launches"] == {k: [0.0, 0] for k in ("fwd", "dkv", "dq")}
    assert out["profile"]["gemm_ms_launches"] == {k: [0.0, 0] for k in ("ffma", "other")}


def test_device_idle_share_reads_the_union_of_device_intervals():
    """Overlapping kernels count once; the span runs from the first device
    operation's start to the last one's end; host events are not device
    time."""
    from bluefog_tpu_torch import profiling

    class Trace:
        def export_chrome_trace(self, path):
            ev = [dict(cat="kernel", ts=0, dur=10), dict(cat="kernel", ts=5, dur=10),
                  dict(cat="gpu_memcpy", ts=30, dur=10), dict(cat="cpu_op", ts=50, dur=50)]
            with open(path, "w") as f:
                json.dump({"traceEvents": ev}, f)

    out = profiling.device_timeline(Trace())
    assert out == {"device_ops": 3, "device_union_busy_ms": 0.025,
                   "device_span_ms": 0.04, "idle_share": 0.375}


def test_profile_sums_each_flash_kernel_outside_the_top_rows():
    """Each flash kernel's device ms and launches are summed over its head
    dims and its bf16 and f32 instances, however far down the kernel list
    it falls; GEMM rows are summed apart, FFMA from tensor-core."""
    from types import SimpleNamespace

    from bluefog_tpu_torch import profiling

    cuda = SimpleNamespace(name="CUDA")
    names = [("gemm", 9000.0)] * 3 + [
        ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>", 4000.0),
        ("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", 3000.0),
        ("void (anonymous namespace)::dkv_kernel<64>(CUtensorMap_st)", 2000.0),
        ("void (anonymous namespace)::fwd_kernel<64>(CUtensorMap_st)", 1000.0),
        ("void (anonymous namespace)::fwd_kernel<128>(CUtensorMap_st)", 500.0),
        ("void (anonymous namespace)::dq_f32_kernel<64>(float const*, float const*)", 250.0),
        ("void (anonymous namespace)::fwd_f32_kernel<128>(float const*)", 125.0)]

    class Prof:
        def key_averages(self):
            return [SimpleNamespace(key=k, device_time_total=us, count=2, device_type=cuda,
                                    is_user_annotation=False) for k, us in names]

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": []}, f)

    out = profiling.device_profile(Prof(), 1.0, top=2)
    assert len(out["top"]) == 2
    assert out["flash_ms_launches"] == {"fwd": [1.625, 6], "dkv": [2.0, 2], "dq": [0.25, 2]}
    assert out["gemm_ms_launches"] == {"ffma": [4.0, 2], "other": [30.0, 8]}


@pytest.mark.parametrize("head_chunks", [0, 4])
def test_bf16_head_matches_reference(jax_params, head_chunks):
    """head_dtype=bf16 on both sides: bf16 operands (the cotangent too, in
    the backward) and f32 accumulation, the custom VJP
    ``_bf16_matmul_f32_acc`` against the port's autograd Function.  Both
    round the same f32 values to bf16 and sum exact bf16 products in f32,
    in another order.  The f32 values rounded differ between the two models
    by f32 roundoff (~1e-7), and an entry that sits on a bf16 rounding
    boundary rounds the other way on one side, moving a product by one bf16
    step (2^-8 of it): logits within 1e-3 of the largest logit, the loss
    within rtol 1e-4, every gradient within 1e-3 of its largest entry."""
    ids = _ids(3, (2, T))
    jm = JaxLlama(**CFG, dtype=jnp.float32, head_chunks=head_chunks,
                  head_dtype=jnp.bfloat16)
    want_logits = np.asarray(jm.apply({"params": jax_params}, jnp.asarray(ids)))
    want, jgrads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids)))(
            jax.tree_util.tree_map(jnp.asarray, jax_params))
    jgrads = llama_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), CFG["num_layers"])

    model = LlamaLM(**CFG, dtype=torch.float32, head_chunks=head_chunks,
                    head_dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(llama_state_dict(jax_params, CFG["num_layers"]))
    t_ids = torch.from_numpy(ids)
    logits = model(t_ids)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0,
                               atol=1e-3 * np.abs(want_logits).max())
    loss = model(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_head_dtype_is_float32_or_bfloat16():
    with pytest.raises(ValueError, match="head_dtype"):
        LlamaLM(**CFG, head_dtype=torch.float16, device="cpu")
    assert LlamaLM(**CFG, device="cpu").head_dtype == torch.float32
