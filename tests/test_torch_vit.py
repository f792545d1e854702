"""ViT in bluefog_tpu_torch against the JAX package's flax ViT: logits and
gradients on the same weights (carried over by ``vit_state_dict``) and
the same images (numpy), the decentralized ATC step of the reference's
test, and the parameter counts of ViT-S/16 and ViT-B/16."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.models import ViT as JaxViT
from bluefog_tpu.models import ViT_B16 as JaxViT_B16
from bluefog_tpu.models import ViT_S16 as JaxViT_S16
from bluefog_tpu.optim import CommunicationType as JaxComm
from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch.interop.jax_weights import vit_state_dict
from bluefog_tpu_torch.models import ViT, ViT_B16, ViT_S16
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
    softmax_cross_entropy,
)

torch.set_num_threads(1)
N = 4
CFG = dict(num_classes=5, patch_size=4, hidden_size=32, num_layers=2, num_heads=4, dff=64)
S = 16

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _jax_params(dtype="bf16"):
    model = JaxViT(**CFG, dtype=JDT[dtype])
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port(dtype="bf16", params=None):
    model = ViT(**CFG, image_size=S, dtype=TDT[dtype], device="cpu")
    if params is not None:
        model.load_state_dict(vit_state_dict(params, CFG["num_layers"]), strict=True)
    return model


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _labels(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["num_classes"], size=shape)


# (logits rtol, logits atol over the largest, gradients atol over the
# largest, loss rtol).  f32: the same sums in another order.  bf16: every
# product rounds its operands to bf16 (8 bits), and an f32 value that sits
# on a rounding boundary rounds the other way on one side; over two blocks
# that moved a logit by 0.6% of the largest, a gradient by 1.9% of its
# largest and the loss by 7e-4 of itself (this test's inputs, CPU).
TOL = {"f32": (1e-4, 1e-5, 1e-5, 1e-5), "bf16": (0.0, 1.5e-2, 3e-2, 2e-3)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vit_logits_and_gradients_match_flax(dtype):
    params = _jax_params(dtype)
    x, y = _images(0, (2, S, S, 3)), _labels(1, (2,))
    jm = JaxViT(**CFG, dtype=JDT[dtype])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    j_loss, j_grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    j_grads = vit_state_dict(jax.tree_util.tree_map(np.asarray, j_grads), CFG["num_layers"])

    model = _port(dtype, params)
    logits = model(torch.from_numpy(x))
    assert logits.shape == (2, CFG["num_classes"]) and logits.dtype == torch.float32
    rtol, atol, gtol, ltol = TOL[dtype]
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))
    t_loss = softmax_cross_entropy(logits, torch.from_numpy(y))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=ltol)
    for name, p in model.named_parameters():
        w = j_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=rtol,
                                   atol=gtol * np.abs(w).max(), err_msg=name)


def test_vit_atc_step_matches_the_reference():
    """The reference test's decentralized step (SGD 0.05, ATC
    neighbor_allreduce, exp2 topology, no batch statistics) for 4 steps on
    4 ranks from the same weights and batch, f32 compute: losses within
    rtol 1e-4 and every rank's parameters within rtol 1e-4 / atol 1e-6;
    the loss falls, as the reference test asserts."""
    params0 = _jax_params("f32")
    x, y = _images(2, (N, 2, S, S, 3)), _labels(3, (N, 2))
    steps = 4
    jbf.init(devices=jax.devices()[:N])
    try:
        ctx = jbasics.context()
        jm = JaxViT(**CFG, dtype=jnp.float32)
        init_fn, step_fn = jax_train_step(
            jm.apply, optax.sgd(0.05), ctx.mesh,
            communication_type=JaxComm.neighbor_allreduce, plan=ctx.plan, donate=False)
        jp = jax_replicate(jax.tree_util.tree_map(jnp.asarray, params0), N)
        state, bs, j_losses = init_fn(jp), {}, []
        for _ in range(steps):
            jp, bs, state, loss, _ = step_fn(jp, bs, state, jnp.asarray(x),
                                             jnp.asarray(y, jnp.int32))
            j_losses.append(np.asarray(loss))
        jp = jax.tree_util.tree_map(np.asarray, jp)
    finally:
        jbf.shutdown()

    tbf.init(size=N, device="cpu")
    try:
        model = _port("f32", params0)
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        step = make_decentralized_train_step(
            make_classifier_apply_fn(model), params,
            torch.optim.SGD(list(params.values()), lr=0.05),
            communication_type=CommunicationType.neighbor_allreduce, plan=tbf.context().plan)
        t_losses = [step(torch.from_numpy(x), torch.from_numpy(y))[0].numpy()
                    for _ in range(steps)]
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses), rtol=1e-4)
    assert t_losses[-1].mean() < t_losses[0].mean()
    for r in range(N):
        want = vit_state_dict(jax.tree_util.tree_map(lambda a: a[r], jp), CFG["num_layers"])
        for name, leaf in params.items():
            np.testing.assert_allclose(leaf[r].detach().numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("port,ref,count", [(ViT_S16, JaxViT_S16, 22_050_664),
                                            (ViT_B16, JaxViT_B16, 86_567_656)])
def test_vit_s16_and_b16_parameter_counts_match_flax(port, ref, count):
    """ViT-S/16 and ViT-B/16 at 224 x 224 and 1000 classes: the port's
    parameter count and every state-dict shape equal flax's (from
    ``jax.eval_shape``, nothing allocated)."""
    shapes = jax.eval_shape(lambda: ref(num_classes=1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
    want = vit_state_dict(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                                 shapes),
                          len([k for k in shapes if k.startswith("_EncoderBlock_")]))
    model = port(num_classes=1000, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert sum(p.numel() for p in model.parameters()) == count == \
        sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))


def test_vit_initializer_mirrors_flax_distributions():
    """Zero [CLS], N(0, 0.02^2) positions, lecun-normal kernels (the
    patchify convolution's fan-in P·P·3), zero biases: the same
    distributions as flax's draw, not the same bits."""
    ref = vit_state_dict(_jax_params(), CFG["num_layers"])
    model = ViT(**dict(CFG, hidden_size=64, dff=128), image_size=32, device="cpu",
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.cls, torch.zeros_like(model.cls))
    assert abs(model.pos_embedding.std().item() / 0.02 - 1) < 0.1
    w = model.patch_embed.weight
    assert abs(w.std().item() * (4 * 4 * 3) ** 0.5 - 1) < 0.1
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
    assert set(model.state_dict()) == set(ref)


def test_vit_rejects_a_patch_that_does_not_tile_the_image():
    with pytest.raises(ValueError, match="not divisible by patch"):
        ViT(**CFG, image_size=18, device="cpu")
