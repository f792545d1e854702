"""The vision slice: LeNet5 and ResNet of bluefog_tpu_torch against the flax
models of the JAX package on the same weights (carried across by
``interop.jax_weights``) and the same images (numpy), in f32; and the
train step with batch statistics against the JAX train step.

Tolerances: f32 on both sides, sums in another order.  BatchNorm divides
by the batch's standard deviation, which amplifies those roundings on the
tiny batches and spatial sizes used here, hence the 1e-4 relative bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import optim as jax_optim
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.models.lenet import LeNet5 as JaxLeNet
from bluefog_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from bluefog_tpu.models.resnet import ResNet as JaxResNet
from bluefog_tpu.optim import CommunicationType as JaxComm
from bluefog_tpu.training import apply_accepts_labels as jax_accepts_labels
from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch.interop.jax_weights import lenet_state_dict, resnet_state_dict
from bluefog_tpu_torch.models import LeNet5, ResNet, ResNet18
from bluefog_tpu_torch.models.layers import BatchNorm, same_padding
from bluefog_tpu_torch.models.resnet import BottleneckBlock, space_to_depth
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.training import (
    apply_accepts_labels,
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
)

torch.set_num_threads(1)
N = 4


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_resnet(variant):
    kw = dict(num_classes=10, num_filters=4, dtype=jnp.float32)
    if variant == "resnet18_small":
        from bluefog_tpu.models.resnet import ResNet18 as J18
        return J18(small_images=True, **kw)
    stem = "space_to_depth" if variant == "bottleneck_s2d" else "conv"
    return JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneck, stem=stem, **kw)


def _port_resnet(variant):
    kw = dict(num_classes=10, num_filters=4, dtype=torch.float32, device="cpu")
    if variant == "resnet18_small":
        return ResNet18(small_images=True, **kw)
    stem = "space_to_depth" if variant == "bottleneck_s2d" else "conv"
    return ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock, stem=stem, **kw)


# resnet18_small: ResNet18(small_images=True) at 16 x 16; bottleneck_conv:
# the canonical 7x7/s2 stem and the 3x3/s2 max-pool at 32 x 32 (which pin
# flax's asymmetric SAME padding); bottleneck_s2d: the space_to_depth stem
RESNETS = {"resnet18_small": 16, "bottleneck_conv": 32, "bottleneck_s2d": 32}


@pytest.fixture(scope="module")
def resnet_runs():
    """Per variant: both models' train-mode logits and new statistics,
    eval-mode logits and the gradient of the mean cross-entropy, on the same
    weights and images."""
    cache = {}

    def run(variant):
        if variant in cache:
            return cache[variant]
        img = RESNETS[variant]
        x = _images(1, (4, img, img, 3))
        y = np.random.default_rng(2).integers(0, 10, size=4)
        jm = _jax_resnet(variant)
        v = _tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True))

        def loss_of(p):
            logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), \
                (logits, mut["batch_stats"])

        (_, (logits, new_bs)), grads = jax.value_and_grad(loss_of, has_aux=True)(v["params"])
        eval_logits = jm.apply({"params": v["params"], "batch_stats": new_bs},
                               jnp.asarray(x), train=False)
        want = {"logits": np.asarray(logits), "eval_logits": np.asarray(eval_logits),
                "stats": resnet_state_dict(v["params"], _tree(new_bs)),
                "grads": resnet_state_dict(_tree(grads), _tree(v["batch_stats"]))}

        model = _port_resnet(variant)
        model.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]))
        model.train()
        out = model(torch.from_numpy(x))
        torch.nn.functional.cross_entropy(out, torch.from_numpy(y)).backward()
        got = {"logits": out.detach().numpy(), "stats": dict(model.state_dict()),
               "grads": {n: p.grad for n, p in model.named_parameters()}}
        model.eval()
        got["eval_logits"] = model(torch.from_numpy(x)).detach().numpy()
        cache[variant] = (got, want)
        return cache[variant]

    return run


def test_lenet_logits_match_flax():
    x = _images(0, (8, 28, 28, 1))
    jm = JaxLeNet()
    params = _tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    model = LeNet5(device="cpu")
    model.load_state_dict(lenet_state_dict(params))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(RESNETS))
def test_resnet_train_mode_matches_flax(resnet_runs, variant):
    """Training mode: logits (batch statistics) within 1e-4 relative, and
    the running statistics each BatchNorm moved within 1e-5."""
    got, want = resnet_runs(variant)
    scale = np.abs(want["logits"]).max()
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-4 * scale)
    stat_names = [n for n in want["stats"] if n.endswith((".mean", ".var"))]
    assert stat_names and set(stat_names) <= set(got["stats"])
    for name in stat_names:
        np.testing.assert_allclose(got["stats"][name].numpy(), want["stats"][name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant", sorted(RESNETS))
def test_resnet_eval_mode_matches_flax(resnet_runs, variant):
    """Eval mode, with the statistics one training pass moved: logits
    within 1e-4 relative."""
    got, want = resnet_runs(variant)
    scale = np.abs(want["eval_logits"]).max()
    np.testing.assert_allclose(got["eval_logits"], want["eval_logits"], rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("variant", sorted(RESNETS))
def test_resnet_gradients_match_flax(resnet_runs, variant):
    """The gradient of the mean cross-entropy with respect to every
    parameter, through the batch statistics: within 1e-4 of each
    parameter's largest gradient entry."""
    got, want = resnet_runs(variant)
    names = [n for n in want["grads"] if not n.endswith((".mean", ".var"))]
    assert set(names) == set(got["grads"])
    for name in names:
        w = want["grads"][name].numpy()
        np.testing.assert_allclose(got["grads"][name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-9, err_msg=name)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)), (28, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (28, 5, 1, (2, 2)), (7, 3, 2, (1, 1))])
def test_same_padding_is_flax_same(size, kernel, stride, want):
    """flax's SAME: output ceil(size / stride), the odd pixel padded at the
    end (lax.padtype_to_pads)."""
    assert same_padding(size, kernel, stride) == want
    assert tuple(jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]) == want


def test_space_to_depth_matches_flax():
    from bluefog_tpu.models.resnet import space_to_depth as jax_s2d

    x = _images(3, (2, 8, 6, 3))
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x))))


def test_batch_norm_keeps_flax_running_average():
    """Training mode moves the buffers by ra = 0.9 ra + 0.1 batch with the
    BIASED variance (torch's BatchNorm2d feeds the unbiased one); eval mode
    normalizes with the buffers."""
    x = torch.from_numpy(_images(4, (3, 5, 2, 2)))
    bn = BatchNorm(5)
    bn.train()
    bn(x)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.1 * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-7)
    bn.eval()
    y = bn(x)
    want = (x - bn.mean[:, None, None]) / torch.sqrt(bn.var[:, None, None] + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def _std_ratio(a, b):
    return a.std().item() / b.std().item()


def test_port_initializers_mirror_flax_distributions():
    """lecun-normal convolution and dense kernels (std within 10% of flax's
    draw where a kernel has >= 4096 entries), zero biases, BatchNorm scales
    1 and 0 on each block's last norm, statistics 0 and 1."""
    jm = _jax_resnet("resnet18_small").clone(num_filters=16, num_classes=100)
    v = _tree(jm.init(jax.random.PRNGKey(0), jnp.ones((1, 16, 16, 3)), train=True))
    ref = resnet_state_dict(v["params"], v["batch_stats"])
    model = ResNet18(small_images=True, num_filters=16, num_classes=100, dtype=torch.float32,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    jl = JaxLeNet()
    lref = lenet_state_dict(_tree(jl.init(jax.random.PRNGKey(1), jnp.ones((1, 28, 28, 1)))
                                  ["params"]))
    lenet = LeNet5(device="cpu", generator=torch.Generator().manual_seed(1))
    for sd, want in ((model.state_dict(), ref), (lenet.state_dict(), lref)):
        assert set(sd) == set(want)
        for name, p in sd.items():
            assert p.shape == want[name].shape, name
            if name.endswith((".scale", ".mean", ".var")) or name.endswith("bias"):
                assert torch.equal(p, want[name]), name
            elif p.numel() >= 4096:
                assert abs(_std_ratio(p, want[name]) - 1) < 0.1, name
    zero_scales = [n for n, p in model.state_dict().items()
                   if n.endswith("norms.1.scale") and not p.any()]
    assert len(zero_scales) == len(model.blocks)


def _train_both(variant_or_lenet, comm, steps=3, lr=0.1):
    """3 momentum-SGD steps of the JAX train step and the port's from the
    same weights on the same rank-major batches: (jax losses, port losses,
    jax accuracies, port accuracies, jax params and stats per rank, port
    params, port stats)."""
    lenet = variant_or_lenet == "lenet"
    img, ch = (28, 1) if lenet else (RESNETS[variant_or_lenet], 3)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(steps, N, 4, img, img, ch)).astype(np.float32)
    ys = rng.integers(0, 10, size=(steps, N, 4))
    jm = JaxLeNet() if lenet else _jax_resnet(variant_or_lenet)
    if lenet:
        v = {"params": _tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0, 0])))["params"]}
    else:
        v = _tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0, 0]), train=True))
    jbf.init(devices=jax.devices()[:N])
    try:
        ctx = jbasics.context()
        init_fn, step_fn = jax_train_step(
            jm.apply, optax.sgd(lr, momentum=0.9), ctx.mesh,
            communication_type=JaxComm[comm], plan=ctx.plan, has_batch_stats=not lenet,
            donate=False)
        params = jax_replicate(jax.tree_util.tree_map(jnp.asarray, v["params"]), N)
        bstats = jax_replicate(jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), N) \
            if not lenet else {}
        state = init_fn(params)
        jl, ja = [], []
        for s in range(steps):
            params, bstats, state, loss, acc = step_fn(
                params, bstats, state, jnp.asarray(xs[s]), jnp.asarray(ys[s], jnp.int32))
            jl.append(np.asarray(loss))
            ja.append(np.asarray(acc))
        jparams, jstats = _tree(params), _tree(bstats)
    finally:
        jbf.shutdown()

    tbf.init(size=N, device="cpu")
    try:
        if lenet:
            model = LeNet5(device="cpu")
            model.load_state_dict(lenet_state_dict(v["params"]))
        else:
            model = _port_resnet(variant_or_lenet)
            model.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]))
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        stats = replicate_for_mesh(dict(model.named_buffers()), N, requires_grad=False)
        opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=0.9, dampening=0.0)
        step_fn = make_decentralized_train_step(
            make_classifier_apply_fn(model), params, opt,
            communication_type=CommunicationType[comm], plan=tbf.context().plan,
            batch_stats=None if lenet else stats)
        tl, ta = [], []
        for s in range(steps):
            loss, acc = step_fn(torch.from_numpy(xs[s]), torch.from_numpy(ys[s]))
            tl.append(loss.numpy())
            ta.append(acc.numpy())
    finally:
        tbf.shutdown()
    return jl, tl, ja, ta, (jparams, jstats), params, stats


@pytest.mark.parametrize("comm", ["neighbor_allreduce", "allreduce"])
def test_train_step_with_batch_stats_matches_reference(comm):
    """3 momentum-SGD steps of ResNet-18 (small images) with batch
    statistics, under ATC neighbor_allreduce and gradient allreduce over 4
    ranks: per-rank losses and accuracies, every rank's parameters and
    every rank's running statistics (local to it, never gossiped) within
    1e-4 relative."""
    jl, tl, ja, ta, (jp, js), params, stats = _train_both("resnet18_small", comm)
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-4)
    np.testing.assert_array_equal(np.stack(ta), np.stack(ja))
    for r in range(N):
        want = resnet_state_dict(jax.tree_util.tree_map(lambda a: a[r], jp),
                                 jax.tree_util.tree_map(lambda a: a[r], js))
        for name, leaf in {**params, **stats}.items():
            w = want[name].numpy()
            np.testing.assert_allclose(leaf[r].detach().numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max() + 1e-7,
                                       err_msg=f"rank {r} {name}")
    # statistics stay local: ranks saw different batches, so they differ
    name = "bn_init.mean"
    assert not torch.equal(stats[name][0], stats[name][1])


def test_lenet_train_step_matches_reference():
    """LeNet (no batch statistics) through both train steps, ATC gossip:
    losses, accuracies and per-rank parameters."""
    jl, tl, ja, ta, (jp, _), params, _ = _train_both("lenet", "neighbor_allreduce")
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-5)
    np.testing.assert_array_equal(np.stack(ta), np.stack(ja))
    for r in range(N):
        want = lenet_state_dict(jax.tree_util.tree_map(lambda a: a[r], jp))
        for name, leaf in params.items():
            np.testing.assert_allclose(leaf[r].detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"rank {r} {name}")


def test_train_step_reports_nan_accuracy_for_a_scalar_loss():
    """A model that returns its own loss has no logits to score: NaN, as
    the reference reports it."""
    tbf.init(size=N, device="cpu")
    try:
        params = replicate_for_mesh({"w": torch.ones(3)}, N)
        step_fn = make_decentralized_train_step(
            lambda state, x, labels=None: (state["w"] * x).sum(), params,
            torch.optim.SGD(list(params.values()), lr=0.1), plan=tbf.context().plan,
            loss_fn=lambda out, y: out)
        loss, acc = step_fn(torch.ones(N, 3), torch.zeros(N, 1))
        assert loss.shape == acc.shape == (N,) and torch.isnan(acc).all()
    finally:
        tbf.shutdown()


def test_train_step_checks_batch_stats_arguments():
    params = replicate_for_mesh({"w": torch.zeros(3)}, N)
    opt = torch.optim.SGD(list(params.values()), lr=0.1)
    with pytest.raises(ValueError, match="rank-major"):
        make_decentralized_train_step(lambda s, x: x, params, opt,
                                      batch_stats={"b": torch.zeros(N + 1, 2)})


def test_apply_accepts_labels_matches_reference():
    def with_labels(state, x, labels=None):
        return x

    def without(state, x):
        return x

    for fn in (with_labels, without, len):
        assert apply_accepts_labels(fn) == jax_accepts_labels(fn)
    assert apply_accepts_labels(with_labels) and not apply_accepts_labels(without)


def test_broadcasts_match_reference():
    """broadcast_parameters gives every rank the root's parameters in place
    (leaves stay leaves); broadcast_optimizer_state gives every rank the
    root's momentum, as the reference's tree broadcast does."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(N, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(N, 5)).astype(np.float32)}
    jbf.init(devices=jax.devices()[:N])
    try:
        want = _tree(jax_optim.broadcast_parameters(
            jax.tree_util.tree_map(jnp.asarray, tree), root_rank=2))
    finally:
        jbf.shutdown()
    tbf.init(size=N, device="cpu")
    try:
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in tree.items()}
        out = tbf.broadcast_parameters(params, root_rank=2)
        assert out is params
        for k, leaf in params.items():
            assert leaf.is_leaf and leaf.requires_grad
            np.testing.assert_array_equal(leaf.detach().numpy(), want[k])
        opt = torch.optim.SGD(list(params.values()), lr=0.1, momentum=0.9)
        for leaf in params.values():
            leaf.grad = torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32))
        opt.step()
        tbf.broadcast_optimizer_state(opt, root_rank=1)
        for leaf in params.values():
            buf = opt.state[leaf]["momentum_buffer"]
            assert torch.equal(buf, buf[1:2].expand_as(buf))
    finally:
        tbf.shutdown()
