"""``profiling.cost_summary`` / ``cost_delta`` of the port against the JAX
package's on the same numpy inputs.

The reference reads XLA's ``HloCostAnalysis`` of the jitted program on the
CPU; the port counts the eager aten ops by the same rules.  ``flops`` and
``transcendentals`` must be equal exactly.  ``bytes accessed`` is equal
exactly where XLA fuses nothing (the matmul / tanh chain, the single
convolutions); elsewhere XLA fuses elementwise ops into their consumers
and counts fewer operand bytes, so the port's count must be at least the
reference's.  Where XLA's fusion pass duplicates a cheap producer into
several consumer fusions and counts it in each (batch norm's backward, a
residual block), the port is held exactly to the same program compiled
with that pass off (:func:`_ref_unfused`), every HLO op counted once, and
below the reference's own count.  Each case names the rule it pins."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu import profiling as ref
from bluefog_tpu.models import ResNet18 as JaxResNet18
from bluefog_tpu_torch import profiling as port
from bluefog_tpu_torch.models import ResNet18
from bluefog_tpu_torch.models.layers import BatchNorm, max_pool_same

# ResNet forward + backward on several CPU threads can corrupt the heap in
# torch 2.13's CPU build; the vision tests run on one thread too
torch.set_num_threads(1)
KEYS = ("flops", "transcendentals", "bytes accessed")


def _jax_args(args):
    """Arrays for the reference; a shape alone (``jax.ShapeDtypeStruct``)
    stays one, as the counts read no value."""
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, jax.ShapeDtypeStruct) else jnp.asarray(a), list(args))


def _ref(fn, args):
    c = ref.cost_summary(fn, _jax_args(args))
    return {k: c.get(k, 0.0) for k in KEYS}


def _ref_unfused(fn, args):
    """XLA's count of the reference's program compiled without the fusion
    pass: each HLO op once, no producer duplicated into its consumers."""
    c = jax.jit(fn).lower(*_jax_args(args)).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"}).cost_analysis()
    return {k: c.get(k, 0.0) for k in KEYS}


def _port(fn, args):
    return port.cost_summary(fn, [torch.from_numpy(np.ascontiguousarray(a)) for a in args])


def _ref_vjp(fn, nargs):
    """The reference's forward and its vjp with a cotangent, the last
    argument (a cotangent of ones would let XLA drop the multiplies by it);
    the gradient is taken of the first ``nargs`` arguments.  Every input is
    an argument, so that XLA folds none of it into a constant."""
    def f(*args):
        rest = args[nargs:-1]
        out, back = jax.vjp(lambda *p: fn(*p, *rest), *args[:nargs])
        return out, back(args[-1])

    return f


def _port_vjp(fn, args, g, wrt=None):
    """The port's forward and ``backward(g)``, the gradient taken of the
    arguments whose index is in ``wrt`` (all by default)."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    for i, t in enumerate(ts):
        t.requires_grad_(wrt is None or i in wrt)
    return port.cost_summary(lambda: fn(*ts).backward(torch.from_numpy(g)))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _mm_jax(n):
    @jax.jit
    def f(x):
        y = x
        for _ in range(n):
            y = jnp.tanh(y @ x)
        return y

    return f


def _mm(n):
    def f(x):
        y = x
        for _ in range(n):
            y = torch.tanh(y @ x)
        return y

    return f


@pytest.mark.parametrize("n", [1, 3])
def test_matmul_tanh_chain_matches_reference_exactly(n):
    """mm is 2·M·N·K flops, tanh one transcendental an element, bytes the
    operands and results of each op unfused: equal on every key."""
    (x,) = _arrays(0, (128, 128))
    got, want = _port(_mm(n), [x]), _ref(_mm_jax(n), [x])
    assert got == want
    assert got["flops"] == n * 2 * 128 ** 3
    assert got["transcendentals"] == n * 128 ** 2


def test_cost_delta_of_the_chain_matches_reference():
    (x,) = _arrays(0, (128, 128))
    got = port.cost_delta(_mm(1), _mm(3), [torch.from_numpy(x)], [torch.from_numpy(x)])
    want = ref.cost_delta(_mm_jax(1), _mm_jax(3), [jnp.asarray(x)], [jnp.asarray(x)])
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["flops"] == 2 * 2 * 128 ** 3 and got["transcendentals"] == 2 * 128 ** 2


def test_mlp_matches_reference():
    """Dense + bias + tanh + Dense: addmm's product and its bias add (one
    flop an output element), tanh, mm."""
    args = _arrays(1, (8, 32), (32, 64), (64,), (64, 16))
    got = _port(lambda x, w1, b1, w2: torch.tanh(F.linear(x, w1.T, b1)) @ w2, args)
    want = _ref(lambda x, w1, b1, w2: jnp.tanh(x @ w1 + b1) @ w2, args)
    assert got["flops"] == want["flops"] == 2 * 8 * 32 * 64 + 8 * 64 + 2 * 8 * 64 * 16
    assert got["transcendentals"] == want["transcendentals"] == 8 * 64
    assert got["bytes accessed"] >= want["bytes accessed"]


@pytest.mark.parametrize("padding,stride", [("VALID", 1), ("SAME", 1), ("SAME", 2)])
def test_conv3x3_nhwc_matches_reference(padding, stride):
    """2 x output positions x taps on real input x in x out features: SAME
    counts only the taps off the padding, both the convolution's own (stride
    1) and the zeros a separate pad op put at the end (flax's asymmetric
    SAME at stride 2)."""
    x, k = _arrays(2, (2, 10, 10, 4), (3, 3, 4, 8))

    def jax_conv(x, k):
        return jax.lax.conv_general_dilated(x, k, (stride, stride), padding,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def torch_conv(x, k):
        x, k = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
        if padding == "VALID":
            return F.conv2d(x, k)
        if stride == 1:
            return F.conv2d(x, k, padding=1)
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), k, stride=2)

    got, want = _port(torch_conv, [x, k]), _ref(jax_conv, [x, k])
    assert got["flops"] == want["flops"]
    assert got["transcendentals"] == want["transcendentals"] == 0
    assert got["bytes accessed"] >= want["bytes accessed"]
    if stride == 1:
        assert got["bytes accessed"] == want["bytes accessed"]
    full = 2 * 2 * (8 if padding == "VALID" else 10) ** 2 * 9 * 4 * 8
    assert (got["flops"] == full) == (padding == "VALID")


CONV_CASES = {
    # name: (padding, stride, bias)
    "valid": ("VALID", 1, False), "same": ("SAME", 1, False),
    "same-stride2-padded": ("SAME", 2, False), "valid-bias": ("VALID", 1, True)}


@pytest.mark.parametrize("wrt", [(0, 1), (0,), (1,)], ids=["both", "input", "kernel"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_forward_and_backward_match_reference(case, wrt):
    """A convolution's backward is its forward's count once for each
    requested gradient (the input's a convolution with the flipped kernel,
    the kernel's one of the input with the output gradient), the pad op's
    zeros skipped there too; a bias gradient is a reduce over all but the
    channel dim.  Against ``jax.vjp`` of the same convolution."""
    padding, stride, bias = CONV_CASES[case]
    x, k, b = _arrays(10, (2, 10, 10, 4), (3, 3, 4, 8), (8,))

    def jax_conv(x, k, b):
        y = jax.lax.conv_general_dilated(x, k, (stride, stride), padding,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + b if bias else y

    def torch_conv(x, k, b):
        x, k = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
        b = b if bias else None
        if padding == "VALID":
            y = F.conv2d(x, k, b)
        elif stride == 1:
            y = F.conv2d(x, k, b, padding=1)
        else:
            y = F.conv2d(F.pad(x, (0, 1, 0, 1)), k, b, stride=2)
        return y.permute(0, 2, 3, 1)

    (g,) = _arrays(11, jax_conv(x, k, b).shape)
    held = {0: x, 1: k, 2: b}
    grads = list(wrt) + ([2] if bias else [])

    def ref_fn(*args):
        vals = dict(held)
        vals.update(zip(grads, args))
        return jax_conv(vals[0], vals[1], vals[2])

    want = _ref(_ref_vjp(ref_fn, len(grads)), [held[i] for i in grads] + [g])
    got = _port_vjp(torch_conv, [x, k, b], g, wrt=grads)
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    fwd = _port(torch_conv, [x, k, b])["flops"]
    conv = fwd - (g.size if bias else 0)  # the forward less its bias add
    assert got["flops"] == fwd + conv * len(wrt) + (g.size - 8 if bias else 0)


BACKWARD = {
    # name: (port fn, reference fn), the backward op's rule in the comment
    "tanh": (torch.tanh, jnp.tanh),                       # (g + g * y) * (1 - y): 4
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid),           # g * y * (1 - y): 3
    "relu": (F.relu, jax.nn.relu),                        # compare and select: 2
    "silu": (F.silu, jax.nn.silu),                        # the product rule: 6
}


@pytest.mark.parametrize("name", sorted(BACKWARD))
def test_backward_rules_match_reference(name):
    """An activation's backward op against ``jax.vjp`` of the same
    activation, forward included (the logistic's exp is shared)."""
    x, g = _arrays(12, (8, 32), (8, 32))
    fn_port, fn_ref = BACKWARD[name]
    want = _ref(_ref_vjp(fn_ref, 1), [x, g])
    got = _port_vjp(fn_port, [x], g)
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])


def _avg_pool(k):
    import flax.linen as nn

    return lambda x: nn.avg_pool(x, (k, k), (k, k))


def _conv_transpose(stride):
    return lambda x, k: jax.lax.conv_transpose(x, k, (stride, stride), "VALID",
                                               dimension_numbers=("NHWC", "HWIO", "NHWC"))


OTHER_RULES = {
    # name: (port fn, reference fn, shapes), the rule in the comment
    # a + w * (b - a): 3 an element
    "lerp-scalar": (lambda a, b: torch.lerp(a, b, 0.3), lambda a, b: a + 0.3 * (b - a),
                    [(8, 32)] * 2),
    "lerp-tensor": (torch.lerp, lambda a, b, w: a + w * (b - a), [(8, 32)] * 3),
    # a + value * b * c (or / c): 2 an element, 3 if value is not 1
    "addcmul": (torch.addcmul, lambda a, b, c: a + b * c, [(8, 32)] * 3),
    "addcmul-scaled": (lambda a, b, c: torch.addcmul(a, b, c, value=0.5),
                       lambda a, b, c: a + 0.5 * b * c, [(8, 32)] * 3),
    "addcdiv": (torch.addcdiv, lambda a, b, c: a + b / c, [(8, 32)] * 3),
    "addcdiv-scaled": (lambda a, b, c: torch.addcdiv(a, b, c, value=0.5),
                       lambda a, b, c: a + 0.5 * b / c, [(8, 32)] * 3),
    # products: 2·M·K (and N, B), the bias add one an output element
    "mv": (torch.mv, lambda m, v: m @ v, [(8, 32), (32,)]),
    "dot": (torch.dot, lambda u, v: u @ v, [(32,), (32,)]),
    "addmv": (torch.addmv, lambda b, m, v: b + m @ v, [(8,), (8, 32), (32,)]),
    "baddbmm": (torch.baddbmm, lambda b, p, q: b + p @ q, [(2, 4, 6), (2, 4, 5), (2, 5, 6)]),
    # the window's adds and one divide an output element
    "avg_pool-2": (lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2), _avg_pool(2),
                   [(2, 8, 8, 4)]),
    "avg_pool-3": (lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 3), _avg_pool(3),
                   [(2, 9, 9, 4)]),
    # every input element scattered over the window of each output feature
    "conv_transpose": (lambda x, k: F.conv_transpose2d(x.permute(0, 3, 1, 2),
                                                       k.permute(2, 3, 0, 1)),
                       _conv_transpose(1), [(2, 5, 5, 8), (3, 3, 8, 4)]),
    "conv_transpose-stride2": (lambda x, k: F.conv_transpose2d(
        x.permute(0, 3, 1, 2), k.permute(2, 3, 0, 1), stride=2),
        _conv_transpose(2), [(2, 5, 5, 8), (3, 3, 8, 4)]),
}


@pytest.mark.parametrize("name", sorted(OTHER_RULES))
def test_other_rules_match_reference(name):
    """The optimizers' fused elementwise ops, the vector products, average
    pooling and the transposed convolution: flops and transcendentals
    exact.  Bytes are not compared: XLA writes ``baddbmm`` and
    ``avg_pool`` as two ops and counts the intermediate, the port one aten
    op."""
    fn_port, fn_ref, shapes = OTHER_RULES[name]
    args = _arrays(13, *shapes)
    got, want = _port(fn_port, args), _ref(fn_ref, args)
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    assert got["flops"] > 0


ELEMENTWISE = {
    # name: (port fn, reference fn), the rule in the comment
    "relu": (F.relu, jax.nn.relu),                        # one flop an element
    "add": (lambda x: x + x, lambda x: x + x),
    "neg": (torch.neg, jnp.negative),
    "convert": (lambda x: x.to(torch.bfloat16), lambda x: x.astype(jnp.bfloat16)),
    "square": (lambda x: x.pow(2), lambda x: x ** 2),     # an integer power: multiplies
    "pow": (lambda x: x.abs().pow(3.5), lambda x: jnp.abs(x) ** 3.5),  # transcendental
    "sqrt": (lambda x: x.abs().sqrt(), lambda x: jnp.sqrt(jnp.abs(x))),
    "exp": (torch.exp, jnp.exp),
    "erf": (torch.erf, jax.scipy.special.erf),
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid),           # XLA CPU: 3 flops + exp
    "where": (lambda x: torch.where(x > 0, x, 0.0), lambda x: jnp.where(x > 0, x, 0.0)),
    "sum": (lambda x: x.sum(1), lambda x: x.sum(1)),      # input - output elements
    "max": (lambda x: x.amax(1), lambda x: x.max(1)),
    "mean": (lambda x: x.mean(0), lambda x: x.mean(0)),   # + one divide an output
    "softmax": (lambda x: torch.softmax(x, -1), lambda x: jax.nn.softmax(x, -1)),
    "log_softmax": (lambda x: torch.log_softmax(x, -1), lambda x: jax.nn.log_softmax(x, -1)),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_and_reduction_rules_match_reference(name):
    """Exact against each HLO op counted once; the reference's fused count
    is the same but for log-softmax, whose ``x - max`` XLA computes in two
    fusions."""
    (x,) = _arrays(3, (8, 32))
    fn_port, fn_ref = ELEMENTWISE[name]
    got, want, fused = _port(fn_port, [x]), _ref_unfused(fn_ref, [x]), _ref(fn_ref, [x])
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    assert got["transcendentals"] == fused["transcendentals"]
    assert got["flops"] == fused["flops"] - (x.size if name == "log_softmax" else 0)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (4, 4, 4, 16)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_flax(shape, train):
    """flax's BatchNorm as XLA counts it, each op once: training 6 flops an
    element and 5 a channel, eval 3 and 2; one rsqrt a channel (the fused
    program counts a channel's op twice in training).  The port's BatchNorm
    layer moves its running averages with separate ops, so the rule is held
    on the aten op alone."""
    import flax.linen as nn

    (x,) = _arrays(4, shape)
    c = shape[-1]
    bn = nn.BatchNorm(use_running_average=not train)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if train:
        fn = lambda v, x: bn.apply(v, x, mutable=["batch_stats"])[0]  # noqa: E731
    else:
        fn = lambda v, x: bn.apply(v, x)  # noqa: E731
    want, fused = _ref_unfused(fn, [v, x]), _ref(fn, [v, x])
    mean, var, w, b = torch.zeros(c), torch.ones(c), torch.ones(c), torch.zeros(c)
    got = _port(lambda x: F.batch_norm(x.permute(0, 3, 1, 2), None if train else mean,
                                       None if train else var, w, b, train), [x])
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    assert got["flops"] == (6 * x.size + 5 * c if train else 3 * x.size + 2 * c)
    assert got["flops"] == fused["flops"] - (c if train else 0)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 5, 5, 8)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_backward_matches_flax(shape, train):
    """The backward op against ``jax.vjp`` of flax's BatchNorm (scale, bias
    and input gradients): training 8 flops an element and 15 a channel,
    eval 4 an element less one a channel, as XLA counts each HLO op once;
    the reference's fused program counts more (its fusion pass recomputes
    the normalized input in several consumers)."""
    import flax.linen as nn

    x, g = _arrays(14, shape, shape)
    c = shape[-1]
    bn = nn.BatchNorm(use_running_average=not train)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def ref_fn(p, x, stats):
        vs = {"params": p, "batch_stats": stats}
        return bn.apply(vs, x, mutable=["batch_stats"])[0] if train else bn.apply(vs, x)

    prog, args = _ref_vjp(ref_fn, 2), [v["params"], x, v["batch_stats"], g]
    want, fused = _ref_unfused(prog, args), _ref(prog, args)
    mean, var = torch.zeros(c), torch.ones(c)

    def torch_bn(x, w, b):
        return F.batch_norm(x.permute(0, 3, 1, 2), None if train else mean,
                            None if train else var, w, b, train).permute(0, 2, 3, 1)

    args = [x, np.ones(c, np.float32), np.zeros(c, np.float32)]
    got, fwd = _port_vjp(torch_bn, args, g), _port(torch_bn, args)
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    assert got["flops"] - fwd["flops"] == (8 * x.size + 15 * c if train else 4 * x.size - c)
    assert got["flops"] < fused["flops"]


def test_layer_norm_matches_flax():
    """7 flops an element, 4 and one rsqrt a row (the fused program counts
    a row's op twice)."""
    import flax.linen as nn

    (x,) = _arrays(5, (4, 6, 16))
    ln = nn.LayerNorm()
    v = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fn = lambda v, x: ln.apply(v, x)  # noqa: E731
    want, fused = _ref_unfused(fn, [v, x]), _ref(fn, [v, x])
    got = _port(lambda x: F.layer_norm(x, (16,), torch.ones(16), torch.zeros(16), 1e-6), [x])
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    assert got["flops"] == fused["flops"] - 4 * 6


def test_max_pool_same_matches_flax():
    """The window's compares an output element, padding included; its
    backward is XLA's select-and-scatter, window^2 an output element."""
    import flax.linen as nn

    (x,) = _arrays(6, (2, 8, 8, 4))
    want = _ref(lambda x: nn.max_pool(x, (3, 3), (2, 2), padding="SAME"), [x])
    got = _port(lambda x: max_pool_same(x.permute(0, 3, 1, 2), 3, 2), [x])
    assert got["flops"] == want["flops"] == 2 * 4 * 4 * 4 * 8
    want_grad = _ref(jax.grad(lambda x: nn.max_pool(x, (3, 3), (2, 2), padding="SAME").sum()),
                     [x])
    xt = torch.from_numpy(x).requires_grad_(True)

    def fwd_bwd():
        max_pool_same(xt.permute(0, 3, 1, 2), 3, 2).sum().backward()

    got_grad = port.cost_summary(fwd_bwd)
    # the port's sum of the output (127 flops) stands where jax's gradient
    # of a sum is a broadcast
    assert got_grad["flops"] - (2 * 4 * 4 * 4 - 1) == want_grad["flops"]


def _resnet18_pair(seed):
    """The reference's ResNet-18 (small images, 8 filters, f32) with the
    shapes of its variables (the counts read no value), the port's, and an
    input batch of 2."""
    (x,) = _arrays(seed, (2, 16, 16, 3))
    jm = JaxResNet18(num_classes=10, num_filters=8, small_images=True, dtype=jnp.float32)
    v = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=True), x)
    model = ResNet18(num_classes=10, num_filters=8, small_images=True, dtype=torch.float32,
                     device="cpu")
    return jm, v, model, x


def _channels(model):
    """The channels of every batch norm: the running averages' count."""
    return sum(m.scale.numel() for m in model.modules() if isinstance(m, BatchNorm))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet18_forward_within_reference_fusion_duplicates(train):
    """ResNet-18 (small images, f32) forward: every convolution, norm, ReLU
    and add counted once, exactly XLA's count of each op of the same
    program, but for the running averages' updates (10 flops a channel) in
    training, which the port counts and XLA drops as dead code.  XLA's CPU
    pipeline duplicates a block's input normalization into the consumer
    fusion that also computes the residual add, and counts it there again,
    so the reference's own count reads up to ~1.2% more."""
    jm, v, model, x = _resnet18_pair(7)
    if train:
        fn = lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0]  # noqa: E731
    else:
        fn = lambda v, x: jm.apply(v, x, train=False)  # noqa: E731
    want, fused = _ref_unfused(fn, [v, x]), _ref(fn, [v, x])
    model.train(train)
    got = _port(model, [x])
    assert got["transcendentals"] == want["transcendentals"] == fused["transcendentals"]
    assert got["flops"] == want["flops"] + (10 * _channels(model) if train else 0)
    assert 0.985 * fused["flops"] <= got["flops"] <= fused["flops"]


def test_batch_norm_ops_count_alike():
    """native_batch_norm (the port's layer) and F.batch_norm's op count the
    same (on the card the latter may dispatch cudnn_batch_norm)."""
    (x,) = _arrays(8, (2, 4, 6, 6))
    xt = torch.from_numpy(x)
    w, b = torch.ones(4), torch.zeros(4)
    a = port.cost_summary(lambda: torch.native_batch_norm(xt, w, b, None, None, True, 0.0, 1e-5))
    f = port.cost_summary(lambda: F.batch_norm(xt, None, None, w, b, True))
    assert a["flops"] == f["flops"] == 6 * xt.numel() + 5 * 4
    layer = BatchNorm(4)
    assert port.cost_summary(layer, [xt])["flops"] == a["flops"] + 10 * 4


def test_views_and_backward_of_a_padded_convolution():
    """Views count nothing; the value and gradient of a padded stride-2
    convolution's sum equal ``jax.value_and_grad``'s: the forward, the
    sum, and the forward's count once for each requested gradient, the pad
    op's zeros skipped there too."""
    x, k = _arrays(15, (2, 10, 10, 4), (3, 3, 4, 8))
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    assert port.cost_summary(lambda: xt.view(2, 400).t().unsqueeze(0)) == {
        "flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0}

    def jax_loss(x, k):
        return jax.lax.conv_general_dilated(x, k, (2, 2), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC")).sum()

    def conv(x, k):
        return F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)), k.permute(3, 2, 0, 1),
                        stride=2)

    want = _ref(jax.value_and_grad(jax_loss, argnums=(0, 1)), [x, k])
    got = port.cost_summary(lambda: conv(xt, kt).sum().backward())
    assert (got["flops"], got["transcendentals"]) == (want["flops"], want["transcendentals"])
    fwd = port.cost_summary(conv, [xt, kt])["flops"]
    assert got["flops"] == 3 * fwd + 2 * 8 * 5 * 5 - 1


def test_resnet18_forward_and_backward_match_reference_per_op():
    """ResNet-18's forward and the gradient of its parameters under one
    cotangent, against ``jax.vjp`` of the reference's model: exactly XLA's
    count of each op of that program, plus what the eager ops do besides:
    the running-average updates (10 flops a channel, dead code to XLA);
    the pool's gradient divided after its broadcast to the pool's input
    (2x2x2x64), where jax divides before (2x64); and in each projection
    block the sum of the output gradient that both its batch norms' backward
    ops compute (n - c flops), which XLA computes once.  The reference's
    fused count reads ~5% more (batch norm's backward and the residual
    blocks computed again in several fusions)."""
    jm, v, model, x = _resnet18_pair(16)
    (g,) = _arrays(17, (2, 10))

    def forward(p, stats, x):
        return jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                        mutable=["batch_stats"])[0]

    prog, args = _ref_vjp(forward, 1), [v["params"], v["batch_stats"], x, g]
    want, fused = _ref_unfused(prog, args), _ref(prog, args)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = port.cost_summary(lambda: model(xt).backward(gt))
    assert got["transcendentals"] == want["transcendentals"] == fused["transcendentals"]
    pool = 2 * 2 * 2 * 64 - 2 * 64
    projections = sum(n - c for n, c in ((2 * 8 * 8 * 16, 16), (2 * 4 * 4 * 32, 32),
                                         (2 * 2 * 2 * 64, 64)))
    assert got["flops"] == want["flops"] + 10 * _channels(model) + pool + projections
    assert 0.93 * fused["flops"] < got["flops"] < fused["flops"]


# --------------------------------------------------------------------------
# the twins of tests/test_profiling.py's cost cases
# --------------------------------------------------------------------------


def test_cost_summary_and_delta_flops():
    x = torch.ones((128, 128))
    c1 = port.cost_summary(_mm(1), (x,))
    c3 = port.cost_summary(_mm(3), (x,))
    assert c1["flops"] > 0
    # each extra matmul adds 2*128^3 flops (+ the tanh)
    delta = port.cost_delta(_mm(1), _mm(3), (x,), (x,))
    added = delta["flops"]
    assert added >= 2 * 2 * 128 ** 3
    np.testing.assert_allclose(added, c3["flops"] - c1["flops"])


def test_cost_summary_accepts_a_module():
    """The counterpart of a pre-jitted function: any callable, a module
    among them."""
    lin = torch.nn.Linear(16, 16)
    assert port.cost_summary(lin, (torch.ones(16, 16),))["flops"] > 0
    assert port.cost_summary(_mm(2), (torch.ones(16, 16),))["flops"] > 0


def test_train_step_counts_forward_and_backward():
    """With a backward in ``fn`` the gradient is counted: a ResNet-18 train
    step (forward, cross-entropy, backward) against the reference's
    ``jax.value_and_grad`` of the same loss.  The two losses are counted
    by their own decompositions (log-softmax and a pick against optax's
    logsumexp), a few hundred flops apart; the rest is each op once, as
    above, so the port lies within 0.1% of XLA's per-op count plus the
    running averages, and under the reference's fused count."""
    jm, v, model, x = _resnet18_pair(18)
    y = np.array([1, 2])

    def loss(p, stats, x, y):
        logits = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])[0]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    step, args = jax.value_and_grad(loss), [v["params"], v["batch_stats"], x, y]
    want, fused = _ref_unfused(step, args), _ref(step, args)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    fwd = port.cost_summary(model, (xt,))["flops"]
    got = port.cost_summary(lambda: F.cross_entropy(model(xt), yt).backward())
    assert got["transcendentals"] == want["transcendentals"] == fused["transcendentals"]
    expected = want["flops"] + 10 * _channels(model)
    assert abs(got["flops"] - expected) < 1e-3 * expected
    assert 0.93 * fused["flops"] < got["flops"] < fused["flops"]
    assert 2.8 * fwd < got["flops"] < 3.2 * fwd  # each convolution's backward is two


def test_reference_cross_entropy_is_counted_alike():
    """The train step's loss: log_softmax and the label pick, against
    optax's softmax cross-entropy (which XLA fuses; flops equal)."""
    logits, = _arrays(9, (4, 10))
    labels = np.array([1, 2, 3, 4])
    want = ref.cost_summary(
        lambda l, y: optax.softmax_cross_entropy_with_integer_labels(l, y).mean(),
        [jnp.asarray(logits), jnp.asarray(labels)])
    got = port.cost_summary(F.cross_entropy, [torch.from_numpy(logits), torch.from_numpy(labels)])
    assert got["transcendentals"] == want["transcendentals"]
