"""The sequence-parallel Llama path of bluefog_tpu_torch against the JAX
package on the 8-device CPU mesh: ``LlamaLM`` with ring (dense and on the
flash kernels' plain versions) and Ulysses attention against the
reference's dense path (its ``test_llama_with_ring_attention_matches_dense_path``
and Ulysses twin), the gradients of the ``--seq-parallel`` loss against
``jax.grad`` of the unsharded loss, three Adam steps of
``examples/llama_pretrain --seq-parallel`` against a JAX step built as the
reference's ``run_seq_parallel`` builds it, the rotary embedding's per-row
positions, and the example's flag rules.  Weights come from the JAX init
through ``llama_state_dict``; token batches are made with numpy.

The reference's seq-parallel step reduces per-shard gradients with
``pmean`` (contiguous) or ``psum`` (striped) and, depending on the layout
and on ``check_vma``, ends with the gradient of the global mean or n
times it (ROADMAP, "Caveats on the reference").  The port's one backward
gives the gradient of the global mean: held against ``jax.grad`` of the
unsharded loss here.  Adam divides each update by the root of its second
moment, so the scale leaves the trajectories within its epsilon (1e-8)
of each other (see ``test_seq_parallel_adam_steps_track_the_reference``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.core.basics import NODES_AXIS
from bluefog_tpu.models.transformer import LlamaLM as JaxLlama
from bluefog_tpu.parallel.ring_attention import make_ring_attention_fn as jax_ring_fn
from bluefog_tpu.parallel.ring_attention import stripe_blocks as jax_stripe
from bluefog_tpu.parallel.ring_attention import striped_positions as jax_striped_positions
from bluefog_tpu_torch.examples import llama_pretrain
from bluefog_tpu_torch.interop.jax_weights import llama_state_dict
from bluefog_tpu_torch.models.transformer import LlamaLM, _rotary
from bluefog_tpu_torch.parallel.ring_attention import (
    gather_outputs,
    make_ring_attention_fn,
    shard_inputs,
    striped_positions,
)
from bluefog_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

torch.set_num_threads(1)
SIZE = 8
RTOL, ATOL = 1e-4, 1e-5  # as tests/test_torch_llama_options.py (f32 throughout)

# the reference example's seq-parallel model: num_heads 4, dff = 3 x hidden, f32
SP = dict(vocab=64, hidden=32, layers=2, heads=4, dff=96, seq=64, batch=2, head_chunks=0)


@pytest.fixture(autouse=True)
def fresh_context(devices):
    jbf.init()
    yield
    jbf.shutdown()


def _jax_params(cfg, t, seed=0):
    model = JaxLlama(**cfg, dtype=jnp.float32)
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, t), jnp.int32))["params"]


def _port_model(cfg, params, attention_fn):
    model = LlamaLM(**cfg, dtype=torch.float32, device="cpu", attention_fn=attention_fn)
    model.load_state_dict(llama_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                           cfg["num_layers"]), strict=True)
    return model


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


@pytest.mark.parametrize("attention", ["ring", "ring_flash", "ring_striped_flash",
                                       "ulysses", "ulysses_flash"])
def test_llama_with_sequence_parallel_attention_matches_the_reference_dense_path(attention):
    """As the reference's ``test_llama_with_ring_attention_matches_dense_path``
    and ``test_llama_with_ulysses_matches_dense_path``: the same widths
    (vocab 64, T 32, hidden 32, 2 layers; 2 heads for the ring, 8 for
    Ulysses), logits within 3e-4 of the reference's single-device dense
    model on the same weights."""
    heads = 8 if attention.startswith("ulysses") else 2
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=heads, dff=64)
    t, b = 32, 2
    params = _jax_params(cfg, t)
    ids = _ids(0, (b, t), 64)
    ref = np.asarray(JaxLlama(**cfg, dtype=jnp.float32).apply({"params": params},
                                                              jnp.asarray(ids)))
    flash = attention.endswith("flash")
    striped = "striped" in attention
    fn = (make_ulysses_attention_fn(SIZE, flash=flash) if attention.startswith("ulysses")
          else make_ring_attention_fn(SIZE, flash=flash, striped=striped))
    model = _port_model(cfg, params, fn)
    x, pos = shard_inputs(torch.from_numpy(ids), SIZE, striped)
    with torch.no_grad():
        out = gather_outputs(model(x, pos), SIZE, striped)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-4)


def _sp_cfg():
    return dict(vocab_size=SP["vocab"], hidden_size=SP["hidden"], num_layers=SP["layers"],
                num_heads=SP["heads"], dff=SP["dff"])


def _unsharded_loss(model, params, ids, striped):
    """The seq-parallel loss of the reference's ``run_seq_parallel`` on the
    whole sequence: striped, the mean next-token loss over every pair but
    the last token; contiguous, the mean over shards of each shard's
    shifted loss (the boundary pairs dropped)."""
    logits = model.apply({"params": params}, ids)
    if striped:
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], ids[:, 1:]).mean()
    tl = ids.shape[1] // SIZE
    lg = logits.reshape(logits.shape[0], SIZE, tl, -1)
    y = ids.reshape(ids.shape[0], SIZE, tl)
    ce = optax.softmax_cross_entropy_with_integer_labels(lg[:, :, :-1], y[:, :, 1:])
    return ce.mean(axis=(0, 2)).mean()


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("striped", [False, True])
def test_seq_parallel_gradients_are_those_of_the_global_mean_loss(striped, flash):
    """One backward of the port's seq-parallel loss gives jax.grad of the
    unsharded loss (the ground truth the reference's comments intend)."""
    cfg = _sp_cfg()
    t, b = SP["seq"], SP["batch"]
    params = _jax_params(cfg, t)
    ids = _ids(1, (b, t), SP["vocab"])
    value, grads = jax.value_and_grad(
        lambda p: _unsharded_loss(JaxLlama(**cfg, dtype=jnp.float32), p, jnp.asarray(ids),
                                  striped))(params)
    want = llama_state_dict(jax.tree_util.tree_map(np.asarray, grads), cfg["num_layers"])
    model = _port_model(cfg, params, make_ring_attention_fn(SIZE, flash=flash,
                                                            striped=striped))
    x, pos = shard_inputs(torch.from_numpy(ids), SIZE, striped)
    loss = llama_pretrain.seq_parallel_loss(model(x, pos), x, SIZE, striped)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-5)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL, atol=ATOL * np.abs(w).max(),
                                   err_msg=name)


def _jax_seq_parallel_grads(flash, striped):
    """The reference's ``run_seq_parallel`` loss and gradient reduction
    (``examples/jax_llama_pretrain.py:160-258``), built as it builds
    them: ``spmd_grads(params, ids) -> (loss, grads)`` inside
    ``shard_map``, ``ids`` the device's ``[B, T_local]`` shard."""
    n, tl = SIZE, SP["seq"] // SIZE
    model = JaxLlama(**_sp_cfg(), dtype=jnp.float32,
                     attention_fn=jax_ring_fn(NODES_AXIS, n, flash=flash, striped=striped))

    def spmd_grads(params, ids):
        idx = jax.lax.axis_index(NODES_AXIS)
        if striped:
            positions = jax_striped_positions(tl, NODES_AXIS)
        else:
            positions = idx * tl + jnp.arange(tl)

        def loss_of(p):
            logits = model.apply({"params": p}, ids, positions=positions)
            if striped:
                nxt = jax.lax.ppermute(ids, NODES_AXIS, [((r + 1) % n, r) for r in range(n)])
                shifted = jnp.concatenate([nxt[:, 1:], jnp.zeros_like(nxt[:, :1])], axis=1)
                labels = jnp.where(idx == n - 1, shifted, nxt)
                mask = jnp.where(idx == n - 1, jnp.arange(tl) < tl - 1,
                                 jnp.ones((tl,), bool))
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
                return (jax.lax.psum((ce * mask).sum(), NODES_AXIS)
                        / jax.lax.psum(mask.sum() * ce.shape[0], NODES_AXIS))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], ids[:, 1:]).mean()

        loss, grads = jax.value_and_grad(loss_of)(params)
        sync = jax.lax.psum if striped else jax.lax.pmean
        grads = jax.tree_util.tree_map(lambda g: sync(g, NODES_AXIS), grads)
        return jax.lax.pmean(loss, NODES_AXIS), grads

    return spmd_grads


def _jax_run_seq_parallel(params, batches, *, flash, striped, lr):
    """Steps of the reference's ``run_seq_parallel``: its loss and
    gradient reduction, ``optax.adam(lr)``, under ``shard_map`` with
    ``check_vma=not flash``, on each batch striped first if asked."""
    spmd_grads = _jax_seq_parallel_grads(flash, striped)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def spmd_step(params, opt_state, ids):
        loss, grads = spmd_grads(params, ids)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    f = jax.jit(jax.shard_map(
        spmd_step, mesh=jbasics.context().mesh,
        in_specs=(P(), jax.tree_util.tree_map(lambda _: P(), opt_state), P(None, NODES_AXIS)),
        out_specs=(P(), jax.tree_util.tree_map(lambda _: P(), opt_state), P()),
        check_vma=not flash))
    losses = []
    for ids in batches:
        ids = jnp.asarray(ids)
        if striped:
            ids = jax_stripe(ids, SIZE)
        params, opt_state, loss = f(params, opt_state, ids)
        losses.append(float(np.asarray(loss).mean()))
    return params, losses


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("striped", [False, True])
def test_reference_seq_parallel_gradient_scale(striped, flash):
    """The caveat the Adam comparison below rests on (ROADMAP, "Caveats
    on the reference"): the reference's reduced gradient is the gradient
    of the global mean loss (``jax.grad`` of the unsharded loss) for the
    contiguous layout under ``check_vma=False`` (flash), and n = 8 times
    it otherwise, within the gradients' tolerance."""
    cfg = _sp_cfg()
    params = _jax_params(cfg, SP["seq"])
    ids = jnp.asarray(_ids(1, (SP["batch"], SP["seq"]), SP["vocab"]))
    truth = jax.grad(lambda p: _unsharded_loss(JaxLlama(**cfg, dtype=jnp.float32), p, ids,
                                               striped))(params)
    f = jax.jit(jax.shard_map(
        _jax_seq_parallel_grads(flash, striped), mesh=jbasics.context().mesh,
        in_specs=(P(), P(None, NODES_AXIS)), out_specs=(P(), P()), check_vma=not flash))
    _, grads = f(params, jax_stripe(ids, SIZE) if striped else ids)
    scale = 1 if flash and not striped else SIZE
    for got, want in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(truth)):
        want = scale * np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("striped", [False, True])
def test_seq_parallel_adam_steps_track_the_reference(striped, flash, monkeypatch):
    """``llama_pretrain --seq-parallel [--striped] --attention dense|flash
    --dtype f32``, 3 steps from the reference's init, against the JAX
    step: the loss of every step within rtol 1e-5, and the parameters
    after the steps as follows.

    Adam moves an entry by about lr a step whatever the gradient's scale,
    so the reference's n x gradient (here n = 8; every layout but the
    contiguous flash one, ROADMAP "Caveats on the reference") changes an
    update ``m / (sqrt(v) + eps)`` only by ``eps (1 - 1/n) / sqrt(v)`` of
    itself: nothing where ``sqrt(v) >> eps``, up to a sizeable part of a
    step for the few entries whose gradients sit near eps, and what moved
    in one step moves the next step's gradients.  So:

    - the contiguous flash layout (the reference's gradient is the true
      one): every entry within a hundredth of a step a step, the
      difference within 1e-4 of the distance travelled, in norm;
    - the n x layouts: the difference within a hundredth of the distance
      travelled, in norm, and at most 0.1% of a tensor's entries beyond a
      hundredth of a step a step (measured: one entry in 3072, at most a
      fifth of a step, and 1.7e-3 of the distance).

    A wiring or loss fault moves every entry by whole steps."""
    monkeypatch.setitem(llama_pretrain.PRESETS, "sp_tiny", SP)
    steps, lr = 3, llama_pretrain.SP_LR
    params = _jax_params(_sp_cfg(), SP["seq"])
    start = llama_state_dict(jax.tree_util.tree_map(np.asarray, params), SP["layers"])
    seen = {}

    def setup(model, opt):
        model.load_state_dict(start, strict=True)
        seen["model"] = model
        # optax.adam's defaults
        assert (opt.defaults["betas"], opt.defaults["eps"]) == ((0.9, 0.999), 1e-8)

    argv = ["--preset", "sp_tiny", "--device", "cpu", "--dtype", "f32", "--seq-parallel",
            "--size", str(SIZE), "--steps", str(steps),
            "--attention", "flash" if flash else "dense"] + (["--striped"] if striped else [])
    out = llama_pretrain.run(llama_pretrain._parser().parse_args(argv), setup=setup)
    assert (out["mode"], out["lr"], out["head_chunks"]) == \
        ("ring_striped" if striped else "ring", lr, 0)
    batches = llama_pretrain.make_streams(np.random.default_rng(0), SP["vocab"],
                                          SP["batch"] * steps, SP["seq"])
    batches = batches.reshape(steps, SP["batch"], SP["seq"])
    jparams, jlosses = _jax_run_seq_parallel(params, batches, flash=flash, striped=striped,
                                             lr=lr)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    want = llama_state_dict(jax.tree_util.tree_map(np.asarray, jparams), SP["layers"])
    scaled = striped or not flash
    for name, p in seen["model"].named_parameters():
        got, ref, init = p.detach().numpy(), want[name].numpy(), start[name].numpy()
        diff, moved = np.abs(got - ref), np.linalg.norm(ref - init)
        beyond = diff > 1e-2 * lr * steps
        if scaled:
            assert beyond.mean() <= 1e-3, (name, beyond.sum(), diff.max() / lr)
            assert np.linalg.norm(diff) <= 1e-2 * moved, (name, np.linalg.norm(diff) / moved)
        else:
            assert not beyond.any(), (name, diff.max() / lr)
            assert np.linalg.norm(diff) <= 1e-4 * moved, (name, np.linalg.norm(diff) / moved)


def test_rotary_per_row_positions_equal_a_loop_over_rows():
    """``_rotary`` on ``[rows, T]`` positions equals the ``[T]`` form row
    by row, bit for bit (the form every shard's rows take in the
    rank-major layout)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(SIZE * 2, 8, 4, 16, generator=g)
    pos = striped_positions(8, SIZE).repeat_interleave(2, dim=0)
    got = _rotary(x, pos)
    want = torch.cat([_rotary(x[i:i + 1], pos[i]) for i in range(x.shape[0])])
    assert torch.equal(got, want)
    assert torch.equal(_rotary(x, pos[0]), _rotary(x, pos[0].expand(x.shape[0], -1)))


def _example(argv):
    return llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--steps", "2"] + argv))


@pytest.mark.parametrize("argv,match", [
    (["--striped"], "--seq-parallel"),
    (["--ulysses"], "--seq-parallel"),
    (["--seq-parallel", "--striped", "--ulysses"], "ring layout"),
    (["--seq-parallel", "--head-chunks", "4"], "head-chunks"),
    (["--seq-parallel", "--optimizer", "sgdm"], "optimizer"),
])
def test_example_refuses_the_reference_s_flag_combinations(argv, match):
    with pytest.raises(ValueError, match=match):
        _example(argv)


@pytest.mark.parametrize("mode", ["ring", "ring_striped", "ulysses"])
def test_tiny_seq_parallel_example_runs_on_the_cpu(mode, monkeypatch):
    """The entry point end to end: finite, falling losses, the preset's
    head_chunks set to 0 and said so, 16-ish tokens a rank; ``--attention
    dense`` runs the plain ring and calls no flash function."""
    from bluefog_tpu_torch import kernels

    flags = {"ring": [], "ring_striped": ["--striped"], "ulysses": ["--ulysses"]}[mode]
    out = _example(["--seq-parallel", "--steps", "3"] + flags)
    assert out["mode"] == mode and out["seq_parallel"] and out["ranks"] == 4
    assert (out["head_chunks"], out["optimizer"], out["t_local"]) == (0, "adam", 32)
    assert "head_chunks" in out["head_chunks_note"]
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    # no kernel on the CPU: the counts stay 0 a step
    assert out["launches_per_step"] == [{"fwd": 0, "dkv": 0, "dq": 0}] * 3
    called = []
    monkeypatch.setattr(kernels, "flash_attention_with_lse",
                        lambda *a, **kw: called.append(1))
    monkeypatch.setattr(kernels, "flash_attention", lambda *a, **kw: called.append(1))
    dense = _example(["--seq-parallel", "--attention", "dense"] + flags)
    assert not called and all(np.isfinite(dense["losses"]))
