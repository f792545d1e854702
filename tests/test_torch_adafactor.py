"""``bluefog_tpu_torch.optim.Adafactor`` against ``optax.adafactor`` with its
defaults: on rank-major leaves (4 ranks, a different gradient on each)
against optax run once per rank, as the reference's shard_map runs it, on
a factored ``[256, 128]`` leaf, a square ``[128, 128]`` one, an unfactored
bias, a ``[64, 200]`` leaf (200 x 64: too narrow to factor), a
scan-stacked ``[2, 128, 256]`` leaf and a per-rank scalar; one rank's
update does not move when another rank's gradient changes; and ATC steps
of a small Llama with adafactor against the reference's train step,
weights carried by ``interop/jax_weights``.

Tolerances: parameters after 5 steps within rtol 1e-5 and atol 1e-7 (lr
0.01: an update of ~1e-2 carries a few f32 steps of rounding, and a
parameter of ~1 one of its own); the Llama steps as
``tests/test_torch_llama_options.py`` holds its train steps: losses
within rtol 1e-4, every leaf within rtol 1e-4 and 1e-6 of the largest
entry (two f32 computations of the same gradients in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.models.transformer import LlamaLM as JaxLlama
from bluefog_tpu.optim import CommunicationType as JaxComm
from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
from bluefog_tpu.training import make_lm_loss_fns as jax_lm_loss_fns
from bluefog_tpu.training import replicate_for_mesh as jax_replicate
from bluefog_tpu_torch.examples import llama_pretrain
from bluefog_tpu_torch.interop.jax_weights import llama_state_dict
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.optim import Adafactor, CommunicationType
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

torch.set_num_threads(1)
N, LR, STEPS = 4, 0.01, 5
SHAPES = {"factored": (256, 128), "square": (128, 128), "bias": (128,),
          "narrow": (64, 200), "stacked": (2, 128, 256), "scalar": ()}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SHAPES.items()}
    # a different gradient scale on every rank
    scale = {k: (1.0 + np.arange(N, dtype=np.float32)).reshape((N,) + (1,) * len(s))
             for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal((N,) + s).astype(np.float32) * scale[k]
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _optax_per_rank(params, grads):
    tx = optax.adafactor(LR)
    update = jax.jit(tx.update)  # as every train step of the reference runs it
    ranks = [{k: jnp.asarray(v[r]) for k, v in params.items()} for r in range(N)]
    states = [tx.init(p) for p in ranks]
    for g in grads:
        for r in range(N):
            upd, states[r] = update({k: jnp.asarray(v[r]) for k, v in g.items()},
                                    states[r], ranks[r])
            ranks[r] = optax.apply_updates(ranks[r], upd)
    return {k: np.stack([np.asarray(p[k]) for p in ranks]) for k in params}


def _port(params, grads):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = Adafactor(list(leaves.values()), lr=LR)
    for g in grads:
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in leaves.items()}, opt, leaves


def test_adafactor_matches_optax_rank_by_rank():
    params, grads = _leaves(0)
    want = _optax_per_rank(params, grads)
    got, opt, leaves = _port(params, grads)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert np.abs(got[k] - params[k]).max() > 1e-3, k  # the leaf moved
    # the factored second moment where optax keeps one, in the parameter's dtype
    state = {k: opt.state[p] for k, p in leaves.items()}
    assert state["factored"]["v_row"].shape == (N, 128)  # mean over the 256 axis
    assert state["factored"]["v_col"].shape == (N, 256)
    assert state["stacked"]["v_row"].shape == (N, 2, 128)
    assert state["stacked"]["v_col"].shape == (N, 2, 256)
    for k in ("bias", "narrow", "scalar"):
        assert set(state[k]) == {"step", "v"} and state[k]["v"].shape == (N,) + SHAPES[k]
    assert all(v.dtype == torch.float32 for s in state.values() for v in s.values()
               if isinstance(v, torch.Tensor))


def test_one_ranks_update_never_reads_another_ranks_gradient():
    """Rank 2 gets other gradients (not a multiple of its own: the rule does
    not see a gradient's scale): rank 2 moves elsewhere, every other rank
    exactly as before."""
    params, grads = _leaves(1)
    base, _, _ = _port(params, grads)
    rng = np.random.default_rng(2)
    for g in grads:
        for k in g:
            g[k][2] = rng.standard_normal(g[k][2].shape).astype(np.float32)
    moved, _, _ = _port(params, grads)
    for k in SHAPES:
        for r in range(N):
            assert np.array_equal(moved[k][r], base[k][r]) == (r != 2), (k, r)


def test_shapes_must_reshape_the_per_rank_leaf():
    p = torch.zeros(N, 128, 64, requires_grad=True)
    Adafactor([p], lr=LR, shapes={p: (2, 64, 64)})
    with pytest.raises(ValueError, match="not a reshape"):
        Adafactor([p], lr=LR, shapes={p: (128, 128)})


# --------------------------------------------------------------------------
# a small Llama under the ATC train step
# --------------------------------------------------------------------------

# the tiny preset's depth and heads at widths of 128 and 256: at the tiny
# preset's 64 no leaf has two dims of 128 or more, so nothing would factor.
# Here the embedding, the head and the MLP factor, while the q/k/v weights
# [128, 128] factor in neither package: flax's [d, heads, hd] kernels have
# hd = 32 < 128, and the port factors them as split_head_shapes gives them.
CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, dff=256)
T = 32


def _flax_leaves(params, prefix=()):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("kw", [{}, dict(scan_layers=True)], ids=["unrolled", "scan"])
def test_split_head_shapes_are_the_reference_kernels_axes(kw):
    """Each shape split_head_shapes gives is a reshape of its weight and
    holds the axes of the flax DenseGeneral kernel it loads from, in
    another order; every other weight is the flax leaf transposed or as it
    is (one factoring either way)."""
    kw = dict(kw, num_kv_heads=2)
    jparams = jax.eval_shape(lambda: JaxLlama(**CFG, dtype=jnp.float32, **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32)))["params"]
    model = LlamaLM(**CFG, dtype=torch.float32, device="cpu", **kw)
    split = model.split_head_shapes()
    params = dict(model.named_parameters())
    assert len(split) == 3 * (1 if kw.get("scan_layers") else CFG["num_layers"])
    flax_shapes = sorted(sorted(np.shape(v)) for _, v in _flax_leaves(jparams))
    port_shapes = sorted(sorted(split.get(n, tuple(p.shape))) for n, p in params.items())
    assert port_shapes == flax_shapes
    for name, shape in split.items():
        assert np.prod(shape) == params[name].numel() and len(shape) == params[name].dim() + 1


def test_adafactor_llama_atc_steps_match_the_reference():
    """Two ATC steps with GQA (kv heads 2)."""
    steps, kw = 2, dict(num_kv_heads=2)
    jmodel = JaxLlama(**CFG, dtype=jnp.float32, **kw)
    params0 = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"])
    batches = np.random.default_rng(3).integers(0, CFG["vocab_size"], size=(steps, N, 2, T))
    jbf.init(devices=jax.devices()[:N])
    try:
        ctx = jbasics.context()
        lm_apply, lm_loss = jax_lm_loss_fns(jmodel)
        init_fn, step_fn = jax_train_step(
            lm_apply, optax.adafactor(LR), ctx.mesh,
            communication_type=JaxComm.neighbor_allreduce, plan=ctx.plan, loss_fn=lm_loss,
            donate=False)
        jparams = jax_replicate(jax.tree_util.tree_map(jnp.asarray, params0), N)
        state = init_fn(jparams)
        j_losses = []
        for s in range(steps):
            bx = jnp.asarray(batches[s], jnp.int32)
            jparams, _, state, loss, _ = step_fn(jparams, {}, state, bx, bx)
            j_losses.append(np.asarray(loss))
        jparams = jax.tree_util.tree_map(np.asarray, jparams)
    finally:
        jbf.shutdown()

    tbf.init(size=N, device="cpu")
    try:
        model = LlamaLM(**CFG, dtype=torch.float32, device="cpu", **kw)
        model.load_state_dict(llama_state_dict(params0, CFG["num_layers"]), strict=True)
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        opt = llama_pretrain.make_optimizer("adafactor", model, params, LR)
        apply_fn, loss_fn = make_lm_loss_fns(model)
        step = make_decentralized_train_step(
            apply_fn, params, opt, communication_type=CommunicationType.neighbor_allreduce,
            plan=tbf.context().plan, loss_fn=loss_fn)
        t_losses = [step(torch.from_numpy(b), torch.from_numpy(b))[0].numpy() for b in batches]
        factored = {n for n, p in params.items() if "v_row" in opt.state[p]}
    finally:
        tbf.shutdown()
    assert "embed.weight" in factored and "head.weight" in factored
    assert not any(n.split(".")[-2 if n.endswith("weight") else -1] in "qkv"
                   for n in factored if n.startswith("layers"))
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses), rtol=1e-4)
    for r in range(N):
        want = llama_state_dict(jax.tree_util.tree_map(lambda a: a[r], jparams),
                                CFG["num_layers"])
        for name, leaf in params.items():
            w = want[name].numpy()
            np.testing.assert_allclose(leaf[r].detach().numpy(), w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{r} {name}")
