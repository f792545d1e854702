"""BertEncoder and the push-sum fine-tune round of bluefog_tpu_torch against
the JAX package: the same flax weights (carried across by
``interop.jax_weights.bert_state_dict``) and the same numpy inputs.

Tolerances.  In f32 the two frameworks differ only in the order of their
sums: logits within rtol 1e-4 / atol 1e-5, every gradient within rtol 1e-3
and 1e-4 of its largest entry.  With bf16 products (the reference's dtype)
each framework rounds its products and sums to bf16 at its own places:
logits within 3 bf16 steps (3 x 2^-7) of their largest value, each
gradient within 5% of its norm."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.models.transformer import BertEncoder as JaxBert
from bluefog_tpu_torch.benchmarks import bert_pushsum as tbench
from bluefog_tpu_torch.interop.jax_weights import bert_state_dict
from bluefog_tpu_torch.models import BertEncoder

torch.set_num_threads(1)
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, dff=128, max_len=16,
           num_classes=2)
B, T = 4, 16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    params = JaxBert(**CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(masked):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG["vocab_size"], size=(B, T))
    labels = rng.integers(0, 2, size=(B,))
    if not masked:
        return ids, None, labels
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    mask[2, :] = False  # every key masked: a uniform softmax, as in flax
    return ids, mask, labels


def _jax_loss_and_grads(params, dtype, ids, mask, labels):
    model = JaxBert(**CFG, dtype=dtype)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(ids),
                             None if mask is None else jnp.asarray(mask))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _port(params, dtype, ids, mask, labels):
    model = BertEncoder(**CFG, dtype=dtype, device="cpu")
    model.load_state_dict(bert_state_dict(params, CFG["num_layers"]))
    logits = model(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach().numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bert_logits_and_gradients_match_flax(jax_params, dtype, masked):
    jdt, tdt = DTYPES[dtype]
    ids, mask, labels = _inputs(masked)
    want_logits, want_grads = _jax_loss_and_grads(jax_params, jdt, ids, mask, labels)
    logits, grads = _port(jax_params, tdt, ids, mask, labels)
    want = {k: v.numpy() for k, v in bert_state_dict(want_grads, CFG["num_layers"]).items()}
    assert sorted(grads) == sorted(want)
    if dtype == "f32":
        np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-5)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name], rtol=1e-3,
                                       atol=1e-4 * np.abs(want[name]).max(), err_msg=name)
    else:
        np.testing.assert_allclose(logits, want_logits, rtol=0,
                                   atol=3 * 2.0 ** -7 * np.abs(want_logits).max())
        for name, g in grads.items():
            err = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
            assert err <= 0.05, (name, err)


def test_bert_state_dict_covers_every_parameter(jax_params):
    model = BertEncoder(**CFG, device="cpu")
    sd = bert_state_dict(jax_params, CFG["num_layers"])
    assert sorted(sd) == sorted(k for k, _ in model.named_parameters())
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(jax_params))
    assert sum(v.numel() for v in sd.values()) == n_flax


def test_port_initializer_mirrors_flax_distributions():
    """Same distributions (not the same bits): each parameter's std within
    15% of flax's, means near zero, norms' scales and biases exact."""
    cfg = dict(CFG, hidden_size=128, dff=256, vocab_size=512)
    flax = JaxBert(**cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, T), jnp.int32))["params"]
    want = {k: v.numpy() for k, v in bert_state_dict(
        jax.tree_util.tree_map(np.asarray, flax), cfg["num_layers"]).items()}
    got = {k: p.detach().numpy() for k, p in BertEncoder(
        **cfg, device="cpu", generator=torch.Generator().manual_seed(1)).named_parameters()}
    for name, w in want.items():
        g = got[name]
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, (name, g.std(), w.std())


def _per_rank_state_dicts(tree, n):
    sds = [bert_state_dict(jax.tree_util.tree_map(lambda a: a[r], tree), 2) for r in range(n)]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}


def test_pushsum_round_matches_jax_build_flows(devices):
    """Three push-sum rounds of the tiny preset on 8 ranks: the port's eager
    flow against the JAX eager flow, from the same per-rank parameters (the
    shared init plus rank-dependent N(0, 1e-2) offsets, so the mixing moves
    every weight by ~1e-2) and the same token batches.  Adam's first three
    steps move each weight by at most ~1.004 lr (Cauchy-Schwarz on
    m_hat / sqrt(v_hat)), and the push-sum mix is convex, so two runs whose
    bf16 gradients differ end within 2 x 1.004 x lr x rounds (+1e-6) of
    each other.  The port's device flow equals its eager flow to 1e-6, and
    sum(p) = 8 after every update."""
    from benchmarks.bert_pushsum import PRESETS as JAX_PRESETS
    from benchmarks.bert_pushsum import build_flows as jax_build_flows

    rounds, lr = 3, tbench.LR
    jbf.init()
    n = jbf.size()
    try:
        (params, opt_state), eager_step, _, _ = jax_build_flows(JAX_PRESETS["tiny"], n, seed=3)
        rng = np.random.default_rng(11)
        params = jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 1e-2),
            params)
        start = jax.tree_util.tree_map(np.asarray, params)
        jax_losses = []
        for _ in range(rounds):
            params, opt_state, loss = eager_step(params, opt_state)
            jax_losses.append(np.asarray(loss))
        want = _per_rank_state_dicts(jax.tree_util.tree_map(np.asarray, params), n)
    finally:
        jbf.win_free()
        jbf.turn_off_win_ops_with_associated_p()
        jbf.shutdown()

    tbf.init(size=n, device="cpu")
    try:
        sd0 = bert_state_dict(jax.tree_util.tree_map(lambda a: a[0], start), 2)
        (tp, topt), t_eager, t_device, meta = tbench.build_flows(
            tbench.PRESETS["tiny"], n, seed=3, state_dict=sd0)
        with torch.no_grad():
            for k, v in _per_rank_state_dicts(start, n).items():
                tp[k].copy_(v)
        dstate = meta["device_init"](tp, topt)
        losses = []
        for _ in range(rounds):
            tp, topt, loss = t_eager(tp, topt)
            losses.append(loss.numpy())
        dstate, dloss = t_device(dstate, rounds)
        p_mass = torch.stack(meta["p_mass"]).numpy()
    finally:
        tbf.shutdown()

    atol = 2 * 1.004 * lr * rounds + 1e-6
    start_sd = _per_rank_state_dicts(start, n)
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
        np.testing.assert_allclose(dstate["params"][k].detach().numpy(),
                                   tp[k].detach().numpy(), rtol=0, atol=1e-6, err_msg=k)
        # the offsets were mixed: a round without the exchange ends ~1e-2 away
        moved = np.abs(tp[k].detach().numpy() - start_sd[k].numpy())
        assert moved.max() > 10 * atol, k
    np.testing.assert_allclose(np.stack(losses), np.stack(jax_losses), rtol=1e-2)
    np.testing.assert_allclose(dloss.numpy(), losses[-1], rtol=1e-6)
    assert len(p_mass) == 2 * rounds
    np.testing.assert_allclose(p_mass, n, rtol=1e-6)


def test_bert_pushsum_example_learns_on_the_cpu():
    from bluefog_tpu_torch.examples import bert_pushsum

    out = bert_pushsum.run(bert_pushsum._parser().parse_args(
        ["--device", "cpu", "--size", "4", "--steps", "40"]))
    assert all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-5:]) < 0.5 * np.mean(out["losses"][:5])
    assert abs(out["p_mass"] - 4) < 1e-5


@pytest.mark.parametrize("mode,comm", [("atc", "neighbor_allreduce"),
                                       ("awc", "neighbor_allreduce")])
def test_bert_fine_tune_under_the_train_step_matches_reference(devices, jax_params, mode, comm):
    """BertEncoder (f32) under make_decentralized_train_step on 4 ranks of
    ExponentialTwoGraph(4): 3 steps of momentum SGD on per-rank batches,
    losses and every rank's parameters within rtol 1e-4 / atol 1e-6 of the
    JAX train step's."""
    from bluefog_tpu.core import basics as jbasics
    from bluefog_tpu.optim import CommunicationType as JaxComm
    from bluefog_tpu.training import make_decentralized_train_step as jax_train_step
    from bluefog_tpu.training import replicate_for_mesh as jax_replicate
    from bluefog_tpu_torch.optim import CommunicationType
    from bluefog_tpu_torch.training import (
        make_classifier_apply_fn,
        make_decentralized_train_step,
        replicate_for_mesh,
    )

    n, steps, lr = 4, 3, 0.05
    rng = np.random.default_rng(8)
    ids = rng.integers(0, CFG["vocab_size"], size=(steps, n, B, T))
    labels = rng.integers(0, 2, size=(steps, n, B))
    jbf.init(devices=jax.devices()[:n])
    try:
        ctx = jbasics.context()
        model = JaxBert(**CFG, dtype=jnp.float32)
        init_fn, step_fn = jax_train_step(
            model.apply, optax.sgd(lr, momentum=0.9), ctx.mesh,
            communication_type=JaxComm[comm], plan=ctx.plan, mode=mode, donate=False)
        params = jax_replicate(jax.tree_util.tree_map(jnp.asarray, jax_params), n)
        state = init_fn(params)
        jl = []
        for s in range(steps):
            params, _, state, loss, _ = step_fn(params, {}, state, jnp.asarray(ids[s]),
                                                jnp.asarray(labels[s]))
            jl.append(np.asarray(loss))
        want = _per_rank_state_dicts(jax.tree_util.tree_map(np.asarray, params), n)
    finally:
        jbf.shutdown()

    tbf.init(size=n, device="cpu")
    try:
        model = BertEncoder(**CFG, dtype=torch.float32, device="cpu")
        model.load_state_dict(bert_state_dict(jax_params, CFG["num_layers"]))
        tparams = replicate_for_mesh(dict(model.named_parameters()), n)
        step = make_decentralized_train_step(
            make_classifier_apply_fn(model), tparams,
            torch.optim.SGD(tparams.values(), lr=lr, momentum=0.9),
            communication_type=CommunicationType[comm], plan=tbf.context().plan, mode=mode)
        tl = [step(torch.from_numpy(ids[s]), torch.from_numpy(labels[s]))[0].numpy()
              for s in range(steps)]
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-4)
    for name, w in want.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
