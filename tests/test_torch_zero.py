"""ZeRO-1 / FSDP + machine gossip (``parallel/zero.py``) of bluefog_tpu_torch
against the JAX package on the 4-device CPU mesh, 2 machines x 2.

Every case of ``tests/test_zero.py`` runs through both packages from the
same numpy parameters and batches: machine 0's parameters after the steps
agree within that test's own 2e-5 (3e-5 for adamw), f32 compute.  Then the
FSDP ``LlamaLM`` with the three hooks at tiny widths (vocab 256, hidden 64,
2 layers, 4 heads on 2 kv heads, remat, scan and unrolled, head_chunks 4,
``spmd_vocab``), its weights carried over by ``llama_state_dict`` (the
reference draws another init once the hooks are set, so nothing is drawn
twice): 2 sgdm steps (bf16 momentum), and the masters' move is compared
in norm, ||port - reference|| / ||reference - start||.  At
``compute_dtype=float32`` with ``grad_dtype=bf16``: within 5e-4 (the same
f32 sums in other orders; both sides round every block, embedding and
head gradient to bf16, and a gradient within an f32 step of a rounding
boundary may round the other way, one bf16 step, 2^-8 of itself: the
measured reading is 8e-5), and the port without the hook is more than 5x
farther (measured 1.1e-3: the rounding changes values).  At bf16 compute:
within 2^-5 (bf16 products and sums rounded in other orders, a few 2^-8
steps; measured 1.5e-2); losses within 1e-4 (f32) and 2^-6 (bf16).
Last, the state carried both ways."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu.models.transformer import LlamaLM as JaxLlama
from bluefog_tpu.parallel import zero as jzero
from bluefog_tpu_torch import checkpoint
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.interop.jax_weights import (
    fsdp_state_from_jax,
    fsdp_state_to_jax,
    llama_flax_params,
    llama_state_dict,
    tree_from_jax,
    tree_to_jax,
    zero_state_from_jax,
    zero_state_to_jax,
)
from bluefog_tpu_torch.models.transformer import LlamaLM
from bluefog_tpu_torch.parallel import zero as tzero
from bluefog_tpu_torch.training import make_lm_loss_fns

torch.set_num_threads(1)
MACHINES, LOCAL = 2, 2
LR, MOM = 0.05, 0.9
TOL = 2e-5        # tests/test_zero.py's own
TOL_ADAM = 3e-5   # tests/test_zero.py's own for adamw


@pytest.fixture
def mesh(devices):
    jbf.shutdown()
    jbf.init(devices=devices[:MACHINES * LOCAL], local_size=LOCAL)
    ctx = jbasics.context()
    assert ctx.hier_mesh.devices.shape == (MACHINES, LOCAL)
    jbf.set_machine_topology(jtu.RingGraph(MACHINES))
    yield ctx
    jbf.shutdown()


def _plan(machines=MACHINES):
    return compile_plan(ttu.RingGraph(machines))


def _np_params():
    return {"w1": (np.random.default_rng(0).normal(size=(6, 5)) * 0.3).astype(np.float32),
            "w2": (np.random.default_rng(1).normal(size=(5, 3)) * 0.3).astype(np.float32)}


def _jax_model():
    def apply_fn(params, x):
        return jnp.tanh(x @ params["w1"]) @ params["w2"]

    def loss_fn(pred, y):
        return jnp.mean((pred - y) ** 2)

    return apply_fn, loss_fn


def _port_model():
    def apply_fn(params, x):
        return torch.tanh(x @ params["w1"]) @ params["w2"]

    def loss_fn(pred, y):
        return torch.mean((pred - y) ** 2)

    return apply_fn, loss_fn


def _data(rng, machines=MACHINES, local=LOCAL):
    x = rng.normal(size=(machines, local, 4, 6)).astype(np.float32)
    y = rng.normal(size=(machines, local, 4, 3)).astype(np.float32)
    return x, y


def _builders(variant):
    if variant == "packed":
        return jzero.make_zero_gossip_train_step, tzero.make_zero_gossip_train_step
    return jzero.make_fsdp_gossip_train_step, tzero.make_fsdp_gossip_train_step


def _run_both(ctx, variant, batches, *, machine_plan=True, grid=(MACHINES, LOCAL), **kw):
    """Both packages' builders on the same parameters and batches; returns
    (reference params_of, port params_of, reference losses, port losses)."""
    jmake, tmake = _builders(variant)
    m, l = grid
    j_init, j_step, j_params_of = jmake(
        *_jax_model(), ctx.hier_mesh, ctx.machine_plan if machine_plan else None, **kw)
    t_kw = {k: (torch.float32 if v is jnp.float32 else torch.bfloat16 if v is jnp.bfloat16
                else v) for k, v in kw.items()}
    t_init, t_step, t_params_of = tmake(
        *_port_model(), grid, _plan(m) if machine_plan else None, **t_kw)
    params = _np_params()
    j_state = j_init(jax.tree_util.tree_map(jnp.asarray, params))
    t_state = t_init(tree_from_jax(params))
    j_losses, t_losses = [], []
    for x, y in batches:
        if variant == "fsdp":
            x, y = x.reshape(m, -1, 6), y.reshape(m, -1, 3)
        j_state, jl = j_step(j_state, jnp.asarray(x), jnp.asarray(y))
        t_state, tl = t_step(t_state, torch.from_numpy(x), torch.from_numpy(y))
        j_losses.append(float(jl))
        t_losses.append(tl.item())
    return (j_params_of(j_state), t_params_of(t_state), j_losses, t_losses,
            j_state, t_state)


def _assert_params(jp, tp, tol):
    for k in ("w1", "w2"):
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("variant", ["packed", "fsdp"])
def test_gossip_step_matches_reference(mesh, variant):
    """test_zero_gossip_matches_reference / test_fsdp_gossip_matches_reference:
    5 sgdm steps, machine-0 parameters and every loss."""
    rng = np.random.default_rng(7)
    jp, tp, jl, tl, _, _ = _run_both(
        mesh, variant, [_data(rng) for _ in range(5)],
        learning_rate=LR, momentum=MOM, compute_dtype=jnp.float32)
    _assert_params(jp, tp, TOL)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert all(np.isfinite(tl))


def test_zero_state_layout_matches_reference(mesh):
    """test_zero_state_is_sharded: the same [machines, local, padded/local]
    grid as the reference's global array (one device holds it here)."""
    jmake, tmake = _builders("packed")
    j_state = jmake(*_jax_model(), mesh.hier_mesh, mesh.machine_plan,
                    learning_rate=LR)[0](jax.tree_util.tree_map(jnp.asarray, _np_params()))
    t_state = tmake(*_port_model(), (MACHINES, LOCAL), _plan(),
                    learning_rate=LR)[0](tree_from_jax(_np_params()))
    layout = tzero.packed_layout(tree_from_jax(_np_params()), LOCAL)
    assert tuple(t_state["master"].shape) == tuple(j_state["master"].shape) == (
        MACHINES, LOCAL, layout.padded // LOCAL)
    np.testing.assert_array_equal(t_state["master"].numpy(), np.asarray(j_state["master"]))


def test_unpack_roundtrip():
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.arange(5.0)}
    layout = tzero.packed_layout(params, 4)
    vec = tzero._pack(list(params.values()), layout)
    assert vec.shape[0] % 4 == 0
    back = tzero.unpack_params(vec, layout, torch.float32)
    for k in params:
        assert torch.equal(back[k], params[k])
    # the reference's packed vector, element for element
    jl = jzero.packed_layout({k: jnp.asarray(v.numpy()) for k, v in params.items()}, 4)
    jvec = jzero._pack([jnp.asarray(v.numpy()) for v in params.values()], jl)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))


def test_fsdp_bf16_momentum_tracks_reference(mesh):
    """test_fsdp_bf16_momentum_tracks_f32: the bf16 momentum stays bf16, the
    port tracks the reference's bf16-momentum run within a bf16 step of
    the update (2^-8 of lr x momentum's scale, over 4 steps: 1e-3), and
    the f32-momentum run within the reference test's 2e-2."""
    rng = np.random.default_rng(11)
    batches = [_data(rng) for _ in range(4)]
    kw = dict(learning_rate=LR, momentum=MOM, compute_dtype=jnp.float32)
    jp, tp, _, _, _, t_state = _run_both(mesh, "fsdp", batches, momentum_dtype=jnp.bfloat16,
                                         **kw)
    assert all(l.dtype == torch.bfloat16 for l in t_state["opt"][0].values())
    _assert_params(jp, tp, 1e-3)
    _, tp32, _, _, _, _ = _run_both(mesh, "fsdp", batches, **kw)
    _assert_params(tp32, tp, 2e-2)


def test_fsdp_adamw_nu_stays_f32_under_bf16_accumulators(mesh):
    rng = np.random.default_rng(13)
    jp, tp, _, tl, _, t_state = _run_both(
        mesh, "fsdp", [_data(rng)], learning_rate=LR, momentum=MOM, optimizer="adamw",
        compute_dtype=jnp.float32, momentum_dtype=jnp.bfloat16)
    mu, nu, count = t_state["opt"]
    assert all(l.dtype == torch.bfloat16 for l in mu.values())
    assert all(l.dtype == torch.float32 for l in nu.values())
    assert all(l.dtype == torch.int32 and tuple(l.shape) == (MACHINES, 1, 1)
               for l in count.values())  # [machines, 1, ...], as the reference's
    assert np.isfinite(tl[0])
    _assert_params(jp, tp, 1e-3)


def test_fsdp_state_layout_matches_reference(mesh):
    """test_fsdp_state_is_sharded: ``[machines, *shape]`` leaves (the
    reference shards dim 12 of w1 over LOCAL; here one device holds it)."""
    params = {"w1": np.zeros((8, 12), np.float32), "w2": np.zeros((12, 4), np.float32)}
    _, tmake = _builders("fsdp")
    state = tmake(lambda p, x: x @ p["w1"] @ p["w2"], lambda pred, y: ((pred - y) ** 2).mean(),
                  (MACHINES, LOCAL), _plan(), learning_rate=LR)[0](tree_from_jax(params))
    assert tuple(state["master"]["w1"].shape) == (MACHINES, 8, 12)
    assert state["master"]["w1"].dtype == torch.float32


@pytest.mark.parametrize("variant", ["packed", "fsdp"])
def test_adamw_matches_reference_and_optax_adam(mesh, variant):
    rng = np.random.default_rng(3)
    batches = [_data(rng) for _ in range(4)]
    jp, tp, _, _, _, _ = _run_both(mesh, variant, batches, learning_rate=LR,
                                   optimizer="adamw", compute_dtype=jnp.float32)
    _assert_params(jp, tp, TOL_ADAM)
    # and the reference test's ground truth: optax.adam a machine, then W
    apply_fn, loss_fn = _jax_model()
    W = jtu.GetWeightMatrix(jtu.RingGraph(MACHINES))
    params = jax.tree_util.tree_map(jnp.asarray, _np_params())
    opts = [optax.adam(LR) for _ in range(MACHINES)]
    ref_w = [params] * MACHINES
    ref_s = [o.init(params) for o in opts]
    for x, y in batches:
        new = []
        for m in range(MACHINES):
            g = jax.grad(lambda p: sum(loss_fn(apply_fn(p, x[m, l]), y[m, l])
                                       for l in range(LOCAL)) / LOCAL)(ref_w[m])
            upd, ref_s[m] = opts[m].update(g, ref_s[m], ref_w[m])
            new.append(optax.apply_updates(ref_w[m], upd))
        ref_w = [jax.tree_util.tree_map(lambda *ws: sum(W[m, s] * ws[s]
                                                        for s in range(MACHINES)), *new)
                 for m in range(MACHINES)]
    _assert_params(ref_w[0], tp, TOL_ADAM)


def test_adamw_weight_decay_matches_reference(mesh):
    rng = np.random.default_rng(5)
    jp, tp, _, _, _, _ = _run_both(mesh, "packed", [_data(rng) for _ in range(3)],
                                   learning_rate=LR, optimizer="adamw", weight_decay=0.01,
                                   compute_dtype=jnp.float32)
    _assert_params(jp, tp, TOL_ADAM)


def test_zero_state_checkpoint_resume(mesh, tmp_path):
    """test_zero_state_checkpoint_resume through the port's checkpoint.py
    (the reference's case is skipped on the CPU client): save after 2
    steps, restore_like onto a fresh state, 2 more steps equal an
    uninterrupted 4-step run bit for bit, and the reference's run within
    3e-5."""
    rng = np.random.default_rng(11)
    data = [_data(rng) for _ in range(4)]
    tmake = tzero.make_zero_gossip_train_step

    def make():
        return tmake(*_port_model(), (MACHINES, LOCAL), _plan(), learning_rate=LR,
                     optimizer="adamw", compute_dtype=torch.float32)

    def run(step, state, batches):
        for x, y in batches:
            state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
        return state

    init_fn, step_fn, params_of = make()
    want = params_of(run(step_fn, init_fn(tree_from_jax(_np_params())), data))
    init2, step2, _ = make()
    state2 = run(step2, init2(tree_from_jax(_np_params())), data[:2])
    path = str(tmp_path / "zero_ckpt")
    checkpoint.save(path, state2)
    init3, step3, params_of3 = make()
    template = init3(tree_from_jax(_np_params()))
    state3 = checkpoint.restore_like(path, template)
    assert state3["master"].shape == template["master"].shape
    got = params_of3(run(step3, state3, data[2:]))
    for k in want:
        assert torch.equal(got[k], want[k])
    jp, _, _, _, _, _ = _run_both(mesh, "packed", data, learning_rate=LR, optimizer="adamw",
                                  compute_dtype=jnp.float32)
    _assert_params(jp, got, TOL_ADAM)


@pytest.mark.parametrize("variant", ["packed", "fsdp"])
def test_single_machine_no_gossip(devices, variant):
    """test_zero_single_machine_no_gossip: one machine of 4, no plan; plain
    data-parallel momentum SGD (one step from zero momentum = SGD)."""
    jbf.shutdown()
    jbf.init(devices=devices[:4], local_size=4)
    ctx = jbasics.context()
    assert ctx.hier_mesh.devices.shape == (1, 4)
    try:
        rng = np.random.default_rng(9)
        x, y = _data(rng, 1, 4)
        jp, tp, _, tl, _, _ = _run_both(ctx, variant, [(x, y)], machine_plan=False,
                                        grid=(1, 4), learning_rate=LR, momentum=MOM,
                                        compute_dtype=jnp.float32)
        _assert_params(jp, tp, TOL)
        apply_fn, loss_fn = _jax_model()
        params = jax.tree_util.tree_map(jnp.asarray, _np_params())
        g = jax.grad(lambda p: sum(loss_fn(apply_fn(p, x[0, l]), y[0, l])
                                   for l in range(4)) / 4)(params)
        _assert_params(jax.tree_util.tree_map(lambda w, g_: w - LR * g_, params, g), tp, TOL)
        assert np.isfinite(tl[0])
    finally:
        jbf.shutdown()


def test_optimizer_name_is_checked():
    with pytest.raises(ValueError, match="sgdm"):
        tzero.make_fsdp_gossip_train_step(*_port_model(), (1, 1), None, optimizer="adam")
    _, step_fn, _ = tzero.make_zero_gossip_train_step(*_port_model(), (1, 1), None)
    with pytest.raises(RuntimeError, match="init_fn"):
        step_fn({}, None, None)


# --------------------------------------------------------------------------
# the FSDP LlamaLM with the three hooks
# --------------------------------------------------------------------------

LCFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            dff=128, remat=True, head_chunks=4, spmd_vocab=True)
SEQ, PER_MACHINE = 16, 2 * LOCAL
# the masters' move after 2 steps, in norm (see the module docstring)
UPDATE_TOL_F32, UPDATE_TOL_BF16 = 5e-4, 2.0 ** -5


def _jax_lm(ctx, scan, dtype, grad_dtype):
    return JaxLlama(**LCFG, scan_layers=scan, dtype=dtype,
                    act_constraint=jzero.fsdp_act_constraint(ctx.hier_mesh),
                    onehot_constraint=jzero.fsdp_onehot_constraint(ctx.hier_mesh),
                    weight_constraint=jzero.fsdp_param_io_constraint(
                        ctx.hier_mesh, grad_dtype=grad_dtype))


def _port_lm(scan, dtype, grad_dtype, hooks=True):
    kw = {}
    if hooks:
        kw = dict(act_constraint=tzero.fsdp_act_constraint(),
                  onehot_constraint=tzero.fsdp_onehot_constraint(),
                  weight_constraint=tzero.fsdp_param_io_constraint(grad_dtype=grad_dtype))
    return LlamaLM(**LCFG, scan_layers=scan, dtype=dtype, device="cpu", **kw)


def _lm_ids(seed):
    return np.random.default_rng(seed).integers(0, LCFG["vocab_size"],
                                                (MACHINES, PER_MACHINE, SEQ)).astype(np.int32)


def _fsdp_llama_runs(ctx, scan, compute, steps=2, hooks=True):
    """The reference's FSDP step with the hooked LlamaLM and the port's on
    the same carried weights; returns both states (numpy, flax layout)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jlm = _jax_lm(ctx, scan, jdt, jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jlm.init(
        jax.random.PRNGKey(0), jnp.ones((LOCAL, SEQ), jnp.int32))["params"])
    j_init, j_step, _ = jzero.make_fsdp_gossip_train_step(
        lambda p, ids: jlm.apply({"params": p}, ids, labels=ids), lambda out, labels: out,
        ctx.hier_mesh, ctx.machine_plan, learning_rate=0.1, momentum=0.9, compute_dtype=jdt,
        momentum_dtype=jnp.bfloat16)
    tlm = _port_lm(scan, tdt, torch.bfloat16, hooks)
    t_apply, t_loss = make_lm_loss_fns(tlm)
    t_init, t_step, _ = tzero.make_fsdp_gossip_train_step(
        t_apply, t_loss, (MACHINES, LOCAL), _plan(), learning_rate=0.1, momentum=0.9,
        compute_dtype=tdt, momentum_dtype=torch.bfloat16)
    j_state = j_init(jax.tree_util.tree_map(jnp.asarray, params))
    t_state = t_init(llama_state_dict(params, LCFG["num_layers"]))
    jl, tl = [], []
    for s in range(steps):
        ids = _lm_ids(s)
        j_state, a = j_step(j_state, jnp.asarray(ids), jnp.asarray(ids))
        t_state, b = t_step(t_state, torch.from_numpy(ids).long(), torch.from_numpy(ids).long())
        jl.append(float(a))
        tl.append(b.item())
    to_jax = functools.partial(llama_flax_params, like=params)
    return (jax.tree_util.tree_map(np.asarray, j_state["master"]),
            fsdp_state_to_jax(t_state, to_jax)["master"], jl, tl, params)


def _update_rel(want, got, init):
    """||got - want|| / ||want - init|| over every leaf and machine: the
    distance of the port's masters from the reference's, against how far
    the reference's moved."""
    lw, lg, li = (jax.tree_util.tree_leaves(t) for t in (want, got, init))
    assert len(lw) == len(lg) == len(li)
    num = sum(float(np.sum((w - g).astype(np.float64) ** 2)) for w, g in zip(lw, lg))
    den = sum(float(np.sum((w - i[None]).astype(np.float64) ** 2)) for w, i in zip(lw, li))
    return (num / den) ** 0.5


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_fsdp_llama_with_hooks_matches_reference_f32_compute_bf16_grads(mesh, scan):
    want, got, jl, tl, init = _fsdp_llama_runs(mesh, scan, "f32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    err = _update_rel(want, got, init)
    assert err <= UPDATE_TOL_F32
    # the rounding matters: without the hook the masters move elsewhere
    _, plain, _, _, _ = _fsdp_llama_runs(mesh, scan, "f32", hooks=False)
    assert _update_rel(want, plain, init) > max(5 * err, UPDATE_TOL_F32)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_fsdp_llama_with_hooks_matches_reference_bf16(mesh, scan):
    want, got, jl, tl, init = _fsdp_llama_runs(mesh, scan, "bf16")
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -6)
    assert _update_rel(want, got, init) <= UPDATE_TOL_BF16


def test_custom_weight_constraint_needs_sharding_only():
    lm = LlamaLM(**{**LCFG, "num_kv_heads": None}, dtype=torch.float32, device="cpu",
                 weight_constraint=lambda w: w)
    ids = torch.zeros(1, SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="sharding_only"):
        lm(ids, labels=ids)
    assert torch.isfinite(lm(ids)).all()  # logits need no chunk loop


# --------------------------------------------------------------------------
# state carried both ways
# --------------------------------------------------------------------------


def test_fsdp_and_zero_state_cross_both_ways(mesh):
    rng = np.random.default_rng(17)
    batches = [_data(rng) for _ in range(2)]
    for variant in ("fsdp", "packed"):
        _, _, _, _, j_state, t_state = _run_both(
            mesh, variant, batches, learning_rate=LR, optimizer="adamw",
            compute_dtype=jnp.float32)
        j_np = jax.tree_util.tree_map(np.asarray, j_state)
        if variant == "fsdp":
            port = fsdp_state_from_jax(j_np, tree_from_jax)
            back = fsdp_state_to_jax(port, tree_to_jax)
        else:
            like_t = tree_from_jax(_np_params())
            port = zero_state_from_jax(j_np, _np_params(), tree_from_jax, LOCAL)
            back = zero_state_to_jax(port, like_t, tree_to_jax, LOCAL)
        # reference -> port -> reference is exact; the port's own run agrees
        for a, b in zip(jax.tree_util.tree_leaves(j_np), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(tree_to_jax(port)),
                        jax.tree_util.tree_leaves(tree_to_jax(t_state))):
            np.testing.assert_allclose(a, b, rtol=TOL_ADAM, atol=TOL_ADAM)


def test_llama_flax_params_inverts_llama_state_dict(mesh):
    for scan in (True, False):
        jlm = _jax_lm(mesh, scan, jnp.float32, None)
        params = jax.tree_util.tree_map(np.asarray, jlm.init(
            jax.random.PRNGKey(1), jnp.ones((LOCAL, SEQ), jnp.int32))["params"])
        back = llama_flax_params(llama_state_dict(params, LCFG["num_layers"]), params)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the example twin
# --------------------------------------------------------------------------


def test_zero_gossip_example_twin_matches_the_reference_step(mesh):
    """examples/zero_gossip.py's first 3 steps against the reference
    example's step (examples/jax_zero_gossip.py: its model, loss and
    builder call rebuilt here on the 2 x 2 mesh, ExponentialTwoGraph(2)),
    the same weights carried over and the same batches: losses within
    1e-5, machine 0's parameters within the reference test's 2e-5."""
    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch.examples import zero_gossip

    jbf.set_machine_topology(jtu.ExponentialTwoGraph(MACHINES))
    lm = JaxLlama(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4, dff=64,
                  remat=True, scan_layers=True, dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0), jnp.ones((2, 16), jnp.int32))["params"]

    def loss_fn(logits, labels):
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, 1:, None], axis=-1))

    j_init, j_step, j_params_of = jzero.make_zero_gossip_train_step(
        lambda p, ids: lm.apply({"params": p}, ids), loss_fn, mesh.hier_mesh,
        mesh.machine_plan, learning_rate=0.1, compute_dtype=jnp.float32)
    j_state = j_init(params)
    tbf.init(size=MACHINES * LOCAL, local_size=LOCAL, device="cpu")
    try:
        model = zero_gossip.make_model("cpu")
        model.load_state_dict(llama_state_dict(jax.tree_util.tree_map(np.asarray, params), 2))
        t_init, t_step, t_params_of = zero_gossip.build(model, MACHINES, LOCAL)
        t_state = t_init({k: v.detach() for k, v in model.named_parameters()})
        for ids in zero_gossip.token_batches(MACHINES, LOCAL, 3, "cpu"):
            j_state, jl = j_step(j_state, jnp.asarray(ids.numpy()), jnp.asarray(ids.numpy()))
            t_state, tl = t_step(t_state, ids, ids)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        want = llama_state_dict(jax.tree_util.tree_map(np.asarray, j_params_of(j_state)), 2)
        got = t_params_of(t_state)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=k)
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("module", ["examples.zero_gossip", "examples.tp_gossip",
                                    "examples.pp_gossip", "examples.moe_gossip",
                                    "benchmarks.zero_8b"])
def test_parallel_entry_points_ask_for_the_card(module):
    """Without ``--device`` the slice's entry points ask for the card and
    raise where there is none (nothing falls back to the CPU)."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    mod = importlib.import_module(f"bluefog_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(mod._parser().parse_args([]))


@pytest.mark.parametrize("variant", ["packed", "fsdp"])
def test_llama_state_carried_from_the_reference_resumes_in_the_port(mesh, variant):
    """2 adamw steps of the reference builder on examples/zero_gossip.py's
    LlamaLM, the state carried into the port (``zero_state_from_jax`` /
    ``fsdp_state_from_jax`` through ``llama_state_dict``: every kernel
    transposed, the packed grid re-packed in the port's leaf order), then 2
    more steps on each side: machine 0's parameters within 3e-5 (the
    reference test's adamw tolerance) and the losses within 1e-5."""
    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch.examples import zero_gossip

    jbf.set_machine_topology(jtu.ExponentialTwoGraph(MACHINES))
    lm = JaxLlama(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4, dff=64,
                  remat=True, scan_layers=True, dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0), jnp.ones((2, 16), jnp.int32))["params"]

    def loss_fn(logits, labels):
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, 1:, None], axis=-1))

    jmake, tmake = _builders(variant)
    j_init, j_step, j_params_of = jmake(
        lambda p, ids: lm.apply({"params": p}, ids), loss_fn, mesh.hier_mesh,
        mesh.machine_plan, learning_rate=0.01, optimizer="adamw", compute_dtype=jnp.float32)
    tbf.init(size=MACHINES * LOCAL, local_size=LOCAL, device="cpu")
    try:
        batches = zero_gossip.token_batches(MACHINES, LOCAL, 4, "cpu")
        if variant == "fsdp":
            batches = [b.reshape(MACHINES, LOCAL * 2, 16) for b in batches]
        j_state = j_init(params)
        for ids in batches[:2]:
            j_state, _ = j_step(j_state, jnp.asarray(ids.numpy()), jnp.asarray(ids.numpy()))
        to_port = functools.partial(llama_state_dict, num_layers=2)
        j_np = jax.tree_util.tree_map(np.asarray, j_state)
        model = zero_gossip.make_model("cpu")
        apply_fn, _ = make_lm_loss_fns(model)
        t_init, t_step, t_params_of = tmake(
            apply_fn, zero_gossip.loss_fn, (MACHINES, LOCAL), tbf.context().machine_plan,
            learning_rate=0.01, optimizer="adamw", compute_dtype=torch.float32)
        sd = {k: v.detach() for k, v in model.named_parameters()}
        t_init(sd)  # the packed layout comes from the params tree
        if variant == "fsdp":
            t_state = fsdp_state_from_jax(j_np, to_port)
        else:
            t_state = zero_state_from_jax(j_np, jax.tree_util.tree_map(np.asarray, params),
                                          to_port, LOCAL)
        for ids in batches[2:]:
            j_state, jl = j_step(j_state, jnp.asarray(ids.numpy()), jnp.asarray(ids.numpy()))
            t_state, tl = t_step(t_state, ids, ids)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        want = to_port(jax.tree_util.tree_map(np.asarray, j_params_of(j_state)))
        got = t_params_of(t_state)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=TOL_ADAM, atol=TOL_ADAM,
                                       err_msg=k)
    finally:
        tbf.shutdown()
