"""LlamaLM's options in bluefog_tpu_torch against the JAX package: the
rotary ``positions`` argument, every block layout ``llama_state_dict``
reads, grouped-query attention, remat and its policies, ``scan_layers``,
``spmd_vocab``, the ``sgdm_bf16`` base optimizer in the train step, and the
example's flags.  Weights are carried over by ``llama_state_dict``, token
batches are made with numpy.  Tolerances as in ``test_torch_llama.py``:
f32 throughout, so outputs within rtol 1e-4 / atol 1e-5 (the same sums in
another order), gradients within 1e-5 of their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from bluefog_tpu_torch.optim import CommunicationType, TraceSGD
from bluefog_tpu_torch.training import (
    make_decentralized_train_step,
    make_lm_loss_fns,
    replicate_for_mesh,
)

torch.set_num_threads(1)
N = 4
CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4, dff=128)
T = 32
RTOL, ATOL = 1e-4, 1e-5

LAYOUTS = {  # the reference's options that change its parameter tree
    "unrolled": {},
    "remat": dict(remat=True),
    "scan": dict(scan_layers=True),
    "scan_remat": dict(scan_layers=True, remat=True),
    "gqa": dict(num_kv_heads=2),
    "scan_remat_gqa": dict(scan_layers=True, remat=True, num_kv_heads=1),
}


def _jax_model(flash=False, **kw):
    fn = jax_flash_fn(block_q=16, block_k=16, interpret=True) if flash else None
    return JaxLlama(**CFG, dtype=jnp.float32, attention_fn=fn, **kw)


def _port_model(flash=False, params=None, **kw):
    model = LlamaLM(**CFG, dtype=torch.float32, device="cpu",
                    attention_fn=make_flash_attention_fn() if flash else None, **kw)
    if params is not None:
        model.load_state_dict(llama_state_dict(params, CFG["num_layers"]), strict=True)
    return model


def _jax_params(**kw):
    ids0 = jnp.zeros((1, T), jnp.int32)
    params = _jax_model(**kw).init(jax.random.PRNGKey(0), ids0)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _ids(seed, shape, vocab=CFG["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _jax_loss_and_grads(model, params, ids, positions=None):
    j_ids = jnp.asarray(ids)

    def loss(p):
        return model.apply({"params": p}, j_ids, positions, labels=j_ids)

    value, grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    grads = llama_state_dict(jax.tree_util.tree_map(np.asarray, grads), CFG["num_layers"])
    return float(value), grads


def _port_loss_and_grads(model, ids, positions=None):
    t_ids = torch.from_numpy(ids)
    model.zero_grad(set_to_none=True)
    loss = model(t_ids, positions, labels=t_ids)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL * np.abs(w).max(),
                                   err_msg=name)


# --------------------------------------------------------------------------
# R1: positions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("head_chunks", [0, 4])
def test_positions_reach_the_rotary_embedding_as_in_the_reference(head_chunks, stride):
    """``model(ids, positions)`` returns logits, and the logits, loss and
    gradients for positions ``stride * arange(T) + 37`` equal the
    reference's ``apply(params, ids, positions)``.  A constant offset
    leaves every q.k product as it was (rotary encodes relative positions),
    so stride 3 shows the positions reach the blocks: its logits differ
    from those at ``arange(T)``."""
    params = _jax_params()
    ids = _ids(0, (2, T))
    pos = stride * np.arange(T) + 37
    jm = _jax_model(head_chunks=head_chunks)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pos)))
    model = _port_model(params=params, head_chunks=head_chunks)
    got = model(torch.from_numpy(ids), torch.from_numpy(pos))
    assert got.shape == (2, T, CFG["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    if stride > 1:
        assert np.abs(model(torch.from_numpy(ids)).detach().numpy() - want).max() > 1e-2
    j_loss, j_grads = _jax_loss_and_grads(jm, params, ids, jnp.asarray(pos))
    t_loss, t_grads = _port_loss_and_grads(model, ids, torch.from_numpy(pos))
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)


# --------------------------------------------------------------------------
# R2: every block layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_reference_tree_loads_into_its_port_twin(layout):
    """Each reference tree (``_DecoderBlock_i``, ``Checkpoint_DecoderBlock_i``,
    ``Scan_ScannedDecoderBlock_0/...`` with stacked leaves, GQA's
    ``[d, kvh, hd]`` k/v kernels) loads with ``strict=True`` into the port's
    model with the same options, stacked for a scanned model, and gives the
    reference's logits."""
    kw = LAYOUTS[layout]
    params = _jax_params(**kw)
    sd = llama_state_dict(params, CFG["num_layers"])
    model = _port_model(**kw)
    model.load_state_dict(sd, strict=True)
    if kw.get("scan_layers"):
        assert sd["layers.q"].shape[0] == CFG["num_layers"]
        assert sum(k.startswith("layers.") for k in sd) == 9
    ids = _ids(1, (2, T))
    want = np.asarray(_jax_model(**kw).apply({"params": params}, jnp.asarray(ids)))
    got = model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["unrolled", "remat", "scan", "scan_remat"])
def test_fsdp_hooked_reference_tree_loads_into_its_port_twin(devices, layout):
    """With the FSDP ``weight_constraint`` set, flax's ``nn.map_variables``
    renames the blocks (``Map_variables_DecoderBlock_i``,
    ``Map_variablesCheckpoint_DecoderBlock_i``,
    ``ScanMap_variables_ScannedDecoderBlock_0/...``).  The reference model
    with the three hooks of ``parallel/zero.py`` on a 2 x 2 CPU mesh (GQA,
    ``spmd_vocab``) loads into the port's twin, with the port's hooks, and
    gives the reference's logits."""
    from bluefog_tpu.parallel import zero as jzero
    from bluefog_tpu_torch.parallel import zero as tzero

    jbf.shutdown()
    jbf.init(devices=devices[:4], local_size=2)
    try:
        mesh = jbasics.context().hier_mesh
        kw = dict(LAYOUTS[layout], num_kv_heads=2, spmd_vocab=True)
        jm = _jax_model(**kw, act_constraint=jzero.fsdp_act_constraint(mesh),
                        onehot_constraint=jzero.fsdp_onehot_constraint(mesh),
                        weight_constraint=jzero.fsdp_param_io_constraint(
                            mesh, grad_dtype=jnp.bfloat16))
        params = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(0), jnp.zeros((2, T), jnp.int32))["params"])
        assert any(k.startswith(("Map_variables", "ScanMap_variables")) for k in params)
        model = _port_model(params=params, **kw,
                            act_constraint=tzero.fsdp_act_constraint(),
                            onehot_constraint=tzero.fsdp_onehot_constraint(),
                            weight_constraint=tzero.fsdp_param_io_constraint(
                                grad_dtype=torch.bfloat16))
        ids = _ids(1, (2, T))
        want = np.asarray(jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                   jnp.asarray(ids)))
        got = model(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    finally:
        jbf.shutdown()


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------


def _count(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


def test_gqa_with_every_head_its_own_kv_is_multi_head_attention():
    """kvh = H gives the MHA tree, the MHA state dict and the MHA logits."""
    params = _jax_params()
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        _jax_params(num_kv_heads=CFG["num_heads"]))
    mha = _port_model(params=params)
    same = _port_model(params=params, num_kv_heads=CFG["num_heads"])
    assert {k: v.shape for k, v in mha.state_dict().items()} == \
        {k: v.shape for k, v in same.state_dict().items()}
    ids = torch.from_numpy(_ids(2, (2, T)))
    assert torch.equal(mha(ids), same(ids))


@pytest.mark.parametrize("kvh", [2, 1])
def test_gqa_parameter_saving_equals_the_reference(kvh):
    """k and v shrink from d x d to d x (kvh * hd) a layer, in both packages,
    and the flax initializer's fan-in is kept (the port draws k and v with
    std 1/sqrt(d))."""
    saved_ref = _count(_jax_params()) - _count(_jax_params(num_kv_heads=kvh))
    port = lambda **kw: sum(p.numel() for p in _port_model(**kw).parameters())  # noqa: E731
    d, hd = CFG["hidden_size"], CFG["hidden_size"] // CFG["num_heads"]
    assert port() - port(num_kv_heads=kvh) == saved_ref == \
        CFG["num_layers"] * 2 * d * (d - kvh * hd)
    for scan in (False, True):
        assert port(scan_layers=scan) - port(num_kv_heads=kvh, scan_layers=scan) == saved_ref


def test_gqa_raises_when_kv_heads_do_not_divide_the_heads():
    with pytest.raises(ValueError, match="not divisible by num_kv_heads 3"):
        _jax_params(num_kv_heads=3)
    with pytest.raises(ValueError, match="not divisible by num_kv_heads 3"):
        _port_model(num_kv_heads=3)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_gqa_logits_and_gradients_match_the_reference(kvh, flash):
    """Logits, loss and gradients of GQA against the reference, with the
    dense attention and with the flash function (the JAX kernel in
    interpret mode, block 16; the port's plain version on the CPU).  kvh =
    2 of 4 heads pairs query heads with kv heads the way ``jnp.repeat``
    does: a tiled repeat would fail it."""
    params = _jax_params(num_kv_heads=kvh)
    ids = _ids(3, (2, T))
    jm = _jax_model(flash, num_kv_heads=kvh)
    model = _port_model(flash, params=params, num_kv_heads=kvh)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    got = model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    j_loss, j_grads = _jax_loss_and_grads(jm, params, ids)
    t_loss, t_grads = _port_loss_and_grads(model, ids)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)


# --------------------------------------------------------------------------
# remat and its policies, scan_layers
# --------------------------------------------------------------------------


POLICIES = [None, "dots", "dots_no_batch", "attn"]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_keep_the_function(policy, scan):
    """Each remat policy changes what is saved, never the function: the
    port's loss and gradients equal its model without remat exactly (the
    recomputed forward repeats the same operations), and match the
    reference's remat model with the same policy (flash attention on both
    sides, GQA 2)."""
    kw = dict(num_kv_heads=2, scan_layers=scan)
    params = _jax_params(remat=True, **kw)  # Checkpoint_DecoderBlock names
    ids = _ids(4, (2, T))
    plain = _port_model(True, params=params, **kw)
    remat = _port_model(True, params=params, remat=True, remat_policy=policy, **kw)
    p_loss, p_grads = _port_loss_and_grads(plain, ids)
    r_loss, r_grads = _port_loss_and_grads(remat, ids)
    assert r_loss == p_loss
    for name in p_grads:
        assert torch.equal(r_grads[name], p_grads[name]), name
    jm = _jax_model(True, remat=True, remat_policy=policy, **kw)
    j_loss, j_grads = _jax_loss_and_grads(jm, params, ids)
    np.testing.assert_allclose(r_loss, j_loss, rtol=1e-5)
    _assert_grads_close(r_grads, j_grads)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed_mm,recomputed_bmm", [
    (None, 6, 2), ("dots", 0, 0), ("dots_no_batch", 0, 2), ("attn", 6, 2)])
def test_remat_policy_saves_what_it_names(policy, recomputed_mm, recomputed_bmm):
    """The backward of one block under each policy, counted at the
    dispatcher (dense attention): full remat recomputes six of the block's
    seven projections (``mm``; the recompute stops once it has remade what
    the backward reads, and nothing reads the last projection's output) and
    the two attention products (``bmm``); "dots" saves
    both; "dots_no_batch" saves the projections and recomputes attention's
    products; "attn" saves the named attention output (the marker op runs
    in the forward and is not run again), and recomputes the rest, which the
    attention's own backward needs, as the reference's policy does.  The
    backward's own products are 16 ``mm`` (the block's seven projections
    and the head, twice each) and 4 ``bmm`` in every case."""
    model = LlamaLM(**dict(CFG, num_layers=1), dtype=torch.float32, device="cpu",
                    remat=True, remat_policy=policy)
    ids = torch.from_numpy(_ids(5, (2, T)))
    with _CountOps() as fwd:
        loss = model(ids, labels=ids)
    with _CountOps() as bwd:
        loss.backward()
    assert bwd.counts.get("aten.mm", 0) == 16 + recomputed_mm, bwd.counts
    assert bwd.counts.get("aten.bmm", 0) == 4 + recomputed_bmm, bwd.counts
    marker = "bluefog_tpu_torch.attn_out"
    assert fwd.counts.get(marker, 0) == (policy == "attn")
    assert bwd.counts.get(marker, 0) == 0


def test_remat_policy_without_remat_does_nothing():
    model = _port_model(remat_policy="dots")
    assert model.remat_policy is None and not model.remat
    with pytest.raises(ValueError, match="remat_policy"):
        _port_model(remat=True, remat_policy="everything")


@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_equals_the_unrolled_model(remat):
    """The stacked model (nine ``[L, ...]`` leaves) computes the unrolled
    model's function: the same loss and, stacked, the same gradients."""
    unrolled = _port_model(num_kv_heads=2, generator=torch.Generator().manual_seed(0))
    sd = unrolled.state_dict()
    stacked = {k: v for k, v in sd.items() if not k.startswith("layers.")}
    for name in ("attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up", "down"):
        leaf = "scale" if name.endswith("norm") else "weight"
        stacked[f"layers.{name}"] = torch.stack(
            [sd[f"layers.{i}.{name}.{leaf}"] for i in range(CFG["num_layers"])])
    scanned = _port_model(num_kv_heads=2, scan_layers=True, remat=remat)
    scanned.load_state_dict(stacked, strict=True)
    assert len(list(scanned.parameters())) == 3 + 9
    ids = _ids(6, (2, T))
    u_loss, u_grads = _port_loss_and_grads(unrolled, ids)
    s_loss, s_grads = _port_loss_and_grads(scanned, ids)
    assert s_loss == u_loss
    for name, g in s_grads.items():
        if name.startswith("layers."):
            leaf = "scale" if name.endswith("norm") else "weight"
            want = torch.stack([u_grads[f"{name.replace('layers.', 'layers.%d.' % i)}.{leaf}"]
                                for i in range(CFG["num_layers"])])
        else:
            want = u_grads[name]
        assert torch.equal(g, want), name


def test_scanned_initializer_draws_each_layer_with_its_own_fan_in():
    """lecun-normal with std 1/sqrt(in) on every ``[out, in]`` slice of a
    stacked weight (the stack's size does not enter), ones for the norms."""
    model = LlamaLM(**dict(CFG, num_layers=4, hidden_size=128, dff=512), dtype=torch.float32,
                    device="cpu", scan_layers=True, generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("q", 128), ("gate", 128), ("down", 512)):
        w = getattr(model.layers, name)
        for layer in w.unbind(0):
            assert abs(layer.std().item() * fan_in ** 0.5 - 1.0) < 0.1, name
            assert layer.abs().max().item() <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(model.layers.attn_norm, torch.ones_like(model.layers.attn_norm))


# --------------------------------------------------------------------------
# spmd_vocab
# --------------------------------------------------------------------------


@pytest.mark.parametrize("head_chunks", [0, 4])
def test_spmd_vocab_is_bit_equal_on_in_range_ids(head_chunks):
    """The one-hot embedding and one-hot target on in-range ids: the same
    loss and the same gradients as the gather path, bit for bit (a one-hot
    product sums one value and zeros), and the reference's loss."""
    params = _jax_params()
    ids = _ids(7, (2, T))
    default = _port_model(params=params, head_chunks=head_chunks)
    spmd = _port_model(params=params, head_chunks=head_chunks, spmd_vocab=True)
    d_loss, d_grads = _port_loss_and_grads(default, ids)
    s_loss, s_grads = _port_loss_and_grads(spmd, ids)
    assert s_loss == d_loss
    for name in d_grads:
        assert torch.equal(s_grads[name], d_grads[name]), name
    j_loss, _ = _jax_loss_and_grads(_jax_model(head_chunks=head_chunks, spmd_vocab=True),
                                    params, ids)
    np.testing.assert_allclose(s_loss, j_loss, rtol=1e-5)


@pytest.mark.parametrize("head_chunks", [0, 4])
def test_spmd_vocab_out_of_range_ids_match_the_reference(head_chunks):
    """Ids outside ``[0, vocab)`` (and negative) embed as zeros and have no
    target logit, as ``jax.nn.one_hot`` gives: loss and gradients against
    the reference's ``spmd_vocab=True``."""
    params = _jax_params()
    V = CFG["vocab_size"]
    ids = _ids(8, (2, T))
    ids[0, 3], ids[0, 10], ids[1, 0], ids[1, 20] = V, V + 7, -1, -5
    j_loss, j_grads = _jax_loss_and_grads(
        _jax_model(head_chunks=head_chunks, spmd_vocab=True), params, ids)
    model = _port_model(params=params, head_chunks=head_chunks, spmd_vocab=True)
    t_loss, t_grads = _port_loss_and_grads(model, ids)
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)


# --------------------------------------------------------------------------
# sgdm_bf16 and the train step
# --------------------------------------------------------------------------


def test_trace_sgd_is_optax_sgd_with_its_accumulator_dtype():
    """Five updates of ``TraceSGD`` against optax's ``sgd(momentum=0.9,
    accumulator_dtype=...)`` jitted, as every train step runs it, on the
    same gradients: parameters and trace bit-equal, the trace stored in
    bf16 (or f32).  Under jit the momentum is rounded to the trace's dtype
    and the product is not; an eager optax update rounds the product too,
    which moves a third of the bf16 traces by a step after two updates.
    With an f32 trace XLA fuses the sum and the product into one FMA, so
    there the parameters (of size ~1) agree within 1e-6, a few f32 steps."""
    rng = np.random.default_rng(9)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (None, None)):
        p0 = rng.normal(size=(64, 33)).astype(np.float32)
        grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
        tx = optax.sgd(0.1, momentum=0.9, accumulator_dtype=jdt)
        update = jax.jit(tx.update)
        jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        p = torch.tensor(p0, requires_grad=True)
        opt = TraceSGD([p], lr=0.1, momentum=0.9, trace_dtype=dt)
        for g in grads:
            upd, state = update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            p.grad = torch.from_numpy(g)
            opt.step()
        trace = opt.state[p]["trace"]
        assert trace.dtype == (dt or torch.float32)
        if dt is None:  # XLA contracts the f32 g + m * t into one FMA
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
            continue
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp))
        np.testing.assert_array_equal(trace.float().numpy(),
                                      np.asarray(state[0].trace, np.float32))


def test_sgdm_bf16_train_step_matches_the_reference():
    """Three ATC steps of the 1b preset's layout at a small size (GQA 2,
    remat, scan_layers, chunked loss, flash attention) with momentum SGD on
    a bf16 trace, against the JAX train step with optax's bf16 trace:
    losses within rtol 1e-4; every rank's stacked leaves within rtol 1e-4
    and 1e-6 absolute on 99.9% of entries.  A trace entry that sits on a
    bf16 rounding boundary may round the other way on one side (the two
    gradients differ by f32 roundoff) and then moves its weight by lr x
    0.9 x one bf16 step of the trace (2^-7 of it) a later step: every entry
    within 1e-6 + lr x (steps - 1) x 2^-7 x max|trace| of the reference."""
    lr, steps = 0.1, 3
    kw = dict(num_kv_heads=2, remat=True, scan_layers=True, head_chunks=4)
    params0 = _jax_params(**kw)
    batches = _ids(10, (steps, N, 2, T))
    jbf.init(devices=jax.devices()[:N])
    try:
        ctx = jbasics.context()
        lm_apply, lm_loss = jax_lm_loss_fns(_jax_model(True, **kw))
        init_fn, step_fn = jax_train_step(
            lm_apply, optax.sgd(lr, momentum=0.9, accumulator_dtype=jnp.bfloat16), ctx.mesh,
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
        model = _port_model(True, params=params0, **kw)
        params = replicate_for_mesh(dict(model.named_parameters()), N)
        assert len(params) == 3 + 9
        apply_fn, loss_fn = make_lm_loss_fns(model)
        opt = TraceSGD(list(params.values()), lr=lr, momentum=0.9, trace_dtype=torch.bfloat16)
        step = make_decentralized_train_step(
            apply_fn, params, opt, communication_type=CommunicationType.neighbor_allreduce,
            plan=tbf.context().plan, loss_fn=loss_fn)
        t_losses = [step(torch.from_numpy(b), torch.from_numpy(b))[0].numpy() for b in batches]
        assert all(st["trace"].dtype == torch.bfloat16 for st in opt.state.values())
        flip = lr * (steps - 1) * 2.0 ** -7 * max(
            st["trace"].float().abs().max().item() for st in opt.state.values())
    finally:
        tbf.shutdown()
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses), rtol=1e-4)
    close = total = 0
    for r in range(N):
        want = llama_state_dict(jax.tree_util.tree_map(lambda a: a[r], jparams),
                                CFG["num_layers"])
        for name, leaf in params.items():
            got, w = leaf[r].detach().numpy(), want[name].numpy()
            diff = np.abs(got - w)
            assert diff.max() <= 1e-6 + flip, (r, name, diff.max(), flip)
            close += int((diff <= 1e-6 + 1e-4 * np.abs(w)).sum())
            total += diff.size
    assert close >= 0.999 * total, (close, total)


# --------------------------------------------------------------------------
# the example's flags
# --------------------------------------------------------------------------


def _example(argv):
    from bluefog_tpu_torch.examples import llama_pretrain

    return llama_pretrain.run(llama_pretrain._parser().parse_args(
        ["--device", "cpu", "--steps", "2"] + argv))


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm", "sgdm_bf16"])
def test_tiny_example_takes_every_new_flag(optimizer):
    out = _example(["--preset", "tiny", "--kv-heads", "2", "--optimizer", optimizer,
                    "--head-chunks", "4", "--seq", "64"])
    assert (out["kv_heads"], out["optimizer"], out["head_chunks"], out["seq"]) == \
        (2, optimizer, 4, 64)
    assert all(np.isfinite(out["losses"][-1])) and out["consensus_spread"] < 0.01


def test_remat_policy_flag_needs_a_remat_preset(monkeypatch):
    """As the reference's benchmark, ``--remat-policy`` without a remat
    preset is an error; with one (the tiny widths under the 1b preset's
    remat, scan_layers and sgdm_bf16) the policy and the layout reach the
    model and the step."""
    from bluefog_tpu_torch.examples import llama_pretrain

    with pytest.raises(ValueError, match="remat preset"):
        _example(["--preset", "tiny", "--remat-policy", "dots"])
    remat_tiny = dict(llama_pretrain.PRESETS["tiny"], remat=True, scan_layers=True,
                      optimizer="sgdm_bf16", head_chunks=4)
    monkeypatch.setitem(llama_pretrain.PRESETS, "tiny_remat", remat_tiny)
    out = _example(["--preset", "tiny_remat", "--remat-policy", "dots", "--kv-heads", "1"])
    assert (out["remat"], out["remat_policy"], out["scan_layers"], out["optimizer"]) == \
        (True, "dots", True, "sgdm_bf16")
    assert out["leaves"] == 3 + 9
    assert all(np.isfinite(out["losses"][-1]))


def test_1b_preset_is_the_reference_benchmarks():
    import pathlib

    from bluefog_tpu_torch.examples import llama_pretrain

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "llama.py"
    src = path.read_text()
    start = src.index('"1b": dict(')
    ref = eval(src[start + len('"1b": '):src.index("),", start) + 1])  # noqa: S307
    assert llama_pretrain.PRESETS["1b"] == ref
