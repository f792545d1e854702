"""Tensor parallelism (``parallel/tensor_parallel.py``) of bluefog_tpu_torch
against the JAX package on the CPU mesh.

The reference block runs inside ``jax.shard_map(..., check_vma=False)``:
with jax 0.9 its ``pcast`` fails the varying-manual-axes check even on a
replicated input (the failure of ``tests/test_tensor_parallel.py`` in
this environment), and without the check it runs.  Its gradients are taken
inside the shard_map body, as its example takes them; taken outside, of
an ``out_specs=P()`` output, the sharded leaves come back at 1/tp of the
truth (:func:`test_reference_outside_gradient_scale`).  Same numpy
parameters and inputs on both sides, f32: outputs and gradients within
rtol 1e-5 / atol 1e-5 of the largest entry (the same f32 sums in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import ops_spmd
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core.plan import compile_plan as jax_compile_plan
from bluefog_tpu.parallel import tensor_parallel as jtp
from bluefog_tpu_torch import ops
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.interop.jax_weights import tree_from_jax, tree_to_jax
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.parallel import tensor_parallel as tpp

torch.set_num_threads(1)
D_MODEL, HEADS, DFF = 16, 8, 32
RTOL, ATOL = 1e-5, 1e-5
AXES = tpp.TP_BLOCK_SHARD_AXES


def _full(seed=3, scale=1.0):
    p = tpp.init_tp_block_params(D_MODEL, HEADS, DFF, seed=seed)
    return {k: ({kk: vv * scale for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in p.items()}


def _x(seed, shape=(2, 8, D_MODEL)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max(),
                               err_msg=err_msg)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_shard_unshard_roundtrip_matches_reference():
    p = _full()
    for tp in (2, 4):
        stacked = tpp.shard_tp_params(p, AXES, tp)
        assert stacked["attn"]["wq"].shape == (tp, D_MODEL, HEADS // tp, D_MODEL // HEADS)
        want = jtp.shard_tp_params(tree_to_jax(p), AXES, tp)
        for a, b in zip(_leaves(tree_to_jax(stacked)), _leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
        back = tpp.unshard_tp_params(stacked, AXES)
        for a, b in zip(_leaves(tree_to_jax(p)), _leaves(tree_to_jax(back))):
            np.testing.assert_array_equal(a, b)


def test_shard_list_subtrees():
    p = {"blocks": [_full(), _full(scale=2.0)], "embed": torch.ones(6, 4)}
    axes = {"blocks": [AXES, AXES], "embed": None}
    stacked = tpp.shard_tp_params(p, axes, 2)
    assert stacked["blocks"][1]["mlp"]["wi"].shape == (2, D_MODEL, DFF // 2)
    assert stacked["embed"].shape == (2, 6, 4)
    back = tpp.unshard_tp_params(stacked, axes)
    assert torch.equal(back["blocks"][1]["mlp"]["wi"], p["blocks"][1]["mlp"]["wi"])
    with pytest.raises(ValueError, match="axes list length"):
        tpp.shard_tp_params(p, {"blocks": [None], "embed": None}, 2)
    with pytest.raises(ValueError, match="missing keys"):
        tpp.shard_tp_params(p, {"blocks": AXES}, 2)
    bcast = tpp.shard_tp_params(p, {"blocks": AXES, "embed": None}, 2)
    for b in range(2):
        assert torch.equal(bcast["blocks"][b]["mlp"]["wi"], stacked["blocks"][b]["mlp"]["wi"])


def test_indivisible_tp_raises():
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tpp.shard_tp_params(_full(), AXES, 3)


def test_init_is_seeded_and_shaped_as_the_reference():
    a, b = _full(5), _full(5)
    for x, y in zip(_leaves(tree_to_jax(a)), _leaves(tree_to_jax(b))):
        np.testing.assert_array_equal(x, y)
    ref = jtp.init_tp_block_params(jax.random.PRNGKey(0), D_MODEL, HEADS, DFF, dtype=jnp.float32)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree_to_jax(a))
    for x, y in zip(_leaves(tree_to_jax(a)), _leaves(ref)):
        assert x.shape == y.shape
    g = tpp.init_tp_block_params(D_MODEL, HEADS, DFF, generator=torch.Generator().manual_seed(1))
    assert g["attn"]["wq"].std().item() == pytest.approx(1 / np.sqrt(D_MODEL), rel=0.2)


def _mesh(devices, tp):
    return Mesh(np.array(devices[:tp]).reshape(tp), ("tp",))


def _reference_grads(devices, tp, p, x):
    """The reference block's loss sum(sin(block)) differentiated inside the
    shard_map body: (out, dx, d replicated, d sharded [tp, ...])."""
    repl, shard = jtp.split_tp_params(tree_to_jax(p), AXES)
    shard = jtp.shard_tp_params(shard, AXES, tp)

    def spmd(x, repl, shard):
        local = jax.tree_util.tree_map(lambda a: a[0], shard)

        def loss(x, repl, local):
            y = jtp.tp_transformer_block(x, jtp.merge_tp_params(repl, local), causal=True)
            return jnp.sum(jnp.sin(y)), y

        (_, y), (dx, dr, ds) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            x, repl, local)
        return y, dx, dr, jax.tree_util.tree_map(lambda a: a[None], ds)

    return jax.jit(jax.shard_map(
        spmd, mesh=_mesh(devices, tp), in_specs=(P(), P(), P("tp")),
        out_specs=(P(), P(), P(), P("tp")), check_vma=False))(jnp.asarray(x), repl, shard)


def _port_grads(tp, p, x, attention_fn=None):
    repl, shard = tpp.split_tp_params(tree_from_jax(tree_to_jax(p)), AXES)
    shard = tpp.shard_tp_params(shard, AXES, tp)
    for t in _tensors(repl) + _tensors(shard):
        t.requires_grad_(True)
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    y = tpp.tp_transformer_block(xt, tpp.merge_tp_params(repl, shard), causal=True,
                                 attention_fn=attention_fn)
    torch.sin(y).sum().backward()

    def grad(tree):
        return {k: (grad(v) if isinstance(v, dict) else v.grad)
                for k, v in tree.items() if v is not None}

    return y, xt.grad, grad(repl), grad(shard)


def _tensors(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _tensors(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_block_forward_and_gradients_match_reference(devices, tp):
    p = _full()
    x = _x(7)
    jy, jdx, jdr, jds = _reference_grads(devices, tp, p, x)
    ty, tdx, tdr, tds = _port_grads(tp, p, x)
    _close(ty, jy, "out")
    _close(tdx, jdx, "dx")
    for k in ("norm1", "norm2"):
        _close(tdr[k], jdr[k], k)
    for grp in ("attn", "mlp"):
        for k, g in tds[grp].items():
            _close(g, jds[grp][k], f"{grp}.{k}")


def test_tp_gradients_are_the_unsharded_truth(devices):
    """tp = 4 against ``jax.grad`` of the unsharded block (tp = 1 in one
    device): a sharded leaf's gradient is its shard of the full gradient,
    a replicated leaf's and dx the full gradient."""
    p = _full()
    x = _x(9)
    _, rdx, rdr, rds = _reference_grads(devices, 1, p, x)
    _, tdx, tdr, tds = _port_grads(4, p, x)
    _close(tdx, rdx, "dx")
    _close(tdr["norm1"], rdr["norm1"], "norm1")
    full = tpp.unshard_tp_params({"mlp": {"wi": tds["mlp"]["wi"]}}, {"mlp": {"wi": 1}})
    _close(full["mlp"]["wi"], np.asarray(rds["mlp"]["wi"])[0], "mlp.wi")


def test_reference_outside_gradient_scale(devices):
    """The reference's trap, documented: with the gradient taken outside
    the shard_map, of an ``out_specs=P()`` output, the sharded leaves come
    back at 1/tp of the truth (0.5 at tp = 2) while the replicated ones are
    right; the port has no such form (its gradient is autograd's)."""
    tp = 2
    p = _full()
    x = jnp.asarray(_x(11))
    repl, shard = jtp.split_tp_params(tree_to_jax(p), AXES)
    shard = jtp.shard_tp_params(shard, AXES, tp)

    def fwd(x, repl, shard):
        local = jax.tree_util.tree_map(lambda a: a[0], shard)
        return jtp.tp_transformer_block(x, jtp.merge_tp_params(repl, local), causal=True)

    block = jax.shard_map(fwd, mesh=_mesh(devices, tp), in_specs=(P(), P(), P("tp")),
                          out_specs=P(), check_vma=False)
    _, dr, ds = jax.grad(lambda x, r, s: jnp.sum(jnp.sin(block(x, r, s))),
                         argnums=(0, 1, 2))(x, repl, shard)
    _, rdx, rdr, rds = _reference_grads(devices, tp, p, np.asarray(x))
    ratio = np.asarray(ds["mlp"]["wi"]) / np.asarray(rds["mlp"]["wi"])
    np.testing.assert_allclose(np.median(ratio), 1.0 / tp, rtol=1e-3)
    _close(dr["norm1"], rdr["norm1"], "norm1")
    _, _, _, tds = _port_grads(tp, p, np.asarray(x))
    _close(tds["mlp"]["wi"], rds["mlp"]["wi"], "port mlp.wi")


def test_tp_block_with_flash_attention_fn():
    """The flash ``attention_fn`` (the kernels' plain versions on the CPU),
    the tp shards folded into one call, against the dense default."""
    p = _full()
    x = _x(13, (2, 16, D_MODEL))
    dense = _port_grads(2, p, x)
    flash = _port_grads(2, p, x, attention_fn=make_flash_attention_fn())
    _close(flash[0], dense[0].detach().numpy(), "out")
    _close(flash[1], dense[1].numpy(), "dx")
    _close(flash[3]["attn"]["wq"], dense[3]["attn"]["wq"].numpy(), "wq")


def test_tp_composes_with_gossip(devices):
    """(dp = 4, tp = 2): one neighbor_allreduce over the dp axis of the
    rank-major ``[dp, tp, ...]`` shards equals W shard-wise and the
    reference's mix; a forward on the mixed shards per dp replica equals
    the block on the unsharded mix."""
    dp, tp = 4, 2
    per_rank = [tpp.shard_tp_params(_full(scale=r + 1.0), AXES, tp) for r in range(dp)]
    stacked = {k: ({kk: torch.stack([pr[k][kk] for pr in per_rank]) for kk in v}
                   if isinstance(v, dict) else torch.stack([pr[k] for pr in per_rank]))
               for k, v in per_rank[0].items()}
    mixed = ops.neighbor_allreduce_plan(stacked, compile_plan(ttu.RingGraph(dp)))
    W = jtu.GetWeightMatrix(jtu.RingGraph(dp))
    mesh = Mesh(np.array(devices).reshape(dp, tp), ("bf_nodes", "tp"))
    plan = jax_compile_plan(jtu.RingGraph(dp))

    def spmd(params):
        local = jax.tree_util.tree_map(lambda a: a[0, 0], params)
        out = ops_spmd.neighbor_allreduce(local, plan, "bf_nodes")
        return jax.tree_util.tree_map(lambda a: a[None, None], out)

    ref = jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=(P("bf_nodes", "tp"),),
                                out_specs=P("bf_nodes", "tp"), check_vma=False))(
        tree_to_jax(stacked))
    for got, src, want in zip(_leaves(tree_to_jax(mixed)), _leaves(tree_to_jax(stacked)),
                              _leaves(ref)):
        np.testing.assert_allclose(got, np.einsum("ds,s...->d...", W, src), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    x = torch.from_numpy(_x(1, (2, 4, D_MODEL)))

    def sharded(full, n):
        repl, shard = tpp.split_tp_params(full, AXES)
        return tpp.merge_tp_params(repl, tpp.shard_tp_params(shard, AXES, n))

    for d in range(dp):
        full = tpp.unshard_tp_params(
            {k: ({kk: vv[d] for kk, vv in v.items()} if isinstance(v, dict) else v[d])
             for k, v in mixed.items()}, AXES)
        want = tpp.tp_transformer_block(x, sharded(full, 1), causal=True)
        _close(tpp.tp_transformer_block(x, sharded(full, tp), causal=True), want.numpy(),
               f"dp {d}")


def _jax_example(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tp_gossip_example_twin_matches_the_reference_step(devices):
    """examples/tp_gossip.py's first 3 steps against the reference
    example's ``spmd_step`` (rebuilt here from examples/jax_tp_gossip.py's
    ``init_params`` and ``forward`` under ``check_vma=False``), dp = 4 x
    tp = 2, dense attention, the reference's inits carried over, the same
    batches: losses and every parameter within rtol 1e-5 / atol 1e-5 of
    the leaf's largest entry."""
    import functools

    import optax

    from bluefog_tpu_torch.examples import tp_gossip

    jx = _jax_example("jax_tp_gossip")
    dp, tp, layers, lr = 4, 2, 2, 0.05
    mesh = Mesh(np.array(devices).reshape(dp, tp), ("bf_nodes", "tp"))
    plan = jax_compile_plan(jtu.ExponentialTwoGraph(dp))
    axes = jx.param_axes(layers)
    full = [jx.init_params(jax.random.PRNGKey(r), 32, 4, 64, layers) for r in range(dp)]
    per_repl, per_shard = [], []
    for p in full:
        r, s = jtp.split_tp_params(p, axes)
        per_repl.append(r)
        per_shard.append(jtp.shard_tp_params(s, axes, tp))
    stack = lambda *ls: jnp.stack(ls)
    repl = jax.tree_util.tree_map(stack, *per_repl)
    shard = jax.tree_util.tree_map(stack, *per_shard)
    opt = optax.sgd(lr, momentum=0.9)
    opt_r = jax.tree_util.tree_map(stack, *[opt.init(p) for p in per_repl])
    opt_s = jax.tree_util.tree_map(stack, *[opt.init(p) for p in per_shard])

    def loss_fn(pr, ps, ids):
        logits = jx.forward(jtp.merge_tp_params(pr, ps), ids[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(logits, ids[:, 1:]).mean()

    def spmd_step(repl, shard, opt_r, opt_s, ids):
        t1 = functools.partial(jax.tree_util.tree_map, lambda a: a[0])
        t2 = functools.partial(jax.tree_util.tree_map, lambda a: a[0, 0])
        pr, ps, sr, ss = t1(repl), t2(shard), t1(opt_r), t2(opt_s)
        loss, (gr, gs) = jax.value_and_grad(loss_fn, argnums=(0, 1))(pr, ps, ids[0])
        ur, sr = opt.update(gr, sr, pr)
        pr = optax.apply_updates(pr, ur)
        us, ss = opt.update(gs, ss, ps)
        ps = optax.apply_updates(ps, us)
        pr = ops_spmd.neighbor_allreduce(pr, plan, "bf_nodes")
        ps = ops_spmd.neighbor_allreduce(ps, plan, "bf_nodes")
        e1 = functools.partial(jax.tree_util.tree_map, lambda a: a[None])
        e2 = functools.partial(jax.tree_util.tree_map, lambda a: a[None, None])
        return e1(pr), e2(ps), e1(sr), e2(ss), jax.lax.pmean(loss, "bf_nodes")[None]

    specs = (P("bf_nodes"), P("bf_nodes", "tp"), P("bf_nodes"), P("bf_nodes", "tp"),
             P("bf_nodes"))
    step = jax.jit(jax.shard_map(spmd_step, mesh=mesh, in_specs=specs, out_specs=specs,
                                 check_vma=False))

    t_repl, t_shard = tp_gossip.stack_replicas(
        [tree_from_jax(jax.tree_util.tree_map(np.asarray, p)) for p in full], axes, tp)
    t_step = tp_gossip.make_step(t_repl, t_shard, compile_plan(ttu.ExponentialTwoGraph(dp)),
                                 lr)
    for ids in tp_gossip.synthetic_batches(dp, 8, 16, 3, "cpu"):
        repl, shard, opt_r, opt_s, loss = step(repl, shard, opt_r, opt_s,
                                               jnp.asarray(ids.numpy()))
        np.testing.assert_allclose(t_step(ids).item(), float(np.asarray(loss).mean()),
                                   rtol=1e-5)
    for got, want in zip(_leaves(tree_to_jax(t_repl)) + _leaves(tree_to_jax(t_shard)),
                         _leaves(repl) + _leaves(shard)):
        _close(got, want)
