"""Expert parallelism (``parallel/expert.py``) of bluefog_tpu_torch against the
JAX package on the CPU mesh, at ep in {1, 2, 4} with 8 experts: outputs
and aux loss, dropped tokens at a small capacity, the gradients to the
router and the experts (the reference differentiates each device's loss
inside the shard_map body; the port's replicated router sums the devices'
shares, its expert shards get what the all_to_all transposes bring back),
and the reference's "pass this device's shard" error.  Same numpy weights
and tokens, f32: within rtol 1e-5 / atol 1e-5 of the largest entry (the
same f32 sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.parallel import expert as jep
from bluefog_tpu_torch.interop.jax_weights import tree_from_jax, tree_to_jax
from bluefog_tpu_torch.parallel import expert as ep

torch.set_num_threads(1)
D, F, E, TLOC = 8, 16, 8, 4
RTOL, ATOL = 1e-5, 1e-5


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max(),
                               err_msg=err_msg)


def _params(seed):
    return tree_to_jax(ep.init_moe_params(D, F, E, seed=seed))


def _shard(params, n):
    return {"router": params["router"],
            "wi": params["wi"].reshape((n, E // n) + params["wi"].shape[1:]),
            "wo": params["wo"].reshape((n, E // n) + params["wo"].shape[1:])}


def _reference(devices, x, params, n, cf):
    """The reference layer on an n-device ep mesh: (out [n, T, d], aux), and
    with ``grads`` each device's gradient of sum(out^2) + 0.01 aux."""
    mesh = Mesh(np.array(devices[:n]).reshape(n), ("ep",))
    stacked = {"router": np.broadcast_to(params["router"][None], (n,) + params["router"].shape),
               **{k: v for k, v in _shard(params, n).items() if k != "router"}}

    def spmd(x, p):
        local = jax.tree_util.tree_map(lambda a: a[0], p)

        def loss(local):
            out, aux = jep.switch_moe(x[0], local, "ep", capacity_factor=cf)
            return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

        (_, (out, aux)), g = jax.value_and_grad(loss, has_aux=True)(local)
        return out[None], aux[None], jax.tree_util.tree_map(lambda a: a[None], g)

    return jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=(P("ep"), P("ep")),
                                 out_specs=(P("ep"), P("ep"), P("ep"))))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, stacked))


def _port(x, params, n, cf):
    p = tree_from_jax(_shard(params, n))
    for v in p.values():
        v.requires_grad_(True)
    out, aux = ep.switch_moe(torch.from_numpy(x), p, capacity_factor=cf)
    # the reference's per-device losses, summed: aux is the mean over ranks
    (torch.sum(out ** 2) + 0.01 * n * aux).backward()
    return out, aux, {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("cf", [float(E), 0.5], ids=["ample", "drops"])
def test_moe_matches_reference(devices, n, cf):
    x = np.random.default_rng(0).normal(size=(n, TLOC * (4 // n) * 2, D)).astype(np.float32)
    params = _params(1)
    jout, jaux, jg = _reference(devices, x, params, n, cf)
    tout, taux, tg = _port(x, params, n, cf)
    _close(tout, jout, "out")
    _close(taux, np.asarray(jaux)[0], "aux")
    # expert shards: the same layout on both sides
    for k in ("wi", "wo"):
        _close(tg[k], jg[k], k)
    # the replicated router: the sum of the devices' gradients
    _close(tg["router"], np.asarray(jg["router"]).sum(0), "router")
    assert tg["router"].abs().max().item() > 0


def test_moe_matches_dense_routing():
    """Ample capacity at ep = 4: every token reaches its expert, and the
    layer equals per-token dense routing (the reference test's ground
    truth, gelu's tanh form as jax.nn.gelu)."""
    n = 4
    x = np.random.default_rng(2).normal(size=(n, TLOC, D)).astype(np.float32)
    params = _params(3)
    out, aux = ep.switch_moe(torch.from_numpy(x), tree_from_jax(_shard(params, n)),
                             capacity_factor=float(E))
    xf = x.reshape(-1, D)
    logits = xf @ params["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = probs.argmax(-1)
    h = torch.nn.functional.gelu(torch.from_numpy(np.einsum("td,edf->tef", xf, params["wi"])),
                                 approximate="tanh").numpy()
    y = np.einsum("tef,efd->ted", h, params["wo"])[np.arange(len(xf)), idx]
    _close(out.reshape(-1, D), probs.max(-1)[:, None] * y, "dense")
    assert aux.item() > 0


def test_moe_capacity_drops_tokens(devices):
    """cap = 1 with identical tokens on every rank: one survivor a rank,
    dropped rows exactly zero, as the reference's."""
    n = 4
    x = np.ones((n, TLOC, D), np.float32)
    params = _params(1)
    out, _ = ep.switch_moe(torch.from_numpy(x), tree_from_jax(_shard(params, n)),
                           capacity_factor=1.0 / TLOC)
    o = out.numpy()
    kept = ~np.all(o == 0.0, axis=-1)
    assert kept.sum() == n
    jout, _, _ = _reference(devices, x, params, n, 1.0 / TLOC)
    np.testing.assert_array_equal(kept, ~np.all(np.asarray(jout) == 0.0, axis=-1))
    _close(out, jout, "out")


def test_moe_rejects_full_stack_as_shard():
    params = tree_from_jax(_params(0))
    with pytest.raises(ValueError, match="router"):
        ep.switch_moe(torch.ones(2, 4, D), params)


def test_init_is_seeded_and_shaped_as_the_reference():
    a, b = ep.init_moe_params(D, F, E, seed=4), ep.init_moe_params(D, F, E, seed=4)
    ref = jep.init_moe_params(jax.random.PRNGKey(0), D, F, E)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert tuple(a[k].shape) == tuple(ref[k].shape)


def _jax_example(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_example_steps(devices, jx, inits, batches, psum_replicated):
    """The reference example's ``spmd_step`` (rebuilt here from
    examples/jax_moe_gossip.py's ``init_params`` and ``forward``, under its
    ``check_vma=False``) over ``batches``; with ``psum_replicated`` the
    replicated leaves' gradients are summed over ep, as the example's
    docstring says the transposes do.  Returns (ce a step, params)."""
    import functools

    import optax
    from bluefog_tpu import ops_spmd
    from bluefog_tpu import topology_util as jtu
    from bluefog_tpu.core.plan import compile_plan as jax_compile_plan

    dp, n = len(inits), EX_EP
    mesh = Mesh(np.array(devices).reshape(dp, n), ("bf_nodes", "ep"))
    plan = jax_compile_plan(jtu.ExponentialTwoGraph(dp))
    stack = lambda *ls: jnp.stack(ls)
    shard = lambda tree: jax.tree_util.tree_map(
        lambda a: a.reshape((n, a.shape[0] // n) + a.shape[1:]), tree)
    repl = jax.tree_util.tree_map(stack, *[i[0] for i in inits])
    exp = jax.tree_util.tree_map(stack, *[shard(i[1]) for i in inits])
    opt = optax.sgd(EX_LR, momentum=0.9)
    opt_r = jax.tree_util.tree_map(stack, *[opt.init(i[0]) for i in inits])
    opt_e = jax.tree_util.tree_map(stack, *[opt.init(shard(i[1])) for i in inits])

    def loss_fn(repl_p, exp_p, ids):
        logits, aux = jx.forward(repl_p, exp_p, ids[:, :-1], "ep", EX_CF)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, ids[:, 1:]).mean()
        return (ce + EX_AUX * aux) / n, ce

    def spmd_step(repl, exp, opt_r, opt_e, ids):
        t1 = functools.partial(jax.tree_util.tree_map, lambda a: a[0])
        t2 = functools.partial(jax.tree_util.tree_map, lambda a: a[0, 0])
        pr, pe, sr, se = t1(repl), t2(exp), t1(opt_r), t2(opt_e)
        (_, ce), (gr, ge) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
            pr, pe, ids[0, 0])
        if psum_replicated:
            gr = jax.lax.psum(gr, "ep")
        ur, sr = opt.update(gr, sr, pr)
        pr = optax.apply_updates(pr, ur)
        ue, se = opt.update(ge, se, pe)
        pe = optax.apply_updates(pe, ue)
        pr = ops_spmd.neighbor_allreduce(pr, plan, "bf_nodes")
        pe = ops_spmd.neighbor_allreduce(pe, plan, "bf_nodes")
        e1 = functools.partial(jax.tree_util.tree_map, lambda a: a[None])
        e2 = functools.partial(jax.tree_util.tree_map, lambda a: a[None, None])
        ce = jax.lax.pmean(jax.lax.pmean(ce, "ep"), "bf_nodes")[None, None]
        return e1(pr), e2(pe), e1(sr), e2(se), ce

    s1, s2 = P("bf_nodes"), P("bf_nodes", "ep")
    step = jax.jit(jax.shard_map(spmd_step, mesh=mesh, in_specs=(s1, s2, s1, s2, s2),
                                 out_specs=(s1, s2, s1, s2, s2), check_vma=False))
    ces = []
    for ids in batches:
        repl, exp, opt_r, opt_e, ce = step(repl, exp, opt_r, opt_e, jnp.asarray(ids.numpy()))
        ces.append(float(np.asarray(ce).mean()))
    return ces, (repl, exp)


EX_EP, EX_EXPERTS, EX_LR, EX_AUX = 4, 4, 0.05, 0.01
EX_CF = float(EX_EXPERTS)


def test_moe_gossip_example_twin_matches_the_reference_step(devices):
    """examples/moe_gossip.py's first 3 steps against the reference
    example's step, dp = 2 x ep = 4, 4 experts, ample capacity, aux weight
    0.01, the reference's inits carried over, the same batches.  The port
    trains on the gradient of the mean loss over the mesh, which the
    example's docstring says its step computes; under the example's
    ``check_vma=False`` the replicated leaves' gradients are not summed
    over ep (each device keeps its own share, and device 0's is written
    back), so the example as written matches the first loss only and then
    drifts (0.17% at step 2).  With that sum added the rebuilt step matches
    the port: the mean cross-entropy within rtol 1e-5 and every parameter
    within rtol 1e-5 / atol 1e-5 of the leaf's largest entry."""
    from bluefog_tpu_torch import topology_util as ttu
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.examples import moe_gossip

    jx = _jax_example("jax_moe_gossip")
    dp = 2
    inits = [jx.init_params(jax.random.PRNGKey(r), 32, 4, 64, EX_EXPERTS, 2) for r in range(dp)]
    batches = moe_gossip.synthetic_batches(dp, EX_EP, 8, 16, 3, "cpu")
    t_inits = [(tree_from_jax(jax.tree_util.tree_map(np.asarray, i[0])),
                tree_from_jax(jax.tree_util.tree_map(np.asarray, i[1]))) for i in inits]
    t_repl = moe_gossip.stack_replicas([i[0] for i in t_inits])
    t_exp = moe_gossip.stack_replicas([moe_gossip.shard_experts(i[1], EX_EP) for i in t_inits])
    t_step = moe_gossip.make_step(t_repl, t_exp, compile_plan(ttu.ExponentialTwoGraph(dp)),
                                  EX_LR, EX_CF, EX_AUX)
    t_ces = [t_step(ids).item() for ids in batches]

    ces, (repl, exp) = _reference_example_steps(devices, jx, inits, batches, True)
    np.testing.assert_allclose(t_ces, ces, rtol=1e-5)
    for got, want in zip(jax.tree_util.tree_leaves(tree_to_jax(t_repl))
                         + jax.tree_util.tree_leaves(tree_to_jax(t_exp)),
                         jax.tree_util.tree_leaves(repl) + jax.tree_util.tree_leaves(exp)):
        _close(got, want)
    as_written, _ = _reference_example_steps(devices, jx, inits, batches, False)
    np.testing.assert_allclose(as_written[0], t_ces[0], rtol=1e-5)
    assert abs(as_written[1] - t_ces[1]) > 1e-3 * t_ces[1]
