"""Pipeline parallelism (``parallel/pipeline.py``) of bluefog_tpu_torch
against the JAX package on the CPU mesh.

The reference pipeline runs inside ``jax.shard_map(..., check_vma=False)``
(with jax 0.9 its ``pcast`` fails the varying-manual-axes check, the
failure of ``tests/test_pipeline.py`` in this environment), its gradients
taken inside the shard_map body; taken outside, of an ``out_specs=P()``
output, the stage weights come back at 1/pp of the truth
(:func:`test_reference_outside_gradient_scale`).  The reference test's
``(stages, microbatches)`` cases, same numpy stage weights and inputs, f32:
outputs and gradients within rtol 1e-5 / atol 1e-5 of the largest entry
(the same f32 sums in other orders), and the sequential stages within the
reference test's 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import ops_spmd
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core.plan import compile_plan as jax_compile_plan
from bluefog_tpu.parallel import pipeline as jpp
from bluefog_tpu_torch import ops
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core.plan import compile_plan
from bluefog_tpu_torch.interop.jax_weights import tree_from_jax, tree_to_jax
from bluefog_tpu_torch.parallel import pipeline as pp

torch.set_num_threads(1)
DIM = 8
RTOL, ATOL = 1e-5, 1e-5


def _stage_np(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(DIM, DIM)) / np.sqrt(DIM)).astype(np.float32),
            "b": (rng.normal(size=(DIM,)) * 0.1).astype(np.float32)}


def j_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def t_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _x(seed, rows):
    return np.random.default_rng(seed).normal(size=(rows, DIM)).astype(np.float32)


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max(),
                               err_msg=err_msg)


def _reference(devices, per_stage, x, num_micro):
    """The reference pipeline's output, dx and per-stage gradients of
    sum(sin(y)), differentiated inside the shard_map body."""
    n = len(per_stage)
    mesh = Mesh(np.array(devices[:n]).reshape(n), ("pp",))
    stacked = jpp.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                      for p in per_stage])

    def spmd(x, params):
        local = jax.tree_util.tree_map(lambda a: a[0], params)

        def loss(x, local):
            y = jpp.pipeline_apply(j_stage, local, x, "pp", num_microbatches=num_micro)
            return jnp.sum(jnp.sin(y)), y

        (_, y), (dx, dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(x, local)
        return y, dx, jax.tree_util.tree_map(lambda a: a[None], dp)

    return jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=(P(), P("pp")),
                                 out_specs=(P(), P(), P("pp")), check_vma=False))(
        jnp.asarray(x), stacked)


def _port(per_stage, x, num_micro):
    stacked = pp.stack_stage_params([tree_from_jax(p) for p in per_stage])
    for v in stacked.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pp.pipeline_apply(t_stage, stacked, xt, num_microbatches=num_micro)
    torch.sin(y).sum().backward()
    return y, xt.grad, {k: v.grad for k, v in stacked.items()}


def _sequential(per_stage, x):
    for p in per_stage:
        x = np.tanh(x @ p["w"] + p["b"])
    return x


@pytest.mark.parametrize("n_stages,num_micro", [(8, 4), (4, 8), (2, 2)])
def test_pipeline_matches_reference_and_sequential(devices, n_stages, num_micro):
    per_stage = [_stage_np(i) for i in range(n_stages)]
    x = _x(9, 16)
    jy, jdx, jdp = _reference(devices, per_stage, x, num_micro)
    ty, tdx, tdp = _port(per_stage, x, num_micro)
    _close(ty, jy, "out")
    np.testing.assert_allclose(ty.detach().numpy(), _sequential(per_stage, x), atol=1e-5)
    _close(tdx, jdx, "dx")
    for k in ("w", "b"):
        _close(tdp[k], jdp[k], k)


def test_pipeline_gradients_are_the_sequential_models(devices):
    """test_pipeline_gradients_match_sequential: 4 stages, 4 microbatches,
    against ``jax.grad`` of the sequential stages (no pp scaling)."""
    per_stage = [_stage_np(i) for i in range(4)]
    x = _x(9, 8)
    _, tdx, tdp = _port(per_stage, x, 4)

    def ref_loss(x, ps):
        for p in ps:
            x = j_stage(p, x)
        return jnp.sum(jnp.sin(x))

    rdx, rdp = jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), [jax.tree_util.tree_map(jnp.asarray, p) for p in per_stage])
    _close(tdx, rdx, "dx")
    for s in range(4):
        for k in ("w", "b"):
            _close(tdp[k][s], rdp[s][k], f"stage {s} {k}")


def test_reference_outside_gradient_scale(devices):
    """The reference's trap, documented: the gradient taken outside the
    shard_map of an ``out_specs=P()`` output gives the stage weights at
    1/pp of the truth (0.25 at pp = 4); the port's are the truth."""
    n = 4
    per_stage = [_stage_np(i) for i in range(n)]
    x = _x(9, 8)
    mesh = Mesh(np.array(devices[:n]).reshape(n), ("pp",))
    stacked = jpp.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                      for p in per_stage])

    def fwd(x, params):
        local = jax.tree_util.tree_map(lambda a: a[0], params)
        return jpp.pipeline_apply(j_stage, local, x, "pp", num_microbatches=4)

    f = jax.shard_map(fwd, mesh=mesh, in_specs=(P(), P("pp")), out_specs=P(),
                      check_vma=False)
    outside = jax.grad(lambda p: jnp.sum(jnp.sin(f(jnp.asarray(x), p))))(stacked)
    _, _, inside = _reference(devices, per_stage, x, 4)
    ratio = np.asarray(outside["w"]) / np.asarray(inside["w"])
    np.testing.assert_allclose(ratio, 1.0 / n, rtol=1e-4)
    _, _, tdp = _port(per_stage, x, 4)
    _close(tdp["w"], inside["w"], "port w")


def test_pipeline_bad_microbatch_count():
    stacked = pp.stack_stage_params([tree_from_jax(_stage_np(i)) for i in range(2)])
    with pytest.raises(ValueError, match="not divisible by num_microbatches=3"):
        pp.pipeline_apply(t_stage, stacked, torch.ones(10, DIM), num_microbatches=3)


def test_pipeline_composes_with_gossip(devices):
    """(dp = 2, pp = 4): each dp replica runs its pipeline, then the
    rank-major ``[dp, pp, ...]`` stage weights mix over dp: W stage-wise,
    as the reference's neighbor_allreduce gives."""
    dp, n = 2, 4
    per_rank = [[_stage_np(10 * r + i) for i in range(n)] for r in range(dp)]
    stacked = {k: torch.stack([pp.stack_stage_params([tree_from_jax(p) for p in ps])[k]
                               for ps in per_rank]) for k in ("w", "b")}
    x = np.random.default_rng(3).normal(size=(dp, 8, DIM)).astype(np.float32)
    for r in range(dp):
        y = pp.pipeline_apply(t_stage, {k: v[r] for k, v in stacked.items()},
                              torch.from_numpy(x[r]), num_microbatches=2)
        np.testing.assert_allclose(y.numpy(), _sequential(per_rank[r], x[r]), atol=1e-5)
    mixed = ops.neighbor_allreduce_plan(stacked, compile_plan(ttu.RingGraph(dp)))
    mesh = Mesh(np.array(devices).reshape(dp, n), ("bf_nodes", "pp"))
    plan = jax_compile_plan(jtu.RingGraph(dp))

    def spmd(params):
        local = jax.tree_util.tree_map(lambda a: a[0, 0], params)
        return jax.tree_util.tree_map(
            lambda a: a[None, None], ops_spmd.neighbor_allreduce(local, plan, "bf_nodes"))

    ref = jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=(P("bf_nodes", "pp"),),
                                out_specs=P("bf_nodes", "pp"), check_vma=False))(
        tree_to_jax(stacked))
    W = jtu.GetWeightMatrix(jtu.RingGraph(dp))
    for k in ("w", "b"):
        got = mixed[k].numpy()
        np.testing.assert_allclose(got, np.einsum("ds,s...->d...", W, stacked[k].numpy()),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


def _jax_example(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pp_gossip_example_twin_matches_the_reference_step(devices):
    """examples/pp_gossip.py's first 3 steps against the reference example's
    ``spmd_step`` (rebuilt here from examples/jax_pp_gossip.py's
    ``init_block`` and ``stage_fn`` under ``check_vma=False``), dp = 2 x
    pp = 4, 4 layers, 4 microbatches, the reference's inits carried over,
    the same batches: losses and every parameter within rtol 1e-5 / atol
    1e-5 of the leaf's largest entry."""
    import functools

    import optax

    from bluefog_tpu_torch.examples import pp_gossip

    jx = _jax_example("jax_pp_gossip")
    dp, n, layers, micro, d, lr = 2, 4, 4, 4, 32, 0.05
    mesh = Mesh(np.array(devices).reshape(dp, n), ("bf_nodes", "pp"))
    plan = jax_compile_plan(jtu.ExponentialTwoGraph(dp))
    k = layers // n
    per_repl, per_stage, blocks_np = [], [], []
    for r in range(dp):
        ks = jax.random.split(jax.random.PRNGKey(r), layers + 2)
        blocks = [jx.init_block(ks[i], d, 4) for i in range(layers)]
        per_repl.append({"embed": jax.random.normal(ks[-2], (jx.VOCAB, d)) * 0.3,
                         "unembed": jax.random.normal(ks[-1], (d, jx.VOCAB)) / np.sqrt(d)})
        per_stage.append(jpp.stack_stage_params([
            jpp.stack_stage_params(blocks[s * k:(s + 1) * k]) for s in range(n)]))
        blocks_np.append(blocks)
    stack = lambda *ls: jnp.stack(ls)
    repl = jax.tree_util.tree_map(stack, *per_repl)
    stages = jax.tree_util.tree_map(stack, *per_stage)
    opt = optax.sgd(lr, momentum=0.9)
    opt_r = jax.tree_util.tree_map(stack, *[opt.init(p) for p in per_repl])
    opt_s = jax.tree_util.tree_map(stack, *[opt.init(p) for p in per_stage])

    def loss_fn(pr, ps, ids):
        x = pr["embed"][ids[:, :-1]]
        y = jpp.pipeline_apply(jx.stage_fn, ps, x, "pp", num_microbatches=micro)
        logits = jnp.einsum("btm,mv->btv", y, pr["unembed"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, ids[:, 1:]).mean()

    def spmd_step(repl, stages, opt_r, opt_s, ids):
        t1 = functools.partial(jax.tree_util.tree_map, lambda a: a[0])
        t2 = functools.partial(jax.tree_util.tree_map, lambda a: a[0, 0])
        pr, ps, sr, ss = t1(repl), t2(stages), t1(opt_r), t2(opt_s)
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

    specs = (P("bf_nodes"), P("bf_nodes", "pp"), P("bf_nodes"), P("bf_nodes", "pp"),
             P("bf_nodes"))
    step = jax.jit(jax.shard_map(spmd_step, mesh=mesh, in_specs=specs, out_specs=specs,
                                 check_vma=False))

    t_repl = {key: torch.stack([torch.from_numpy(np.array(p[key])) for p in per_repl])
              .requires_grad_(True) for key in ("embed", "unembed")}
    per = [pp_gossip.stage_stack([tree_from_jax(jax.tree_util.tree_map(np.asarray, b))
                                  for b in blocks], n) for blocks in blocks_np]
    t_stages = {key: torch.stack([p[key] for p in per]).requires_grad_(True) for key in per[0]}
    t_step = pp_gossip.make_step(t_repl, t_stages, compile_plan(ttu.ExponentialTwoGraph(dp)),
                                 lr, micro)
    for ids in pp_gossip.synthetic_batches(dp, 8, 16, 3, "cpu"):
        repl, stages, opt_r, opt_s, loss = step(repl, stages, opt_r, opt_s,
                                                jnp.asarray(ids.numpy()))
        np.testing.assert_allclose(t_step(ids).item(), float(np.asarray(loss).mean()),
                                   rtol=1e-5)
    for key in t_repl:
        _close(t_repl[key], repl[key], key)
    for key in t_stages:
        _close(t_stages[key], stages[key], key)
