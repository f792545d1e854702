"""The one-sided window ops of bluefog_tpu_torch against the JAX package.

Every case of ``tests/test_win_ops.py`` is written once as a scenario over
a small facade (:class:`Side`) and run twice from the same numpy inputs:
through ``bluefog_tpu.windows`` on the 8-device CPU mesh and through
``bluefog_tpu_torch.windows`` with ``device="cpu"``.  Each run returns
what the reference test looks at (the returned tensors, versions, p,
whether an error was raised) and, at the end, every window's full state:
exposed tensor, mailbox, versions, p and the p mailbox.  The two must
agree: f32 within rtol 1e-5 / atol 1e-6 (the same sums in another order,
over up to 120 rounds), bf16 and f16 within one step of their own
precision (2^-7 and 2^-10 relative).  A value the port changed in place
after handing it out would differ from the JAX value, which cannot
change, so the aliasing cases (``nonblocking_handle_survives_buffer_
donation``, ``win_associated_p_copy_survives_donation``) read every
handed-out tensor again after the later ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology_util as jtu
from bluefog_tpu import windows as jwin
from bluefog_tpu.core import basics as jbasics
from bluefog_tpu_torch import ops as tops
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core import basics as tbasics

torch.set_num_threads(1)
SIZE = 8
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 2.0 ** -7),
       "float16": (2.0 ** -10, 2.0 ** -10)}


class Side:
    """The window API, topology module and array helpers of one package."""

    def __init__(self, kind):
        self.kind = kind
        jax_side = kind == "jax"
        self.bf = jbf if jax_side else tbf
        self.tu = jtu if jax_side else ttu
        self.basics = jbasics if jax_side else tbasics

    def arr(self, a, dtype="float32"):
        a = np.asarray(a, np.float32)
        if self.kind == "jax":
            return jnp.asarray(a, getattr(jnp, dtype))
        return torch.from_numpy(a.copy()).to(getattr(torch, dtype))

    def np(self, x):
        if self.kind == "jax":
            return np.asarray(x).astype(np.float64)
        return x.detach().float().numpy().astype(np.float64)

    def dtype_name(self, x):
        return str(x.dtype).replace("torch.", "")

    def tree_map(self, fn, tree):
        return jax.tree_util.tree_map(fn, tree) if self.kind == "jax" else tops.tree_map(fn, tree)

    def leaves(self, tree):
        return (jax.tree_util.tree_leaves(tree) if self.kind == "jax"
                else tops.tree_flatten(tree)[0])

    def ones_like(self, x):
        return jnp.ones_like(x) if self.kind == "jax" else torch.ones_like(x)

    def per_rank(self, p, a):  # p [SIZE] broadcast against a rank-major a
        return p.reshape((SIZE,) + (1,) * (a.ndim - 1))

    def raises(self, fn):
        try:
            fn()
        except ValueError:
            return True
        return False

    def rank_tensor(self, shape=(4,), dtype="float32"):
        r = np.arange(SIZE, dtype=np.float32).reshape((SIZE,) + (1,) * len(shape))
        return self.arr(np.broadcast_to(r, (SIZE,) + shape), dtype)

    def window_states(self):
        """Every window's full state, by window name."""
        out = {}
        for name, w in self.basics.context().windows.items():
            out[name] = {k: self.np(getattr(w, k))
                         for k in ("self_tensor", "mail", "versions", "p_self", "p_mail")}
            out[name]["dtype"] = self.dtype_name(w.self_tensor)
        return out


# ---------------------------------------------------------------------------
# Scenarios: one per test function of tests/test_win_ops.py, same op order
# ---------------------------------------------------------------------------


def win_create_free(s):
    x = s.rank_tensor()
    return {"calls": [s.bf.win_create(x, "w1"), s.bf.win_create(x, "w1"),
                      s.bf.win_free("w1"), s.bf.win_free("w1")]}


def win_create_requires_rank_major(s):
    return {"raises": s.raises(lambda: s.bf.win_create(s.arr(np.zeros((3, 2))), "bad"))}


def win_update_before_put_is_identity_average(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    s.bf.win_create(s.rank_tensor(), "w")
    return {"out": s.bf.win_update("w")}


def win_put_then_update_is_gossip_step(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    x = s.rank_tensor()
    s.bf.win_create(x, "w")
    s.bf.win_put(x, "w")
    return {"out": s.bf.win_update("w")}


def win_put_with_dst_weights(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    x = s.rank_tensor()
    s.bf.win_create(x, "w", zero_init=True)
    s.bf.win_put(x, "w", dst_weights=[{(r + 1) % SIZE: 2.0} for r in range(SIZE)])
    out = s.bf.win_update("w", self_weight=0.0,
                          neighbor_weights=[{(r - 1) % SIZE: 1.0} for r in range(SIZE)])
    return {"out": out}


def win_accumulate(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    x = s.arr(np.ones((SIZE, 2)))
    s.bf.win_create(x, "w", zero_init=True)
    s.bf.win_accumulate(x, "w")
    s.bf.win_accumulate(x, "w")
    nw = [{(r - 1) % SIZE: 1.0} for r in range(SIZE)]
    out = s.bf.win_update("w", self_weight=0.0, neighbor_weights=nw, reset=True)
    out2 = s.bf.win_update("w", self_weight=0.0, neighbor_weights=nw)
    return {"out": out, "out2": out2}


def win_get(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    s.bf.win_create(s.rank_tensor(), "w", zero_init=True)
    s.bf.win_get("w")
    out = s.bf.win_update("w", self_weight=0.0,
                          neighbor_weights=[{(r - 1) % SIZE: 1.0} for r in range(SIZE)])
    return {"out": out}


def win_version_tracking(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    x = s.rank_tensor()
    s.bf.win_create(x, "w")
    v0 = s.bf.get_win_version("w")
    s.bf.win_put(x, "w")
    s.bf.win_put(x, "w")
    return {"v0": v0, "v2": s.bf.get_win_version("w")}


def win_mutex_noop(s):
    x = s.rank_tensor()
    s.bf.win_create(x, "w")
    with s.bf.win_mutex("w"):
        s.bf.win_put(x, "w")
    return {}


def gossip_consensus_convergence(s):
    s.bf.set_topology(s.tu.ExponentialTwoGraph(SIZE))
    x = s.arr(np.random.default_rng(42).normal(size=(SIZE, 5)))
    s.bf.win_create(x, "w")
    cur = x
    for _ in range(25):
        s.bf.win_put(cur, "w")
        cur = s.bf.win_update("w")
    return {"cur": cur}


def push_sum_with_associated_p(s):
    s.bf.turn_on_win_ops_with_associated_p()
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    x = s.arr(np.random.default_rng(7).normal(size=(SIZE, 3)))
    s.bf.win_create(x, "w", zero_init=True)
    cur = x
    dst = [{(r + 1) % SIZE: 0.5} for r in range(SIZE)]
    ones_prev = [{(r - 1) % SIZE: 1.0} for r in range(SIZE)]
    for _ in range(60):
        s.bf.win_accumulate(cur, "w", dst_weights=dst)
        cur = s.bf.win_update("w", self_weight=0.5, neighbor_weights=ones_prev, reset=True)
    return {"cur": cur, "p": s.bf.win_associated_p("w")}


def _put_update_fused(s, accumulate):
    s.bf.turn_on_win_ops_with_associated_p()
    s.bf.set_topology(s.tu.ExponentialTwoGraph(SIZE))
    x = s.rank_tensor((3,))
    dst = [{d: 0.5 for d in s.tu.GetSendWeights(s.tu.ExponentialTwoGraph(SIZE), r)[1]}
           for r in range(SIZE)]
    s.bf.win_create(x, "seq", zero_init=True)
    (s.bf.win_accumulate if accumulate else s.bf.win_put)(x, "seq", dst_weights=dst)
    expected = s.bf.win_update("seq", self_weight=0.25)
    obs = {"expected": expected, "ver_seq": s.bf.get_win_version("seq"),
           "p_seq": s.bf.win_associated_p("seq")}
    s.bf.win_create(x, "fused", zero_init=True)
    obs["got"] = s.bf.win_put_update(x, "fused", dst_weights=dst, self_weight=0.25,
                                     accumulate=accumulate)
    obs["ver_fused"] = s.bf.get_win_version("fused")
    obs["p_fused"] = s.bf.win_associated_p("fused")
    return obs


def win_set_exposed_debias_restart(s):
    s.bf.turn_on_win_ops_with_associated_p()
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    x = s.rank_tensor()
    s.bf.win_create(x, "w")
    s.bf.win_set_exposed("w", s.ones_like(x) * 7.0, associated_p=1.0)
    out = s.bf.win_update("w", self_weight=1.0, neighbor_weights=[{} for _ in range(SIZE)])
    return {"out": out, "p": s.bf.win_associated_p("w"),
            "raises": s.raises(lambda: s.bf.win_set_exposed("w", s.arr(np.ones((SIZE, 99)))))}


def selective_win_put_touches_only_listed_ranks(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    x = s.rank_tensor()
    s.bf.win_create(x, "w", zero_init=True)
    s.bf.win_put(x, "w", dst_weights=[{1: 1.0}] + [{} for _ in range(SIZE - 1)])
    ver = s.bf.get_win_version("w")
    topo = s.bf.load_topology()
    out = s.bf.win_update("w", self_weight=0.0, neighbor_weights=[
        {n: 1.0 for n in s.tu.GetRecvWeights(topo, r)[1]} for r in range(SIZE)])
    return {"ver": ver, "out": out}


def win_put_refreshes_exposure_for_win_get(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    x = s.rank_tensor()
    s.bf.win_create(x, "w", zero_init=True)
    s.bf.win_put(x + 100.0, "w", dst_weights=[{} for _ in range(SIZE)])  # no deposit
    s.bf.win_get("w")
    out = s.bf.win_update("w", self_weight=0.0,
                          neighbor_weights=[{(r - 1) % SIZE: 1.0} for r in range(SIZE)])
    return {"out": out}


def _dtype_matrix(s, dtype):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    x = s.rank_tensor((3,), dtype)
    s.bf.win_create(x, "wdt")
    s.bf.win_put(x, "wdt")
    out = s.bf.win_update("wdt")
    obs = {"out": out, "dtype": s.dtype_name(out), "state": s.window_states()}
    s.bf.win_free("wdt")
    return obs


def fused_pytree_window_gossip(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    tree = {"w": s.rank_tensor((3, 2)), "b": s.rank_tensor((5,))}
    obs = {"created": s.bf.win_create(tree, "fused")}
    s.bf.win_put(tree, "fused")
    out = s.bf.win_update("fused")
    obs.update(out_w=out["w"], out_b=out["b"], keys=sorted(out))
    s.bf.win_create(tree["w"], "solo")
    s.bf.win_put(tree["w"], "solo")
    obs["solo"] = s.bf.win_update("solo")
    merged = s.bf.win_put_update(out, "fused")
    obs.update(merged_w=merged["w"], merged_b=merged["b"], state=s.window_states())
    s.bf.win_free("fused")
    s.bf.win_free("solo")
    return obs


def fused_window_structure_and_dtype_errors(s):
    tree = {"a": s.rank_tensor((2,)), "b": s.rank_tensor((2,))}
    s.bf.win_create(tree, "f2")
    wrong = s.raises(lambda: s.bf.win_put({"a": s.rank_tensor((2,))}, "f2"))
    s.bf.win_free("f2")
    mixed = {"a": s.rank_tensor((2,)), "b": s.arr(np.zeros((SIZE, 2)), "bfloat16")}
    return {"wrong_structure": wrong,
            "mixed_dtypes": s.raises(lambda: s.bf.win_create(mixed, "f3"))}


def fused_window_push_sum_associated_p(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE, connect_style=1))
    s.bf.turn_on_win_ops_with_associated_p()
    tree = {"x": s.rank_tensor((4,)), "y": s.rank_tensor((2, 2))}
    s.bf.win_create(tree, "ps", zero_init=True)
    vals = tree
    dst = [{(r + 1) % SIZE: 0.5} for r in range(SIZE)]
    ones_prev = [{(r - 1) % SIZE: 1.0} for r in range(SIZE)]
    for _ in range(120):
        s.bf.win_accumulate(vals, "ps", dst_weights=dst)
        m = s.bf.win_update("ps", self_weight=0.5, neighbor_weights=ones_prev, reset=True)
        p = s.bf.win_associated_p("ps")
        vals = s.tree_map(lambda a: a / s.per_rank(p, a), m)
        s.bf.win_set_exposed("ps", vals, associated_p=1.0)
    obs = {f"leaf{i}": a for i, a in enumerate(s.leaves(vals))}
    obs["state"] = s.window_states()
    s.bf.win_free("ps")
    return obs


def nonblocking_handle_survives_buffer_donation(s):
    s.bf.set_topology(s.tu.ExponentialTwoGraph(SIZE))
    x = s.rank_tensor((4,))
    s.bf.win_create(x, "hnb")
    h1 = s.bf.win_put_nonblocking(x, "hnb")
    s.bf.win_put(x + 1.0, "hnb")
    first = s.bf.win_update("hnb")  # handed out, then the window moves on
    polled = h1.poll() in (True, False)
    h1.wait()
    h2 = s.bf.win_accumulate_nonblocking(x, "hnb")
    second = s.bf.win_put_update(x, "hnb")
    h2.wait()
    obs = {"polled": polled, "state": s.window_states(), "second": second,
           "first": first}  # read after every later op
    s.bf.win_free("hnb")
    return obs


def win_associated_p_copy_survives_donation(s):
    s.bf.set_topology(s.tu.RingGraph(SIZE))
    s.bf.turn_on_win_ops_with_associated_p()
    s.bf.win_create(s.rank_tensor((4,)), "pd")
    s.bf.win_put(s.rank_tensor((4,)), "pd")
    p = s.bf.win_associated_p("pd")
    s.bf.win_put_update(s.rank_tensor((4,)), "pd")
    obs = {"p": p, "state": s.window_states()}  # p read after the later op
    s.bf.win_free("pd")
    return obs


SCENARIOS = {
    "win_create_free": win_create_free,
    "win_create_requires_rank_major": win_create_requires_rank_major,
    "win_update_before_put_is_identity_average": win_update_before_put_is_identity_average,
    "win_put_then_update_is_gossip_step": win_put_then_update_is_gossip_step,
    "win_put_with_dst_weights": win_put_with_dst_weights,
    "win_accumulate": win_accumulate,
    "win_get": win_get,
    "win_version_tracking": win_version_tracking,
    "win_mutex_noop": win_mutex_noop,
    "gossip_consensus_convergence": gossip_consensus_convergence,
    "push_sum_with_associated_p": push_sum_with_associated_p,
    "win_put_update_fused_matches_sequential[put]": lambda s: _put_update_fused(s, False),
    "win_put_update_fused_matches_sequential[accumulate]": lambda s: _put_update_fused(s, True),
    "win_set_exposed_debias_restart": win_set_exposed_debias_restart,
    "selective_win_put_touches_only_listed_ranks": selective_win_put_touches_only_listed_ranks,
    "win_put_refreshes_exposure_for_win_get": win_put_refreshes_exposure_for_win_get,
    "win_put_update_dtype_matrix[bfloat16]": lambda s: _dtype_matrix(s, "bfloat16"),
    "win_put_update_dtype_matrix[float16]": lambda s: _dtype_matrix(s, "float16"),
    "win_put_update_dtype_matrix[float32]": lambda s: _dtype_matrix(s, "float32"),
    "fused_pytree_window_gossip": fused_pytree_window_gossip,
    "fused_window_structure_and_dtype_errors": fused_window_structure_and_dtype_errors,
    "fused_window_push_sum_associated_p": fused_window_push_sum_associated_p,
    "nonblocking_handle_survives_buffer_donation": nonblocking_handle_survives_buffer_donation,
    "win_associated_p_copy_survives_donation": win_associated_p_copy_survives_donation,
}


def _run(kind, scenario):
    s = Side(kind)
    if kind == "jax":
        jbf.init(local_size=2)
    else:
        tbf.init(size=SIZE, device="cpu")
    try:
        obs = scenario(s)
        obs.setdefault("state", s.window_states())
        return _plain(s, obs)
    finally:
        s.bf.win_free()
        s.bf.turn_off_win_ops_with_associated_p()
        s.bf.shutdown()


def _plain(s, obj):
    """Observations as numpy arrays (with their dtype name) and host values."""
    if isinstance(obj, dict):
        return {k: _plain(s, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(s, v) for v in obj]
    if isinstance(obj, (jax.Array, torch.Tensor)):
        return ("array", s.dtype_name(obj), s.np(obj))
    return obj


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        dtype = want.get("dtype", "float32")
        for k in want:
            _assert_same(got[k], want[k] if k != "dtype" else want[k], f"{where}.{k}")
            if isinstance(want[k], np.ndarray):  # a window's state array
                rtol, atol = TOL[dtype]
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                           err_msg=f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, tuple) and want[0] == "array":
        assert got[1] == want[1], f"{where}: dtype {got[1]} vs {want[1]}"
        rtol, atol = TOL[want[1]] if want[1] in TOL else TOL["float32"]
        np.testing.assert_allclose(got[2], want[2], rtol=rtol, atol=atol, err_msg=where)
    elif not isinstance(want, np.ndarray):
        assert got == want, f"{where}: {got} vs {want}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_window_scenario_matches_reference(devices, name):
    want = _run("jax", SCENARIOS[name])
    got = _run("torch", SCENARIOS[name])
    _assert_same(got, want, name)


def test_scenarios_cover_every_reference_test():
    """One scenario (or one per parameter) for each test of test_win_ops.py."""
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "test_win_ops.py")
    with open(path) as fh:
        tests = {n.name[len("test_"):] for n in ast.parse(fh.read()).body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    covered = {k.split("[")[0] for k in SCENARIOS}
    assert tests == covered, tests ^ covered
    assert len(tests) == 21


def test_push_sum_conserves_mass_and_reaches_the_mean():
    """The README's directed-ring push-sum on the port alone: after each
    win_update (before any restart) sum p = n and the un-debiased values
    sum to what was sent; x / p reaches the mean."""
    tbf.init(ttu.RingGraph(SIZE, connect_style=1), size=SIZE, device="cpu")
    try:
        tbf.turn_on_win_ops_with_associated_p()
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(SIZE, 5)).astype(np.float32))
        tbf.win_create(x, "ps", zero_init=True)
        dst = [{(r + 1) % SIZE: 0.5} for r in range(SIZE)]
        prev = [{(r - 1) % SIZE: 1.0} for r in range(SIZE)]
        cur = x
        for _ in range(150):  # the directed ring mixes at cos(pi/8) ~ 0.92 a round
            sent = cur.double().sum(0)
            tbf.win_accumulate(cur, "ps", dst_weights=dst)
            cur = tbf.win_update("ps", self_weight=0.5, neighbor_weights=prev, reset=True)
            p = tbf.win_associated_p("ps")
            assert abs(p.double().sum().item() - SIZE) < 1e-5
            torch.testing.assert_close(cur.double().sum(0), sent, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cur / p[:, None], x.mean(0).expand(SIZE, 5),
                                   rtol=0, atol=1e-3)
    finally:
        tbf.shutdown()


def test_record_win_ops_and_unknown_window():
    tbf.init(size=SIZE, device="cpu")
    try:
        x = torch.zeros(SIZE, 2)
        with tbf.record_win_ops() as log:
            tbf.win_create(x, "r")
            tbf.win_put(x, "r")
            tbf.win_update("r")
            tbf.win_free()
        assert log == [("win_create", "r"), ("win_put", "r"), ("win_update", "r"),
                       ("win_free", "*")]
        with pytest.raises(KeyError, match="no window named"):
            tbf.win_put(x, "r")
    finally:
        tbf.shutdown()


def test_degraded_update_weights_match_reference(devices):
    jbf.init(local_size=2)
    try:
        jbf.set_topology(jtu.ExponentialTwoGraph(SIZE))
        want = jwin.degraded_update_weights(jbasics.context().plan, [3, 5])
    finally:
        jbf.shutdown()
    tbf.init(ttu.ExponentialTwoGraph(SIZE), size=SIZE, device="cpu")
    try:
        got = tbf.degraded_update_weights(tbasics.context().plan, [3, 5])
    finally:
        tbf.shutdown()
    assert got == want


def test_shutdown_frees_every_window():
    tbf.init(size=SIZE, device="cpu")
    tbf.win_create(torch.zeros(SIZE, 2), "a")
    ctx = tbasics.context()
    tbf.shutdown()
    assert ctx.windows == {} and ctx.win_fusion == {}


def _winput_grads(params, A, c):
    """Quadratic gradients A_r (w_r - c_r) and b_r - c_r[:3], in numpy f32."""
    w, b = params
    return (np.einsum("rij,rj->ri", A, w - c).astype(np.float32),
            (b - c[:, :3]).astype(np.float32))


@pytest.mark.parametrize("fuse,k", [(True, 1), (False, 1), (True, 2)])
def test_winput_optimizer_matches_reference(devices, fuse, k):
    """DistributedWinPutOptimizer (momentum SGD, then win_put + win_update
    on ExponentialTwoGraph(8)) for 5 steps: the port's parameters against
    the JAX optimizer's, rtol 1e-5 / atol 1e-6, fed the same numpy
    gradients of per-rank quadratics."""
    import optax

    rng = np.random.default_rng(9)
    M = rng.normal(size=(SIZE, 6, 6))
    A = (M @ M.transpose(0, 2, 1) / 6 + np.eye(6)).astype(np.float32)
    c = rng.normal(size=(SIZE, 6)).astype(np.float32)
    w0 = rng.normal(size=(SIZE, 6)).astype(np.float32)
    b0 = rng.normal(size=(SIZE, 3)).astype(np.float32)
    steps, lr = 5, 0.1

    jbf.init()
    try:
        opt = jbf.DistributedWinPutOptimizer(optax.sgd(lr, momentum=0.9), fuse=fuse,
                                             num_steps_per_communication=k)
        params = {"b": jnp.asarray(b0), "w": jnp.asarray(w0)}
        state = opt.init(params)
        for _ in range(steps):
            gw, gb = _winput_grads((np.asarray(params["w"]), np.asarray(params["b"])), A, c)
            params, state = opt.step(params, {"b": jnp.asarray(gb), "w": jnp.asarray(gw)},
                                     state)
        want = {k_: np.asarray(v) for k_, v in params.items()}
        opt.free()
    finally:
        jbf.shutdown()

    tbf.init(size=SIZE, device="cpu")
    try:
        params = {"b": torch.from_numpy(b0.copy()).requires_grad_(),
                  "w": torch.from_numpy(w0.copy()).requires_grad_()}
        opt = tbf.DistributedWinPutOptimizer(
            torch.optim.SGD(params.values(), lr=lr, momentum=0.9), fuse=fuse,
            num_steps_per_communication=k)
        assert len(tbasics.context().windows) == (1 if fuse else 2)
        for _ in range(steps):
            gw, gb = _winput_grads((params["w"].detach().numpy(),
                                    params["b"].detach().numpy()), A, c)
            params["w"].grad, params["b"].grad = torch.from_numpy(gw), torch.from_numpy(gb)
            opt.step()
        opt.free()
        assert tbasics.context().windows == {}
    finally:
        tbf.shutdown()
    for name, w in want.items():
        np.testing.assert_allclose(params[name].detach().numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
