"""Exact decentralized algorithms: gradient tracking, EXTRA, Push-DIGing.

Counterpart of ``bluefog_tpu/algorithms.py``.  Plain gossip SGD (ATC /
AWC) converges to a neighborhood of the optimum when ranks hold
heterogeneous data; these three reach the centralized optimum at a
constant step on smooth strongly convex objectives.

Each is a functional ``(init, update)`` pair on rank-major tensor trees
(a tensor, or a dict / list / tuple of tensors, every leaf ``[N, ...]``),
the twin of the JAX package's optax transforms: ``update(grads, state,
params) -> (updates, state)``, and the new parameters are ``params +
updates``.  Each round is one fused ``neighbor_allreduce`` of everything
that mixes (iterate, tracker and, for Push-DIGing, the push weight).

- :func:`gradient_tracking` (``gradient_tracking_spmd``): the tracker
  ``y^k = W y^{k-1} + g^k - g^{k-1}`` and ``x^{k+1} = W (x^k - lr y^k)``.
  Needs a doubly stochastic W (the built-in undirected topologies).
- :func:`extra` (``extra_spmd``): ``x^{k+1} = 2 Wt x^k - Wt x^{k-1} -
  lr (g^k - g^{k-1})`` with ``Wt = (I + W) / 2`` and ``x^1 = Wt x^0 - lr
  g^0``.
- :func:`push_diging` (``push_diging_spmd``): gradient tracking over a
  column-stochastic plan (:func:`column_stochastic_plan`) with a push-sum
  weight v that debiases the iterate, ``x = u / v``; for directed graphs.

The eager classes run them on the installed topology:
``opt.init(params) -> state`` and ``opt.step(params, grads, state) ->
(params, state)``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from bluefog_tpu_torch import ops
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.plan import CommPlan, plan_from_neighbor_lists

__all__ = [
    "Transform",
    "column_stochastic_plan",
    "gradient_tracking",
    "extra",
    "push_diging",
    "DistributedGradientTrackingOptimizer",
    "DistributedEXTRAOptimizer",
    "DistributedPushDIGingOptimizer",
]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    flat = [ops.tree_flatten(t) for t in trees]
    spec = flat[0][1]
    return ops.tree_unflatten(spec, [fn(*ls) for ls in zip(*(f[0] for f in flat))])


def column_stochastic_plan(topology) -> CommPlan:
    """Column-stochastic mixing plan of a (directed) graph: sender s splits
    its mass uniformly over its out-neighbors and itself, ``C[d, s] = 1 /
    (out_deg(s) + 1)``, so every column sums to 1."""
    size = topology.number_of_nodes()
    out_deg = {s: 0 for s in range(size)}
    src_lists = [[] for _ in range(size)]
    for s, d in topology.edges():
        if s == d:
            continue
        out_deg[int(s)] += 1
        src_lists[int(d)].append(int(s))
    src_weights = [{s: 1.0 / (out_deg[s] + 1) for s in src_lists[d]} for d in range(size)]
    self_weights = [1.0 / (out_deg[s] + 1) for s in range(size)]
    return plan_from_neighbor_lists(size, [sorted(s) for s in src_lists],
                                    src_weights=src_weights, self_weights=self_weights)


def _comm(plan: CommPlan):
    return lambda tree: ops.neighbor_allreduce_plan(tree, plan, fuse=True)


def _updates(x_new, params):
    return _map(lambda xn, p: (xn - p).to(p.dtype), x_new, params)


class _GTState(NamedTuple):
    cy: Any  # W y from the previous round (zeros before the first)
    prev_g: Any
    step: int


def gradient_tracking(learning_rate: float, plan: CommPlan) -> Transform:
    """ATC gradient tracking (DIGing family) over ``plan``, which must mix
    with a doubly stochastic matrix."""
    lr = float(learning_rate)
    comm = _comm(plan)

    def init(params):
        z = _map(torch.zeros_like, params)
        return _GTState(cy=z, prev_g=z, step=0)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("gradient tracking requires params")
        # y^k = W y^{k-1} + g^k - g^{k-1}   (y^0 = g^0)
        y = _map(lambda c, g, pg: c + g - pg, state.cy, grads, state.prev_g)
        # one fused round: the x-descent and the tracker share the plan
        x_new, cy = comm((_map(lambda p, yy: p - lr * yy, params, y), y))
        return _updates(x_new, params), _GTState(cy=cy, prev_g=grads, step=state.step + 1)

    return Transform(init, update)


class _ExtraState(NamedTuple):
    prev_wtx: Any  # Wt x^{k-1}
    prev_g: Any
    step: int


def extra(learning_rate: float, plan: CommPlan) -> Transform:
    """EXTRA with ``Wt = (I + W) / 2``; one round per step."""
    lr = float(learning_rate)
    comm = _comm(plan)

    def wt(tree):
        return _map(lambda m, t: 0.5 * (m + t), comm(tree), tree)

    def init(params):
        z = _map(torch.zeros_like, params)
        return _ExtraState(prev_wtx=z, prev_g=z, step=0)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("EXTRA requires params")
        wtx = wt(params)
        if state.step == 0:  # x^1 = Wt x^0 - lr g^0
            x_new = _map(lambda w, g: w - lr * g, wtx, grads)
        else:  # x^{k+1} = 2 Wt x^k - Wt x^{k-1} - lr (g^k - g^{k-1})
            x_new = _map(lambda w, pw, g, pg: 2.0 * w - pw - lr * (g - pg),
                         wtx, state.prev_wtx, grads, state.prev_g)
        return _updates(x_new, params), _ExtraState(prev_wtx=wtx, prev_g=grads,
                                                    step=state.step + 1)

    return Transform(init, update)


class _PushDigingState(NamedTuple):
    u: Any  # the raw (biased) iterate; params hold x = u / v
    v: torch.Tensor  # push-sum weight, [N, 1] f32
    cy: Any  # C y from the previous round
    prev_g: Any
    step: int


def push_diging(learning_rate: float, plan: CommPlan) -> Transform:
    """Push-DIGing over a column-stochastic plan: gradient tracking plus
    push-sum debiasing.  Gradients are taken at ``x = u / v``, which is
    what ``params`` hold."""
    lr = float(learning_rate)
    comm = _comm(plan)

    def init(params):
        leaf = ops.tree_flatten(params)[0][0]
        z = _map(torch.zeros_like, params)
        return _PushDigingState(
            u=_map(torch.clone, params),
            v=torch.ones(leaf.shape[0], 1, dtype=torch.float32, device=leaf.device),
            cy=z, prev_g=z, step=0)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("Push-DIGing requires params")
        # y^k = C y^{k-1} + g^k - g^{k-1}   (y^0 = g^0)
        y = _map(lambda c, g, pg: c + g - pg, state.cy, grads, state.prev_g)
        # one fused push round: the u-descent, the weight v and the tracker
        u_new, v_new, cy = comm((_map(lambda u, yy: u - lr * yy, state.u, y), state.v, y))
        x_new = _map(lambda u: u / v_new.view((-1,) + (1,) * (u.dim() - 1)), u_new)
        return _updates(x_new, params), _PushDigingState(
            u=u_new, v=v_new, cy=cy, prev_g=grads, step=state.step + 1)

    return Transform(init, update)


# --------------------------------------------------------------------------
# Eager classes on the installed topology
# --------------------------------------------------------------------------


class _EagerExactOptimizer:
    """One exact transform on the context's plan: ``init(params) -> state``,
    ``step(params, grads, state) -> (params, state)``."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)
        self._tx_key = None
        self._tx = None

    def _plan(self, ctx) -> CommPlan:
        return ctx.plan

    def _make_tx(self, plan: CommPlan) -> Transform:
        raise NotImplementedError

    def _transform(self) -> Transform:
        plan = self._plan(basics.context())
        if self._tx_key != plan:
            self._tx, self._tx_key = self._make_tx(plan), plan
        return self._tx

    def init(self, params):
        return self._transform().init(params)

    def step(self, params, grads, state):
        updates, state = self._transform().update(grads, state, params)
        return _map(lambda p, u: (p + u).to(p.dtype), params, updates), state


class DistributedGradientTrackingOptimizer(_EagerExactOptimizer):
    """Gradient tracking (DIGing) on the installed (undirected) topology."""

    def _make_tx(self, plan):
        return gradient_tracking(self.learning_rate, plan)


class DistributedEXTRAOptimizer(_EagerExactOptimizer):
    """EXTRA on the installed (undirected) topology."""

    def _make_tx(self, plan):
        return extra(self.learning_rate, plan)


class DistributedPushDIGingOptimizer(_EagerExactOptimizer):
    """Push-DIGing with column-stochastic weights from the installed
    topology, which may be a directed graph."""

    def _plan(self, ctx):
        return column_stochastic_plan(ctx.topology)

    def _make_tx(self, plan):
        return push_diging(self.learning_rate, plan)
