"""Decentralized optimizers (counterpart of ``bluefog_tpu/optim.py``).

The JAX package writes each algorithm as an optax transform run inside the
jitted step.  Here each wraps a ``torch.optim`` optimizer whose parameters
are rank-major leaves ``[N, ...]``; because the usual optimizers are
elementwise, one optimizer over the stacked leaves equals a separate one
per rank.

  ATC  (adapt-then-combine):  w_{t+1} = W (w_t - a u_t)
  AWC  (adapt-with-combine):  w_{t+1} = W w_t - a u_t
  Gradient allreduce:         u_t from globally averaged gradients.
  Win-put:                    w_{t+1} = win_update(win_put(w_t - a u_t)),
                              the one-sided window round.

The combine updates the parameters in place under ``no_grad``.  An ATC /
AWC optimizer built without a plan reads the installed topology's plan
(and, for the hierarchical communication, the machine plan) at every
step, as the reference's ``_transform`` does, so ``set_topology`` between
steps takes effect; ``step(plan=)`` overrides the plan for one step.  Every step counts in the
``optim.steps`` telemetry counter and runs inside an
``optimizer_step_<mode>_<comm>`` timeline span.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import ops, topology_util, windows
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.plan import CommPlan, plan_from_neighbor_lists
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.timeline import timeline_context

__all__ = [
    "CommunicationType",
    "broadcast_optimizer_state",
    "broadcast_parameters",
    "make_comm_fn",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer",
    "DistributedGradientAllreduceOptimizer",
    "DistributedWinPutOptimizer",
    "TraceSGD",
    "Adafactor",
    "one_peer_plan_schedule",
]


class CommunicationType(enum.Enum):
    allreduce = "allreduce"
    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    empty = "empty"


CommFn = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def _check_fuse(comm_type: CommunicationType, fuse: bool) -> None:
    if fuse and comm_type != CommunicationType.neighbor_allreduce:
        raise ValueError(
            f"fuse=True is only implemented for neighbor_allreduce, not {comm_type}")


def make_comm_fn(comm_type: CommunicationType, plan: Optional[CommPlan] = None,
                 fuse: bool = False, machine_plan: Optional[CommPlan] = None) -> CommFn:
    """The communication function for a CommunicationType: a list of
    rank-major tensors in, the combined list out."""
    _check_fuse(comm_type, fuse)
    if comm_type == CommunicationType.empty:
        return lambda xs: xs
    if comm_type == CommunicationType.allreduce:
        return lambda xs: ops.allreduce(xs, average=True)
    if comm_type == CommunicationType.neighbor_allreduce:
        if plan is None:
            raise ValueError("neighbor_allreduce needs a CommPlan")
        return lambda xs: ops.neighbor_allreduce_plan(xs, plan, fuse=fuse)
    if comm_type == CommunicationType.hierarchical_neighbor_allreduce:
        if machine_plan is None:
            raise ValueError("hierarchical_neighbor_allreduce needs a machine CommPlan")
        return lambda xs: ops.hierarchical_neighbor_allreduce_plan(xs, machine_plan)
    raise ValueError(f"unknown communication type {comm_type}")


class _DistributedOptimizer:
    """Wraps ``base`` (a ``torch.optim.Optimizer`` over rank-major leaves);
    ``step()`` runs the local update and the communication.  ``plan`` /
    ``machine_plan`` fix the plans; left None, each step reads them from
    the context."""

    _mode = "atc"

    def __init__(self, base: torch.optim.Optimizer,
                 communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
                 plan: Optional[CommPlan] = None,
                 num_steps_per_communication: int = 1, fuse: bool = False,
                 machine_plan: Optional[CommPlan] = None):
        _check_fuse(communication_type, fuse)
        self.base = base
        self.communication_type = communication_type
        self.plan, self.machine_plan, self.fuse = plan, machine_plan, fuse
        self.k = max(1, int(num_steps_per_communication))
        self.steps = 0
        self.params = [p for group in base.param_groups for p in group["params"]]

    def _comm(self, plan: Optional[CommPlan]) -> CommFn:
        """This step's communication: ``plan`` (the one-step override), the
        fixed plans, or the context's current ones."""
        comm = self.communication_type
        if plan is not None:
            if comm != CommunicationType.neighbor_allreduce:
                raise ValueError("per-step plan override requires neighbor_allreduce")
            world = basics.context().size
            if plan.size != world:
                raise ValueError(f"plan is for {plan.size} ranks, the context has {world}")
        elif comm == CommunicationType.neighbor_allreduce:
            plan = self.plan or basics.context().plan
        mplan = self.machine_plan
        if mplan is None and comm == CommunicationType.hierarchical_neighbor_allreduce:
            mplan = basics.context().machine_plan
        return make_comm_fn(comm, plan, self.fuse, mplan)

    def _communicates(self) -> bool:
        # every k-th call, as the JAX package's _every_k
        return (self.steps + 1) % self.k == 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def step(self, plan: Optional[CommPlan] = None) -> None:
        """One step: the local update and (every k-th step) the
        communication, over ``plan`` for this step where given."""
        comm = self._comm(plan)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("optim.steps", optimizer=self._mode,
                        comm=self.communication_type.name).inc()
        with timeline_context(f"optimizer_step_{self._mode}_{self.communication_type.name}"):
            self._step(comm if self._communicates() else None)
        self.steps += 1


class DistributedAdaptThenCombineOptimizer(_DistributedOptimizer):
    """ATC: local step, then neighbor-combine the adapted parameters."""

    _mode = "atc"

    def _step(self, comm: Optional[CommFn]) -> None:
        self.base.step()
        if comm is not None:
            with torch.no_grad():
                for p, c in zip(self.params, comm([p.detach() for p in self.params])):
                    p.copy_(c)


class DistributedAdaptWithCombineOptimizer(_DistributedOptimizer):
    """AWC: ``w <- comm(w) + u`` with u the local update computed at w."""

    _mode = "awc"

    def _step(self, comm: Optional[CommFn]) -> None:
        deltas = None
        if comm is not None:
            with torch.no_grad():
                combined = comm([p.detach() for p in self.params])
                deltas = [c.to(p.dtype) - p for p, c in zip(self.params, combined)]
        self.base.step()
        if deltas is not None:
            with torch.no_grad():
                for p, dlt in zip(self.params, deltas):
                    p.add_(dlt)


class DistributedGradientAllreduceOptimizer(_DistributedOptimizer):
    """Synchronous data parallelism: gradients averaged over ranks before the
    local step (the baseline the gossip modes are compared with).  Its
    telemetry and timeline labels say ``atc``, as the reference's do."""

    def __init__(self, base: torch.optim.Optimizer, num_steps_per_communication: int = 1):
        super().__init__(base, CommunicationType.allreduce,
                         num_steps_per_communication=num_steps_per_communication)

    def _step(self, comm: Optional[CommFn]) -> None:
        if comm is not None:
            with torch.no_grad():
                with_grad = [p for p in self.params if p.grad is not None]
                for p, g in zip(with_grad, comm([p.grad for p in with_grad])):
                    p.grad.copy_(g)
        self.base.step()


class DistributedWinPutOptimizer:
    """The win-put optimizer: each step runs the local update of ``base``,
    then deposits the parameters at the out-neighbors with ``win_put`` and
    merges the mailbox with ``win_update``; no global reduction.  With
    ``fuse`` (the default) the leaves of one dtype share one window, so a
    round is one :func:`windows.win_put_update` per dtype group; without it
    every leaf has its own window.  The windows are created here, from the
    parameters' current values, under ``window_prefix``; :meth:`free`
    releases them."""

    def __init__(self, base: torch.optim.Optimizer, window_prefix: str = "winput_opt",
                 num_steps_per_communication: int = 1, fuse: bool = True):
        self.base = base
        self.prefix = window_prefix
        self.k = max(1, int(num_steps_per_communication))
        self.fuse = fuse
        self.steps = 0
        self.params = [p for group in base.param_groups for p in group["params"]]
        if fuse:
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i, p in enumerate(self.params):
                by_dtype.setdefault(p.dtype, []).append(i)
            self._groups = [(f"{self.prefix}.fused{g}", idxs) for g, (_, idxs) in
                            enumerate(sorted(by_dtype.items(), key=lambda kv: str(kv[0])))]
        else:
            self._groups = [(f"{self.prefix}.{i}", [i]) for i in range(len(self.params))]
        for name, idxs in self._groups:
            leaves = [self.params[i].detach() for i in idxs]
            if not windows.win_create(leaves if fuse else leaves[0], name):
                raise RuntimeError(
                    f"window {name!r} already exists: two optimizers share "
                    f"window_prefix={self.prefix!r}, or a prior one was not freed")
        self._created = True

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        self.base.step()
        self.steps += 1
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("optim.steps", optimizer="winput").inc()
        if self.steps % self.k:
            return
        if reg.enabled:
            reg.counter("optim.gossip_rounds", optimizer="winput").inc()
        with torch.no_grad():
            for name, idxs in self._groups:
                leaves = [self.params[i].detach() for i in idxs]
                if self.fuse:
                    parts = windows.win_put_update(leaves, name)
                else:
                    windows.win_put(leaves[0], name)  # also refreshes the exposure
                    parts = [windows.win_update(name)]
                for i, part in zip(idxs, parts):
                    self.params[i].copy_(part)

    def close(self) -> None:
        """Nothing to drain: the emulation has no background pipeline.  Kept
        so teardown written for the reference (``finish`` / ``close`` /
        ``free``) runs unchanged."""

    def finish(self, params):
        """``close()``, then ``params`` unchanged (no pipeline to apply)."""
        self.close()
        return params

    def free(self) -> None:
        """Release this optimizer's windows."""
        self.close()
        if self._created:
            ctx = basics.context()
            for name in [n for n in ctx.windows if n.startswith(self.prefix + ".")]:
                windows.win_free(name)
            self._created = False


def one_peer_plan_schedule(size: int) -> List[CommPlan]:
    """The exp-2 one-peer rotation as a list of plans to cycle through
    (``plans[t % len(plans)]``): each plan is one shift class, log2(size)
    plans in all."""
    if size <= 1:
        return [plan_from_neighbor_lists(size, [[] for _ in range(size)])]
    nbits = max(1, int(math.ceil(math.log2(size))))
    gens = [topology_util.GetDynamicOnePeerSendRecvRanks(size, r) for r in range(size)]
    return [plan_from_neighbor_lists(size, [next(g)[1] for g in gens]) for _ in range(nbits)]


class TraceSGD(torch.optim.Optimizer):
    """Momentum SGD with optax's trace semantics and its ``accumulator_dtype``
    (``optax.sgd(lr, momentum, accumulator_dtype=trace_dtype)``; the
    reference's ``sgdm_bf16`` base optimizer takes ``torch.bfloat16``).  Per
    parameter ``p`` with gradient ``g`` and trace ``t`` (zeros at start, in
    ``trace_dtype``, or ``p``'s dtype when None)::

        new = g + m' * t    # in g's dtype (f32)
        p  += -lr * new
        t   = new           # stored in trace_dtype

    ``m'`` is the momentum rounded to the trace's dtype (JAX's weak typing:
    0.9 becomes 0.8984375 in bf16), and the product is not rounded to it:
    XLA drops that rounding in the jitted step, where every train step of
    the reference runs its update.  ``torch.optim.SGD`` keeps its buffer in
    the parameter's dtype, so it cannot hold a bf16 trace for f32
    parameters."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 trace_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(lr=lr, momentum=momentum, trace_dtype=trace_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p, dtype=group["trace_dtype"] or p.dtype)
                trace = state["trace"]
                m = torch.tensor(group["momentum"], dtype=trace.dtype).item()
                new = trace.to(p.grad.dtype, copy=True).mul_(m).add_(p.grad)
                trace.copy_(new)
                p.add_(new.mul_(-group["lr"]))
        return loss


def _rank_mean(x: torch.Tensor) -> torch.Tensor:
    """Each rank's mean of rank-major ``x [n, ...]``, shaped to broadcast
    against ``x`` (a per-rank scalar leaf is its own mean)."""
    return x.reshape(x.shape[0], -1).mean(1).view((-1,) + (1,) * (x.dim() - 1))


def _factored_dims(shape: Sequence[int], min_dim: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` on a per-rank shape: the two largest dims
    ``(d1, d0)`` by ``np.argsort``, or None below two dims or where the
    second largest is under ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults (optax 0.2.6), over
    rank-major leaves ``[n, ...]``: each rank's slice is updated as optax
    updates that rank's leaf, and no rank's update reads another rank's
    gradient.  Per leaf, with ``t`` the step (0 first)::

        beta  = 1 - (t + 1)^-0.8
        G     = g^2 + 1e-30
        factored (the per-rank leaf's two largest dims d1, d0 by
        np.argsort, the second at least 128):
            v_row = beta v_row + (1 - beta) mean_d0(G)
            v_col = beta v_col + (1 - beta) mean_d1(G)
            u = g (v_row / mean_d1(v_row))^-1/2 v_col^-1/2
        else:
            v = beta v + (1 - beta) G;  u = g v^-1/2
        u /= max(1, rms(u))                  # clip_by_block_rms(1.0)
        p -= lr u max(rms(p), 1e-3)          # scale_by_param_block_rms

    where every mean over a leaf and every rms is a rank's own, and the
    parameter's rms is taken before the update.  The state is kept in the
    parameter's dtype, as optax keeps it.  Since mean(v_row) = mean(v_col)
    the rule is unchanged when the leaf's axes are permuted (a torch
    ``[out, in]`` weight gets the update of its flax ``[in, out]`` kernel,
    transposed), but not when they are merged: ``shapes`` maps a leaf to
    the per-rank shape in which to factor it, a reshape of its own whose
    axes are the reference leaf's in some order (the Llama q, k and v
    weights ``[H * hd, d]`` as ``[H, hd, d]``, flax's ``[d, H, hd]``
    DenseGeneral kernels: :meth:`~bluefog_tpu_torch.models.transformer.LlamaLM.split_head_shapes`)."""

    DECAY, EPS, MIN_DIM_TO_FACTOR, CLIP, MIN_SCALE = 0.8, 1e-30, 128, 1.0, 1e-3

    def __init__(self, params, lr: float,
                 shapes: Optional[Mapping[torch.Tensor, Sequence[int]]] = None):
        super().__init__(params, dict(lr=lr))
        self._shapes = {id(p): tuple(int(d) for d in s) for p, s in (shapes or {}).items()}
        for group in self.param_groups:
            for p in group["params"]:
                shape = self._shapes.get(id(p))
                if shape is not None and math.prod(shape) != p[0].numel():
                    raise ValueError(f"shapes: {shape} is not a reshape of the per-rank "
                                     f"shape {tuple(p.shape[1:])}")

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self._update(p, p.grad, group["lr"]))
        return loss

    def _update(self, p: torch.Tensor, grad: torch.Tensor, lr: float) -> torch.Tensor:
        n = p.shape[0]
        shape = self._shapes.get(id(p), tuple(p.shape[1:]))
        g = grad.reshape((n,) + shape)
        dims = _factored_dims(shape, self.MIN_DIM_TO_FACTOR)
        state = self.state[p]
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(g, dtype=p.dtype)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(g.select(d0 + 1, 0), dtype=p.dtype)
                state["v_col"] = torch.zeros_like(g.select(d1 + 1, 0), dtype=p.dtype)
        t = np.float32(state["step"] + 1)
        beta = float(np.float32(1.0) - t ** np.float32(-self.DECAY))
        state["step"] += 1
        g_sqr = g * g + self.EPS
        if dims is None:
            v = state["v"]
            v.copy_(beta * v + (1.0 - beta) * g_sqr)
            u = g * v ** -0.5
        else:
            d1, d0 = dims  # the per-rank dims; +1 on the rank-major leaf
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.copy_(beta * v_row + (1.0 - beta) * g_sqr.mean(d0 + 1))
            v_col.copy_(beta * v_col + (1.0 - beta) * g_sqr.mean(d1 + 1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1 + 1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0 + 1) * col_factor.unsqueeze(d1 + 1)
        u = u / torch.clamp_min(_rank_mean(u * u).sqrt() / self.CLIP, 1.0)
        u = u * lr
        rms = _rank_mean(p * p).sqrt()
        u = u.reshape(p.shape) * torch.where(rms <= self.MIN_SCALE, self.MIN_SCALE, rms)
        return u * -1.0


# --------------------------------------------------------------------------
# Parameter/state broadcast helpers
# --------------------------------------------------------------------------


def broadcast_parameters(params, root_rank: int = 0):
    """Give every rank the root's parameters (the reference's
    ``bf.broadcast_parameters``): a consistent initialization.  ``params``
    is a rank-major tensor or a dict / list / tuple of them; each takes the
    root's slice in place (leaves that require grad stay leaves), and
    ``params`` is returned."""
    with torch.no_grad():
        ops.tree_map(lambda a: a.copy_(ops.broadcast(a, root_rank=root_rank)), params)
    return params


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer, root_rank: int = 0) -> None:
    """The reference's ``bf.broadcast_optimizer_state`` for a ``torch.optim``
    optimizer over rank-major leaves: every rank-major tensor of its state
    (momentum buffers, Adam moments) takes the root's slice, in place;
    scalars (step counts) are shared by all ranks already."""
    with torch.no_grad():
        for state in optimizer.state.values():
            for value in state.values():
                if isinstance(value, torch.Tensor) and value.dim() >= 1:
                    value.copy_(ops.broadcast(value, root_rank=root_rank))
