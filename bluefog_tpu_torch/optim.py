"""Decentralized optimizers (counterpart of ``bluefog_tpu/optim.py``).

The JAX package writes each algorithm as an optax transform run inside the
jitted step.  Here each wraps a ``torch.optim`` optimizer whose parameters
are rank-major leaves ``[N, ...]``; because the usual optimizers are
elementwise, one optimizer over the stacked leaves equals a separate one
per rank.

  ATC  (adapt-then-combine):  w_{t+1} = W (w_t - a u_t)
  AWC  (adapt-with-combine):  w_{t+1} = W w_t - a u_t
  Gradient allreduce:         u_t from globally averaged gradients.

The combine updates the parameters in place under ``no_grad``.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional

import torch

from bluefog_tpu_torch import ops
from bluefog_tpu_torch.core.plan import CommPlan

__all__ = [
    "CommunicationType",
    "make_comm_fn",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer",
    "DistributedGradientAllreduceOptimizer",
]


class CommunicationType(enum.Enum):
    allreduce = "allreduce"
    neighbor_allreduce = "neighbor.allreduce"
    empty = "empty"


CommFn = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def make_comm_fn(comm_type: CommunicationType, plan: Optional[CommPlan] = None,
                 fuse: bool = False) -> CommFn:
    """The communication function for a CommunicationType: a list of
    rank-major tensors in, the combined list out."""
    if fuse and comm_type != CommunicationType.neighbor_allreduce:
        raise ValueError(
            f"fuse=True is only implemented for neighbor_allreduce, not {comm_type}")
    if comm_type == CommunicationType.empty:
        return lambda xs: xs
    if comm_type == CommunicationType.allreduce:
        return lambda xs: ops.allreduce(xs, average=True)
    if comm_type == CommunicationType.neighbor_allreduce:
        if plan is None:
            raise ValueError("neighbor_allreduce needs a CommPlan")
        return lambda xs: ops.neighbor_allreduce(xs, plan, fuse=fuse)
    raise ValueError(f"unknown communication type {comm_type}")


class _DistributedOptimizer:
    """Wraps ``base`` (a ``torch.optim.Optimizer`` over rank-major leaves);
    ``step()`` runs the local update and the communication."""

    def __init__(self, base: torch.optim.Optimizer,
                 communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
                 plan: Optional[CommPlan] = None,
                 num_steps_per_communication: int = 1, fuse: bool = False):
        self.base = base
        self.comm = make_comm_fn(communication_type, plan, fuse)
        self.k = max(1, int(num_steps_per_communication))
        self.steps = 0
        self.params = [p for group in base.param_groups for p in group["params"]]

    def _communicates(self) -> bool:
        # every k-th call, as the JAX package's _every_k
        return (self.steps + 1) % self.k == 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)


class DistributedAdaptThenCombineOptimizer(_DistributedOptimizer):
    """ATC: local step, then neighbor-combine the adapted parameters."""

    def step(self) -> None:
        self.base.step()
        if self._communicates():
            with torch.no_grad():
                for p, c in zip(self.params, self.comm([p.detach() for p in self.params])):
                    p.copy_(c)
        self.steps += 1


class DistributedAdaptWithCombineOptimizer(_DistributedOptimizer):
    """AWC: ``w <- comm(w) + u`` with u the local update computed at w."""

    def step(self) -> None:
        deltas = None
        if self._communicates():
            with torch.no_grad():
                combined = self.comm([p.detach() for p in self.params])
                deltas = [c.to(p.dtype) - p for p, c in zip(self.params, combined)]
        self.base.step()
        if deltas is not None:
            with torch.no_grad():
                for p, dlt in zip(self.params, deltas):
                    p.add_(dlt)
        self.steps += 1


class DistributedGradientAllreduceOptimizer(_DistributedOptimizer):
    """Synchronous data parallelism: gradients averaged over ranks before the
    local step (the baseline the gossip modes are compared with)."""

    def __init__(self, base: torch.optim.Optimizer, num_steps_per_communication: int = 1):
        super().__init__(base, CommunicationType.allreduce,
                         num_steps_per_communication=num_steps_per_communication)

    def step(self) -> None:
        if self._communicates():
            with torch.no_grad():
                with_grad = [p for p in self.params if p.grad is not None]
                for p, g in zip(with_grad, self.comm([p.grad for p in with_grad])):
                    p.grad.copy_(g)
        self.base.step()
        self.steps += 1
