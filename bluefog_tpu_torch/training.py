"""Decentralized train step (counterpart of ``bluefog_tpu/training.py``).

Parameters are rank-major leaves ``[N, ...]`` with ``requires_grad``.  A
step runs every rank's forward and backward on its own slices through
``torch.func.functional_call`` (autograd writes rank r's gradient into
``P.grad[r]``), then one optimizer step over the stacked leaves and the
communication of the chosen mode.  Models with batch statistics (LeNet,
ResNet) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from bluefog_tpu_torch.core.plan import CommPlan
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedGradientAllreduceOptimizer,
)

__all__ = [
    "make_decentralized_train_step",
    "make_lm_loss_fns",
    "replicate_for_mesh",
    "softmax_cross_entropy",
]


def softmax_cross_entropy(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1))


def make_lm_loss_fns(model: nn.Module) -> Tuple[Callable, Callable]:
    """``(apply_fn, loss_fn)`` for LM pretraining with inputs as their own
    labels.  With ``head_chunks > 1`` the model computes the chunked loss
    itself and ``loss_fn`` is the identity; otherwise the model returns
    logits and ``loss_fn`` is the shifted cross-entropy."""
    if getattr(model, "head_chunks", 0) > 1:
        def apply_fn(params, ids, labels=None):
            return functional_call(model, params, (ids,),
                                   {"labels": ids if labels is None else labels})

        def loss_fn(out, labels):
            return out
    else:
        def apply_fn(params, ids, labels=None):
            return functional_call(model, params, (ids,))

        def loss_fn(logits, labels):
            return softmax_cross_entropy(logits[:, :-1], labels[:, 1:])

    return apply_fn, loss_fn


def replicate_for_mesh(tree: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """Replicate single-rank tensors into rank-major leaves ``[n, ...]`` that
    require grad."""
    return {k: v.detach().unsqueeze(0).repeat((n,) + (1,) * v.dim()).requires_grad_(True)
            for k, v in tree.items()}


def make_decentralized_train_step(
    apply_fn: Callable,
    params: Dict[str, torch.Tensor],
    base_optimizer: torch.optim.Optimizer,
    *,
    communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
    plan: Optional[CommPlan] = None,
    mode: str = "atc",
    loss_fn: Callable = softmax_cross_entropy,
    num_steps_per_communication: int = 1,
    comm_fuse: bool = False,
):
    """Build ``step_fn(batch, labels) -> losses [N]`` (f32, detached).

    ``params`` maps names to rank-major leaves; ``base_optimizer`` is a
    ``torch.optim`` optimizer constructed over exactly those leaves.
    ``batch``/``labels`` are rank-major ``[N, B, ...]``.  ``mode`` picks
    ATC or AWC for the neighbor modes; ``CommunicationType.allreduce``
    averages gradients instead.
    """
    leaves = {id(p) for g in base_optimizer.param_groups for p in g["params"]}
    if leaves != {id(p) for p in params.values()}:
        raise ValueError("base_optimizer must be built over exactly the params leaves")
    if communication_type == CommunicationType.allreduce:
        if comm_fuse:
            raise ValueError("comm_fuse=True is only implemented for neighbor_allreduce")
        opt = DistributedGradientAllreduceOptimizer(base_optimizer, num_steps_per_communication)
    else:
        cls = {"atc": DistributedAdaptThenCombineOptimizer,
               "awc": DistributedAdaptWithCombineOptimizer}[mode]
        opt = cls(base_optimizer, communication_type, plan,
                  num_steps_per_communication, comm_fuse)
    n = next(iter(params.values())).shape[0]

    def step_fn(batch, labels):
        opt.zero_grad(set_to_none=True)
        losses = []
        for r in range(n):
            p_r = {k: v[r] for k, v in params.items()}
            loss = loss_fn(apply_fn(p_r, batch[r], labels=labels[r]), labels[r])
            loss.backward()
            losses.append(loss.detach().float())
        opt.step()
        return torch.stack(losses)

    return step_fn
