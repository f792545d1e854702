"""Decentralized train step (counterpart of ``bluefog_tpu/training.py``).

Parameters are rank-major leaves ``[N, ...]`` with ``requires_grad``.  A
step runs every rank's forward and backward on its own slices through
``torch.func.functional_call`` (autograd writes rank r's gradient into
``P.grad[r]``), then one optimizer step over the stacked leaves and the
communication of the chosen mode.  Batch statistics (the ResNet's
BatchNorm buffers) are rank-major too and stay local to each rank, as in
the reference: rank r normalizes with its own batch and its model moves
its running averages in place in its own slice ``B[r]``; only parameters
are communicated.  Every call of a step counts in the ``train.steps``
telemetry counter (k for ``steps_per_call=k``) and runs inside a
``train_step`` timeline span.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from bluefog_tpu_torch.core.plan import CommPlan
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.timeline import timeline_context
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedGradientAllreduceOptimizer,
)

__all__ = [
    "apply_accepts_labels",
    "make_classifier_apply_fn",
    "make_decentralized_train_step",
    "make_lm_loss_fns",
    "replicate_for_mesh",
    "softmax_cross_entropy",
]


def apply_accepts_labels(apply_fn: Callable) -> bool:
    """True when ``apply_fn`` declares a ``labels`` parameter: the marker by
    which the train step hands the true targets to a model that computes
    its own loss (the chunked LM head).  A wrapper around such an apply_fn
    must keep the parameter, or the step stops passing the targets."""
    try:
        return "labels" in inspect.signature(apply_fn).parameters
    except (TypeError, ValueError):
        return False


def make_classifier_apply_fn(model: nn.Module) -> Callable:
    """``apply_fn(state, x) -> logits`` for an image classifier: ``state``
    holds one rank's parameters and, for a model with BatchNorm, its
    statistics buffers, which a model in training mode moves in place."""
    def apply_fn(state, x):
        return functional_call(model, state, (x,))

    return apply_fn


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


def replicate_for_mesh(tree: Dict[str, torch.Tensor], n: int,
                       requires_grad: bool = True) -> Dict[str, torch.Tensor]:
    """Replicate single-rank tensors into rank-major leaves ``[n, ...]``:
    parameters that require grad, or (``requires_grad=False``) buffers such
    as batch statistics."""
    return {k: v.detach().unsqueeze(0).repeat((n,) + (1,) * v.dim())
            .requires_grad_(requires_grad) for k, v in tree.items()}


def make_decentralized_train_step(
    apply_fn: Callable,
    params: Dict[str, torch.Tensor],
    base_optimizer: torch.optim.Optimizer,
    *,
    communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
    plan: Optional[CommPlan] = None,
    machine_plan: Optional[CommPlan] = None,
    mode: str = "atc",
    loss_fn: Callable = softmax_cross_entropy,
    num_steps_per_communication: int = 1,
    comm_fuse: bool = False,
    batch_stats: Optional[Dict[str, torch.Tensor]] = None,
    steps_per_call: int = 1,
):
    """Build ``step_fn(batch, labels) -> (losses [N], accuracy [N])`` (f32,
    detached).

    ``params`` maps names to rank-major leaves; ``base_optimizer`` is a
    ``torch.optim`` optimizer constructed over exactly those leaves.
    ``batch``/``labels`` are rank-major ``[N, B, ...]``.  ``mode`` picks
    ATC or AWC for the neighbor modes, which mix over ``plan``
    (``neighbor_allreduce``) or average each machine's ranks and mix the
    machines over ``machine_plan`` (``hierarchical_neighbor_allreduce``);
    each raises without its plan.  ``CommunicationType.allreduce``
    averages gradients instead.  ``steps_per_call=k`` runs k full steps a
    call on ``batch``/``labels`` with a leading ``[k]`` sub-step axis and
    returns the last sub-step's losses and accuracies.
    ``apply_fn(state, x)`` gets one rank's slices, plus ``labels=`` where
    it declares that parameter
    (:func:`apply_accepts_labels`).  ``batch_stats``, where given, maps
    buffer names to rank-major buffers ``[N, ...]``;
    rank r's slices join its parameters in ``state``, and a model in
    training mode updates them in place.  Accuracy is the share of argmax
    hits where ``apply_fn`` returns logits, NaN where it returns the loss
    itself.
    """
    stats = batch_stats or {}
    n = next(iter(params.values())).shape[0]
    if any(b.shape[0] != n for b in stats.values()):
        raise ValueError(f"batch_stats must be rank-major with {n} ranks")
    takes_labels = apply_accepts_labels(apply_fn)
    leaves = {id(p) for g in base_optimizer.param_groups for p in g["params"]}
    if leaves != {id(p) for p in params.values()}:
        raise ValueError("base_optimizer must be built over exactly the params leaves")
    if communication_type == CommunicationType.allreduce:
        if comm_fuse:
            raise ValueError("comm_fuse=True is only implemented for neighbor_allreduce")
        opt = DistributedGradientAllreduceOptimizer(base_optimizer, num_steps_per_communication)
    else:
        if communication_type == CommunicationType.neighbor_allreduce and plan is None:
            raise ValueError("neighbor_allreduce needs a CommPlan")
        if (communication_type == CommunicationType.hierarchical_neighbor_allreduce
                and machine_plan is None):
            raise ValueError("hierarchical_neighbor_allreduce needs a machine CommPlan")
        cls = {"atc": DistributedAdaptThenCombineOptimizer,
               "awc": DistributedAdaptWithCombineOptimizer}[mode]
        opt = cls(base_optimizer, communication_type, plan,
                  num_steps_per_communication, comm_fuse, machine_plan)
    k = max(1, int(steps_per_call))

    def one_step(batch, labels):
        opt.zero_grad(set_to_none=True)
        losses, accs = [], []
        for r in range(n):
            state = {k: v[r] for k, v in params.items()}
            state.update((k, b[r]) for k, b in stats.items())
            kw = {"labels": labels[r]} if takes_labels else {}
            out = apply_fn(state, batch[r], **kw)
            loss = loss_fn(out, labels[r])
            loss.backward()
            losses.append(loss.detach().float())
            if out.dim() >= 2:
                accs.append((out.detach().argmax(-1) == labels[r]).float().mean())
            else:  # the model returned its loss: no logits to score
                accs.append(torch.full_like(losses[-1], float("nan")))
        opt.step()
        return torch.stack(losses), torch.stack(accs)

    def step_fn(batch, labels):
        if k > 1:
            lead = {batch.shape[0], labels.shape[0]}
            if lead != {k}:
                # a [ranks, B, ...] batch here would train on wrong slices
                raise ValueError(
                    f"steps_per_call={k} needs batch/labels with a leading [{k}] "
                    f"sub-step axis; got leading dims {sorted(lead)}")
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("train.steps").add(k)
        with timeline_context("train_step"):
            if k == 1:
                return one_step(batch, labels)
            for i in range(k):
                out = one_step(batch[i], labels[i])
            return out

    return step_fn
