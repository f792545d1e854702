"""GPipe-style pipeline parallelism on the rank-major backend (counterpart
of ``bluefog_tpu/parallel/pipeline.py``).

The reference holds one *stage* (a contiguous slice of layers) a device
and streams microbatches stage to stage with a single-hop ``ppermute``
inside one ``lax.scan``.  Here the stages are dim 0 of one tensor: stage
parameters stacked ``[pp, ...]`` (:func:`stack_stage_params`), the
in-flight activations ``[pp, mb, ...]``, one per stage.  The schedule is
the reference's, tick for tick: ``num_micro + pp - 1`` ticks; at tick t
stage 0 takes microbatch t (zeros once drained), every stage applies its
layers to what it holds (one ``torch.func.vmap`` of ``stage_fn`` over the
stage axis, the fill and drain bubbles included, as the reference's
devices compute them), the last stage banks microbatch m at tick ``m + pp
- 1``, and the stream shifts one stage along (stage 0 receiving zeros,
as a ``ppermute`` without a source gives): a ``cat`` that moves every row
to the next stage, which the collective inventory files as the
reference's collective-permute.  The banked outputs are the result,
replicated as in the reference: the last stage's, by a masked sum over
the stage axis (its psum) through the ``g`` operator.

Autograd differentiates the schedule end to end, and the gradients are
the sequential model's: ``g`` is the identity backward, so nothing is
scaled by pp.
Wrap ``stage_fn`` in ``torch.utils.checkpoint`` for rematerialised long
pipelines.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from bluefog_tpu_torch.ops import tree_flatten, tree_unflatten
from bluefog_tpu_torch.parallel.tensor_parallel import reduce_from_tp_region

__all__ = ["pipeline_apply", "stack_stage_params", "PP_AXIS"]

PP_AXIS = "pp"


def stack_stage_params(per_stage_params):
    """List of per-stage parameter trees -> one tree of stacked ``[pp, ...]``
    leaves."""
    flat = [tree_flatten(p) for p in per_stage_params]
    return tree_unflatten(flat[0][1], [torch.stack(ls) for ls in zip(*(f for f, _ in flat))])


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params,
                   x: torch.Tensor, *, num_microbatches: int) -> torch.Tensor:
    """Run the pipeline: ``x [num_micro * mb, ...]`` -> the same shape.

    ``stage_params``: every stage's parameters stacked ``[pp, ...]``;
    ``stage_fn(stage_params_of_one_stage, activation) -> activation`` with
    one signature for every stage (the homogeneous-transformer
    assumption).  Microbatch m is injected at tick m, transformed by stage
    s at tick ``m + s``, and collected after its last-stage tick."""
    total = x.shape[0]
    if total % num_microbatches:
        raise ValueError(
            f"batch {total} not divisible by num_microbatches={num_microbatches}")
    n = tree_flatten(stage_params)[0][0].shape[0]
    mb = total // num_microbatches
    micro = x.reshape((num_microbatches, mb) + x.shape[1:])
    stages = torch.func.vmap(stage_fn)
    state = x.new_zeros((n, mb) + x.shape[1:])
    outs = []
    for t in range(num_microbatches + n - 1):
        # stage 0 swallows the next microbatch (zeros once drained)
        inject = micro[t] if t < num_microbatches else torch.zeros_like(micro[0])
        state = torch.cat([inject.unsqueeze(0), state[1:]])
        state = stages(stage_params, state)
        if t >= n - 1:  # the last stage banks microbatch t - (n - 1)
            outs.append(state)
        # stream every in-flight activation one stage forward
        state = torch.cat([torch.zeros_like(state[:1]), state[:-1]])
    # replicate the last stage's outputs to every stage: the reference's
    # masked psum, a g operator (identity backward)
    banked = torch.stack(outs, 1)  # [pp, num_micro, mb, ...]
    last = torch.arange(n, device=x.device).view((n,) + (1,) * (banked.dim() - 1)) == n - 1
    banked = reduce_from_tp_region(torch.where(last, banked, torch.zeros_like(banked)))
    return banked.reshape((total,) + x.shape[1:])
