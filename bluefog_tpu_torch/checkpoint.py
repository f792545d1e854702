"""Checkpoint and resume (counterpart of ``bluefog_tpu/checkpoint.py``).

The reference writes its trees with orbax; here they go through
``torch.save`` / ``torch.load`` (a file a checkpoint, written to a
temporary name and moved into place).  A tree is a tensor or a dict /
list / tuple of them, stored as CPU tensors.  Ranks hold different
parameters by design, so there are two modes, as in the reference:

- ``mode="all"``: the full rank-major tree (an exact resume, disagreement
  between ranks included);
- ``mode="rank0"``: rank 0's slice only, restored to every rank by
  :func:`restore_broadcast` (the reference's ``load`` +
  ``broadcast_parameters`` idiom).

:func:`save_consensus` stores the mean over the rank axis, the model
gossip training converges to.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.ops import tree_flatten, tree_map, tree_unflatten

__all__ = ["save", "restore", "restore_like", "save_consensus", "restore_broadcast"]


def _host_tree(tree: Any, fn=lambda a: a) -> Any:
    """Every leaf after ``fn``, detached, as a CPU tensor."""
    return tree_map(lambda a: fn(a.detach()).cpu(), tree)


def _write(path: str, tree: Any) -> None:
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def save(path: str, tree: Any, *, mode: str = "all") -> None:
    """Store a rank-major tree: every rank (``mode="all"``) or rank 0's
    slice of each leaf with a rank axis (``mode="rank0"``)."""
    if mode not in ("all", "rank0"):
        raise ValueError(f"mode must be 'all' or 'rank0', got {mode!r}")
    if mode == "rank0":
        _write(path, _host_tree(tree, lambda a: a[0] if a.dim() >= 1 else a))
    else:
        _write(path, _host_tree(tree))


def restore(path: str) -> Any:
    """The tree stored by :func:`save`, as CPU tensors (the reference
    returns host arrays)."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore_like(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: every leaf takes the dtype
    and device of the template's leaf in the same place."""
    r_leaves, r_spec = tree_flatten(restore(path))
    l_leaves, l_spec = tree_flatten(like)
    if len(r_leaves) != len(l_leaves):
        raise ValueError(f"checkpoint has {len(r_leaves)} leaves, template has "
                         f"{len(l_leaves)}")
    if r_spec != l_spec:
        raise ValueError("checkpoint and template trees differ in structure")
    return tree_unflatten(l_spec, [r.to(dtype=l.dtype, device=l.device)
                                   for r, l in zip(r_leaves, l_leaves)])


def save_consensus(path: str, tree: Any) -> None:
    """Store the mean over the rank axis of every leaf that has one (float32
    for integer leaves)."""
    def mean(a):
        if a.dim() == 0:
            return a
        return (a if a.is_floating_point() else a.float()).mean(0)

    _write(path, _host_tree(tree, mean))


def restore_broadcast(path: str, *, root_rank: int = 0) -> Any:
    """Restore a ``rank0`` or consensus checkpoint and give every rank a copy
    of each leaf, rank-major on the context's device.  ``root_rank`` is
    accepted for the reference's signature: the file holds one slice."""
    del root_rank
    ctx = basics.context()
    return tree_map(lambda a: a.to(ctx.device).unsqueeze(0).repeat(
        (ctx.size,) + (1,) * a.dim()) if a.dim() >= 1 else a.to(ctx.device), restore(path))
