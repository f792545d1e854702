"""Collectives on the rank-major backend (counterpart of ``bluefog_tpu/ops_spmd.py``).

Every tensor carries the rank axis as dim 0: ``x[r]`` is rank r's value.
Where the JAX package does one ``ppermute`` per shift class inside
``shard_map``, this module does one indexed gather of the rank axis per
shift class: ``out = sw[:, None] * x + sum_c w_c[:, None] * x[src_c]``.
Functions take a tensor, or a dict / list / tuple of tensors, and return
the same structure.  The eager veneer of ``bluefog_tpu/ops.py`` (dynamic
per-call weights, handles) is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.plan import CommPlan

__all__ = ["allreduce", "broadcast", "neighbor_allreduce"]


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a tensor / dict / list / tuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    raise TypeError(f"expected a tensor or a dict/list/tuple of tensors, got {type(x)}")


def _leaves(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    else:
        for v in x:
            _leaves(v, out)
    return out


def _weight_dtype(a: torch.Tensor) -> torch.dtype:
    return a.dtype if a.is_floating_point() else torch.float32


def allreduce(x, *, average: bool = True):
    """Global mean (default) or sum over the rank axis; every rank gets the
    result."""
    def red(a):
        r = a.mean(0, keepdim=True) if average else a.sum(0, keepdim=True)
        return r.expand_as(a).clone()

    return tree_map(red, x)


def broadcast(x, root_rank: int = 0):
    """Every rank gets ``root_rank``'s value."""
    return tree_map(lambda a: a[root_rank].expand_as(a).clone(), x)


@functools.lru_cache(maxsize=64)
def _plan_tensors(plan: CommPlan, self_weight, dtype, device):
    """(self weights [N], [(src index [N], recv weights [N]) per class]) on
    ``device`` — built once per plan, dtype and device."""
    sw = plan.self_weights if self_weight is None else [self_weight] * plan.size
    classes = tuple(
        (torch.tensor(cls.sources(), dtype=torch.long, device=device),
         torch.tensor(cls.recv_weights, dtype=dtype, device=device))
        for cls in plan.classes)
    return torch.tensor(sw, dtype=dtype, device=device), classes


def neighbor_allreduce(x, plan: Optional[CommPlan] = None, *,
                       self_weight: Optional[float] = None, average_dtype=None,
                       fuse: bool = False):
    """Weighted neighbor averaging: ``out_d = w_dd * x_d + sum_{s in N_in(d)}
    w_ds * x_s`` over the rank axis, weights from ``plan`` (default: the
    installed topology's).  ``self_weight`` overrides the plan's self
    weights uniformly.  Values cross in the narrower of their storage dtype
    and ``average_dtype`` and accumulate in ``average_dtype`` (default: the
    tensor's own float dtype).  ``fuse=True`` packs same-dtype tensors into
    one flat buffer so each shift class is one gather per dtype group; the
    result is the same either way."""
    plan = basics.context().plan if plan is None else plan

    def nar(a):
        if a.shape[0] != plan.size:
            raise ValueError(f"rank axis has {a.shape[0]} entries, plan size is {plan.size}")
        wdt = average_dtype or _weight_dtype(a)
        sw, classes = _plan_tensors(plan, None if self_weight is None
                                    else float(self_weight), wdt, a.device)
        bshape = (plan.size,) + (1,) * (a.dim() - 1)
        acc = a.to(wdt) * sw.view(bshape)
        # gather in the NARROWER of storage/average dtype
        wire = a if a.element_size() <= torch.finfo(wdt).bits // 8 else a.to(wdt)
        for src, w in classes:
            acc.addcmul_(w.view(bshape), wire.index_select(0, src).to(wdt))
        return acc

    leaves = _leaves(x, [])
    if not (fuse and len(leaves) > 1):
        return tree_map(nar, x)
    groups = {}  # dtype -> leaf positions, insertion-ordered
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    out = [None] * len(leaves)
    for idxs in groups.values():
        mixed = nar(torch.cat([leaves[i].reshape(plan.size, -1) for i in idxs], dim=1))
        off = 0
        for i in idxs:
            n = leaves[i][0].numel()
            out[i] = mixed[:, off:off + n].reshape(leaves[i].shape)
            off += n
    it = iter(out)
    return tree_map(lambda _: next(it), x)
