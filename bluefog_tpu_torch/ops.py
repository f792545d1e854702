"""Collectives on the rank-major backend (counterpart of ``bluefog_tpu/ops_spmd.py``).

Every tensor carries the rank axis as dim 0: ``x[r]`` is rank r's value.
Where the JAX package does one ``ppermute`` per shift class inside
``shard_map``, this module does one indexed gather of the rank axis per
shift class: ``out = sw[:, None] * x + sum_c w_c[:, None] * x[src_c]``.
Functions take a tensor, or a dict / list / tuple of tensors, and return
the same structure.  Of the eager veneer of ``bluefog_tpu/ops.py``, the
handles of the nonblocking ops are here (:class:`Handle`, :func:`poll`,
:func:`synchronize`); dynamic per-call weights are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.plan import CommPlan

__all__ = ["Handle", "allreduce", "broadcast", "device_sync", "neighbor_allreduce",
           "poll", "synchronize", "wait"]


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a tensor / dict / list / tuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    raise TypeError(f"expected a tensor or a dict/list/tuple of tensors, got {type(x)}")


def tree_flatten(x):
    """``(leaves, spec)`` of a tensor / dict / list / tuple; dict keys in
    sorted order, as ``jax.tree_util`` flattens them.  ``spec`` is hashable
    and compares equal exactly for equal structures."""
    if isinstance(x, torch.Tensor):
        return [x], None
    if isinstance(x, dict):
        keys = sorted(x)
        kids = [tree_flatten(x[k]) for k in keys]
        return [l for ls, _ in kids for l in ls], (dict, tuple(keys), tuple(s for _, s in kids))
    if isinstance(x, (list, tuple)):
        kids = [tree_flatten(v) for v in x]
        return [l for ls, _ in kids for l in ls], (type(x), len(x), tuple(s for _, s in kids))
    raise TypeError(f"expected a tensor or a dict/list/tuple of tensors, got {type(x)}")


def _count(spec) -> int:
    return 1 if spec is None else sum(_count(s) for s in spec[2])


def tree_unflatten(spec, leaves):
    """Inverse of :func:`tree_flatten`."""
    if spec is None:
        (leaf,) = leaves
        return leaf
    kind, keys, kids = spec
    parts, off = [], 0
    for s in kids:
        n = _count(s)
        parts.append(tree_unflatten(s, leaves[off:off + n]))
        off += n
    if kind is dict:
        return dict(zip(keys, parts))
    return kind(parts)


def device_sync(tree):
    """Block until the work that produces every CUDA tensor of ``tree`` is
    done, and return ``tree`` (CPU tensors are done already)."""
    leaves, _ = tree_flatten(tree) if tree is not None else ([], None)
    for dev in {l.device for l in leaves if l.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class Handle:
    """Result of a nonblocking op (the reference's integer handle).  On the
    card it records a ``torch.cuda.Event`` on the current stream when the op
    is issued: :meth:`poll` asks the event, :meth:`wait` blocks on it and
    returns the value.  On the CPU the op is done when the handle exists."""

    __slots__ = ("_value", "_event")

    def __init__(self, value=None, device: Optional[torch.device] = None):
        self._value = value
        if device is None and isinstance(value, torch.Tensor):
            device = value.device
        self._event = None
        if device is not None and torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def poll(self) -> bool:
        """True once the op is done; never blocks."""
        return True if self._event is None else self._event.query()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return self._value


def poll(handle: Handle) -> bool:
    """The reference's ``bf.poll(handle)``."""
    return handle.poll()


def synchronize(handle: Handle):
    """The reference's ``bf.synchronize(handle)``: block, return the output."""
    return handle.wait()


wait = synchronize


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

    leaves, spec = tree_flatten(x)
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
    return tree_unflatten(spec, out)
