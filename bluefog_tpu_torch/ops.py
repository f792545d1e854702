"""Collectives on the rank-major backend (counterpart of ``bluefog_tpu/ops_spmd.py``).

Every tensor carries the rank axis as dim 0: ``x[r]`` is rank r's value.
Where the JAX package does one ``ppermute`` per shift class inside
``shard_map``, this module does one indexed gather of the rank axis per
shift class: ``out = sw[:, None] * x + sum_c w_c[:, None] * x[src_c]``.
Functions take a tensor, or a dict / list / tuple of tensors, and return
the same structure.

Two layers, as in the JAX package: the ``*_plan`` functions (and
:func:`pairwise_gossip`) take an explicit :class:`CommPlan` and are the
counterparts of ``ops_spmd``'s; the rest is the eager veneer of
``bluefog_tpu/ops.py`` with its signatures: static and dynamic
``neighbor_allreduce``, ``neighbor_allgather``,
``hierarchical_neighbor_allreduce``, ``allgather``, ``barrier``, and a
``_nonblocking`` form of every collective returning a :class:`Handle`.
Each eager op runs inside a :func:`~bluefog_tpu_torch.timeline.timeline_context`.

With several processes (``init(distributed=True)``) every function takes
this process's rows ``[size // nprocs, ...]`` and returns its rows of the
result: a shift class gathers its in-process sources by ``index_select``
and the others by :func:`bluefog_tpu_torch.core.distributed.exchange`
(only the rows that cross a process boundary move); the global
collectives reduce each process's partial result over the process group.
A tensor that holds every rank ``[size, ...]`` is computed in the process
as before.  Transfers are complete when a function returns, so a
nonblocking handle completes only after them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core import distributed as _dist
from bluefog_tpu_torch.core.plan import CommPlan, plan_from_neighbor_lists
from bluefog_tpu_torch.timeline import timeline_context

__all__ = [
    "Handle",
    "device_sync",
    "allreduce",
    "allreduce_nonblocking",
    "broadcast",
    "broadcast_nonblocking",
    "allgather",
    "allgather_nonblocking",
    "neighbor_allgather",
    "neighbor_allgather_nonblocking",
    "neighbor_allreduce",
    "neighbor_allreduce_nonblocking",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_nonblocking",
    "barrier",
    "poll",
    "synchronize",
    "wait",
    "neighbor_allreduce_plan",
    "neighbor_allgather_plan",
    "hierarchical_neighbor_allreduce_plan",
    "pairwise_gossip",
]


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a tensor / dict / list / tuple; a
    None is an empty subtree (as in ``jax.tree_util``) and stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    raise TypeError(f"expected a tensor or a dict/list/tuple of tensors, got {type(x)}")


def tree_flatten(x):
    """``(leaves, spec)`` of a tensor / dict / list / tuple; dict keys in
    sorted order, as ``jax.tree_util`` flattens them, and a None an empty
    subtree.  ``spec`` is hashable and compares equal exactly for equal
    structures."""
    if x is None:
        return [], (type(None), 0, ())
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
    if kind is type(None):
        return None
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


def _handle(value) -> Handle:
    return Handle(value, device=basics.context().device)


#: the layout of a tensor that holds every rank: one process's block
_WHOLE = _dist.ProcessLayout(1, 0)


def _rows_layout(a: torch.Tensor, n: int) -> _dist.ProcessLayout:
    """How ``a``'s rows lie over an axis of ``n`` ranks: ``_WHOLE`` when it
    holds all ``n`` (one process, or a tensor every process holds whole),
    the process layout when it holds this process's block of them."""
    lay = basics.process_layout()
    rows = a.shape[0] if a.dim() else 0
    if rows == n:
        return _WHOLE
    if lay is not None and n % lay.nprocs == 0 and rows == n // lay.nprocs:
        return lay
    extra = "" if lay is None else f" or this process's {n // lay.nprocs}"
    raise ValueError(f"rank axis has {rows} entries, plan size is {n}{extra}")


def _gather(a: torch.Tensor, src: Tuple[int, ...], lay: _dist.ProcessLayout) -> torch.Tensor:
    """Row ``d`` of the result is global row ``src[d]`` of ``a``, for each of
    the rows ``a`` holds (:func:`~bluefog_tpu_torch.core.distributed.exchange`)."""
    return _dist.exchange(a, _dist.schedule(src, lay.nprocs, lay.pid))


def _eager_rows(x):
    """An eager op's input as this process's rows on the context's device
    (:func:`~bluefog_tpu_torch.core.basics.to_rank_major_global`); in one
    process the input as it is."""
    return x if basics.process_layout() is None else basics.to_rank_major_global(x)


# --------------------------------------------------------------------------
# Global collectives
# --------------------------------------------------------------------------


def allreduce(x, average: bool = True, name: Optional[str] = None):
    """Global mean (default) or sum over the rank axis; every rank gets the
    result.  The mean of an integer tensor is float32; the sum keeps the
    tensor's dtype."""
    del name
    lay = basics.process_layout()

    def red(a):
        if lay is not None and _rows_layout(a, basics.context().size).nprocs > 1:
            part = a.to(_weight_dtype(a) if average else a.dtype).sum(0, keepdim=True)
            r = _dist.all_reduce_sum(part)
            r = r / basics.context().size if average else r
        elif average:
            r = a.to(_weight_dtype(a)).mean(0, keepdim=True)
        else:
            r = a.sum(0, keepdim=True, dtype=a.dtype)
        return r.expand_as(a).clone()

    with timeline_context("allreduce"):
        return tree_map(red, _eager_rows(x))


def allreduce_nonblocking(x, average: bool = True, name: Optional[str] = None) -> Handle:
    return _handle(allreduce(x, average=average, name=name))


def broadcast(x, root_rank: int = 0, name: Optional[str] = None):
    """Every rank gets ``root_rank``'s value."""
    del name

    def bcast(a):
        lay = basics.process_layout()
        n = a.shape[0] if lay is None else basics.context().size
        if lay is None or _rows_layout(a, n).nprocs == 1:
            return a[root_rank].expand_as(a).clone()
        b = a.shape[0]
        owner = root_rank // b
        row = a[root_rank - lay.first(n)] if owner == lay.pid else torch.empty_like(a[0])
        return _dist.broadcast_from(row.contiguous(), owner).expand_as(a).clone()

    with timeline_context("broadcast"):
        return tree_map(bcast, _eager_rows(x))


def broadcast_nonblocking(x, root_rank: int = 0, name: Optional[str] = None) -> Handle:
    return _handle(broadcast(x, root_rank=root_rank, name=name))


def allgather(x, name: Optional[str] = None):
    """Every rank gets the concatenation, along its per-rank axis 0, of all
    ranks' tensors: ``[size, n0, ...]`` in, ``[size, size * n0, ...]`` out."""
    del name
    lay = basics.process_layout()

    def gather(a):
        full = (a if lay is None or _rows_layout(a, basics.context().size).nprocs == 1
                else _dist.all_gather_rows(a))
        flat = full.reshape((full.shape[0] * full.shape[1],) + full.shape[2:])
        return flat.unsqueeze(0).expand((a.shape[0],) + flat.shape).contiguous()

    with timeline_context("allgather"):
        return tree_map(gather, _eager_rows(x))


def allgather_nonblocking(x, name: Optional[str] = None) -> Handle:
    return _handle(allgather(x, name=name))


def barrier() -> None:
    """Block until all work issued on the context's device is done and,
    with several processes, until every process has reached the barrier."""
    dev = basics.context().device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if basics.process_layout() is not None:
        _dist.barrier()


# --------------------------------------------------------------------------
# Neighbor collectives on a plan (the counterparts of ops_spmd's)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _plan_tensors(plan: CommPlan, self_weight, dtype, device):
    """(self weights [N], [(sources, recv weights [N]) per class]) on
    ``device`` — built once per plan, dtype and device."""
    sw = plan.self_weights if self_weight is None else [self_weight] * plan.size
    classes = tuple(
        (cls.sources(), torch.tensor(cls.recv_weights, dtype=dtype, device=device))
        for cls in plan.classes)
    return torch.tensor(sw, dtype=dtype, device=device), classes


def neighbor_allreduce_plan(x, plan: CommPlan, *, self_weight: Optional[float] = None,
                            average_dtype=None, fuse: bool = False):
    """Weighted neighbor averaging on ``plan``: ``out_d = w_dd * x_d +
    sum_{s in N_in(d)} w_ds * x_s`` over the rank axis (the counterpart of
    ``ops_spmd.neighbor_allreduce``).  ``self_weight`` overrides the plan's
    self weights uniformly.  Values cross in the narrower of their storage
    dtype and ``average_dtype`` and accumulate in ``average_dtype``
    (default: the tensor's own float dtype, float32 for integers).
    ``fuse=True`` packs same-dtype tensors into one flat buffer so each
    shift class is one gather per dtype group; the result is the same
    either way."""
    def nar(a):
        lay = _rows_layout(a, plan.size)
        wdt = average_dtype or _weight_dtype(a)
        sw, classes = _plan_tensors(plan, None if self_weight is None
                                    else float(self_weight), wdt, a.device)
        bshape = (a.shape[0],) + (1,) * (a.dim() - 1)
        rows = slice(lay.first(plan.size), lay.first(plan.size) + a.shape[0])
        acc = a.to(wdt) * sw[rows].view(bshape)
        # gather in the NARROWER of storage/average dtype
        wire = a if a.element_size() <= torch.finfo(wdt).bits // 8 else a.to(wdt)
        for src, w in classes:
            acc.addcmul_(w[rows].view(bshape), _gather(wire, src, lay).to(wdt))
        return acc

    leaves, spec = tree_flatten(x)
    if not (fuse and len(leaves) > 1):
        return tree_map(nar, x)
    groups = {}  # dtype -> leaf positions, insertion-ordered
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    out = [None] * len(leaves)
    for idxs in groups.values():
        mixed = nar(torch.cat([leaves[i].reshape(leaves[i].shape[0], -1) for i in idxs],
                              dim=1))
        off = 0
        for i in idxs:
            n = leaves[i][0].numel()
            out[i] = mixed[:, off:off + n].reshape(leaves[i].shape)
            off += n
    return tree_unflatten(spec, out)


@functools.lru_cache(maxsize=64)
def _gather_tensors(plan: CommPlan, lay: _dist.ProcessLayout, device):
    """Per class of ``plan``: (its sources, the receiving rows of ``lay``'s
    block, their slots), the rows and slots as index tensors on ``device``."""
    r0, b = lay.first(plan.size), lay.block(plan.size)
    out = []
    for cls in plan.classes:
        dst = [d for _, d in cls.perm if r0 <= d < r0 + b]
        out.append((cls.sources(),
                    torch.tensor([d - r0 for d in dst], dtype=torch.long, device=device),
                    torch.tensor([cls.slot_index[d] for d in dst], dtype=torch.long,
                                 device=device)))
    return tuple(out)


def neighbor_allgather_plan(x, plan: CommPlan):
    """In-neighbor tensors per rank, stacked on a new axis 1 in ascending
    source order: ``[size, n0, ...]`` in, ``[size, maxD, n0, ...]`` out,
    zero where a rank has fewer than ``maxD`` in-neighbors (the
    counterpart of ``ops_spmd.neighbor_allgather``)."""
    maxd = plan.max_in_degree

    def nag(a):
        lay = _rows_layout(a, plan.size)
        out = a.new_zeros((a.shape[0], maxd) + a.shape[1:])
        for src, dst, slot in _gather_tensors(plan, lay, a.device):
            out[dst, slot] = _gather(a, src, lay)[dst]
        return out

    return tree_map(nag, x)


def hierarchical_neighbor_allreduce_plan(x, machine_plan: CommPlan, *,
                                         self_weight: Optional[float] = None):
    """Machine-level gossip on ``machine_plan``: the ranks of each machine
    (``size // machine_plan.size`` consecutive ranks, machine-major) are
    averaged in the weight dtype, the machine rows are mixed by
    :func:`neighbor_allreduce_plan`, and each machine's row goes back to
    all its ranks (the counterpart of
    ``ops_spmd.hierarchical_neighbor_allreduce``).  The output is in the
    weight dtype (float32 for integers)."""
    m = machine_plan.size
    lay = basics.process_layout()
    n = basics.context().size if lay is not None else None

    def hnar(a):
        if lay is not None and a.shape[0] != n:
            return _hnar_rows(a, machine_plan, self_weight, lay, n)
        if a.shape[0] % m:
            raise ValueError(f"rank axis has {a.shape[0]} entries, not a multiple of "
                             f"{m} machines")
        local = a.shape[0] // m
        avg = a.to(_weight_dtype(a)).reshape((m, local) + a.shape[1:]).mean(1)
        mixed = neighbor_allreduce_plan(avg, machine_plan, self_weight=self_weight)
        return mixed.unsqueeze(1).expand((m, local) + mixed.shape[1:]).reshape(a.shape)

    return tree_map(hnar, x)


def _hnar_rows(a, machine_plan: CommPlan, self_weight, lay, n: int):
    """``hierarchical_neighbor_allreduce_plan`` on this process's rows ``a
    [n // nprocs, ...]``.  Where every machine lies inside one process the
    machine means are taken in the process and the machine rows cross by
    :func:`neighbor_allreduce_plan`; where a machine spans processes, each
    process's per-machine partial sums are summed over the group and every
    process mixes all machine rows."""
    m = machine_plan.size
    if n % m:
        raise ValueError(f"{n} ranks are not a multiple of {m} machines")
    local, b, r0 = n // m, a.shape[0], lay.first(n)
    wdt = _weight_dtype(a)
    if b % local == 0:
        avg = a.to(wdt).reshape((b // local, local) + a.shape[1:]).mean(1)
        mixed = neighbor_allreduce_plan(avg, machine_plan, self_weight=self_weight)
        return mixed.unsqueeze(1).expand((b // local, local) + mixed.shape[1:]).reshape(a.shape)
    mine = torch.arange(r0, r0 + b, device=a.device) // local
    part = a.new_zeros((m,) + a.shape[1:], dtype=wdt).index_add_(0, mine, a.to(wdt))
    avg = _dist.all_reduce_sum(part) / local
    mixed = neighbor_allreduce_plan(avg, machine_plan, self_weight=self_weight)
    return mixed.index_select(0, mine)


@functools.lru_cache(maxsize=64)
def _pairwise_tensors(send_to, size, self_weight, peer_weight, dtype, device):
    src = list(range(size))
    mask = [0.0] * size
    for s, d in send_to:
        if mask[d]:
            raise ValueError(f"rank {d} receives twice in {send_to}")
        src[d], mask[d] = s, 1.0
    keep = [self_weight + (1.0 - m) * peer_weight for m in mask]
    return (tuple(src), torch.tensor(keep, dtype=dtype, device=device),
            torch.tensor([m * peer_weight for m in mask], dtype=dtype, device=device))


def pairwise_gossip(x, send_to, size: Optional[int] = None, *, self_weight: float = 0.5,
                    peer_weight: float = 0.5):
    """One-peer gossip step along the ``(src, dst)`` pairs of ``send_to``:
    a rank that receives takes ``self_weight * own + peer_weight * peer``,
    a rank that receives nothing keeps ``(self_weight + peer_weight) *
    own`` (the counterpart of ``ops_spmd.pairwise_gossip``).  ``size``
    defaults to the rank axis; the output is in the weight dtype."""
    pairs = tuple((int(s), int(d)) for s, d in send_to)

    def g(a):
        n = a.shape[0] if size is None else size
        lay = _rows_layout(a, n)
        wdt = _weight_dtype(a)
        src, keep, peer = _pairwise_tensors(pairs, n, float(self_weight),
                                            float(peer_weight), wdt, a.device)
        bshape = (a.shape[0],) + (1,) * (a.dim() - 1)
        rows = slice(lay.first(n), lay.first(n) + a.shape[0])
        out = a.to(wdt) * keep[rows].view(bshape)
        return out.addcmul_(peer[rows].view(bshape), _gather(a, src, lay).to(wdt))

    return tree_map(g, x)


# --------------------------------------------------------------------------
# The reference's eager neighbor ops (static and dynamic topology)
# --------------------------------------------------------------------------

WeightsArg = Union[None, Sequence[Dict[int, float]]]
RanksArg = Union[None, Sequence[Sequence[int]]]


def _resolve_src_lists(size: int, src_arg, dst_arg, src_name: str, dst_name: str) -> list:
    """Per-rank source lists of a dynamic call from ``src_arg`` (entry d
    iterates the ranks d receives from) and/or ``dst_arg`` (entry s
    iterates the ranks s sends to); given both, they must describe the
    same edge set."""
    if src_arg is None and dst_arg is None:
        raise ValueError(f"dynamic path needs {src_name} and/or {dst_name}")
    for nm, arg in ((src_name, src_arg), (dst_name, dst_arg)):
        if arg is not None and len(arg) != size:
            raise ValueError(f"{nm} must be a length-{size} sequence (one entry per rank)")
    src_lists = None
    if src_arg is not None:
        src_lists = [sorted(int(s) for s in src_arg[d]) for d in range(size)]
    if dst_arg is not None:
        inferred = topology_util.InferSourceFromDestinationRanks(
            [sorted(int(d) for d in dst_arg[s]) for s in range(size)])
        if src_lists is None:
            src_lists = inferred
        elif src_lists != [sorted(x) for x in inferred]:
            raise ValueError(f"{src_name} and {dst_name} describe different edge sets")
    return src_lists


def _dynamic_plan(size: int, self_weight, src_weights: WeightsArg,
                  dst_weights: WeightsArg) -> CommPlan:
    """The plan of one dynamic ``neighbor_allreduce`` call.  Edge s -> d
    weighs ``src_weights[d][s] * dst_weights[s][d]`` (either side 1 when
    not given); ``self_weight`` None keeps each row summing to 1."""
    src_lists = _resolve_src_lists(size, src_weights, dst_weights, "src_weights",
                                   "dst_weights")
    eff = []
    for d in range(size):
        wd = {}
        for s in src_lists[d]:
            w = 1.0
            if src_weights is not None:
                w *= float(src_weights[d][s])
            if dst_weights is not None:
                w *= float(dst_weights[s][d])
            wd[s] = w
        eff.append(wd)
    if self_weight is None:
        self_w = [1.0 - sum(eff[d].values()) for d in range(size)]
    elif np.isscalar(self_weight):
        self_w = [float(self_weight)] * size
    else:
        self_w = [float(w) for w in self_weight]
        if len(self_w) != size:
            raise ValueError(f"self_weight must be scalar or length-{size}")
    return plan_from_neighbor_lists(size, src_lists, src_weights=eff, self_weights=self_w)


def neighbor_allreduce(x, self_weight=None, src_weights: WeightsArg = None,
                       dst_weights: WeightsArg = None, name: Optional[str] = None):
    """Weighted neighbor averaging over the rank axis (the reference's
    ``bf.neighbor_allreduce``).

    Static mode (no weight arguments): the installed topology's weights;
    ``self_weight``, a scalar or a per-rank sequence, replaces the self
    weights.  Dynamic mode: per-rank ``src_weights`` / ``dst_weights``
    sequences of ``{rank: weight}`` dicts define this call's edges (see
    :func:`_dynamic_plan`); ``self_weight`` is then None (each row sums to
    1), a scalar or a per-rank sequence."""
    del name
    ctx = basics.context()
    with timeline_context("neighbor_allreduce"):
        if src_weights is None and dst_weights is None:
            if self_weight is None:
                plan = ctx.plan
            else:
                sw = (float(self_weight) if np.isscalar(self_weight)
                      else tuple(float(w) for w in self_weight))
                plan = ctx.plan_for(ctx.topology, self_weight=sw)
        else:
            plan = _dynamic_plan(ctx.size, self_weight, src_weights, dst_weights)
        return neighbor_allreduce_plan(_eager_rows(x), plan)


def neighbor_allreduce_nonblocking(x, self_weight=None, src_weights: WeightsArg = None,
                                   dst_weights: WeightsArg = None,
                                   name: Optional[str] = None) -> Handle:
    return _handle(neighbor_allreduce(x, self_weight=self_weight, src_weights=src_weights,
                                      dst_weights=dst_weights, name=name))


def neighbor_allgather(x, src_ranks: RanksArg = None, dst_ranks: RanksArg = None,
                       name: Optional[str] = None):
    """In-neighbor tensors per rank in ascending source order (the
    reference's ``bf.neighbor_allgather``): ``[size, n0, ...]`` in,
    ``[size, D * n0, ...]`` out on a topology where every rank has D
    in-neighbors, else ``[size, maxD, n0, ...]`` zero-padded (the valid
    counts are the plan's ``in_degrees``).  ``src_ranks`` / ``dst_ranks``
    (per-rank lists) give this call's edges instead of the installed
    topology's."""
    del name
    ctx = basics.context()
    if src_ranks is None and dst_ranks is None:
        plan = ctx.plan
    else:
        plan = plan_from_neighbor_lists(
            ctx.size, _resolve_src_lists(ctx.size, src_ranks, dst_ranks, "src_ranks",
                                         "dst_ranks"))

    def finish(a):
        if plan.is_regular and a.dim() >= 3:
            return a.reshape((a.shape[0], a.shape[1] * a.shape[2]) + a.shape[3:])
        return a

    with timeline_context("neighbor_allgather"):
        return tree_map(finish, neighbor_allgather_plan(_eager_rows(x), plan))


def neighbor_allgather_nonblocking(x, src_ranks: RanksArg = None, dst_ranks: RanksArg = None,
                                   name: Optional[str] = None) -> Handle:
    return _handle(neighbor_allgather(x, src_ranks=src_ranks, dst_ranks=dst_ranks, name=name))


def hierarchical_neighbor_allreduce(x, self_weight: Optional[float] = None,
                                    name: Optional[str] = None):
    """Intra-machine average, then gossip between machines on the machine
    topology, then every rank of a machine holds its machine's value (the
    reference's ``bf.hierarchical_neighbor_allreduce``).  Raises without a
    machine topology (one machine, and none installed)."""
    del name
    ctx = basics.context()
    if ctx.machine_topology is None:
        raise RuntimeError(
            "no machine topology; call set_machine_topology() (machine_size="
            f"{ctx.machine_size_})")
    with timeline_context("hierarchical_neighbor_allreduce"):
        return hierarchical_neighbor_allreduce_plan(_eager_rows(x), ctx.machine_plan,
                                                    self_weight=self_weight)


def hierarchical_neighbor_allreduce_nonblocking(x, self_weight: Optional[float] = None,
                                                name: Optional[str] = None) -> Handle:
    return _handle(hierarchical_neighbor_allreduce(x, self_weight=self_weight, name=name))
