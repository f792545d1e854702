"""Collective inventory of an eager torch program (counterpart of
``bluefog_tpu/common/hlo_inspect.py``).

The reference pins the collective inventory of the POST-PARTITIONER HLO:
one ``collective-permute`` per shift class of a gossip step, nothing else.
The port compiles no HLO: every rank lives on one device as a slice of a
rank-major tensor ``[N, ...]``, and communication is whatever aten op mixes
entries across that leading rank axis.  :class:`CollectiveInventory` is a
``TorchDispatchMode`` that records each such op as it runs, filed under
the reference's opcode name:

==================  =====================================================
opcode              aten ops that realize it on the rank axis
==================  =====================================================
collective-permute  ``index_select(x, 0, src)`` of a rank-major ``x``: the
                    gather of one shift class's sources
                    (``ops.neighbor_allreduce_plan``, the window exchange);
                    a shift along the rank axis: ``roll`` by a nonzero
                    amount (the dense ring's hop and its transpose), a
                    ``cat`` along dim 0 that puts a dim-0 slice of a
                    rank-major tensor at other rows than it came from (the
                    pipeline's stage stream), and the ``slice_backward``
                    that moves such a slice's cotangent back (the stream's
                    transpose)
all-reduce          a reduction (``sum``, ``mean``, ``amax``, ...) whose
                    dims include the rank axis; on a machine-split tensor
                    ``[M, L, ...]`` (``machines=M``) one over the local
                    axis 1 (``hierarchical_neighbor_allreduce_plan``)
reduce-scatter      in-place adds (``add_``) into one rank-major
                    accumulator ``[N, k]`` of a vector of ``N*k`` that
                    is not rank-major, viewed as ``[N, k]``: each add
                    sends block s of one rank's vector to rank s, and the
                    adds into one accumulator together are one
                    reduce-scatter, recorded at the first (the ZeRO-1
                    gradient)
all-gather          ``expand`` / ``repeat`` to ``[N, ...]`` of a tensor
                    that holds the whole rank axis as data (a rank-major
                    tensor folded by ``view`` / ``reshape`` or lifted by
                    ``unsqueeze(0)``): every rank materializes every rank
                    (``ops.allgather``)
all-to-all          ``transpose`` / ``permute`` that swaps the rank axis
                    with another axis of extent N
==================  =====================================================

Row-addressed reads and writes (``index`` / ``index_put_`` by receiver,
``select`` of rank r, a ``cat`` that keeps every row at its own rank, a
``roll`` by a multiple of N) stay on their own rank and are not
collectives; a rank-major tensor is one whose leading extent is N (or M,
the machine axis, when ``machines`` is given).  A :class:`CollectiveOp`
keeps the per-rank result shape, which is what the reference's per-device
HLO shape is, so the byte and axis rules keep their semantics: the result
without its rank axis, where the op kept it, and the whole result where a
reduction already dropped it (``x.sum(0)`` of ``[N, 4, 16]`` is the
reference's psum result ``[4, 16]`` a rank).

Ops run for real inside the mode (on any device, ``meta`` included, where
only shapes are computed), so the inventory of a step is the inventory of
exactly what it executed.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_aten = torch.ops.aten
# reductions: the dims argument sits at position 1 (or kwarg ``dim``); no
# dims (or an empty list) reduces over every axis, the rank axis included
_REDUCTIONS = frozenset({
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.prod, _aten.norm, _aten.linalg_vector_norm, _aten.std, _aten.var,
    _aten.std_mean, _aten.var_mean, _aten.logsumexp, _aten.any, _aten.all,
    _aten.argmax, _aten.argmin, _aten.nansum, _aten.count_nonzero,
})
# view-like ops through which a tensor that holds the rank axis as data
# keeps holding it
_VIEWLIKE = frozenset({
    _aten.view, _aten._unsafe_view, _aten.reshape, _aten.unsqueeze,
    _aten.flatten, _aten.squeeze, _aten.clone, _aten.alias, _aten.detach,
    _aten._to_copy, _aten.contiguous, _aten.view_copy, _aten.unsqueeze_copy,
})
_BROADCASTS = frozenset({_aten.expand, _aten.repeat, _aten.expand_copy})
_TRANSPOSES = frozenset({_aten.transpose, _aten.permute, _aten.t})


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One rank-axis op: the reference's opcode name, the aten overload that
    realized it, and its per-rank result shapes ``((dtype, dims), ...)``
    (dtype in HLO spelling, dims without the leading rank axis)."""

    opcode: str
    aten: str
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]
    line: str
    itemsize: int = 0

    def result_bytes(self) -> int:
        """Per-rank bytes of the result (0 for an unknown dtype)."""
        total = 0
        for _dtype, dims in self.shapes:
            n = 1
            for d in dims:
                n *= d
            total += n * self.itemsize
        return total


def _dims_of(func, args, kwargs, ndim: int) -> Optional[List[int]]:
    """The reduced dims of a reduction call, read by the overload's
    argument named ``dim`` (not by position: ``norm``'s ``p`` and
    ``linalg_vector_norm``'s ``ord`` come first); None = every dim."""
    names = [a.name for a in func._schema.arguments]
    dim = kwargs.get("dim")
    if dim is None and "dim" in names and names.index("dim") < len(args):
        dim = args[names.index("dim")]
    if dim is None:
        return None
    if isinstance(dim, int):
        dim = [dim]
    dim = list(dim)
    if not dim:
        return None
    return [d % max(ndim, 1) for d in dim]


def _norm(start: int, n: int) -> int:
    """A slice start as a row index of an axis of extent ``n``."""
    return range(n)[start:].start if n else 0


def _rolls_rank_axis(args, kwargs, x) -> bool:
    """Whether ``roll(x, shifts, dims)`` moves rows along dim 0: a shift of
    dim 0 that is not a multiple of its extent, or a flattened roll (no
    dims) by a nonzero amount."""
    shifts = kwargs.get("shifts", args[1] if len(args) > 1 else ())
    dims = kwargs.get("dims", args[2] if len(args) > 2 else ())
    shifts = [int(v) for v in ([shifts] if isinstance(shifts, int) else shifts)]
    dims = [int(v) for v in ([dims] if isinstance(dims, int) else dims)]
    if not dims:
        return any(v % max(x.numel(), 1) for v in shifts)
    return any(d % x.dim() == 0 and v % x.shape[0] for v, d in zip(shifts, dims))


def _reduced_per_rank(x, out, dims, rank_axes) -> Tuple[int, ...]:
    """The per-rank result shape of a reduction of ``x`` over ``dims``
    (None = every dim): ``out`` without the rank axes it kept.  With
    ``keepdim`` every axis survives as ``out``'s; without it only the
    unreduced ones do, so a rank axis the reduction dropped is not cut
    again."""
    nd = x.dim()
    if out.dim() == nd:
        return tuple(int(d) for i, d in enumerate(out.shape) if i not in rank_axes)
    reduced = set(range(nd)) if dims is None else set(dims)
    kept = [i for i in range(nd) if i not in reduced]
    return tuple(int(out.shape[j]) for j, i in enumerate(kept) if i not in rank_axes)


class CollectiveInventory(TorchDispatchMode):
    """Record the rank-axis collectives of everything run inside ``with``.

    ``ranks`` is the extent N of the rank axis; ``machines``, where given,
    the machine count M of a hierarchical program (rank-major tensors
    ``[N, ...]`` split as ``[M, N // M, ...]``, machine rows ``[M, ...]``).
    """

    def __init__(self, ranks: int, machines: Optional[int] = None):
        super().__init__()
        self.ranks = int(ranks)
        self.machines = None if machines is None else int(machines)
        self.ops: List[CollectiveOp] = []
        # tensors that hold the whole rank axis as data (folded or lifted)
        self._lifted = WeakIdKeyDictionary()
        # dim-0 slices of rank-major tensors: slice -> (extent, first row)
        self._slices = WeakIdKeyDictionary()
        # [N, k] views of vectors that are not rank-major, split into N blocks
        self._split_blocks = WeakIdKeyDictionary()
        # rank-major accumulators whose reduce-scatter is recorded
        self._scattered = WeakIdKeyDictionary()

    # -- classification -------------------------------------------------
    def _axis_extents(self) -> Tuple[int, ...]:
        if self.machines and self.machines != self.ranks:
            return (self.ranks, self.machines)
        return (self.ranks,)

    def _rank_major(self, t) -> bool:
        return (isinstance(t, torch.Tensor) and t.dim() >= 1
                and t.shape[0] in self._axis_extents())

    def _split(self, t) -> bool:
        m = self.machines
        return (bool(m) and isinstance(t, torch.Tensor) and t.dim() >= 2
                and tuple(t.shape[:2]) == (m, self.ranks // m))

    def _record(self, opcode: str, func, out: torch.Tensor, src,
                per_rank: Optional[Tuple[int, ...]] = None) -> None:
        dtype = _HLO_DTYPE.get(out.dtype, str(out.dtype))
        if per_rank is None:
            per_rank = tuple(int(d) for d in out.shape[1:])
        src_s = "x".join(str(int(d)) for d in src.shape)
        line = (f"{func} {dtype}[{','.join(map(str, per_rank))}] per rank "
                f"<- [{src_s}]")
        self.ops.append(CollectiveOp(
            opcode=opcode, aten=str(func), shapes=((dtype, per_rank),),
            line=line, itemsize=out.element_size()))

    def _classify(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        x = args[0] if args else None
        if packet in _REDUCTIONS and isinstance(out, (tuple, list)) and out:
            out = out[0]  # (values, indices) of max.dim and its kin
        if packet is _aten.cat:
            if isinstance(out, torch.Tensor) and self._moves_rows(args, kwargs, out):
                self._record("collective-permute", func, out, out)
            return
        if not isinstance(x, torch.Tensor) or not isinstance(out, torch.Tensor):
            return
        if packet is _aten.index_select:
            dim = int(kwargs.get("dim", args[1])) % max(x.dim(), 1)
            if dim == 0 and self._rank_major(x):
                self._record("collective-permute", func, out, x)
            return
        if packet is _aten.roll:
            if self._rank_major(x) and _rolls_rank_axis(args, kwargs, x):
                self._record("collective-permute", func, out, x)
            return
        if packet is _aten.slice:
            self._note_slice(args, kwargs, x, out)
            return
        if packet is _aten.slice_backward:
            # the cotangent of a dim-0 slice placed back at rows [start, ...):
            # a shift when it is itself a slice cut at other rows
            sizes, dim, start, step = args[1], int(args[2]), int(args[3]), int(args[5])
            src = self._slices.get(x)
            n = int(sizes[0]) if len(sizes) else 0
            if (src is not None and step == 1 and dim % len(sizes) == 0
                    and src[0] == n and src[1] != _norm(start, n)):
                self._record("collective-permute", func, out, out)
            return
        if packet in _REDUCTIONS:
            if any(isinstance(a, torch.Tensor) for a in args[1:]):
                return  # an elementwise overload (max.other, min.other)
            dims = _dims_of(func, args, kwargs, x.dim())
            if self._split(x) and (dims is None or 1 in dims):
                self._record("all-reduce", func, out, x,
                             _reduced_per_rank(x, out, dims, (0, 1)))
            elif self._rank_major(x) and (dims is None or 0 in dims):
                self._record("all-reduce", func, out, x,
                             _reduced_per_rank(x, out, dims, (0,)))
            return
        if packet is _aten.add_:
            other = args[1] if len(args) > 1 else None
            if (self._rank_major(x) and x.shape[0] == self.ranks
                    and isinstance(other, torch.Tensor) and other in self._split_blocks
                    and x not in self._scattered):
                self._scattered[x] = True
                self._record("reduce-scatter", func, out, x)
            return
        if packet in _BROADCASTS:
            if x in self._lifted and out.dim() >= 1 \
                    and out.shape[0] == self.ranks:
                self._record("all-gather", func, out, x)
            return
        if packet in _TRANSPOSES and self._rank_major(x) and out.dim() >= 2:
            if packet is _aten.permute:
                perm = [int(p) % x.dim() for p in args[1]]
                lead = perm[0]
            elif packet is _aten.t:
                lead = 1
            else:
                d0, d1 = (int(a) % x.dim() for a in args[1:3])
                lead = d1 if d0 == 0 else d0 if d1 == 0 else 0
            if lead != 0 and x.shape[lead] == x.shape[0]:
                self._record("all-to-all", func, out, x)
            return
        if packet in _VIEWLIKE and out.numel() == x.numel():
            folded = self._rank_major(x) and (
                out.dim() == 0 or out.shape[0] != x.shape[0])
            if folded or x in self._lifted:
                self._lifted[out] = True
            n = self.ranks
            if (x.dim() == 1 and out.dim() == 2 and out.shape[0] == n
                    and not self._rank_major(x) and x not in self._lifted):
                self._split_blocks[out] = True

    def _note_slice(self, args, kwargs, x, out) -> None:
        """Remember a unit-step dim-0 slice of a rank-major tensor and the
        row it starts at."""
        dim = int(kwargs.get("dim", args[1] if len(args) > 1 else 0))
        step = int(kwargs.get("step", args[4] if len(args) > 4 else 1))
        if dim % max(x.dim(), 1) != 0 or step != 1 or not self._rank_major(x):
            return
        start = kwargs.get("start", args[2] if len(args) > 2 else None)
        n = int(x.shape[0])
        self._slices[out] = (n, _norm(0 if start is None else int(start), n))

    def _moves_rows(self, args, kwargs, out) -> bool:
        """A dim-0 ``cat`` whose result is rank-major and which puts some
        slice of a rank-major tensor of the same extent at other rows than
        the ones it was cut from."""
        pieces = args[0]
        dim = int(kwargs.get("dim", args[1] if len(args) > 1 else 0))
        if out.dim() == 0 or dim % out.dim() != 0 or not self._rank_major(out):
            return False
        at = 0
        for p in pieces:
            if not isinstance(p, torch.Tensor) or p.dim() == 0:
                continue
            src = self._slices.get(p)
            if src is not None and src[0] == out.shape[0] and src[1] != at:
                return True
            at += int(p.shape[0])
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._classify(func, args, kwargs, out)
        return out

    # -- results --------------------------------------------------------
    def counts(self) -> Counter:
        """Opcode -> number of rank-axis ops recorded."""
        return Counter(op.opcode for op in self.ops)

    def aten_counts(self) -> Counter:
        """(opcode, aten overload) -> number recorded: which aten op
        realized each collective."""
        return Counter((op.opcode, op.aten) for op in self.ops)


def collective_ops(inventory) -> List[CollectiveOp]:
    """The recorded ops of an inventory (or an op sequence) in order."""
    if isinstance(inventory, CollectiveInventory):
        return list(inventory.ops)
    return list(inventory)


def collective_counts(inventory) -> Counter:
    """Opcode counts of an inventory or of an op sequence."""
    return Counter(op.opcode for op in collective_ops(inventory))


def record(fn, *args, ranks: int, machines: Optional[int] = None,
           **kwargs) -> Tuple[object, CollectiveInventory]:
    """Run ``fn(*args, **kwargs)`` under a fresh inventory; return
    ``(result, inventory)``."""
    inv = CollectiveInventory(ranks, machines)
    with inv:
        out = fn(*args, **kwargs)
    return out, inv


__all__ = ["COLLECTIVES", "CollectiveOp", "CollectiveInventory",
           "collective_ops", "collective_counts", "record"]

