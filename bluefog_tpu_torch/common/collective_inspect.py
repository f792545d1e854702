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
                    (``ops.neighbor_allreduce_plan``, the window exchange)
all-reduce          a reduction (``sum``, ``mean``, ``amax``, ...) whose
                    dims include the rank axis; on a machine-split tensor
                    ``[M, L, ...]`` (``machines=M``) one over the local
                    axis 1 (``hierarchical_neighbor_allreduce_plan``)
all-gather          ``expand`` / ``repeat`` to ``[N, ...]`` of a tensor
                    that holds the whole rank axis as data (a rank-major
                    tensor folded by ``view`` / ``reshape`` or lifted by
                    ``unsqueeze(0)``): every rank materializes every rank
                    (``ops.allgather``)
all-to-all          ``transpose`` / ``permute`` that swaps the rank axis
                    with another axis of extent N
==================  =====================================================

Row-addressed reads and writes (``index`` / ``index_put_`` by receiver,
``select`` of rank r) stay on their own rank and are not collectives; a
rank-major tensor is one whose leading extent is N (or M, the machine
axis, when ``machines`` is given).  A :class:`CollectiveOp` keeps the
per-rank result shape (the result without its leading axis), which is
what the reference's per-device HLO shape is, so the byte and axis rules
keep their semantics.

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

    def _record(self, opcode: str, func, out: torch.Tensor, src) -> None:
        dtype = _HLO_DTYPE.get(out.dtype, str(out.dtype))
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
        if not isinstance(x, torch.Tensor) or not isinstance(out, torch.Tensor):
            return
        if packet is _aten.index_select:
            dim = int(kwargs.get("dim", args[1])) % max(x.dim(), 1)
            if dim == 0 and self._rank_major(x):
                self._record("collective-permute", func, out, x)
            return
        if packet in _REDUCTIONS:
            if any(isinstance(a, torch.Tensor) for a in args[1:]):
                return  # an elementwise overload (max.other, min.other)
            dims = _dims_of(func, args, kwargs, x.dim())
            if self._split(x) and (dims is None or 1 in dims):
                self._record("all-reduce", func, out, x)
            elif self._rank_major(x) and (dims is None or 0 in dims):
                self._record("all-reduce", func, out, x)
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

