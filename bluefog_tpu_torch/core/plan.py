"""Comm-plan compiler: virtual topology -> per-shift-class gather schedule.

Counterpart of ``bluefog_tpu/core/plan.py``.  A weighted digraph over ranks
is compiled once into a ``CommPlan``: the edge set is partitioned into
*shift classes* (edges sharing the same ``(dst - src) mod n``).  Within a
shift class every rank appears at most once as source and at most once as
destination, so each class is one permutation of the rank axis: one indexed
gather on the rank-major backend.  For circulant topologies (ring,
exponential(-2), fully connected) the class count equals the graph degree.

Per class the plan carries dense per-rank weight vectors so the weighted
combine is a fused multiply-add on device.  The class split is the pure
Python one, by choice: the native compiler is ported
(:mod:`bluefog_tpu_torch.native.plan_native`, held against this split in
the tests), but the plan keeps one Python route, so it needs no built
library and no C++ toolchain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.topology_util import DiGraph

__all__ = ["PermClass", "CommPlan", "compile_plan", "plan_from_neighbor_lists"]


@dataclasses.dataclass(frozen=True)
class PermClass:
    """One permutation round.

    perm:         tuple of (src, dst) pairs.
    recv_weights: shape [size]; weight rank d applies to the value it
                  receives this round (0.0 when d receives nothing).
    recv_mask:    shape [size]; 1 where the rank receives this round.
    send_mask:    shape [size]; 1.0 where the rank sends this round.
    slot_index:   shape [size]; position of this round's source in the
                  receiving rank's ascending in-neighbor list (-1 if the
                  rank receives nothing).
    """

    perm: Tuple[Tuple[int, int], ...]
    recv_weights: Tuple[float, ...]
    recv_mask: Tuple[int, ...]
    send_mask: Tuple[float, ...]
    slot_index: Tuple[int, ...]

    @property
    def shift(self) -> Optional[int]:
        """The uniform rotation amount, or None if not a pure rotation."""
        n = len(self.recv_weights)
        shifts = {(d - s) % n for s, d in self.perm}
        return shifts.pop() if len(shifts) == 1 else None

    def sources(self) -> Tuple[int, ...]:
        """``src[d]`` = the rank whose value d receives this round (d itself
        where d receives nothing; its weight there is 0)."""
        src = list(range(len(self.recv_weights)))
        for s, d in self.perm:
            src[d] = s
        return tuple(src)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Compiled gossip schedule for one topology over the rank axis."""

    size: int
    self_weights: Tuple[float, ...]  # [size]
    classes: Tuple[PermClass, ...]
    in_degrees: Tuple[int, ...]  # [size]
    out_degrees: Tuple[int, ...]  # [size]
    # in_neighbors[d] = ordered in-neighbors of d (ascending rank)
    in_neighbors: Tuple[Tuple[int, ...], ...]
    out_neighbors: Tuple[Tuple[int, ...], ...]

    @property
    def max_in_degree(self) -> int:
        return max(self.in_degrees) if self.in_degrees else 0

    @property
    def is_regular(self) -> bool:
        return len(set(self.in_degrees)) <= 1 and len(set(self.out_degrees)) <= 1

    def mixing_matrix(self) -> np.ndarray:
        """Reconstruct W: W[d, s] = weight of s's value at d."""
        W = np.zeros((self.size, self.size))
        np.fill_diagonal(W, self.self_weights)
        for cls in self.classes:
            for s, d in cls.perm:
                W[d, s] += cls.recv_weights[d]
        return W

    def stochasticity_error(self) -> Tuple[float, float]:
        """(max |row sum - 1|, max |col sum - 1|) of the mixing matrix."""
        W = self.mixing_matrix()
        row = float(np.abs(W.sum(axis=1) - 1.0).max()) if self.size else 0.0
        col = float(np.abs(W.sum(axis=0) - 1.0).max()) if self.size else 0.0
        return row, col


def _edge_classes_and_slots(size, edges):
    """Per-edge (class index, allgather slot)."""
    in_neighbors = [sorted(s for s, d in edges if d == v) for v in range(size)]
    shifts = sorted({(d - s) % size for s, d in edges})
    class_of_shift = {sh: i for i, sh in enumerate(shifts)}
    cls = [class_of_shift[(d - s) % size] for s, d in edges]
    slot = [in_neighbors[d].index(s) for s, d in edges]
    return cls, slot


def _classes_from_edges(
    size: int,
    edges: Sequence[Tuple[int, int]],
    recv_weight: Dict[Tuple[int, int], float],
) -> Tuple[PermClass, ...]:
    edges = sorted(edges)
    if not edges:
        return ()
    cls_of, slot_of = _edge_classes_and_slots(size, edges)
    n_classes = max(cls_of) + 1
    perm = [[] for _ in range(n_classes)]
    rw = [[0.0] * size for _ in range(n_classes)]
    rm = [[0] * size for _ in range(n_classes)]
    sm = [[0.0] * size for _ in range(n_classes)]
    slot = [[-1] * size for _ in range(n_classes)]
    for i, (s, d) in enumerate(edges):
        c = cls_of[i]
        perm[c].append((s, d))
        rw[c][d] = recv_weight[(s, d)]
        rm[c][d] = 1
        sm[c][s] = 1.0
        slot[c][d] = slot_of[i]
    return tuple(
        PermClass(
            perm=tuple(sorted(perm[c])),
            recv_weights=tuple(rw[c]),
            recv_mask=tuple(rm[c]),
            send_mask=tuple(sm[c]),
            slot_index=tuple(slot[c]),
        )
        for c in range(n_classes)
    )


def compile_plan(
    topo: DiGraph,
    self_weight=None,
    neighbor_weight: Optional[float] = None,
) -> CommPlan:
    """Compile a weighted digraph into a CommPlan.

    By default weights come from the graph (``GetRecvWeights`` convention);
    ``self_weight`` (scalar or per-rank sequence) / ``neighbor_weight``
    override them uniformly.  Self-loop edges need no transfer: their weight
    folds into the rank's self weight, preserving row-stochasticity.
    """
    size = topo.number_of_nodes()
    if sorted(topo.nodes()) != list(range(size)):
        raise ValueError("topology nodes must be exactly 0..size-1")
    edges = [(int(u), int(v)) for u, v in topo.edges() if u != v]
    recv_w: Dict[Tuple[int, int], float] = {}
    self_w = [1.0] * size
    for d in range(size):
        sw, rw = topology_util.GetRecvWeights(topo, d)
        sw += rw.pop(d, 0.0)  # fold self-loop weight back into self
        for s, w in rw.items():
            recv_w[(s, d)] = w if neighbor_weight is None else neighbor_weight
        if self_weight is None:
            self_w[d] = sw
        elif np.isscalar(self_weight):
            self_w[d] = float(self_weight)
        else:
            self_w[d] = float(self_weight[d])
    classes = _classes_from_edges(size, edges, recv_w)
    in_nb = tuple(tuple(sorted(int(u) for u in topo.predecessors(d))) for d in range(size))
    out_nb = tuple(tuple(sorted(int(v) for v in topo.successors(d))) for d in range(size))
    return CommPlan(
        size=size,
        self_weights=tuple(self_w),
        classes=classes,
        in_degrees=tuple(len(x) for x in in_nb),
        out_degrees=tuple(len(x) for x in out_nb),
        in_neighbors=in_nb,
        out_neighbors=out_nb,
    )


def plan_from_neighbor_lists(
    size: int,
    src_ranks: Sequence[Sequence[int]],
    src_weights: Optional[Sequence[Dict[int, float]]] = None,
    self_weights: Optional[Sequence[float]] = None,
) -> CommPlan:
    """Build a plan from per-rank dynamic neighbor lists.

    src_ranks[d] lists the ranks d receives from this step.  Weights default
    to the uniform average 1/(deg+1).
    """
    edges = []
    recv_w: Dict[Tuple[int, int], float] = {}
    self_w = []
    for d in range(size):
        srcs = list(src_ranks[d])
        if len(set(srcs)) != len(srcs):
            raise ValueError(f"rank {d} has duplicate sources {srcs}")
        for s in srcs:
            if not 0 <= s < size or s == d:
                raise ValueError(f"invalid source {s} for rank {d}")
            edges.append((s, d))
            if src_weights is not None:
                recv_w[(s, d)] = float(src_weights[d][s])
            else:
                recv_w[(s, d)] = 1.0 / (len(srcs) + 1)
        if self_weights is not None:
            self_w.append(float(self_weights[d]))
        elif src_weights is not None:
            self_w.append(1.0 - sum(recv_w[(s, d)] for s in srcs))
        else:
            self_w.append(1.0 / (len(srcs) + 1))
    classes = _classes_from_edges(size, edges, recv_w)
    in_nb = tuple(tuple(sorted(src_ranks[d])) for d in range(size))
    out_lists = topology_util.InferDestinationFromSourceRanks(src_ranks)
    out_nb = tuple(tuple(x) for x in out_lists)
    return CommPlan(
        size=size,
        self_weights=tuple(self_w),
        classes=classes,
        in_degrees=tuple(len(x) for x in in_nb),
        out_degrees=tuple(len(x) for x in out_nb),
        in_neighbors=in_nb,
        out_neighbors=out_nb,
    )
