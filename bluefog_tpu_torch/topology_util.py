"""Virtual-topology library: weighted digraph constructors + dynamic generators.

Counterpart of ``bluefog_tpu/topology_util.py``.  A *topology* is a
:class:`DiGraph` over ranks ``0..size-1`` whose edge ``(u, v)`` means "rank v
receives rank u's tensor", with edge attribute ``weight`` = the combine
coefficient receiver ``v`` assigns to ``u``'s value.  Every constructor
produces a **row-stochastic** mixing matrix ``W`` (``W[v, u]`` = weight of
``u``'s value at ``v``; ``W[v, v] = 1 - sum of in-weights``).

The JAX package builds on ``networkx.DiGraph``; this package carries the
small digraph below instead, so it needs nothing beyond torch and numpy.
It keeps networkx's insertion order for nodes, successors and predecessors,
so weights and plans come out identical, float for float.

Dynamic-topology generators yield per-step ``(send_ranks, recv_ranks)``
pairs implementing one-peer rotating gossip.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DiGraph",
    "is_strongly_connected",
    "relabel_nodes",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "RingGraph",
    "StarGraph",
    "MeshGrid2DGraph",
    "FullyConnectedGraph",
    "IsRegularGraph",
    "IsTopologyEquivalent",
    "MetropolisHastingsWeights",
    "GetRecvWeights",
    "GetSendWeights",
    "GetWeightMatrix",
    "GetDynamicOnePeerSendRecvRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "InferSourceFromDestinationRanks",
    "InferDestinationFromSourceRanks",
]


class _NodeView(list):
    """The node list; calling it returns itself, so both networkx spellings
    ``G.nodes`` and ``G.nodes()`` work."""

    def __call__(self):
        return self


class _EdgeView(list):
    """The ``(u, v)`` edge list; ``G.edges(data=True)`` gives the
    ``(u, v, attrs)`` triples, as in networkx."""

    def __init__(self, graph: "DiGraph"):
        super().__init__((u, v) for u, nb in graph._succ.items() for v in nb)
        self._graph = graph

    def __call__(self, data: bool = False) -> list:
        if data:
            return [(u, v, d) for u, nb in self._graph._succ.items()
                    for v, d in nb.items()]
        return list(self)


class DiGraph:
    """The part of ``networkx.DiGraph`` the topology, plan and resilience
    code uses.

    ``G[u][v]`` is the attribute dict of edge ``(u, v)``; ``G.graph`` holds
    graph-level attributes.  Nodes, successors and predecessors iterate in
    insertion order, as in networkx.
    """

    def __init__(self):
        self.graph: Dict[str, object] = {}
        self._succ: Dict[int, Dict[int, dict]] = {}
        self._pred: Dict[int, Dict[int, dict]] = {}

    def add_node(self, n: int) -> None:
        if n not in self._succ:
            self._succ[n] = {}
            self._pred[n] = {}

    def add_nodes_from(self, nodes) -> None:
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u: int, v: int, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        data = self._succ[u].get(v)
        if data is None:
            data = {}
            self._succ[u][v] = data
            self._pred[v][u] = data
        data.update(attr)

    def add_edges_from(self, edges) -> None:
        for e in edges:
            self.add_edge(e[0], e[1], **(e[2] if len(e) > 2 else {}))

    def has_edge(self, u: int, v: int) -> bool:
        return u in self._succ and v in self._succ[u]

    def remove_edge(self, u: int, v: int) -> None:
        if not self.has_edge(u, v):
            raise KeyError(f"the edge {u}-{v} is not in the graph")
        del self._succ[u][v]
        del self._pred[v][u]

    def copy(self) -> "DiGraph":
        """An independent copy (``networkx.DiGraph.copy()``): the same
        nodes and edges in the same order, each attribute dict (and
        ``graph``) copied shallowly."""
        H = DiGraph()
        H.graph.update(self.graph)
        H.add_nodes_from(self._succ)
        for u, v, d in self.edges(data=True):
            H.add_edge(u, v, **d)
        return H

    def subgraph(self, nodes) -> "DiGraph":
        """The induced subgraph on ``nodes`` (a copy; networkx returns a
        view), in this graph's node and edge order."""
        keep = set(nodes)
        H = DiGraph()
        H.graph.update(self.graph)
        H.add_nodes_from(n for n in self._succ if n in keep)
        for u, v, d in self.edges(data=True):
            if u in keep and v in keep:
                H.add_edge(u, v, **d)
        return H

    def __getitem__(self, u: int) -> Dict[int, dict]:
        return self._succ[u]

    def __contains__(self, n) -> bool:
        return n in self._succ

    def __iter__(self):
        return iter(self._succ)

    def __len__(self) -> int:
        return len(self._succ)

    @property
    def nodes(self) -> _NodeView:
        return _NodeView(self._succ)

    def number_of_nodes(self) -> int:
        return len(self._succ)

    def number_of_edges(self) -> int:
        return sum(len(nb) for nb in self._succ.values())

    @property
    def edges(self) -> _EdgeView:
        return _EdgeView(self)

    def predecessors(self, v: int) -> Iterator[int]:
        return iter(self._pred[v])

    def successors(self, u: int) -> Iterator[int]:
        return iter(self._succ[u])

    def in_degree(self, v: int) -> int:
        return len(self._pred[v])

    def out_degree(self, u: int) -> int:
        return len(self._succ[u])


def is_strongly_connected(G: DiGraph) -> bool:
    """Whether every node reaches every other along directed edges
    (``networkx.is_strongly_connected``, which raises on an empty graph)."""
    nodes = list(G.nodes)
    if not nodes:
        raise ValueError("connectivity is undefined for the null graph")

    def reach(start, nbrs) -> int:
        seen, stack = {start}, [start]
        while stack:
            for w in nbrs(stack.pop()):
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen)

    return (reach(nodes[0], G.successors) == len(nodes)
            and reach(nodes[0], G.predecessors) == len(nodes))


def relabel_nodes(G: DiGraph, mapping: Dict[int, int],
                  copy: bool = True) -> DiGraph:
    """A relabeled copy of ``G`` (``networkx.relabel_nodes(G, mapping,
    copy=True)``): nodes, edges and their attributes in ``G``'s order,
    nodes missing from ``mapping`` keep their label, ``graph`` is copied.

    Only the copy is supported: ``copy=False`` (networkx's in-place
    relabel) raises ``ValueError``."""
    if not copy:
        raise ValueError("relabel_nodes supports only copy=True "
                         "(a relabeled copy); in-place relabeling is "
                         "not implemented")
    H = DiGraph()
    H.graph.update(G.graph)
    H.add_nodes_from(mapping.get(n, n) for n in G.nodes)
    for u, v, d in G.edges(data=True):
        H.add_edge(mapping.get(u, u), mapping.get(v, v), **dict(d))
    return H


def _check_size(size: int) -> None:
    if not isinstance(size, (int, np.integer)) or size < 1:
        raise ValueError(f"topology size must be a positive int, got {size!r}")


def _finalize(G: DiGraph, weighted: bool) -> DiGraph:
    """Stamp bookkeeping attributes used by GetRecvWeights / the plan
    compiler."""
    G.graph["weighted"] = weighted
    return G


def _uniform_in_weights(G: DiGraph) -> None:
    """Assign each in-edge of v the weight 1/(in_degree(v)+1); the implicit
    self weight becomes the same 1/(d+1)."""
    for v in G.nodes():
        d = G.in_degree(v)
        for u in G.predecessors(v):
            G[u][v]["weight"] = 1.0 / (d + 1)


def ExponentialTwoGraph(size: int) -> DiGraph:
    """Static exponential-2 digraph: rank i receives from (i - 2^j) % size and
    sends to (i + 2^j) % size for j = 0..ceil(log2(size))-1."""
    _check_size(size)
    G = DiGraph()
    G.add_nodes_from(range(size))
    if size > 1:
        nbits = int(math.ceil(math.log2(size)))
        offsets = sorted({(1 << j) % size for j in range(nbits)} - {0})
        for i in range(size):
            for off in offsets:
                G.add_edge((i - off) % size, i)
    _uniform_in_weights(G)
    return _finalize(G, weighted=False)


def ExponentialGraph(size: int, base: int = 2) -> DiGraph:
    """Exponential digraph with offsets base^j for all j with base^j < size."""
    _check_size(size)
    if base < 2:
        raise ValueError("base must be >= 2")
    G = DiGraph()
    G.add_nodes_from(range(size))
    offsets = []
    off = 1
    while off < size:
        offsets.append(off)
        off *= base
    for i in range(size):
        for off in offsets:
            G.add_edge((i - off) % size, i)
    _uniform_in_weights(G)
    return _finalize(G, weighted=False)


def SymmetricExponentialGraph(size: int, base: int = 4) -> DiGraph:
    """Exponential graph with symmetric offsets ±base^j; the mixing matrix
    is symmetric hence doubly stochastic."""
    _check_size(size)
    if base < 2:
        raise ValueError("base must be >= 2")
    G = DiGraph()
    G.add_nodes_from(range(size))
    offsets = set()
    off = 1
    while off < size:
        offsets.add(off % size)
        offsets.add((-off) % size)
        off *= base
    offsets -= {0}
    for i in range(size):
        for off in sorted(offsets):
            G.add_edge((i - off) % size, i)
    _uniform_in_weights(G)
    return _finalize(G, weighted=False)


def RingGraph(size: int, connect_style: int = 0) -> DiGraph:
    """Ring topology.  connect_style 0: bidirectional; 1: receive from left
    (i-1 -> i); 2: receive from right (i+1 -> i)."""
    _check_size(size)
    if connect_style not in (0, 1, 2):
        raise ValueError(f"connect_style must be 0, 1, or 2, got {connect_style}")
    G = DiGraph()
    G.add_nodes_from(range(size))
    if size > 1:
        for i in range(size):
            if connect_style in (0, 1):
                G.add_edge((i - 1) % size, i)
            if connect_style in (0, 2) and size > 2:
                G.add_edge((i + 1) % size, i)
            elif connect_style == 2 and size == 2:
                G.add_edge((i + 1) % size, i)
    _uniform_in_weights(G)
    return _finalize(G, weighted=False)


def StarGraph(size: int, center_rank: int = 0) -> DiGraph:
    """Star topology with Metropolis–Hastings weights (doubly stochastic)."""
    _check_size(size)
    if not 0 <= center_rank < size:
        raise ValueError("center_rank out of range")
    G = DiGraph()
    G.add_nodes_from(range(size))
    for i in range(size):
        if i != center_rank:
            G.add_edge(center_rank, i)
            G.add_edge(i, center_rank)
    MetropolisHastingsWeights(G)
    return _finalize(G, weighted=True)


def MetropolisHastingsWeights(G: DiGraph) -> DiGraph:
    """Re-weight every edge in place with ``w_uv = 1 / (1 + max(deg(u),
    deg(v)))`` and return ``G``."""
    for u, v in G.edges():
        G[u][v]["weight"] = 1.0 / (1 + max(G.in_degree(u), G.in_degree(v)))
    G.graph["weighted"] = True
    return G


def MeshGrid2DGraph(size: int, shape: Optional[Tuple[int, int]] = None) -> DiGraph:
    """2-D (non-wraparound) grid with 4-neighborhood and Metropolis–Hastings
    weights; ``shape`` defaults to the most-square factorization."""
    _check_size(size)
    if shape is None:
        a = int(math.sqrt(size))
        while size % a != 0:
            a -= 1
        shape = (a, size // a)
    nrow, ncol = shape
    if nrow * ncol != size:
        raise ValueError(f"shape {shape} does not factor size {size}")
    G = DiGraph()
    G.add_nodes_from(range(size))
    for r in range(nrow):
        for c in range(ncol):
            i = r * ncol + c
            if c + 1 < ncol:
                G.add_edge(i, i + 1)
                G.add_edge(i + 1, i)
            if r + 1 < nrow:
                G.add_edge(i, i + ncol)
                G.add_edge(i + ncol, i)
    MetropolisHastingsWeights(G)
    G.graph["shape"] = (nrow, ncol)
    return _finalize(G, weighted=True)


def FullyConnectedGraph(size: int) -> DiGraph:
    """Complete digraph, weight 1/size everywhere."""
    _check_size(size)
    G = DiGraph()
    G.add_nodes_from(range(size))
    for i, j in itertools.permutations(range(size), 2):
        G.add_edge(i, j, weight=1.0 / size)
    return _finalize(G, weighted=True)


# --------------------------------------------------------------------------
# Introspection helpers
# --------------------------------------------------------------------------


def IsRegularGraph(topo: DiGraph) -> bool:
    """True iff every node has the same in-degree and the same out-degree."""
    degs_in = {topo.in_degree(v) for v in topo.nodes()}
    degs_out = {topo.out_degree(v) for v in topo.nodes()}
    return len(degs_in) <= 1 and len(degs_out) <= 1


def IsTopologyEquivalent(topo1: Optional[DiGraph], topo2: Optional[DiGraph]) -> bool:
    """Node/edge/weight equality up to float tolerance."""
    if topo1 is None or topo2 is None:
        return topo1 is topo2
    if set(topo1.nodes()) != set(topo2.nodes()):
        return False
    if set(topo1.edges()) != set(topo2.edges()):
        return False
    for u, v in topo1.edges():
        w1 = topo1[u][v].get("weight", 1.0)
        w2 = topo2[u][v].get("weight", 1.0)
        if abs(w1 - w2) > 1e-12:
            return False
    return True


def GetRecvWeights(topo: DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {in_neighbor: weight}) for ``rank``; self weight is
    1 - sum(in-weights)."""
    recv = {int(u): float(topo[u][rank]["weight"]) for u in topo.predecessors(rank)}
    return 1.0 - sum(recv.values()), recv


def GetSendWeights(topo: DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {out_neighbor: weight dst assigns to us})."""
    send = {int(v): float(topo[rank][v]["weight"]) for v in topo.successors(rank)}
    return 1.0 - sum(send.values()), send


def GetWeightMatrix(topo: DiGraph) -> np.ndarray:
    """Dense mixing matrix W with W[v, u] = weight of u's value at v and
    W[v, v] = self weight.  Rows sum to 1 by construction."""
    n = topo.number_of_nodes()
    W = np.zeros((n, n))
    for v in range(n):
        sw, recv = GetRecvWeights(topo, v)
        W[v, v] = sw
        for u, w in recv.items():
            W[v, u] = w
    return W


# --------------------------------------------------------------------------
# Dynamic (per-step) topology generators
# --------------------------------------------------------------------------


def GetDynamicOnePeerSendRecvRanks(
    size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Infinite generator of one-peer exp-2 rotations: at step t each rank
    sends to (rank + 2^(t mod nbits)) and receives from (rank - 2^(t mod
    nbits))."""
    _check_size(size)
    if not 0 <= self_rank < size:
        raise ValueError("self_rank out of range")
    nbits = max(1, int(math.ceil(math.log2(size)))) if size > 1 else 1
    for t in itertools.count():
        if size == 1:
            yield [], []
            continue
        off = (1 << (t % nbits)) % size
        if off == 0:
            off = 1
        yield [(self_rank + off) % size], [(self_rank - off) % size]


def GetInnerOuterRingDynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Alternate an intra-machine ring step with a cross-machine ring step
    at fixed local index."""
    _check_size(world_size)
    if world_size % local_size != 0:
        raise ValueError("world_size must be a multiple of local_size")
    nmachines = world_size // local_size
    machine, lrank = divmod(self_rank, local_size)
    for t in itertools.count():
        if t % 2 == 0 and local_size > 1:
            send = machine * local_size + (lrank + 1) % local_size
            recv = machine * local_size + (lrank - 1) % local_size
            yield [send], [recv]
        elif nmachines > 1:
            send = ((machine + 1) % nmachines) * local_size + lrank
            recv = ((machine - 1) % nmachines) * local_size + lrank
            yield [send], [recv]
        else:
            yield [], []


def GetInnerOuterExpo2DynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Alternate intra-machine exp-2 rotation with cross-machine exp-2
    rotation at fixed local index."""
    _check_size(world_size)
    if world_size % local_size != 0:
        raise ValueError("world_size must be a multiple of local_size")
    nmachines = world_size // local_size
    machine, lrank = divmod(self_rank, local_size)
    in_bits = max(1, int(math.ceil(math.log2(local_size)))) if local_size > 1 else 1
    out_bits = max(1, int(math.ceil(math.log2(nmachines)))) if nmachines > 1 else 1
    ti = to = 0
    for t in itertools.count():
        if t % 2 == 0 and local_size > 1:
            off = (1 << (ti % in_bits)) % local_size or 1
            ti += 1
            send = machine * local_size + (lrank + off) % local_size
            recv = machine * local_size + (lrank - off) % local_size
            yield [send], [recv]
        elif nmachines > 1:
            off = (1 << (to % out_bits)) % nmachines or 1
            to += 1
            send = ((machine + off) % nmachines) * local_size + lrank
            recv = ((machine - off) % nmachines) * local_size + lrank
            yield [send], [recv]
        else:
            yield [], []


def GetExp2DynamicSendRecvMachineRanks(
    world_size: int, local_size: int, self_rank: int, local_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Machine-level one-peer exp-2 rotation for hierarchical ops: yields
    *machine* indices, only meaningful for ranks with ``local_rank == 0``."""
    _check_size(world_size)
    if world_size % local_size != 0:
        raise ValueError("world_size must be a multiple of local_size")
    nmachines = world_size // local_size
    machine = self_rank // local_size
    bits = max(1, int(math.ceil(math.log2(nmachines)))) if nmachines > 1 else 1
    for t in itertools.count():
        if nmachines == 1 or local_rank != 0:
            yield [], []
            continue
        off = (1 << (t % bits)) % nmachines or 1
        yield [(machine + off) % nmachines], [(machine - off) % nmachines]


# --------------------------------------------------------------------------
# Rank-inference helpers: pure functions over all ranks' lists (the rank-major
# context holds the global picture in one process)
# --------------------------------------------------------------------------


def InferDestinationFromSourceRanks(
    src_ranks: Sequence[Sequence[int]],
) -> List[List[int]]:
    """Given per-rank *source* lists (src_ranks[r] = ranks r receives from),
    return per-rank *destination* lists (who r must send to)."""
    n = len(src_ranks)
    dst: List[List[int]] = [[] for _ in range(n)]
    for r, srcs in enumerate(src_ranks):
        for s in srcs:
            if not 0 <= s < n:
                raise ValueError(f"rank {r} lists out-of-range source {s}")
            dst[s].append(r)
    return [sorted(d) for d in dst]


def InferSourceFromDestinationRanks(
    dst_ranks: Sequence[Sequence[int]],
) -> List[List[int]]:
    """Given per-rank *destination* lists, return per-rank *source* lists."""
    n = len(dst_ranks)
    src: List[List[int]] = [[] for _ in range(n)]
    for r, dsts in enumerate(dst_ranks):
        for d in dsts:
            if not 0 <= d < n:
                raise ValueError(f"rank {r} lists out-of-range destination {d}")
            src[d].append(r)
    return [sorted(s) for s in src]
