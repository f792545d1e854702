"""ICI-aware topology layout (counterpart of ``bluefog_tpu/parallel/ici_map.py``).

The reference maps virtual gossip graphs onto the TPU's ICI torus: it
orders devices along a snake (boustrophedon) Hamiltonian cycle, so
consecutive ranks sit one hop apart, and prices a plan's edges in hops.
The pure layout arithmetic is copied here unchanged: :func:`snake_order`,
:func:`hop_distance`, :func:`plan_hop_cost` and
:func:`assignment_from_coords`, for callers that model a torus.

On the rank-major backend one CUDA card holds every rank: there is no
torus to lay ranks onto, and a ``torch.device`` has no physical
``coords``.  So :func:`device_coords` returns None for CUDA (and CPU)
devices, and :func:`order_devices_for_ring` and
:func:`order_devices_for_topology` keep the given order, as the reference
does on its CPU meshes.  :func:`optimize_assignment` runs the
reference's simulated annealer (``native/layout_optimizer.cc``, built from
this package's copy of the source, through
``native.layout_native.anneal_layout``) for callers that model a torus.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.core.plan import CommPlan

Coord = Tuple[int, ...]

__all__ = [
    "snake_order",
    "device_coords",
    "order_devices_for_ring",
    "order_devices_for_topology",
    "hop_distance",
    "plan_hop_cost",
    "assignment_from_coords",
    "optimize_assignment",
]


def snake_order(shape: Sequence[int]) -> List[Coord]:
    """Boustrophedon visit order of an N-D torus grid.

    Consecutive entries differ by one unit step in exactly one dimension
    (torus-adjacent); for even leading dimensions the cycle also closes
    (last adjacent to first via a wraparound link).
    """
    shape = tuple(int(s) for s in shape)
    if not shape:
        return [()]
    if len(shape) == 1:
        return [(i,) for i in range(shape[0])]
    inner = snake_order(shape[1:])
    out: List[Coord] = []
    for i in range(shape[0]):
        layer = inner if i % 2 == 0 else inner[::-1]
        out.extend((i,) + c for c in layer)
    return out


def device_coords(devices) -> Optional[List[Coord]]:
    """Physical torus coords of ``devices`` (None when unavailable: CUDA and
    CPU devices have none)."""
    coords = []
    for d in devices:
        c = getattr(d, "coords", None)
        if c is None:
            return None
        coords.append(tuple(int(v) for v in c))
    return coords


def assignment_from_coords(
    coords: Sequence[Coord], torus_shape: Sequence[int]
) -> List[int]:
    """Rank order (device indices) following the snake cycle of the torus.

    ``coords[i]`` is device i's physical coordinate; returns a permutation
    ``order`` such that rank r should be device ``order[r]``.
    """
    pos = {tuple(c): i for i, c in enumerate(coords)}
    order = []
    for c in snake_order(torus_shape):
        if c in pos:
            order.append(pos[c])
    if len(order) != len(coords):
        raise ValueError(
            f"coords do not tile the torus {tuple(torus_shape)}: "
            f"{len(order)} of {len(coords)} matched"
        )
    return order


def order_devices_for_ring(devices, torus_shape: Optional[Sequence[int]] = None):
    """Reorder ``devices`` so consecutive ranks are torus-adjacent.

    Keeps the given order when physical coords are unavailable (always, for
    CUDA and CPU devices): the mapping is then logical only.
    """
    coords = device_coords(devices)
    if coords is None:
        return list(devices)
    if torus_shape is None:
        torus_shape = tuple(max(c[d] for c in coords) + 1 for d in range(len(coords[0])))
    order = assignment_from_coords(coords, torus_shape)
    return [devices[i] for i in order]


def _topology_edges(topo):
    """Directed non-self edges + weights of a digraph."""
    edges, weights = [], []
    for s, d, data in topo.edges(data=True):
        if s == d:
            continue
        edges.append((int(s), int(d)))
        weights.append(float(data.get("weight", 1.0)))
    return edges, weights


def optimize_assignment(
    topo,
    coords: Sequence[Coord],
    torus_shape: Sequence[int],
    *,
    iters: int = 20000,
    seed: int = 0,
):
    """Annealed rank→position assignment for an arbitrary weighted digraph.

    Seeds the search with the snake order (so the result is never worse than
    the heuristic) and runs the native simulated annealer
    (``native/layout_optimizer.cc``) to minimize Σ weight·hops over the
    topology's edges.  Returns ``(order, cost)`` where ``order[r]`` indexes
    ``coords``.  The native library is built at first use; a failed build
    raises.
    """
    from bluefog_tpu_torch.native.layout_native import anneal_layout

    try:
        init = assignment_from_coords(coords, torus_shape)
    except ValueError:
        init = None  # coords don't tile the torus; start from identity
    edges, weights = _topology_edges(topo)
    return anneal_layout(
        coords, torus_shape, edges, weights, init=init, iters=iters, seed=seed
    )


def order_devices_for_topology(
    devices,
    topo,
    torus_shape: Optional[Sequence[int]] = None,
    *,
    iters: int = 20000,
    seed: int = 0,
):
    """Reorder ``devices`` to minimize the topology's weighted ICI hop cost.

    The general-graph sibling of :func:`order_devices_for_ring`.  Keeps the
    given order when physical coords are unavailable (always, for CUDA and
    CPU devices); with coords it runs :func:`optimize_assignment`.
    """
    coords = device_coords(devices)
    if coords is None:
        return list(devices)
    if torus_shape is None:
        torus_shape = tuple(
            max(c[d] for c in coords) + 1 for d in range(len(coords[0]))
        )
    order, _ = optimize_assignment(
        topo, coords, torus_shape, iters=iters, seed=seed
    )
    return [devices[i] for i in order]


def hop_distance(a: Coord, b: Coord, torus_shape: Sequence[int]) -> int:
    """Torus Manhattan distance (wraparound-aware) between two coords."""
    dist = 0
    for x, y, s in zip(a, b, torus_shape):
        d = abs(x - y)
        dist += min(d, s - d)
    return dist


def plan_hop_cost(
    plan: CommPlan,
    rank_coords: Sequence[Coord],
    torus_shape: Sequence[int],
) -> Dict[str, float]:
    """Hop statistics of a compiled plan under a rank→coord assignment.

    total_hops drives link-bandwidth use; max_edge_hops is the latency
    critical path of one gossip round.
    """
    hops = [
        hop_distance(rank_coords[s], rank_coords[d], torus_shape)
        for cls in plan.classes
        for s, d in cls.perm
    ]
    if not hops:
        return {"total_hops": 0.0, "max_edge_hops": 0.0, "mean_edge_hops": 0.0}
    return {
        "total_hops": float(np.sum(hops)),
        "max_edge_hops": float(np.max(hops)),
        "mean_edge_hops": float(np.mean(hops)),
    }
