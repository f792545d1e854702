"""ctypes wrapper over the native layout annealer (layout_optimizer.cc).
The reference falls back to a pure-Python twin of the search when its
library is missing; here the library is built from the sources, and a
failed build raises."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.native import get_lib


def anneal_layout(
    coords: Sequence[Sequence[int]],
    torus_shape: Sequence[int],
    edges: Sequence[Tuple[int, int]],
    weights: Optional[Sequence[float]] = None,
    *,
    init: Optional[Sequence[int]] = None,
    iters: int = 20000,
    seed: int = 0,
) -> Tuple[List[int], float]:
    """Best-found rank→position assignment and its weighted hop cost.

    ``coords[p]`` is candidate position p's torus coordinate; ranks and
    positions are both ``0..n-1``.  ``init`` seeds the search (identity by
    default).  Deterministic for a given seed.
    """
    n = len(coords)
    nd = len(torus_shape)
    if any(len(c) != nd for c in coords):
        raise ValueError("coords dimensionality does not match torus_shape")
    m = len(edges)
    w = [1.0] * m if weights is None else list(weights)
    if len(w) != m:
        raise ValueError(f"{m} edges but {len(w)} weights")
    assign = list(range(n)) if init is None else list(init)
    if sorted(assign) != list(range(n)):
        raise ValueError("init must be a permutation of 0..n-1")
    for s, d in edges:
        if not (0 <= s < n and 0 <= d < n) or s == d:
            raise ValueError(f"invalid edge ({s}, {d})")

    lib = get_lib()
    c_coords = np.ascontiguousarray(coords, dtype=np.int64).reshape(n, nd)
    c_shape = np.ascontiguousarray(torus_shape, dtype=np.int64)
    c_src = np.ascontiguousarray([e[0] for e in edges], dtype=np.int64)
    c_dst = np.ascontiguousarray([e[1] for e in edges], dtype=np.int64)
    c_w = np.ascontiguousarray(w, dtype=np.float64)
    c_assign = np.ascontiguousarray(assign, dtype=np.int64)
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    cost = lib.bf_layout_anneal(
        n, nd, ip(c_coords), ip(c_shape), m, ip(c_src), ip(c_dst),
        c_w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        iters, seed, ip(c_assign),
    )
    if cost < 0:
        raise ValueError("native annealer rejected the input")
    return c_assign.tolist(), float(cost)
