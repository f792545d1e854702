"""ctypes wrapper over the native plan compiler (plan_compiler.cc)."""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.native import get_lib


def compile_edge_classes(
    size: int, edges: Sequence[Tuple[int, int]]
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(class_of_edge, slot_of_edge, n_classes) via the native library.
    Raises ValueError on invalid edges (the same conditions plan.py
    checks)."""
    lib = get_lib()
    n = len(edges)
    srcs = np.ascontiguousarray([e[0] for e in edges], dtype=np.int64)
    dsts = np.ascontiguousarray([e[1] for e in edges], dtype=np.int64)
    cls = np.zeros(n, dtype=np.int64)
    slot = np.zeros(n, dtype=np.int64)
    as_ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    n_classes = lib.bf_plan_compile(
        size, n, as_ptr(srcs), as_ptr(dsts), as_ptr(cls), as_ptr(slot)
    )
    if n_classes < 0:
        raise ValueError("invalid edge list (self-edge, duplicate, or out of range)")
    return cls, slot, int(n_classes)
