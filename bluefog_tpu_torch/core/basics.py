"""Context basics: init, size, topology installation.

Counterpart of ``bluefog_tpu/core/basics.py`` on the rank-major backend:
``N`` virtual ranks live along dim 0 of every tensor on one device, the
twin of the JAX package's one-rank-per-device mesh.  Where the JAX context
builds a ``Mesh``, this one records the device and the rank count; the
topology is compiled into a cached :class:`CommPlan` the same way.  The
context also holds the one-sided window state of
:mod:`bluefog_tpu_torch.windows`.  The ``torch.distributed`` backend (one
process per rank) is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.common.config import Config
from bluefog_tpu_torch.common.logging_util import logger
from bluefog_tpu_torch.core.plan import CommPlan, compile_plan
from bluefog_tpu_torch.topology_util import DiGraph

__all__ = [
    "BlueFogContext",
    "init",
    "shutdown",
    "is_initialized",
    "context",
    "size",
    "rank",
    "device",
    "set_topology",
    "load_topology",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "is_topo_weighted",
]


def _topo_key(topo: DiGraph) -> Tuple:
    return (
        topo.number_of_nodes(),
        tuple(sorted((int(u), int(v), round(float(d.get("weight", 1.0)), 12))
                     for u, v, d in topo.edges(data=True))),
    )


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.  Asking for the
    card where there is none raises: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bluefog_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the rank-major backend on the CPU"
        )
    return dev


class BlueFogContext:
    """Global framework state for ``size`` virtual ranks on ``device``."""

    def __init__(self, size: int, device: torch.device,
                 topology: Optional[DiGraph] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.config = Config.from_env()
        self.size = int(size)
        self.device = device
        self._plan_cache: Dict[Tuple, CommPlan] = {}
        self._lock = threading.Lock()
        self.topology: Optional[DiGraph] = None
        # one-sided window state (bluefog_tpu_torch.windows)
        self.windows: Dict[str, Any] = {}
        self.win_fusion: Dict[str, Any] = {}  # fused window name -> pack metadata
        self.win_associated_p_enabled = False
        self.set_topology(
            topology if topology is not None
            else topology_util.ExponentialTwoGraph(self.size)
        )

    def set_topology(self, topo: DiGraph) -> bool:
        if topo.number_of_nodes() != self.size:
            raise ValueError(
                f"topology has {topo.number_of_nodes()} nodes, world size is {self.size}"
            )
        if self.topology is not None and topology_util.IsTopologyEquivalent(
            topo, self.topology
        ):
            logger.debug("set_topology: identical topology, skipping")
            return False
        self.topology = topo
        self.plan  # eagerly compile + cache
        return True

    def plan_for(self, topo: DiGraph, **overrides) -> CommPlan:
        key = (_topo_key(topo), tuple(sorted(overrides.items())))
        with self._lock:
            if key not in self._plan_cache:
                self._plan_cache[key] = compile_plan(topo, **overrides)
            return self._plan_cache[key]

    @property
    def plan(self) -> CommPlan:
        return self.plan_for(self.topology)


_context: Optional[BlueFogContext] = None


def init(topology: Optional[DiGraph] = None, *, size: int, device=None) -> None:
    """Initialize ``size`` virtual ranks on ``device`` (default: the card;
    raises if there is none).  Default topology: ``ExponentialTwoGraph``."""
    global _context
    _context = BlueFogContext(size, resolve_device(device), topology)


def shutdown() -> None:
    """Free every window and release the context."""
    global _context
    if _context is not None:
        _context.windows.clear()
        _context.win_fusion.clear()
    _context = None


def is_initialized() -> bool:
    return _context is not None


def context() -> BlueFogContext:
    if _context is None:
        raise RuntimeError(
            "bluefog_tpu_torch is not initialized; call bluefog_tpu_torch.init()")
    return _context


def size() -> int:
    """World size = number of virtual ranks."""
    return context().size


def rank() -> int:
    """Always 0: one process holds every rank and ops act on all of them."""
    context()
    return 0


def device() -> torch.device:
    return context().device


def set_topology(topology: Optional[DiGraph] = None) -> bool:
    """Install the virtual topology (default ``ExponentialTwoGraph(size)``).
    Returns True if changed."""
    ctx = context()
    if topology is None:
        topology = topology_util.ExponentialTwoGraph(ctx.size)
    return ctx.set_topology(topology)


def load_topology() -> DiGraph:
    return context().topology


def in_neighbor_ranks(rank_: int = 0) -> List[int]:
    return list(context().plan.in_neighbors[rank_])


def out_neighbor_ranks(rank_: int = 0) -> List[int]:
    return list(context().plan.out_neighbors[rank_])


def is_topo_weighted() -> bool:
    return bool(context().topology.graph.get("weighted", False))
