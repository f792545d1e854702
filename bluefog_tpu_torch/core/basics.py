"""Context basics: init, size, topology installation.

Counterpart of ``bluefog_tpu/core/basics.py`` on the rank-major backend:
``N`` virtual ranks live along dim 0 of every tensor on one device, the
twin of the JAX package's one-rank-per-device mesh.  Where the JAX context
builds a ``Mesh``, this one records the device and the rank count; the
topology is compiled into a cached :class:`CommPlan` the same way.  The
context also holds the one-sided window state of
:mod:`bluefog_tpu_torch.windows`.  The ``torch.distributed`` backend (one
process per rank) is not ported yet.

Ranks are machine-major, as in the reference: ``rank // local_size`` is the
machine, so a machine's ranks are one contiguous block of the rank axis.
The reference's sharding plumbing (``mesh``, ``hierarchical_mesh``,
``rank_major_sharding``, ``replicated_sharding``, ``to_rank_major_global``,
``local_slice``) has no counterpart here: every rank's row lives in one
tensor on one device, so there is nothing to shard or assemble.
"""

from __future__ import annotations

import os
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
    "local_size",
    "local_rank",
    "machine_size",
    "machine_rank",
    "device",
    "set_topology",
    "load_topology",
    "set_machine_topology",
    "load_machine_topology",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "in_neighbor_machine_ranks",
    "out_neighbor_machine_ranks",
    "is_topo_weighted",
    "is_machine_topo_weighted",
    "unified_mpi_window_model_supported",
]


def _machine_grid(size: int, local_size: Optional[int]) -> Tuple[int, int]:
    """``(machine_size, local_size)`` for ``size`` ranks, chosen as the
    reference's ``_machine_grid`` chooses them, in priority order:

    1. an explicit ``local_size``, which must divide ``size``;
    2. ``BLUEFOG_SIMULATE_SLICES=k`` (k > 1): k machines of ``size // k``
       ranks, k must divide ``size``;
    3. one machine holding every rank.

    The reference's other branches group devices by TPU slice or by host
    process; here one process holds every rank on one device, so there
    is neither to group by."""
    if local_size is not None:
        if local_size < 1 or size % local_size != 0:
            raise ValueError(f"size {size} not divisible by local_size {local_size}")
        return size // local_size, int(local_size)
    sim = os.environ.get("BLUEFOG_SIMULATE_SLICES")
    if sim:
        k = int(sim)
        if k > 1:
            if size % k != 0:
                raise ValueError(f"BLUEFOG_SIMULATE_SLICES={k} does not divide {size} ranks")
            return k, size // k
    return 1, size


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
                 topology: Optional[DiGraph] = None, local_size: Optional[int] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.config = Config.from_env()
        self.size = int(size)
        self.machine_size_, self.local_size_ = _machine_grid(self.size, local_size)
        self.device = device
        self._plan_cache: Dict[Tuple, CommPlan] = {}
        self._lock = threading.Lock()
        self.topology: Optional[DiGraph] = None
        self.machine_topology: Optional[DiGraph] = None
        # one-sided window state (bluefog_tpu_torch.windows)
        self.windows: Dict[str, Any] = {}
        self.win_fusion: Dict[str, Any] = {}  # fused window name -> pack metadata
        self.win_associated_p_enabled = False
        self.set_topology(
            topology if topology is not None
            else topology_util.ExponentialTwoGraph(self.size)
        )
        if self.machine_size_ > 1:
            self.set_machine_topology(topology_util.ExponentialTwoGraph(self.machine_size_))

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

    def set_machine_topology(self, topo: DiGraph) -> bool:
        if topo.number_of_nodes() != self.machine_size_:
            raise ValueError(
                f"machine topology has {topo.number_of_nodes()} nodes, "
                f"machine size is {self.machine_size_}"
            )
        self.machine_topology = topo
        self.machine_plan
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

    @property
    def machine_plan(self) -> CommPlan:
        if self.machine_topology is None:
            raise RuntimeError(
                "no machine topology; call set_machine_topology() (machine_size="
                f"{self.machine_size_})")
        return self.plan_for(self.machine_topology)


_context: Optional[BlueFogContext] = None


def init(topology: Optional[DiGraph] = None, *, size: int,
         local_size: Optional[int] = None, device=None) -> None:
    """Initialize ``size`` virtual ranks on ``device`` (default: the card;
    raises if there is none).  Default topology: ``ExponentialTwoGraph``.

    ``local_size`` sets the ranks a machine for the hierarchical ops; by
    default ``BLUEFOG_SIMULATE_SLICES=k`` makes k machines, and without it
    all ranks form one machine (see :func:`_machine_grid`).  With more than
    one machine the machine topology defaults to
    ``ExponentialTwoGraph(machine_size)``."""
    global _context
    _context = BlueFogContext(size, resolve_device(device), topology, local_size)


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


def local_size() -> int:
    return context().local_size_


def local_rank() -> int:
    return rank() % context().local_size_


def machine_size() -> int:
    return context().machine_size_


def machine_rank() -> int:
    return rank() // context().local_size_


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


def set_machine_topology(topology: DiGraph) -> bool:
    """Install the machine-level topology of
    :func:`~bluefog_tpu_torch.ops.hierarchical_neighbor_allreduce`."""
    return context().set_machine_topology(topology)


def load_machine_topology() -> Optional[DiGraph]:
    return context().machine_topology


def in_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    r = rank() if rank_ is None else rank_
    return list(context().plan.in_neighbors[r])


def out_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    r = rank() if rank_ is None else rank_
    return list(context().plan.out_neighbors[r])


def in_neighbor_machine_ranks(machine_rank_: Optional[int] = None) -> List[int]:
    ctx = context()
    if ctx.machine_topology is None:
        return []
    r = machine_rank() if machine_rank_ is None else machine_rank_
    return list(ctx.machine_plan.in_neighbors[r])


def out_neighbor_machine_ranks(machine_rank_: Optional[int] = None) -> List[int]:
    ctx = context()
    if ctx.machine_topology is None:
        return []
    r = machine_rank() if machine_rank_ is None else machine_rank_
    return list(ctx.machine_plan.out_neighbors[r])


def is_topo_weighted() -> bool:
    return bool(context().topology.graph.get("weighted", False))


def is_machine_topo_weighted() -> bool:
    topo = context().machine_topology
    return bool(topo.graph.get("weighted", False)) if topo is not None else False


def unified_mpi_window_model_supported() -> bool:
    """Always True, as in the reference: the mailbox emulation gives every
    rank the same window model."""
    return True
