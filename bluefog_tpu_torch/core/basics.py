"""Context basics: init, size, topology installation, and the process
layout of the multi-process mode.

Counterpart of ``bluefog_tpu/core/basics.py`` on the rank-major backend:
``N`` ranks live along dim 0 of every tensor, the twin of the JAX
package's one-rank-per-device mesh.  Where the JAX context builds a
``Mesh``, this one records the device and the rank count; the topology is
compiled into a cached :class:`CommPlan` the same way.  The context also
holds the one-sided window state of :mod:`bluefog_tpu_torch.windows`.

One process holds every rank by default.  With ``init(distributed=True)``
(the default under ``bftpu-torch-run -np N``, which exports the
coordinator) the ranks spread over the launched processes as in the
reference's ``jax.distributed`` world: a gloo process group
(:mod:`bluefog_tpu_torch.core.distributed`), each process holding one
contiguous block of ``size // nprocs`` ranks on its own device.  Eager ops
then take and return this process's rows: :func:`to_rank_major_global`
keeps them (from the full ``[size, ...]`` or from the block), and
:func:`local_slice` gives them back, as in the reference.  :func:`rank`
is the first rank of the block and :func:`local_ranks` lists it.

Ranks are machine-major, as in the reference: ``rank // local_size`` is the
machine, so a machine's ranks are one contiguous block of the rank axis;
without an explicit ``local_size`` or ``BLUEFOG_SIMULATE_SLICES``, a
process is a machine.  The reference's sharding objects (``mesh``,
``hierarchical_mesh``, ``rank_major_sharding``, ``replicated_sharding``)
have no counterpart: a process's rows live in one tensor on one device.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.common.config import Config
from bluefog_tpu_torch.common.logging_util import logger
from bluefog_tpu_torch.core import distributed as _distributed
from bluefog_tpu_torch.core.distributed import ProcessLayout
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
    "local_ranks",
    "process_layout",
    "to_rank_major_global",
    "local_slice",
]


def _machine_grid(size: int, local_size: Optional[int], nprocs: int = 1) -> Tuple[int, int]:
    """``(machine_size, local_size)`` for ``size`` ranks, chosen as the
    reference's ``_machine_grid`` chooses them, in priority order:

    1. an explicit ``local_size``, which must divide ``size``;
    2. ``BLUEFOG_SIMULATE_SLICES=k`` (k > 1): k machines of ``size // k``
       ranks, k must divide ``size``;
    3. several processes: one machine a process (its block of ranks);
    4. one machine holding every rank.

    The reference's TPU-slice branch has no counterpart: a process's ranks
    share one device."""
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
    if nprocs > 1:
        return nprocs, size // nprocs
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
                 topology: Optional[DiGraph] = None, local_size: Optional[int] = None,
                 layout: Optional[ProcessLayout] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.config = Config.from_env()
        self.size = int(size)
        self.layout = layout or ProcessLayout(1, 0)
        self.rows = self.layout.block(self.size)  # ranks this process holds
        self.machine_size_, self.local_size_ = _machine_grid(self.size, local_size,
                                                             self.layout.nprocs)
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


def init(topology: Optional[DiGraph] = None, *, size: Optional[int] = None,
         local_size: Optional[int] = None, device=None,
         distributed: Optional[bool] = None) -> None:
    """Initialize ``size`` ranks on ``device`` (default: the card; raises if
    there is none).  Default topology: ``ExponentialTwoGraph``.

    ``size`` defaults to ``BFTPU_SIMULATE`` (``bftpu-torch-run --simulate
    N``), which also makes the default device the CPU: the caller asked
    for N ranks there.

    ``distributed`` (default: whether the launcher's coordinator env,
    ``BFTPU_COORDINATOR_ADDRESS``, is set) joins the gloo process group of
    the launched processes; ``size`` is then the global rank count and
    this process holds ranks ``rank() ... rank() + size // nprocs - 1``.
    A failed rendezvous raises.

    ``local_size`` sets the ranks a machine for the hierarchical ops; by
    default ``BLUEFOG_SIMULATE_SLICES=k`` makes k machines, else each
    process is one (see :func:`_machine_grid`).  With more than one
    machine the machine topology defaults to
    ``ExponentialTwoGraph(machine_size)``."""
    global _context
    sim = os.environ.get("BFTPU_SIMULATE")
    if size is None:
        if not sim:
            raise ValueError("init() needs size= (or BFTPU_SIMULATE, as "
                             "bftpu-torch-run --simulate N exports it)")
        size = int(sim)
        if device is None:
            device = "cpu"
    if distributed is None:
        distributed = _distributed.coordinator_from_env() is not None
    dev = resolve_device(device)
    layout = _distributed.init_process_group() if distributed else None
    _context = BlueFogContext(size, dev, topology, local_size, layout)


def shutdown() -> None:
    """Free every window and release the context (the process group stays
    up, as the reference's ``jax.distributed`` does, so a later ``init``
    rejoins it)."""
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
    """The first rank this process holds: 0 in one process, which holds
    every rank and whose ops act on all of them; with several processes,
    the first of its contiguous block (``machine_rank() * local_size()``
    under the default grid)."""
    ctx = context()
    return ctx.layout.first(ctx.size)


def local_ranks() -> List[int]:
    """The global ranks this process holds, in order (one contiguous
    block)."""
    ctx = context()
    r0 = ctx.layout.first(ctx.size)
    return list(range(r0, r0 + ctx.rows))


def process_layout() -> Optional[ProcessLayout]:
    """The process layout when several processes share the ranks; None in
    one process or before :func:`init`."""
    ctx = _context
    if ctx is None or ctx.layout.nprocs == 1:
        return None
    return ctx.layout


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def to_rank_major_global(x):
    """A tree of rank-major arrays as this process's rows on the context's
    device.  Each leaf is either the full ``[size, ...]`` (the same in
    every process, e.g. replicated parameters) or this process's block
    ``[len(local_ranks()), ...]`` (e.g. its data shard); a full leaf keeps
    the block.  A leaf that requires grad comes back as a fresh leaf that
    requires grad.  In one process the leaves are moved to the device."""
    ctx = context()
    r0, b = ctx.layout.first(ctx.size), ctx.rows

    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        if ctx.layout.nprocs == 1:
            return t.to(ctx.device)
        if t.dim() == 0 or t.shape[0] not in (ctx.size, b):
            raise ValueError(
                f"rank-major leaf has leading dim {tuple(t.shape[:1])}; expected "
                f"size={ctx.size} (full, the same in every process) or {b} (this "
                f"process's rank rows {local_ranks()})")
        if t.shape[0] == ctx.size and ctx.size != b:
            grad = t.requires_grad
            t = t.detach()[r0:r0 + b].to(ctx.device, copy=True)
            return t.requires_grad_(grad)
        return t.to(ctx.device)

    return _tree_map(leaf, x)


def local_slice(x):
    """This process's rank rows of a tree of rank-major tensors, on the
    host: the read-side inverse of :func:`to_rank_major_global`.  A leaf
    that holds every rank ``[size, ...]`` gives this process's block; a
    leaf of this process's rows, or a replicated value, is returned as it
    is (never duplicated).  In one process every leaf is the full value."""
    ctx = context()
    r0, b = ctx.layout.first(ctx.size), ctx.rows

    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        t = t.detach()
        if ctx.layout.nprocs > 1 and t.dim() and t.shape[0] == ctx.size != b:
            t = t[r0:r0 + b]
        return t.cpu()

    return _tree_map(leaf, x)


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
