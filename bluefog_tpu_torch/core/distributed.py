"""The multi-process backend: process groups on ``torch.distributed`` (gloo)
and the row exchange every cross-process op rides on (counterpart of the
reference's ``jax.distributed`` world, ``bluefog_tpu/core/basics.py``).

Ranks are process-major, as in the reference: with ``P`` processes over
``N`` ranks, process ``p`` holds the contiguous block of rows ``p*N/P ...
(p+1)*N/P - 1`` of every rank-major tensor, on its own device.  An op
that mixes ranks (one shift class of a plan, a window deposit) needs, for
each row it holds, the row of one global source rank.  :func:`schedule`
turns those sources into a pure, cached plan of who sends which rows to
whom; :func:`exchange` carries it out:

- rows whose source this process holds come by ``index_select``;
- rows whose source another process holds come in one ``irecv`` from
  that process, answered by its one ``isend``, carrying only the rows that
  cross the boundary, one pair a peer a call.

The backend is gloo.  Gloo moves host memory, so a row on the card is
staged, visibly: the outgoing rows are copied into a pinned host buffer
before the send and the incoming ones land in a pinned host buffer that
is copied to the card after the receive.  Every byte that crosses and the
time the staging copies take are counted in :func:`transfer_stats`.  The
global collectives (:func:`all_reduce_sum`, :func:`all_gather_rows`,
:func:`broadcast_from`) stage the same way.

The launcher (``bftpu-torch-run -np N``) exports the rendezvous in
``BFTPU_COORDINATOR_ADDRESS`` / ``BFTPU_NUM_PROCESSES`` /
``BFTPU_PROCESS_ID``; :func:`init_process_group` reads them and raises
where the rendezvous fails: it never goes on as one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "ENV_COORDINATOR",
    "ENV_NUM_PROCESSES",
    "ENV_PROCESS_ID",
    "ProcessLayout",
    "Schedule",
    "coordinator_from_env",
    "init_process_group",
    "schedule",
    "exchange",
    "all_reduce_sum",
    "all_gather_rows",
    "broadcast_from",
    "barrier",
    "transfer_stats",
]

ENV_COORDINATOR = "BFTPU_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "BFTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "BFTPU_PROCESS_ID"


class ProcessLayout(NamedTuple):
    """``nprocs`` processes, this one ``pid``; ranks in contiguous blocks."""

    nprocs: int
    pid: int

    def block(self, n: int) -> int:
        """Rows a process holds of an axis of ``n`` ranks."""
        if n % self.nprocs:
            raise ValueError(f"{n} ranks do not split over {self.nprocs} processes")
        return n // self.nprocs

    def first(self, n: int) -> int:
        """The first of this process's rows of an axis of ``n`` ranks."""
        return self.pid * self.block(n)


def coordinator_from_env() -> Optional[str]:
    """The launcher's rendezvous address, or None outside a launch."""
    return os.environ.get(ENV_COORDINATOR) or None


def init_process_group(coordinator: Optional[str] = None, nprocs: Optional[int] = None,
                       pid: Optional[int] = None, *,
                       timeout: float = 300.0) -> ProcessLayout:
    """Join the gloo process group at ``tcp://coordinator`` as process
    ``pid`` of ``nprocs`` (each, where None, from the launcher's env).
    Raises where the rendezvous fails within ``timeout`` seconds (which
    also bounds every later transfer) or an argument is missing."""
    import torch.distributed as dist

    coordinator = coordinator or coordinator_from_env()
    if nprocs is None and os.environ.get(ENV_NUM_PROCESSES):
        nprocs = int(os.environ[ENV_NUM_PROCESSES])
    if pid is None and os.environ.get(ENV_PROCESS_ID):
        pid = int(os.environ[ENV_PROCESS_ID])
    if not coordinator or nprocs is None or pid is None:
        raise RuntimeError(
            "bluefog_tpu_torch: the distributed mode needs a coordinator, a process "
            f"count and a process id ({ENV_COORDINATOR}, {ENV_NUM_PROCESSES}, "
            f"{ENV_PROCESS_ID}, as bftpu-torch-run -np N exports them); got "
            f"{coordinator!r}, {nprocs!r}, {pid!r}")
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=int(nprocs), rank=int(pid),
                                timeout=datetime.timedelta(seconds=timeout))
    if dist.get_world_size() != int(nprocs) or dist.get_rank() != int(pid):
        raise RuntimeError(
            f"the process group is {dist.get_rank()} of {dist.get_world_size()}, "
            f"asked for {pid} of {nprocs}")
    return ProcessLayout(int(nprocs), int(pid))


# --------------------------------------------------------------------------
# The schedule: a pure function of (sources, nprocs, pid)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Who sends which rows to whom, for one gather of global source rows.

    All row indices are relative to this process's block.  ``local_dst[i]``
    takes this process's row ``local_src[i]``; for each ``(peer, rows)`` of
    ``recvs`` the rows ``rows`` come from ``peer``, in that order, and for
    each ``(peer, rows)`` of ``sends`` this process sends its rows ``rows``
    to ``peer``, in the order the peer receives them."""

    n: int
    nprocs: int
    pid: int
    local_dst: Tuple[int, ...]
    local_src: Tuple[int, ...]
    recvs: Tuple[Tuple[int, Tuple[int, ...]], ...]
    sends: Tuple[Tuple[int, Tuple[int, ...]], ...]

    @property
    def rows_in(self) -> int:
        """Rows that cross into this process."""
        return sum(len(r) for _, r in self.recvs)

    @property
    def rows_out(self) -> int:
        """Rows that cross out of this process."""
        return sum(len(r) for _, r in self.sends)


@functools.lru_cache(maxsize=1024)
def schedule(src: Tuple[int, ...], nprocs: int, pid: int) -> Schedule:
    """The schedule of gathering ``src[d]`` into row ``d`` for every global
    row ``d`` (``len(src)`` ranks over ``nprocs`` processes), seen from
    process ``pid``.  Only rows whose source lies in another process
    cross, one batch a peer each way."""
    n = len(src)
    lay = ProcessLayout(nprocs, pid)
    b, r0 = lay.block(n), lay.first(n)
    local_dst, local_src = [], []
    recvs: Dict[int, List[int]] = {}
    for i in range(b):
        s = int(src[r0 + i])
        if not 0 <= s < n:
            raise ValueError(f"source {s} of row {r0 + i} is outside {n} ranks")
        if s // b == pid:
            local_dst.append(i)
            local_src.append(s - r0)
        else:
            recvs.setdefault(s // b, []).append(i)
    sends: Dict[int, List[int]] = {}
    for q in range(nprocs):
        if q == pid:
            continue
        for d in range(q * b, (q + 1) * b):
            s = int(src[d])
            if s // b == pid:
                sends.setdefault(q, []).append(s - r0)
    return Schedule(n, nprocs, pid, tuple(local_dst), tuple(local_src),
                    tuple((q, tuple(r)) for q, r in sorted(recvs.items())),
                    tuple((q, tuple(r)) for q, r in sorted(sends.items())))


# --------------------------------------------------------------------------
# Staging and the transfers
# --------------------------------------------------------------------------

_STATS = {"bytes_sent": 0, "bytes_received": 0, "messages": 0, "staging_s": 0.0,
          "wire_s": 0.0, "calls": 0}


def transfer_stats() -> Dict[str, float]:
    """What crossed processes so far in this process: bytes each way, the
    point-to-point messages, the seconds spent in the host staging copies
    (card to pinned host and back, the card synchronized around them) and
    in the transfers themselves."""
    return dict(_STATS)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` that gloo can move (and write): a
    pinned buffer for a tensor on the card."""
    if not t.is_cuda:
        return t.contiguous().clone()
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _STATS["staging_s"] += time.perf_counter() - t0
    return host


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A receive buffer on the host, pinned where the rows go to the card."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type != "cuda":
        return host
    t0 = time.perf_counter()
    out = host.to(device, non_blocking=True)
    torch.cuda.synchronize(device)
    _STATS["staging_s"] += time.perf_counter() - t0
    return out


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The raw bytes of a contiguous tensor, so any dtype crosses as is."""
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1).to(torch.uint8)


@functools.lru_cache(maxsize=1024)
def _index(rows: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.long, device=device)


def exchange(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """``out[i]`` = global row ``src[first + i]`` of the rank-major tensor
    whose rows this process holds as ``x [block, ...]``: the in-process
    rows by ``index_select``, the others by one ``isend`` / ``irecv`` pair
    a peer, through pinned host buffers on the card.  Every process of the
    group calls it with its own schedule of the same sources.  Where no row
    crosses either way (one process, or a class inside every process) it
    is one ``index_select``."""
    dev = x.device
    if not sched.sends and not sched.recvs:  # then local_dst is every row, in order
        return x.index_select(0, _index(sched.local_src, dev))
    import torch.distributed as dist

    out = torch.empty_like(x)
    if sched.local_dst:
        out[_index(sched.local_dst, dev)] = x.index_select(0, _index(sched.local_src, dev))
    _sync(x)
    row_shape, row_bytes = x.shape[1:], x[0].numel() * x.element_size()
    outgoing = [(q, _to_host(x.index_select(0, _index(rows, dev)))) for q, rows in sched.sends]
    incoming = [(q, rows, _host_buffer((len(rows),) + row_shape, x.dtype, dev))
                for q, rows in sched.recvs]
    t0 = time.perf_counter()
    reqs = [dist.irecv(_as_bytes(buf), src=q) for q, _, buf in incoming]
    reqs += [dist.isend(_as_bytes(buf), dst=q) for q, buf in outgoing]
    for r in reqs:
        r.wait()
    _STATS["wire_s"] += time.perf_counter() - t0
    _STATS["bytes_sent"] += sum(len(rows) for _, rows in sched.sends) * row_bytes
    _STATS["bytes_received"] += sched.rows_in * row_bytes
    _STATS["messages"] += len(reqs)
    _STATS["calls"] += 1
    for q, rows, buf in incoming:
        out[_index(rows, dev)] = _to_device(buf, dev)
    return out


def _wide(t: torch.Tensor) -> torch.Tensor:
    """Half-precision floats cross gloo's reductions as float32."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over every process of ``t`` (same shape everywhere), in
    ``t``'s dtype (half floats summed in float32), on ``t``'s device."""
    import torch.distributed as dist

    _sync(t)
    host = _to_host(_wide(t))
    t0 = time.perf_counter()
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    _STATS["wire_s"] += time.perf_counter() - t0
    nbytes = host.numel() * host.element_size()
    _STATS["bytes_sent"] += nbytes
    _STATS["bytes_received"] += nbytes
    return _to_device(host, t.device).to(t.dtype)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t [block, ...]`` concatenated in process order:
    ``[nprocs * block, ...]`` on ``t``'s device."""
    import torch.distributed as dist

    _sync(t)
    host = _to_host(t)
    parts = [_host_buffer(host.shape, host.dtype, t.device)
             for _ in range(dist.get_world_size())]
    t0 = time.perf_counter()
    dist.all_gather([_as_bytes(p) for p in parts], _as_bytes(host))
    _STATS["wire_s"] += time.perf_counter() - t0
    nbytes = host.numel() * host.element_size()
    _STATS["bytes_sent"] += nbytes * (len(parts) - 1)
    _STATS["bytes_received"] += nbytes * (len(parts) - 1)
    return _to_device(torch.cat(parts), t.device)


def broadcast_from(t: torch.Tensor, owner: int) -> torch.Tensor:
    """Process ``owner``'s ``t`` on every process (``t`` gives the shape
    and dtype elsewhere), on ``t``'s device."""
    import torch.distributed as dist

    _sync(t)
    host = _to_host(t)
    t0 = time.perf_counter()
    dist.broadcast(_as_bytes(host), src=owner)
    _STATS["wire_s"] += time.perf_counter() - t0
    return _to_device(host, t.device)


def barrier() -> None:
    import torch.distributed as dist

    dist.barrier()
