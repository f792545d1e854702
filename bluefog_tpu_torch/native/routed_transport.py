"""Hierarchical island transport: shared memory intra-host, TCP inter-host.

The deployment shape of the reference's hierarchical design (SURVEY.md
§2.4: NCCL/shared-memory fast path inside a machine, network transport
between machines — ``hierarchical_neighbor_allreduce``'s premise) applied
to the island mailbox: ranks on the SAME host exchange deposits through the
native seqlock shm mailbox (:mod:`shm_native`), ranks on different hosts
through the TCP mailbox (:mod:`tcp_transport`) — one window, routed per
edge by a rank→host map.

Routing rule (everything else follows from it):

- a window's slot ``(owner d, in-neighbor s)`` lives in the transport
  matching the (s, d) pair: shm iff ``host(s) == host(d)``;
- ``write``: the writer picks the transport by comparing its host with the
  destination's;
- ``read``/``collect``/``read_version``: the OWNER picks per slot the same
  way — it knows every in-neighbor's host from the map, so it reads each
  slot from the transport the writer used (the islands layer passes the
  in-neighbor rank via ``src``);
- ``expose``/``read_exposed``: exposed tensors are published to BOTH
  transports (cheap: one local shm write + one local TCP-store write), so
  any reader uses its natural path;
- ``barrier``/``mutex``: global coordination rides TCP (the only transport
  every rank shares).

The rank→host map comes from ``BLUEFOG_ISLAND_HOSTMAP`` — either
``"0,0,1,1"`` (host index per rank, comma-separated) or
``"r:h,r:h,..."`` pairs.  Single-machine tests simulate multiple hosts by
assigning fake host indices: same-"host" pairs genuinely use shm,
cross-"host" pairs genuinely use TCP loopback.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from bluefog_tpu_torch.native import capabilities as _caps


def parse_hostmap(raw: str, nranks: int) -> List[str]:
    """``"0,0,1,1"`` or ``"0:a,1:a,2:b"`` → host label per rank."""
    raw = raw.strip()
    if ":" in raw:
        out = [""] * nranks
        for item in raw.split(","):
            r, h = item.split(":")
            idx = int(r)
            if not 0 <= idx < nranks:
                raise ValueError(
                    f"hostmap rank {idx} out of range [0, {nranks}): {raw!r}"
                )
            out[idx] = h.strip()
        if any(h == "" for h in out):
            raise ValueError(f"hostmap missing ranks: {raw!r}")
        return out
    parts = [p.strip() for p in raw.split(",")]
    if len(parts) != nranks:
        raise ValueError(
            f"hostmap has {len(parts)} entries for {nranks} ranks: {raw!r}"
        )
    return parts


class RoutedJob:
    """Job handle: a thin TCP wrapper — global coordination (barrier,
    mutexes, rendezvous) always rides TCP, the only transport every rank
    shares.  Windows create their own per-host shm segments; there is no
    job-scope shm state."""

    def __init__(self, job: str, rank: int, nranks: int, hosts: List[str],
                 coord: str):
        from bluefog_tpu_torch.native.tcp_transport import TcpShmJob

        self.hosts = hosts
        self.rank = rank
        self.tcp = TcpShmJob(job, rank, nranks, coord)

    def barrier(self) -> None:
        self.tcp.barrier()

    def mutex_acquire(self, rank: int) -> None:
        self.tcp.mutex_acquire(rank)

    def mutex_release(self, rank: int) -> None:
        self.tcp.mutex_release(rank)

    def close(self, unlink: bool = False) -> None:
        self.tcp.close(unlink)


class RoutedWindow:
    """One window over both transports, routed per (writer, owner) edge.

    The islands layer addresses mailbox slots by (owner, slot-index) and
    knows the writer rank for every slot; this class only needs the hosts
    of the two endpoints, passed as ``src``/``dst`` rank arguments.
    """

    #: static floor: what routed may claim before knowing which shm leg
    #: (native or fallback) an instance gets — the meet over every
    #: possible leg pair.  __init__ upgrades to the actual legs' meet.
    CAPS = None  # filled in below the class (needs the leg classes)

    def __init__(self, job: str, name: str, rank: int, nranks: int,
                 maxd: int, shape, dtype, hosts: List[str], coord: str):
        from bluefog_tpu_torch.native.shm_native import make_shm_window
        from bluefog_tpu_torch.native.tcp_transport import TcpShmWindow

        self.hosts = hosts
        self.rank = rank
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.tcp = TcpShmWindow(job, name, rank, nranks, maxd, shape, dtype,
                                coord)
        local = [r for r in range(nranks) if hosts[r] == hosts[rank]]
        if len(local) > 1:
            li = {r: i for i, r in enumerate(local)}
            self.shm = make_shm_window(
                f"{job}_h{hosts[rank]}", name, li[rank], len(local), maxd,
                shape, dtype,
            )
            self._local_index = li
            # caller-facing capabilities: a routed edge may take either
            # leg, so only the meet of the two is honest
            self.CAPS = _caps.meet(type(self.shm).CAPS, type(self.tcp).CAPS,
                                   "routed")
        else:
            self.shm = None
            self._local_index = {}
            self.CAPS = _caps.meet(type(self.tcp).CAPS,
                                   type(self.tcp).CAPS, "routed")

    def _same_host(self, a: int, b: int) -> bool:
        return self.hosts[a] == self.hosts[b]

    def _shm_dst(self, dst: int) -> int:
        return self._local_index[dst]

    # -- mailbox ------------------------------------------------------------
    def write(self, dst: int, slot: int, array, p: float = 1.0,
              accumulate: bool = False, writer: Optional[int] = None) -> None:
        # a slot's canonical transport is set by the (writer-of-record,
        # owner) pair; `writer` defaults to self (win_put) but win_get's
        # self-deposit passes the pulled in-neighbor so deposit and read
        # agree on which transport holds the slot
        w = self.rank if writer is None else writer
        if self.shm is not None and self._same_host(w, dst):
            self.shm.write(self._shm_dst(dst), slot, array, p, accumulate)
        else:
            self.tcp.write(dst, slot, array, p, accumulate)

    def trace_stamp(self, dst: int, slot: int, word: int,
                    writer: Optional[int] = None) -> None:
        # must route exactly like the write it annotates, so the word
        # lands beside the slot the consumer will actually read
        w = self.rank if writer is None else writer
        if self.shm is not None and self._same_host(w, dst):
            self.shm.trace_stamp(self._shm_dst(dst), slot, word)
        else:
            self.tcp.trace_stamp(dst, slot, word)

    def trace_peek(self, slot: int, src: Optional[int] = None) -> int:
        if src is not None and self.shm is not None \
                and self._same_host(self.rank, src):
            return self.shm.trace_peek(slot)
        return self.tcp.trace_peek(slot)

    def read(self, slot: int, collect: bool = False, src: Optional[int] = None):
        if src is not None and self.shm is not None \
                and self._same_host(self.rank, src):
            return self.shm.read(slot, collect)
        return self.tcp.read(slot, collect)

    def read_version(self, slot: int, src: Optional[int] = None) -> int:
        if src is not None and self.shm is not None \
                and self._same_host(self.rank, src):
            return self.shm.read_version(slot)
        return self.tcp.read_version(slot)

    def reset(self, slot: int, src: Optional[int] = None) -> None:
        if src is not None and self.shm is not None \
                and self._same_host(self.rank, src):
            self.shm.reset(slot)
        else:
            self.tcp.reset(slot)

    def force_drain(self, slot: int, src: Optional[int] = None) -> None:
        # heal-path dead-writer drain, routed like read(): the slot lives
        # in the transport the (dead) writer used
        if src is not None and self.shm is not None \
                and self._same_host(self.rank, src):
            drain = getattr(self.shm, "force_drain", None)
            if drain is not None:
                drain(slot, src=src)
        else:
            self.tcp.force_drain(slot, src=src)

    # -- exposed ------------------------------------------------------------
    def expose(self, array, p: float = 1.0) -> None:
        # publish to both transports so any reader uses its natural path
        if self.shm is not None:
            self.shm.expose(array, p)
        self.tcp.expose(array, p)

    def read_exposed(self, src: int):
        if self.shm is not None and self._same_host(self.rank, src):
            return self.shm.read_exposed(self._local_index[src])
        return self.tcp.read_exposed(src)

    def close(self, unlink: bool = False) -> None:
        if self.shm is not None:
            self.shm.close(unlink)
        self.tcp.close(unlink)

    def unlink_segments(self) -> None:
        # each host group's segment-rank-0 unlinks that host's segment
        if self.shm is not None:
            self.shm.unlink_segments()


def _static_floor_caps() -> "_caps.TransportCaps":
    from bluefog_tpu_torch.native.shm_native import (FallbackShmWindow,
                                               NativeShmWindow)
    from bluefog_tpu_torch.native.tcp_transport import TcpShmWindow

    shm_floor = _caps.meet(NativeShmWindow.CAPS, FallbackShmWindow.CAPS,
                           "shm")
    return _caps.meet(shm_floor, TcpShmWindow.CAPS, "routed")


RoutedWindow.CAPS = _static_floor_caps()
# a routed window never fuses a scale factor (the TCP leg cannot)
RoutedWindow.supports_scale = False
