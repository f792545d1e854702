"""The distribution wire: feed servers, the coordinator, the publisher.

Every node in the tree — publisher and relaying subscriber alike —
runs a :class:`FeedServer`: a thread-per-connection TCP server (the
same shape as ``tcp_transport._Server``) answering **pull** requests
out of its :class:`~.delta.ChunkStore`.  A child holds ONE persistent
socket to its parent and polls; the publisher therefore keeps at most
``fanout`` persistent feed sockets no matter how many replicas the
tree holds, plus short-lived control connections for join/re-parent.

Frames reuse the PR-11 chunked header (``tcp_transport._HDR``) and the
``_OP_CHUNK``/``_OP_COMMIT`` state machine:

====================  ==================================================
``OP_POLL`` (20)      child → parent; ``trace`` = version the child has
``OP_NOCHANGE`` (21)  parent → child; ``trace`` = parent's head version
``_OP_CHUNK`` (14)    one encoded chunk; ``win_id`` = chunk index,
                      ``mode`` = ``(wire_code << 1) | full_flag``,
                      ``p`` = int8 scale, ``trace`` = chunk lastmod
``_OP_COMMIT`` (15)   seals the stream; payload = :data:`_COMMIT`
                      (version/epoch/step, chunk counts, shape, dtype,
                      canonical CRC32, full flag)
``OP_JOIN`` (22)      joiner → coordinator; payload = relay addr JSON
``OP_PARENT`` (23)    child → coordinator: my parent died, re-place me
``OP_ASSIGN`` (24)    coordinator → child; ``slot`` = tree slot,
                      payload = parent feed address JSON ({} = feed
                      straight from the publisher)
====================  ==================================================

The coordinator (join/re-parent handling) runs only on the publisher's
feed server and drives the SAME pure placement code the sim and the
analysis family model-check (:mod:`.tree`).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from bluefog_tpu_torch import telemetry as _telemetry
from bluefog_tpu_torch.native.tcp_transport import (_HDR, _OP_CHUNK, _OP_COMMIT,
                                              _BufReader, _send_msg)
from bluefog_tpu_torch.serve.distrib import tree as _tree
from bluefog_tpu_torch.serve.distrib.delta import (ChunkMeta, ChunkStore,
                                             distrib_fanout,
                                             distrib_timeout_s)

__all__ = [
    "OP_POLL",
    "OP_NOCHANGE",
    "OP_JOIN",
    "OP_PARENT",
    "OP_ASSIGN",
    "FeedServer",
    "DistribPublisher",
    "parse_addr",
]

OP_POLL = 20
OP_NOCHANGE = 21
OP_JOIN = 22
OP_PARENT = 23
OP_ASSIGN = 24

#: commit payload: version, epoch, step (u64); nchunks, nsent, ndim
#: (u32); dims[4] (u32); dtype str (8s); canonical crc32 (u32);
#: flags (u32, bit 0 = full resync)
_COMMIT = struct.Struct("<QQQIII4I8sII")
_FLAG_FULL = 1


def parse_addr(addr: str) -> Tuple[str, int]:
    """``host:port`` -> tuple (the ``--serve-remote`` argument)."""
    host, _, port = str(addr).rpartition(":")
    return (host or "127.0.0.1"), int(port)


def pack_commit(meta: ChunkMeta, nsent: int, full: bool) -> bytes:
    dims = list(meta.shape[:4]) + [0] * (4 - min(4, len(meta.shape)))
    return _COMMIT.pack(meta.version, meta.epoch, meta.step,
                        meta.nchunks, nsent, len(meta.shape),
                        *[int(d) for d in dims],
                        meta.dtype.encode()[:8].ljust(8, b"\x00"),
                        meta.crc, _FLAG_FULL if full else 0)


def unpack_commit(payload: bytes) -> Tuple[ChunkMeta, int, bool]:
    (ver, epoch, step, nchunks, nsent, ndim, d0, d1, d2, d3, dt, crc,
     flags) = _COMMIT.unpack(payload)
    shape = tuple(int(d) for d in (d0, d1, d2, d3)[:ndim])
    meta = ChunkMeta(ver, epoch, step, nchunks, shape,
                     dt.rstrip(b"\x00").decode(), crc)
    return meta, int(nsent), bool(flags & _FLAG_FULL)


def send_delta(sock: socket.socket, store: ChunkStore,
               have: int) -> Tuple[bool, int, int]:
    """Answer one POLL out of ``store``: NOCHANGE, a delta, or a full
    resync.  Returns ``(full, chunks_sent, payload_bytes)``."""
    meta, _ = store.snap()
    if meta is None or (have == meta.version and have > 0):
        head = meta.version if meta is not None else 0
        _send_msg(sock, OP_NOCHANGE, trace=head)
        return False, 0, 0
    full, items, meta = store.delta_since(have)
    sent_bytes = 0
    for idx, (lastmod, code, payload, scale) in items:
        _send_msg(sock, _OP_CHUNK, win_id=idx,
                  mode=(code << 1) | (1 if full else 0),
                  p=scale, payload=payload, trace=lastmod)
        sent_bytes += len(payload)
    _send_msg(sock, _OP_COMMIT, payload=pack_commit(meta, len(items),
                                                    full))
    return full, len(items), sent_bytes


def recv_delta(rd: "_BufReader") -> Tuple[Optional[ChunkMeta],
                                          Dict[int, tuple], bool, int]:
    """Read one POLL answer: ``(meta, chunks, full, head)``.  ``meta``
    is None on NOCHANGE (``head`` then carries the server's version).
    Raises ``ConnectionError`` on a stream that dies mid-delta."""
    chunks: Dict[int, tuple] = {}
    full = False
    while True:
        op, win_id, slot, mode, nbytes, p, trace = _HDR.unpack(
            rd.read_exact(_HDR.size))
        payload = rd.read_exact(nbytes) if nbytes else b""
        if op == OP_NOCHANGE:
            return None, {}, False, int(trace)
        if op == _OP_CHUNK:
            full = full or bool(mode & 1)
            chunks[int(win_id)] = (int(trace), int(mode) >> 1,
                                   bytes(payload), float(p))
            continue
        if op == _OP_COMMIT:
            meta, nsent, cfull = unpack_commit(payload)
            if nsent != len(chunks):
                raise ConnectionError(
                    f"delta stream torn: commit says {nsent} chunks, "
                    f"received {len(chunks)}")
            return meta, chunks, full or cfull, meta.version
        raise ConnectionError(f"unexpected feed op {op}")


class FeedServer:
    """Serve deltas out of a store; on the publisher, also place
    joiners into the tree and repair it when a relay dies."""

    def __init__(self, store: ChunkStore, host: str = "127.0.0.1",
                 port: int = 0, *, coordinator: bool = False,
                 fanout: Optional[int] = None):
        self.store = store
        self.coordinator = bool(coordinator)
        self.fanout = int(fanout) if fanout else distrib_fanout()
        self._lsock = socket.create_server((host, int(port)))
        self.addr = self._lsock.getsockname()[:2]
        self._lock = threading.Lock()
        # coordinator state: slot -> parent slot (the live tree, the
        # exact map tree_valid() checks) and slot -> relay feed addr
        # (None = leaf that cannot relay)
        self.parents: Dict[int, int] = {}
        self.relay_addr: Dict[int, Optional[Tuple[str, int]]] = {}
        self._next_slot = 0
        self.reparents = 0
        self.feeds = 0  # persistent feed conns accepted (lifetime)
        self._live = 0  # persistent feed conns open right now
        self._conns: set = set()
        self._stop = threading.Event()
        self._thr = threading.Thread(target=self._accept_loop,
                                     daemon=True)
        self._thr.start()

    # -- coordinator placement ----------------------------------------------

    def _assign(self, slot: int, *, dead: Optional[int] = None) -> dict:
        with self._lock:
            if dead is not None and dead in self.parents:
                self.parents = _tree.reassign(self.parents, dead,
                                              self.fanout)
                self.relay_addr.pop(dead, None)
                self.reparents += 1
            if slot not in self.parents:
                self.parents[slot] = _tree.choose_parent(
                    slot, self.parents, self.fanout)
            parent = self.parents[slot]
            # a parent that cannot relay (leaf-only subscriber) or has
            # no known address feeds the child from the publisher
            addr = self.relay_addr.get(parent) \
                if parent != _tree.PUBLISHER else None
            if parent != _tree.PUBLISHER and addr is None:
                parent = self.parents[slot] = _tree.PUBLISHER
            err = _tree.tree_valid(self.parents, self.fanout)
        if err:
            raise RuntimeError(f"coordinator built an invalid tree: "
                               f"{err}")
        out = {"slot": slot, "parent": parent}
        if parent != _tree.PUBLISHER:
            out["host"], out["port"] = addr
        return out

    def handle_join(self, relay: Optional[Tuple[str, int]],
                    slot: Optional[int] = None) -> dict:
        with self._lock:
            if slot is None:
                slot = self._next_slot
                self._next_slot += 1
            else:
                self._next_slot = max(self._next_slot, slot + 1)
            self.relay_addr[slot] = relay
        rep = self._assign(slot)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("distrib.joins").inc()
            reg.journal("distrib_join", slot=slot,
                        parent=rep["parent"])
        return rep

    def handle_reparent(self, slot: int, dead: int) -> dict:
        with self._lock:
            self.parents.pop(slot, None)  # re-place, subtree intact
        rep = self._assign(slot, dead=dead if dead >= 0 else None)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("distrib.reparents").inc()
            reg.journal("distrib_reparent", slot=slot, dead=dead,
                        parent=rep["parent"])
        return rep

    # -- server loop ---------------------------------------------------------

    def _accept_loop(self) -> None:
        self._lsock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        reg = _telemetry.get_registry()
        counted = False
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(distrib_timeout_s())
            rd = _BufReader(conn)
            while not self._stop.is_set():
                op, win_id, slot, mode, nbytes, p, trace = _HDR.unpack(
                    rd.read_exact(_HDR.size))
                payload = rd.read_exact(nbytes) if nbytes else b""
                if op == OP_POLL:
                    if not counted:
                        counted = True
                        self.feeds += 1
                        with self._lock:
                            self._live += 1
                    full, n, nbytes_out = send_delta(conn, self.store,
                                                     int(trace))
                    if reg.enabled and n:
                        reg.counter("distrib.resyncs" if full
                                    else "distrib.syncs").inc()
                        reg.counter("distrib.full_bytes" if full else
                                    "distrib.delta_bytes").add(nbytes_out)
                elif op in (OP_JOIN, OP_PARENT) and self.coordinator:
                    req = json.loads(payload.decode() or "{}")
                    relay = req.get("relay")
                    if op == OP_JOIN:
                        rep = self.handle_join(
                            tuple(relay) if relay else None,
                            req.get("slot"))
                    else:
                        rep = self.handle_reparent(int(req["slot"]),
                                                   int(req.get("dead",
                                                               -1)))
                    _send_msg(conn, OP_ASSIGN, slot=rep["slot"],
                              payload=json.dumps(rep).encode())
                else:
                    raise ConnectionError(f"unexpected op {op} "
                                          f"(coordinator="
                                          f"{self.coordinator})")
        except (OSError, ConnectionError, ValueError, struct.error):
            pass
        finally:
            with self._lock:
                if counted:
                    self._live -= 1
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    @property
    def live_feeds(self) -> int:
        """Persistent feed sockets open right now — the acceptance
        bound: a publisher's stays <= fanout however many replicas
        the tree holds."""
        return self._live

    def close(self) -> None:
        """Stop accepting AND sever live feed conns — process-death
        semantics, so a child's next read fails fast instead of
        pulling stale generations from a zombie thread."""
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._thr.join(timeout=2.0)


class DistribPublisher:
    """The tree root: encode committed snapshots into the store and
    coordinate the tree.  Feed it from the job's shm
    ``SnapshotRegion`` (:meth:`pump`) or directly (:meth:`publish` —
    tests and the bench)."""

    def __init__(self, job: str = "distrib", host: str = "127.0.0.1",
                 port: int = 0, *, fanout: Optional[int] = None):
        from bluefog_tpu_torch.serve.distrib.delta import DeltaEncoder

        self.job = str(job)
        self.encoder = DeltaEncoder()
        self.store = self.encoder.store
        self.server = FeedServer(self.store, host, port,
                                 coordinator=True, fanout=fanout)
        self.addr = self.server.addr

    @property
    def addr_str(self) -> str:
        return f"{self.addr[0]}:{self.addr[1]}"

    def publish(self, version: int, epoch: int, step: int,
                arr: np.ndarray) -> ChunkMeta:
        meta = self.encoder.publish(version, epoch, step, arr)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("distrib.publishes").inc()
            reg.gauge("distrib.version").set(meta.version)
            reg.journal("distrib_publish", version=meta.version,
                        dirty=self.encoder.last_dirty,
                        nchunks=meta.nchunks)
        return meta

    def pump(self) -> bool:
        """Re-encode the region's committed snapshot when it moved;
        returns True when a new version was published to the tree."""
        from bluefog_tpu_torch.serve import snapshot as _snap

        version, epoch, step, arr = _snap.read_committed(self.job)
        if version <= self.store.version:
            return False
        self.publish(version, epoch, step, arr)
        return True

    def close(self) -> None:
        self.server.close()
