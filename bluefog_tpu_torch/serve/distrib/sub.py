"""The subscriber: a TCP-backed region twin for :class:`~..replica.Replica`.

``TcpSource`` joins the tree through the publisher's coordinator, gets
a slot and a parent feed address, and polls that parent over one
persistent socket.  Applied deltas stage beside the committed
generation and land with a single reference flip — the same
death-matrix shape as the shm region: a kill mid-delta leaves the
previous version serving, and the CRC check before the flip makes
served bytes bit-identical to a committed canonical snapshot.

Every subscriber is also (by default) a **relay**: it runs its own
:class:`~.feed.FeedServer` over its committed store and reports that
address at join, so the coordinator can hang children off it.  The
store flips at commit time — before the owning replica's own
``poll_swap`` — so a relay feeds its children the new generation no
later than it starts serving it.

Parent death shows up as socket errors/timeouts; after
``BFTPU_DISTRIB_RETRIES`` full-jitter attempts the subscriber asks the
coordinator to re-place it (``OP_PARENT``), falling back to the
publisher as root of last resort.  A subscriber that slept past the
dirty-map horizon simply receives the full-resync stream — same code
path, one flag.
"""

from __future__ import annotations

import json
import random
import socket
import time
from typing import Optional, Tuple

import numpy as np

from bluefog_tpu_torch import telemetry as _telemetry
from bluefog_tpu_torch.native.tcp_transport import _HDR, _BufReader, _send_msg
from bluefog_tpu_torch.serve.distrib import feed as _feed
from bluefog_tpu_torch.serve.distrib import tree as _tree
from bluefog_tpu_torch.serve.distrib.delta import (ChunkStore,
                                             distrib_timeout_s)
from bluefog_tpu_torch.serve.snapshot import SnapshotUnavailable

__all__ = ["TcpSource"]


def _chaos_kill(var: str) -> Tuple[int, int]:
    """Parse ``"replica_id:n"`` chaos vars (-1 = off)."""
    import os

    v = os.environ.get(var, "")
    if not v:
        return -1, 0
    try:
        rid, _, n = v.partition(":")
        return int(rid), int(n or "1")
    except ValueError:
        return -1, 0


class TcpSource:
    """``source=`` twin for :class:`bluefog_tpu_torch.serve.replica.Replica`:
    attach by ``host:port`` instead of shm name."""

    def __init__(self, addr: str, *, replica_id: int = 0,
                 relay: bool = True, relay_host: str = "127.0.0.1",
                 rng: Optional[random.Random] = None,
                 fanout: Optional[int] = None):
        self.coord_addr = _feed.parse_addr(addr)
        self.replica_id = int(replica_id)
        self.store = ChunkStore()
        self._rng = rng if rng is not None else random.Random()
        self.slot: Optional[int] = None
        self.parent_slot = _tree.PUBLISHER
        self._parent_addr: Optional[Tuple[str, int]] = None
        self._sock: Optional[socket.socket] = None
        self._rd: Optional[_BufReader] = None
        self.syncs = 0
        self.resyncs = 0
        self.reparents = 0
        self.relay_server: Optional[_feed.FeedServer] = None
        if relay:
            self.relay_server = _feed.FeedServer(self.store, relay_host,
                                                 0, fanout=fanout)

    # -- control plane (transient coordinator connections) -------------------

    def _control(self, op: int, req: dict) -> dict:
        s = socket.create_connection(self.coord_addr,
                                     timeout=distrib_timeout_s())
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(s, op, payload=json.dumps(req).encode())
            rd = _BufReader(s)
            hdr = _HDR.unpack(rd.read_exact(_HDR.size))
            payload = rd.read_exact(hdr[4]) if hdr[4] else b""
            if hdr[0] != _feed.OP_ASSIGN:
                raise ConnectionError(f"coordinator replied op {hdr[0]}")
            return json.loads(payload.decode())
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _join(self) -> None:
        req = {"slot": self.slot}
        if self.relay_server is not None:
            req["relay"] = list(self.relay_server.addr)
        rep = self._control(_feed.OP_JOIN, req)
        self._adopt_assignment(rep)

    def _reparent(self, dead_slot: int) -> None:
        rep = self._control(_feed.OP_PARENT,
                            {"slot": self.slot, "dead": dead_slot})
        self._adopt_assignment(rep)
        self.reparents += 1
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("distrib.sub_reparents",
                        replica=str(self.replica_id)).inc()

    def _adopt_assignment(self, rep: dict) -> None:
        self.slot = int(rep["slot"])
        self.parent_slot = int(rep["parent"])
        if self.parent_slot >= 0:
            self._parent_addr = (rep["host"], int(rep["port"]))
        else:
            self._parent_addr = self.coord_addr
        self._disconnect()

    # -- the persistent feed socket ------------------------------------------

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock, self._rd = None, None

    def _connect(self) -> None:
        if self.slot is None:
            self._join()
        assert self._parent_addr is not None
        s = socket.create_connection(self._parent_addr,
                                     timeout=distrib_timeout_s())
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock, self._rd = s, _BufReader(s)

    def _poll_once(self) -> Tuple[int, int, int, np.ndarray]:
        from bluefog_tpu_torch.serve.distrib.delta import distrib_retries
        from bluefog_tpu_torch.serve.replica import full_jitter

        last: Optional[Exception] = None
        for attempt in range(distrib_retries()):
            try:
                if self._sock is None:
                    self._connect()
                return self._sync()
            except (OSError, ConnectionError) as e:
                last = e
                self._disconnect()
                time.sleep(full_jitter(attempt, 0.02, 0.5, self._rng))
        # parent presumed dead: re-place through the coordinator (the
        # publisher itself being down surfaces as the next failure,
        # which the Replica's own retry loop owns)
        dead = self.parent_slot
        self._reparent(dead)
        self._connect()
        return self._sync()

    def poll(self) -> Tuple[int, int, int, np.ndarray]:
        """The Replica source contract: newest committed snapshot as
        ``(version, epoch, step, arr)``; transient trouble raises
        OSError-family so the replica's jittered retry owns policy."""
        try:
            return self._poll_once()
        except (ConnectionError, json.JSONDecodeError) as e:
            raise OSError(str(e)) from e

    def _sync(self) -> Tuple[int, int, int, np.ndarray]:
        assert self._sock is not None and self._rd is not None
        # chaos instrumentation: a schedule_suspend() here SIGSTOPs
        # the subscriber between syncs — sleeping past the dirty-map
        # horizon is exactly how the full-resync path gets exercised
        from bluefog_tpu_torch.resilience import chaos as _chaos
        from bluefog_tpu_torch.serve.replica import REPLICA_RANK_BASE
        _chaos.checkpoint(REPLICA_RANK_BASE + self.replica_id,
                          "distrib_sync")
        have = self.store.version
        _send_msg(self._sock, _feed.OP_POLL, trace=have)
        meta, chunks, full, head = _feed.recv_delta(self._rd)
        reg = _telemetry.get_registry()
        if meta is None:
            # NOCHANGE: serve what we hold (nothing yet -> the replica
            # treats SnapshotUnavailable as transient and retries)
            if reg.enabled:
                reg.counter("distrib.nochange",
                            replica=str(self.replica_id)).inc()
            if self.store.version == 0:
                raise SnapshotUnavailable(
                    f"distrib slot {self.slot}: upstream head is "
                    f"v{head}, nothing committed here yet")
            m, arr = self.store.decode()
            return m.version, m.epoch, m.step, arr
        kill_id, kill_n = _chaos_kill("BFTPU_CHAOS_DISTRIB_KILL_SYNC")
        if kill_id == self.replica_id and self.syncs + 1 == kill_n:
            # chaos: die mid-delta, AFTER receiving the stream but
            # BEFORE the flip — previous generation must keep serving
            from bluefog_tpu_torch.resilience import chaos as _chaos
            _chaos.kill_self()
        try:
            arr = self.store.install(meta, chunks, full=full)
        except (ValueError, KeyError):
            # torn/incomplete generation (e.g. shape changed under a
            # delta): drop state and take the full-resync path
            self.store = ChunkStore() if self.relay_server is None \
                else self._reset_relay_store()
            raise ConnectionError(
                f"distrib slot {self.slot}: staged generation "
                f"v{meta.version} failed verification; resyncing")
        self.syncs += 1
        if full:
            self.resyncs += 1
        if reg.enabled:
            reg.counter("distrib.sub_resyncs" if full
                        else "distrib.sub_syncs",
                        replica=str(self.replica_id)).inc()
            reg.gauge("distrib.sub_version",
                      replica=str(self.replica_id)).set(meta.version)
            reg.journal("distrib_resync" if full else "distrib_sync",
                        replica=self.replica_id, slot=self.slot,
                        version=meta.version, chunks=len(chunks),
                        parent=self.parent_slot)
        kill_id, kill_n = _chaos_kill("BFTPU_CHAOS_DISTRIB_KILL_RELAY")
        if kill_id == self.replica_id and self.syncs == kill_n:
            # chaos: the relay dies mid-fanout — after its store flip
            # (children may already have pulled v) but before its own
            # replica swap; the e2e asserts the subtree re-parents
            from bluefog_tpu_torch.resilience import chaos as _chaos
            _chaos.kill_self()
        return meta.version, meta.epoch, meta.step, arr

    def _reset_relay_store(self) -> ChunkStore:
        # the relay server holds a reference to the store object, so a
        # reset must keep the identity: swap the internal state instead
        self.store._snap = (None, {})
        self.store._decoded = (0, None)
        return self.store

    def close(self) -> None:
        self._disconnect()
        if self.relay_server is not None:
            self.relay_server.close()
            self.relay_server = None
