"""TCP mailbox transport — the islands' cross-host (DCN) path.

Same window model and interface as the shared-memory transport
(:mod:`bluefog_tpu_torch.native.shm_native`), carried over sockets so island
processes can live on DIFFERENT hosts: the deployment where each host
runs one island and gossips parameters asynchronously over the
data-center network, exactly the role the reference's CUDA-aware MPI RMA
plays between its GPU nodes (``MPI_Win_create``/``MPI_Put`` over
IB/Ethernet, ``bluefog/common/mpi_controller.cc`` [U]; SURVEY.md §2.4).

Topology of responsibility (the passive-target model, unchanged):

- every rank runs a small **mailbox server thread** that OWNS that rank's
  state: its mail slots (one per in-neighbor per window), its exposed
  tensor, its mutex, and — on rank 0 — the job barrier;
- ``write``/``read_exposed`` are requests to the *destination's* server —
  the receiver's application code never participates (one-sided);
- ``read``/``collect``/``expose``/``reset`` touch only the local server's
  store (an in-process dict guarded by a lock) — no network;
- rendezvous: rank 0 additionally serves a registry where every rank posts
  its ``host:port`` and fetches the full table, so only ONE address
  (``BLUEFOG_ISLAND_COORD``) must be known up front — the analogue of
  ``bfrun``'s host list [U].

Wire format: 40-byte fixed header ``(op, win_id, slot, mode, nbytes, p,
trace)`` + raw payload bytes, over persistent connections (one per peer,
created lazily).  ``trace`` is the u64 trace-context word
(:func:`bluefog_tpu_torch.tracing.pack_ctx`; 0 = tracing off) that lets the
merge CLI draw a flow arrow from the depositing span on the writer to
the collecting span on the owner.  No external dependencies.

One wire protocol (the v2 chunk state machine, ported from shm)
----------------------------------------------------------------

Window deposits default to the CHUNKED framing (``BFTPU_TCP_CHUNKED``):
the sender splits the payload into ``shm_native.chunk_bytes()``-sized
chunks — the SAME geometry the shm mailbox uses — and streams one
``_OP_CHUNK`` frame per chunk (header+payload in one scatter-gather
``sendmsg``), pipelined under a credit window
(``BFTPU_TCP_WINDOW_CHUNKS`` frames in flight before one ack is
collected — windowed credit, not stop-and-wait), then seals the deposit
with an ``_OP_COMMIT`` frame.  The server commits chunks in ascending
order into the mail slot and advances the slot version and push-sum
mass ONLY at the commit frame (``TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD``) —
so a writer that dies mid-stream committed exactly zero mass, and the
disconnect handler's drain (``TCP_DEAD_WRITER_DRAIN_STEPS``) restores
the slot to the logical-zero drained state readers expect, just like
shm's dead-writer drain.  Chunk frames may carry bf16/int8-quantized
values (``BFTPU_WIRE_DTYPE``; per-chunk wire code in ``mode``, scale in
``p``, element offset in ``trace``) with an error-feedback residual
held per edge on the sender — see :mod:`bluefog_tpu_torch.native.wire_codec`.
Both transports are model-checked from one shared protocol spec by
:mod:`bluefog_tpu.analysis.wire_rules`.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.common.logging_util import logger
from bluefog_tpu_torch.native import capabilities as _caps
from bluefog_tpu_torch.native import wire_codec
from bluefog_tpu_torch.resilience.detector import PeerTimeoutError
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.tracing import tracer as _tracing

# ops
_OP_WRITE = 1          # deposit into (my) mail slot: mode 0 put, 1 accumulate
_OP_READ_EXPOSED = 2   # return my exposed tensor
_OP_MUTEX_ACQ = 3
_OP_MUTEX_REL = 4
_OP_BARRIER = 5        # rank-0 only
_OP_REGISTER = 6       # rank-0 only: register rank -> addr, get table when full
_OP_PING = 7
_OP_BARRIER_T = 8      # rank-0 only: timed barrier, timeout rides in p
_OP_HEARTBEAT = 9      # rank-0 only: renew rank `slot`'s lease
_OP_LIVENESS = 10      # rank-0 only: age of rank `slot`'s lease (in p)
_OP_CLOCK = 11         # rank-0 only: coordinator's monotonic clock (in p)
_OP_JOIN_RANK = 12     # rank-0 only: grant a fresh global rank (in slot)
_OP_EPOCH = 13         # rank-0 only: membership-epoch word (read/publish)
_OP_CHUNK = 14         # one chunk of a streaming deposit: mode packs
                       # (chunk_idx << 8) | (wire_code << 1) | accumulate,
                       # p carries the per-chunk quantization scale and
                       # trace the element offset; acked per frame (credit)
_OP_COMMIT = 15        # seal a chunk stream: mode packs (nchunks << 1) |
                       # accumulate, p the EXACT push-sum mass, trace the
                       # trace-context word; version/mass advance HERE

#: human-readable op names: PeerTimeoutError context + telemetry labels
_OP_NAMES = {
    _OP_WRITE: "write", _OP_READ_EXPOSED: "read_exposed",
    _OP_MUTEX_ACQ: "mutex_acquire", _OP_MUTEX_REL: "mutex_release",
    _OP_BARRIER: "barrier", _OP_REGISTER: "register", _OP_PING: "ping",
    _OP_BARRIER_T: "barrier_timed", _OP_HEARTBEAT: "heartbeat",
    _OP_LIVENESS: "liveness", _OP_CLOCK: "clock",
    _OP_JOIN_RANK: "join_rank", _OP_EPOCH: "epoch",
    _OP_CHUNK: "chunk", _OP_COMMIT: "commit",
}

#: ops a mid-exchange disconnect may safely REPLAY on a fresh
#: connection: pure reads of server state.  Mutation ops (write,
#: mutex, barrier, join_rank) stay one-shot — the server may have
#: applied the lost request, and re-sending would double-apply.
#: Chunked deposits get their own replay rule in ``deposit_chunked``
#: (safe up to the commit frame, which is where state advances).
_IDEMPOTENT_OPS = frozenset({
    _OP_READ_EXPOSED, _OP_PING, _OP_HEARTBEAT, _OP_LIVENESS,
    _OP_CLOCK, _OP_EPOCH,
})

# op, win_id, slot, mode, nbytes, p, trace — the trace word is LAST so
# pre-trace header fields keep their offsets on the wire
_HDR = struct.Struct("<iiiiqdQ")

# -- protocol spec constants ---------------------------------------------
# Model-checked against shm_native's spec by bluefog_tpu.analysis.
# wire_rules: ONE wire protocol, two carriers.
TCP_CHUNK_COMMIT_IN_ORDER = True
TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD = True
TCP_DRAINED_COLLECT_IS_ATOMIC = True
#: the disconnect-handler drain for a writer that died mid-stream, in
#: order: make the slot seq even so readers stop spinning, mark it
#: logically drained (reads as zeros, mass 0), then clear the stream
#: registration — mark_drained MUST precede the clear, same invariant
#: as shm's DEAD_WRITER_DRAIN_STEPS
TCP_DEAD_WRITER_DRAIN_STEPS = ("evenize_wseq", "mark_drained",
                               "clear_stream")


def peer_timeout_s() -> Optional[float]:
    """Deadline for any single request/response round trip to a peer
    (``BFTPU_PEER_TIMEOUT_S``; <= 0 disables, restoring unbounded waits).
    The default is generous: mutex and barrier waits legitimately block
    while other ranks compute — the deadline exists to unstick survivors
    from a DEAD peer, not to police slow ones."""
    try:
        t = float(os.environ.get("BFTPU_PEER_TIMEOUT_S", "120"))
    except ValueError:
        t = 120.0
    return t if t > 0 else None


def tcp_retries() -> int:
    """Session-resume attempts after a DISCONNECT-class failure
    (``BFTPU_TCP_RETRIES``, default 3; 0 restores the old one-shot
    behavior where the next request reconnects but the failing one
    raises).  Only connection drops are retried — a connected peer
    that stays silent is the failure detector's business and still
    surfaces as :class:`PeerTimeoutError` after one deadline."""
    try:
        n = int(os.environ.get("BFTPU_TCP_RETRIES", "3"))
    except ValueError:
        n = 3
    return max(n, 0)


def tcp_backoff_s() -> float:
    """Base of the bounded full-jitter reconnect backoff
    (``BFTPU_TCP_BACKOFF_S``, default 0.05): retry ``k`` sleeps
    ``uniform(0, min(2.0, base * 2**k))`` seconds."""
    try:
        b = float(os.environ.get("BFTPU_TCP_BACKOFF_S", "0.05"))
    except ValueError:
        b = 0.05
    return max(b, 0.0)


#: RNG behind the reconnect jitter — module-level so tests can pin it
#: (``tcp_transport._jitter_rng = random.Random(seed)``) and so every
#: connection in the process shares one stream
_jitter_rng = random.Random()


def tcp_chunked() -> bool:
    """Chunked pipelined framing for window deposits
    (``BFTPU_TCP_CHUNKED``; default on, ``0`` restores the legacy
    whole-payload acked write — kept for A/B benches)."""
    return os.environ.get("BFTPU_TCP_CHUNKED", "1") != "0"


def window_chunks() -> int:
    """Sender credit window: chunk frames in flight before one ack is
    collected (``BFTPU_TCP_WINDOW_CHUNKS``, default 32; 1 degenerates
    to stop-and-wait)."""
    try:
        w = int(os.environ.get("BFTPU_TCP_WINDOW_CHUNKS", "32"))
    except ValueError:
        w = 32
    return max(w, 1)


def _chunk_bytes() -> int:
    # ONE chunk geometry for both transports: the shm setting
    # (BLUEFOG_SHM_CHUNK_BYTES) governs the TCP stream too (lazy import:
    # shm_native imports this module for transport selection)
    from bluefog_tpu_torch.native import shm_native
    return shm_native.chunk_bytes()


def _chunk_kill_after(src_rank: int) -> int:
    """Chaos hook: ``BFTPU_CHAOS_KILL_CHUNK="<rank>:<n>"`` makes rank
    ``<rank>`` (-1 = any) SIGKILL itself after streaming ``<n>`` chunk
    frames of a deposit — the deterministic mid-stream death the
    drain-path tests need (an external signal cannot time it).  Returns
    -1 when no schedule matches."""
    spec = os.environ.get("BFTPU_CHAOS_KILL_CHUNK")
    if not spec:
        return -1
    try:
        kr, kn = spec.split(":")
        if int(kr) in (src_rank, -1):
            return int(kn)
    except ValueError:
        pass
    return -1


def _chunk_drop_after() -> int:
    """Chaos hook: ``BFTPU_CHAOS_DROP_CHUNK="<n>"`` makes the RECEIVING
    server drop the connection after accepting ``<n>`` chunk frames of
    one stream, ONE TIME per server — the deterministic mid-stream
    disconnect the session-resume tests need (a real link flap cannot
    be timed).  The writer sees ConnectionError with the commit unsent,
    so the bounded-backoff retry must replay the stream from chunk 0
    and lose nothing.  Returns -1 when unset."""
    spec = os.environ.get("BFTPU_CHAOS_DROP_CHUNK")
    if not spec:
        return -1
    try:
        return int(spec)
    except ValueError:
        return -1


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # preallocate + recv_into: a `buf += chunk` loop would copy O(n²/chunk)
    # bytes (measured 20x slowdown on multi-MB window payloads)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf  # bytearray: frombuffer/slice-assign/decode all accept it


class _BufReader:
    """Buffered frame reader for a server connection: one ``recv_into``
    syscall fetches MANY queued 40-byte chunk headers and acks at once
    (the pipelined framing makes back-to-back small frames the common
    case, and per-frame ``recv`` syscalls were the dominant per-chunk
    cost).  Large payloads bypass the buffer — and ``read_into`` lands
    them straight in caller memory (the mail slot), eliminating the
    per-deposit staging allocation + copy of the legacy path."""

    __slots__ = ("sock", "_buf", "_lo", "_hi")

    def __init__(self, sock: socket.socket, bufsize: int = 1 << 16):
        self.sock = sock
        self._buf = memoryview(bytearray(bufsize))
        self._lo = 0
        self._hi = 0

    def read_exact(self, n: int):
        """n bytes as a bytes-like; small reads are served from the
        buffer, which refills with bulk ``recv_into`` calls that sweep
        up every queued frame the kernel already holds."""
        avail = self._hi - self._lo
        if avail < n <= len(self._buf):
            if avail:  # compact the tail to the front before refilling
                self._buf[:avail] = self._buf[self._lo:self._hi]
            self._lo, self._hi = 0, avail
            while self._hi < n:
                r = self.sock.recv_into(self._buf[self._hi:],
                                        len(self._buf) - self._hi)
                if r == 0:
                    raise ConnectionError("peer closed")
                self._hi += r
            avail = self._hi
        if avail >= n:
            out = bytes(self._buf[self._lo:self._lo + n])
            self._lo += n
            return out
        out = bytearray(n)
        self.read_into(memoryview(out))
        return out

    def read_into(self, dest) -> None:
        """Fill ``dest`` (a writable memoryview) — buffered remainder
        first, then straight ``recv_into`` the destination: payload
        bytes cross exactly once from kernel to their final resting
        place."""
        n = len(dest)
        avail = self._hi - self._lo
        take = min(avail, n)
        if take:
            dest[:take] = self._buf[self._lo:self._lo + take]
            self._lo += take
        got = take
        while got < n:
            r = self.sock.recv_into(dest[got:], n - got)
            if r == 0:
                raise ConnectionError("peer closed")
            got += r


def _send_frame(sock, hdr, payload=b""):
    """One frame in (at most) one syscall: scatter-gather ``sendmsg``
    coalesces header+payload — no concat copy, no back-to-back
    ``sendall`` pair; partial sends finish with zero-copy memoryview
    slices.  Header-only frames (control ops, acks) ship as a single
    ``sendall``."""
    if not payload:
        sock.sendall(hdr)
        return
    sent = sock.sendmsg([hdr, memoryview(payload)])
    hl = len(hdr)
    if sent < hl:
        sock.sendall(memoryview(hdr)[sent:])
        sent = hl
    if sent < hl + len(payload):
        sock.sendall(memoryview(payload)[sent - hl:])


def _send_iov(sock, bufs):
    """MANY frames in one scatter-gather syscall: the pipelined chunk
    stream pays one ``sendmsg`` per credit half-window instead of one
    per chunk.  Partial sends resume with zero-copy memoryview slices."""
    total = sum(len(b) for b in bufs)
    sent = sock.sendmsg(bufs)
    while sent < total:
        i = 0
        while sent >= len(bufs[i]):
            sent -= len(bufs[i])
            i += 1
        bufs = [memoryview(bufs[i])[sent:]] + list(bufs[i + 1:])
        total = sum(len(b) for b in bufs)
        sent = sock.sendmsg(bufs)


def _drain_acks(sock, k):
    """Collect ``k`` header-only acks in bulk ``recv`` calls (the server
    writes them back-to-back, so one syscall typically sweeps them all).
    A server-side protocol error closes the connection, which surfaces
    here as ConnectionError."""
    if k > 0:
        _recv_exact(sock, _HDR.size * k)


def _send_msg(sock, op, win_id=0, slot=0, mode=0, p=0.0, payload=b"",
              trace=0):
    _send_frame(
        sock, _HDR.pack(op, win_id, slot, mode, len(payload), p, trace),
        payload,
    )


# the per-chunk credit ack, precomputed once: the hottest server->client
# frame, sent once per chunk of every deposit
_ACK_CHUNK = _HDR.pack(_OP_CHUNK, 0, 0, 0, 0, 0.0, 0)


def _recv_msg(sock):
    # trace rides LAST in the tuple so existing payload/mode indexing
    # ([5], [3], ...) is unchanged
    op, win_id, slot, mode, nbytes, p, trace = _HDR.unpack(
        _recv_exact(sock, _HDR.size))
    payload = _recv_exact(sock, nbytes) if nbytes else b""
    return op, win_id, slot, mode, p, payload, trace


class _Slot:
    __slots__ = ("data", "p", "version", "trace", "wseq", "drained")

    def __init__(self, nbytes: int):
        self.data = bytearray(nbytes)
        self.p = 0.0
        self.version = 0
        self.trace = 0  # trace-context word of the last deposit
        # chunk-stream seq: even = settled, odd = a deposit is streaming
        # into the slot (readers wait on the server's store_cond)
        self.wseq = 0
        # drained marker, the shm v2 trick: drained == version means the
        # slot is LOGICALLY zero (mass 0) without touching the payload
        # bytes — collect is one comparison + two stores, O(1)
        self.drained = 0


class _WinStore:
    """One window's rank-local state, owned by the server thread."""

    def __init__(self, maxd: int, nbytes: int, dtype):
        self.nbytes = nbytes
        self.dtype = np.dtype(dtype)
        self.mail = [_Slot(nbytes) for _ in range(max(maxd, 1))]
        self.exposed = _Slot(nbytes)


class _Server:
    """Per-rank mailbox server: owns this rank's slots/exposed/mutex (and
    the barrier + registry on rank 0).  Thread-per-connection; handlers are
    short critical sections under one lock (mutex/barrier waits use
    conditions so they never hold it)."""

    def __init__(self, rank: int, nranks: int, host: str, port: int = 0):
        self.rank = rank
        self.nranks = nranks
        self.lock = threading.Lock()
        self.windows: Dict[int, _WinStore] = {}
        # chunk-stream completion/drain notifications for readers of a
        # mid-stream slot (wraps the SAME lock as the store)
        self.store_cond = threading.Condition(self.lock)
        # open chunk streams: (win_id, slot) -> state.  Exactly one
        # writer owns a mailbox slot by construction, so the key needs
        # no writer component; the owning connection is recorded so a
        # disconnect can drain exactly its own torn streams.
        self.streams: Dict[Tuple[int, int], dict] = {}
        # mutex (this rank's): the CONNECTION holding it, or None — owner
        # tracking lets a dead holder's disconnect release the lock
        self.mutex_cond = threading.Condition()
        self.mutex_owner = None
        # barrier state (rank 0 only)
        self.bar_cond = threading.Condition()
        self.bar_count = 0
        self.bar_gen = 0
        # registry (rank 0 only)
        self.reg_cond = threading.Condition()
        self.registry: Dict[int, str] = {}
        # liveness leases (rank-0 coordinator only): rank -> last-renewal
        # stamp on THIS server's monotonic clock.  Ranks heartbeat the
        # coordinator, survivors query lease AGE (clock-transportable,
        # unlike the raw stamp) — the tcp analogue of the shm transport's
        # per-rank liveness words.
        self.lease_lock = threading.Lock()
        self.leases: Dict[int, float] = {}
        # elastic-membership rendezvous (rank-0 coordinator only): the
        # monotone fresh-rank counter (seeded past the launch world — a
        # dead rank's id is never reissued) and the membership-epoch
        # word.  The multi-host analogue of the shm membership board
        # (resilience/join.py) for deployments where joiner and members
        # share no filesystem.
        self.join_lock = threading.Lock()
        self.next_join_rank = nranks
        self.membership_epoch = 0
        # one-shot latch for the BFTPU_CHAOS_DROP_CHUNK disconnect hook
        self._chaos_dropped = False
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(nranks * 4 + 8)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _handle_chunk(self, conn, rd, win_id, slot, mode, p, nbytes,
                      trace):
        """One ``_OP_CHUNK`` frame: open the stream on chunk 0, commit
        the chunk into the mail slot in ascending order
        (``TCP_CHUNK_COMMIT_IN_ORDER``), ack it (the sender's credit).
        Any protocol violation drops the connection — the writer sees
        ConnectionError instead of a corrupted slot.

        Validation is header-driven so a RAW put chunk can be received
        STRAIGHT into the mail slot (``rd.read_into``) — payload bytes
        cross kernel→slot exactly once, with no staging buffer.  The
        reception happens outside the server lock: the stream state
        machine already serializes the slot (one writer per slot by
        construction) and readers wait out the odd ``wseq``."""
        idx = mode >> 8
        code = (mode >> 1) & 0x3
        acc = mode & 1
        with self.lock:
            w = self.windows[win_id]
            s = w.mail[slot]
            key = (win_id, slot)
            st = self.streams.get(key)
            if st is None:
                if idx != 0:
                    logger.error(
                        "rank %d mailbox: chunk stream %d[%d] opened at "
                        "chunk %d — dropping connection",
                        self.rank, win_id, slot, idx,
                    )
                    raise ConnectionError("chunk stream opened mid-sequence")
                fresh = s.drained == s.version
                if acc and fresh:
                    # accumulating onto a LOGICALLY zero slot: the bytes
                    # may still hold the drained deposit — swap in a
                    # zeroed buffer (calloc; no memset of the old one)
                    s.data = bytearray(w.nbytes)
                st = self.streams[key] = {
                    "conn": conn, "next": 0, "acc": acc,
                    "fresh": fresh, "elems": 0,
                }
                s.wseq += 1  # odd: a deposit is streaming into the slot
            if st["conn"] is not conn or st["next"] != idx \
                    or st["acc"] != acc:
                logger.error(
                    "rank %d mailbox: chunk %d to %d[%d] violates stream "
                    "order (expected %d) — dropping connection",
                    self.rank, idx, win_id, slot, st["next"],
                )
                raise ConnectionError("out-of-order chunk commit")
            item = w.dtype.itemsize
            if code == wire_codec.WIRE_RAW:
                cnt = nbytes // item
                endbyte = int(trace) * item + nbytes
            elif code == wire_codec.WIRE_BF16:
                cnt = nbytes // 2
                endbyte = (int(trace) + cnt) * item
            else:
                cnt = nbytes
                endbyte = (int(trace) + cnt) * item
            off = int(trace)  # element offset rides the trace field
            if endbyte > w.nbytes:
                raise ConnectionError("chunk overruns window")
            st["next"] = idx + 1
            st["elems"] += cnt
            drop_n = _chunk_drop_after()
            if drop_n >= 0 and idx + 1 >= drop_n \
                    and not self._chaos_dropped:
                # one-shot chaos disconnect: the stream dies UNCOMMITTED
                # (the disconnect drain restores the slot), the writer's
                # session resume replays it from chunk 0
                self._chaos_dropped = True
                raise ConnectionError("chaos: scheduled mid-stream drop")
            do_acc = acc and not st["fresh"]
            dest = (memoryview(s.data)[off * item:off * item + nbytes]
                    if code == wire_codec.WIRE_RAW and not do_acc else None)
        if dest is not None:
            rd.read_into(dest)  # zero-copy commit: kernel -> slot
        else:
            payload = rd.read_exact(nbytes)
            decoded = wire_codec.decode_chunk(payload, code, p, w.dtype,
                                              cnt)
            with self.lock:
                region = np.frombuffer(s.data, w.dtype, count=cnt,
                                       offset=off * item)
                if do_acc:
                    region += decoded
                else:
                    region[:] = decoded
        conn.sendall(_ACK_CHUNK)

    def _handle_commit(self, conn, win_id, slot, mode, p, trace):
        """The ``_OP_COMMIT`` frame: version and push-sum mass advance
        ONLY here, after every chunk landed
        (``TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD``) — a writer that dies
        mid-stream committed zero mass, which is what makes the
        disconnect drain sound."""
        nchunks = mode >> 1
        acc = mode & 1
        with self.lock:
            w = self.windows[win_id]
            s = w.mail[slot]
            st = self.streams.pop((win_id, slot), None)
            if st is None or st["conn"] is not conn \
                    or st["next"] != nchunks \
                    or st["elems"] * w.dtype.itemsize != w.nbytes:
                logger.error(
                    "rank %d mailbox: commit of %d[%d] without a complete "
                    "stream (%s) — dropping connection",
                    self.rank, win_id, slot,
                    "no stream" if st is None else
                    f"{st['next']}/{nchunks} chunks, {st['elems']} elems",
                )
                raise ConnectionError("commit without a complete stream")
            if acc and not st["fresh"]:
                s.p += p
            else:
                s.p = p
            s.version += 1
            s.wseq += 1  # even again: the deposit is settled
            if trace:
                s.trace = trace
            self.store_cond.notify_all()
        _send_msg(conn, _OP_COMMIT)

    def _drain_conn_streams(self, conn):
        """Disconnect drain (``TCP_DEAD_WRITER_DRAIN_STEPS``): any slot
        the dying connection left mid-stream is restored to the
        logical-zero drained state — evenize the seq so readers stop
        waiting, mark drained, clear the stream registration.  The torn
        deposit committed zero mass (version unchanged), so heal-time
        ledger accounting sees it as drained pending."""
        reg = _telemetry.get_registry()
        with self.lock:
            for key, st in list(self.streams.items()):
                if st["conn"] is not conn:
                    continue
                w = self.windows.get(key[0])
                if w is not None:
                    s = w.mail[key[1]]
                    s.wseq += 1            # 1. evenize_wseq
                    s.drained = s.version  # 2. mark_drained (reads zeros)
                    s.p = 0.0
                del self.streams[key]      # 3. clear_stream
                self.store_cond.notify_all()
                if reg.enabled:
                    reg.counter("tcp.mid_stream_drains").inc()
                    reg.journal("tcp_mid_stream_drain", win_id=key[0],
                                slot=key[1], rank=self.rank)

    def _serve_conn(self, conn):
        rd = _BufReader(conn)
        try:
            while True:
                op, win_id, slot, mode, nbytes, p, trace = _HDR.unpack(
                    rd.read_exact(_HDR.size))
                if op == _OP_CHUNK:
                    # payload handled inside (zero-copy into the slot)
                    self._handle_chunk(conn, rd, win_id, slot, mode, p,
                                       nbytes, trace)
                    continue
                payload = rd.read_exact(nbytes) if nbytes else b""
                if op == _OP_COMMIT:
                    self._handle_commit(conn, win_id, slot, mode, p, trace)
                elif op == _OP_WRITE:
                    with self.lock:
                        w = self.windows[win_id]
                        s = w.mail[slot]
                        if len(payload) != w.nbytes:
                            # log, then drop the faulty request AND the
                            # connection: the writer sees ConnectionError at
                            # the ack instead of corrupting the slot (a
                            # bytearray slice-assign would silently RESIZE it)
                            logger.error(
                                "rank %d mailbox: win write to %d[%d]: "
                                "payload %dB != window %dB — dropping "
                                "connection", self.rank, win_id, slot,
                                len(payload), w.nbytes,
                            )
                            raise ConnectionError("size mismatch")
                        if mode == 1 and w.dtype.kind == "f" \
                                and s.drained != s.version:
                            a = np.frombuffer(bytes(s.data), w.dtype) + \
                                np.frombuffer(payload, w.dtype)
                            s.data[:] = a.tobytes()
                            s.p += p
                        else:
                            # put — or accumulate onto a logically-zero
                            # (drained) slot, which is just a put
                            s.data[:] = payload
                            s.p = p
                        s.version += 1
                        if trace:
                            s.trace = trace
                    _send_msg(conn, op)  # ack → MPI_Win_flush semantics
                elif op == _OP_READ_EXPOSED:
                    with self.lock:
                        w = self.windows[win_id]
                        s = w.exposed
                        data, pv = bytes(s.data), s.p
                        ver = s.version
                    _send_msg(conn, op, win_id, ver, 0, pv, data)
                elif op == _OP_MUTEX_ACQ:
                    with self.mutex_cond:
                        while self.mutex_owner is not None:
                            self.mutex_cond.wait()
                        self.mutex_owner = conn
                    _send_msg(conn, op)
                elif op == _OP_MUTEX_REL:
                    with self.mutex_cond:
                        if self.mutex_owner is conn:
                            self.mutex_owner = None
                            self.mutex_cond.notify()
                    _send_msg(conn, op)
                elif op == _OP_BARRIER:
                    with self.bar_cond:
                        gen = self.bar_gen
                        self.bar_count += 1
                        if self.bar_count == self.nranks:
                            self.bar_count = 0
                            self.bar_gen += 1
                            self.bar_cond.notify_all()
                        else:
                            while self.bar_gen == gen:
                                self.bar_cond.wait()
                    _send_msg(conn, op)
                elif op == _OP_REGISTER:
                    r = slot
                    addr = payload.decode()
                    with self.reg_cond:
                        self.registry[r] = addr
                        if len(self.registry) == self.nranks:
                            self.reg_cond.notify_all()
                        else:
                            while len(self.registry) < self.nranks:
                                self.reg_cond.wait()
                        table = "\n".join(
                            f"{k} {v}" for k, v in sorted(self.registry.items())
                        ).encode()
                    _send_msg(conn, op, payload=table)
                elif op == _OP_BARRIER_T:
                    # timed barrier: the COORDINATOR owns the retraction
                    # (client-side socket timeouts cannot un-arrive), so a
                    # timed-out rank leaves the count exactly as if it had
                    # never arrived and a later barrier is unharmed
                    timed_out = 0
                    with self.bar_cond:
                        gen = self.bar_gen
                        self.bar_count += 1
                        if self.bar_count == self.nranks:
                            self.bar_count = 0
                            self.bar_gen += 1
                            self.bar_cond.notify_all()
                        else:
                            deadline = time.monotonic() + max(0.0, p)
                            while self.bar_gen == gen:
                                left = deadline - time.monotonic()
                                if left <= 0:
                                    break
                                self.bar_cond.wait(left)
                            if self.bar_gen == gen:
                                self.bar_count -= 1  # retract arrival
                                timed_out = 1
                    _send_msg(conn, op, mode=timed_out)
                elif op == _OP_HEARTBEAT:
                    with self.lease_lock:
                        self.leases[slot] = time.monotonic()
                    _send_msg(conn, op)
                elif op == _OP_LIVENESS:
                    with self.lease_lock:
                        stamp = self.leases.get(slot, 0.0)
                    age = (time.monotonic() - stamp) if stamp > 0 else -1.0
                    _send_msg(conn, op, p=age)
                elif op == _OP_CLOCK:
                    # coordinator clock read for the min-RTT offset
                    # estimator (bluefog_tpu_torch.tracing.clock): reply as
                    # late as possible so queueing before the read only
                    # widens the client's RTT bound, never biases it
                    _send_msg(conn, op, p=time.monotonic())
                elif op == _OP_JOIN_RANK:
                    with self.join_lock:
                        granted = self.next_join_rank
                        self.next_join_rank += 1
                    _send_msg(conn, op, slot=granted)
                elif op == _OP_EPOCH:
                    # mode 1 publishes (monotone, like
                    # shm_native.publish_membership_epoch), mode 0 reads;
                    # either way the reply carries the current word
                    with self.join_lock:
                        if mode == 1 and slot > self.membership_epoch:
                            self.membership_epoch = slot
                        e = self.membership_epoch
                    _send_msg(conn, op, slot=e)
                elif op == _OP_PING:
                    _send_msg(conn, op)
                else:
                    raise ValueError(f"bad op {op}")
        except (ConnectionError, OSError):
            pass
        finally:
            # a dying holder must not leave the mutex locked forever
            with self.mutex_cond:
                if self.mutex_owner is conn:
                    self.mutex_owner = None
                    self.mutex_cond.notify()
            # ... nor its slot torn: drain any stream it left mid-flight
            self._drain_conn_streams(conn)
            conn.close()

    def stop(self):
        self._stop = True
        # shutdown() wakes a thread blocked in accept() (close() alone
        # does not on Linux — the zombie thread would keep accepting on
        # the fd number once the kernel reuses it for a later listener)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.thread.join(timeout=5.0)


class _Peers:
    """Lazy persistent client connections, one per destination rank.
    One request/response at a time per peer (guarded by a lock) — the
    caller is single-threaded in practice, the lock makes it safe anyway."""

    def __init__(self, table: Dict[int, str]):
        self.table = table
        self.conns: Dict[int, socket.socket] = {}
        self.locks: Dict[int, threading.Lock] = {}

    def _connect(self, rank: int) -> socket.socket:
        """Get-or-create the persistent connection (caller holds the
        per-peer lock)."""
        conn = self.conns.get(rank)
        if conn is None:
            host, port = self.table[rank].rsplit(":", 1)
            conn = socket.create_connection((host, int(port)), timeout=60)
            # a bounded deadline replaces the old unbounded wait: a
            # request to a DEAD peer must eventually surface as a
            # PeerTimeoutError naming the rank, not a silent hang
            conn.settimeout(peer_timeout_s())
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.conns[rank] = conn
        return conn

    def _evict(self, rank: int, conn) -> None:
        # a half-done exchange leaves the stream unusable (a late reply
        # would be mis-paired with the next request) — drop the socket so
        # the NEXT request reconnects instead of failing forever
        self.conns.pop(rank, None)
        try:
            conn.close()
        except OSError:
            pass

    def _backoff(self, rank: int, attempt: int, opname: str) -> None:
        """One bounded full-jitter backoff step before a reconnect.

        Sampling ``uniform(0, min(cap, base * 2**attempt))`` instead of
        sleeping the deterministic bound decorrelates a fleet that lost
        the same peer at the same instant (publisher restart → every
        replica reconnecting in lockstep, a thundering herd)."""
        delay = _jitter_rng.uniform(
            0.0, min(tcp_backoff_s() * (2 ** attempt), 2.0))
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.histogram("tcp.retry_backoff_s", op=opname).observe(delay)
            reg.journal("tcp_retry", peer_rank=rank, op=opname,
                        attempt=attempt + 1, backoff_s=delay)
        if delay > 0:
            time.sleep(delay)

    def _note_reconnect(self, opname: str) -> None:
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("tcp.reconnects", op=opname).inc()

    def _timeout_error(self, rank: int, opname: str) -> PeerTimeoutError:
        reg = _telemetry.get_registry()
        addr = self.table.get(rank)
        if reg.enabled:
            reg.counter("tcp.timeouts", op=opname).inc()
            reg.journal("peer_timeout", peer_rank=rank, addr=addr,
                        op=opname, deadline_s=peer_timeout_s())
        tr = _tracing.get_tracer()
        if tr.enabled:
            tr.instant(f"peer_timeout:{opname}", aux=rank)
            tr.dump_flight(f"PeerTimeoutError:{opname}:r{rank}")
        return PeerTimeoutError(
            f"rank {rank} ({addr}) did not respond to op "
            f"{opname} within {peer_timeout_s()}s (set "
            f"BFTPU_PEER_TIMEOUT_S to adjust)",
            rank=rank, addr=addr, op=opname)

    def request(self, rank: int, op, win_id=0, slot=0, mode=0, p=0.0,
                payload=b"", trace=0):
        reg = _telemetry.get_registry()
        opname = _OP_NAMES.get(op, str(op))
        t0 = time.perf_counter_ns() if reg.enabled else 0
        lock = self.locks.setdefault(rank, threading.Lock())
        with lock:
            attempt = 0
            while True:
                conn = None
                try:
                    conn = self._connect(rank)
                    if attempt:
                        self._note_reconnect(opname)
                    _send_msg(conn, op, win_id, slot, mode, p, payload,
                              trace=trace)
                    reply = _recv_msg(conn)
                    break
                except socket.timeout as e:
                    # deliberately NOT retried: the peer is connected
                    # but silent — reconnecting can't help, and the
                    # failure detector owns this verdict
                    self._evict(rank, conn)
                    raise self._timeout_error(rank, opname) from e
                except (ConnectionError, OSError):
                    if conn is not None:
                        self._evict(rank, conn)
                    # a failure INSIDE _connect (conn is None) never
                    # reached the server, so any op may retry it; a
                    # mid-exchange drop replays only idempotent ops
                    replayable = conn is None or op in _IDEMPOTENT_OPS
                    if not replayable or attempt >= tcp_retries():
                        raise
                    self._backoff(rank, attempt, opname)
                    attempt += 1
        if reg.enabled:
            reg.counter("tcp.round_trips", op=opname).inc()
            reg.counter("tcp.acks").inc()
            reg.counter("tcp.bytes_sent").add(_HDR.size + len(payload))
            reg.counter("tcp.bytes_received").add(_HDR.size + len(reply[5]))
            reg.histogram("tcp.rtt_s", op=opname).observe(
                (time.perf_counter_ns() - t0) / 1e9)
        return reply

    def deposit_chunked(self, rank: int, win_id: int, slot: int,
                        arr: np.ndarray, p: float, accumulate: bool,
                        trace: int, residual: Optional[np.ndarray] = None,
                        src_rank: int = -1) -> None:
        """Stream ONE window deposit as pipelined chunk frames + a commit.

        The sender runs ahead of the acks under a credit window
        (``BFTPU_TCP_WINDOW_CHUNKS``): it collects one ack per chunk
        frame only once that many are outstanding, then sends the
        ``_OP_COMMIT`` frame carrying the exact mass ``p`` and drains
        the remaining credits — the whole deposit costs ~one RTT
        instead of one per payload byte window.

        ``residual`` (same dtype/size as ``arr``, flattened) enables
        error-feedback quantization: the carry is folded into the
        outgoing values and re-settled per chunk against what the wire
        actually delivered, so ``sum(delivered) + residual`` always
        equals ``sum(inputs)`` — mass conservation at the value level.
        """
        reg = _telemetry.get_registry()
        t0 = time.perf_counter_ns() if reg.enabled else 0
        code = wire_codec.wire_code() if arr.dtype.kind == "f" \
            else wire_codec.WIRE_RAW
        buf = arr.ravel() if residual is None else arr.ravel() + residual
        elems = max(_chunk_bytes() // arr.dtype.itemsize, 1)
        total = buf.size
        nchunks = (total + elems - 1) // elems
        credit = window_chunks()
        acc = 1 if accumulate else 0
        kill_after = _chunk_kill_after(src_rank)
        wire_bytes = 0
        lock = self.locks.setdefault(rank, threading.Lock())
        with lock:
            attempt = 0
            while True:
                conn = None
                commit_sent = False
                wire_bytes = 0
                try:
                    conn = self._connect(rank)
                    if attempt:
                        self._note_reconnect("write_chunked")
                    # frames coalesce into half-credit-window sendmsg
                    # iovecs (one syscall apiece), acks drain in matching
                    # bulk recvs; the chaos kill path flushes per frame so
                    # the "die after n chunk frames" schedule stays exact
                    batch = max(credit // 2, 1) if kill_after < 0 else 1
                    outstanding = 0
                    pend = 0
                    iov = []
                    for idx in range(nchunks):
                        lo = idx * elems
                        hi = min(lo + elems, total)
                        view = buf[lo:hi]
                        code_i, payload, scale = wire_codec.encode_chunk(
                            view, code)
                        iov.append(_HDR.pack(
                            _OP_CHUNK, win_id, slot,
                            (idx << 8) | (code_i << 1) | acc,
                            len(payload), scale, lo))
                        if payload:
                            iov.append(payload)
                        pend += 1
                        wire_bytes += _HDR.size + len(payload)
                        if residual is not None:
                            # pure function of `buf` (encode is
                            # deterministic), so a stream REPLAY after a
                            # disconnect rewrites the same residuals —
                            # no pre-attempt snapshot needed
                            if code_i == wire_codec.WIRE_RAW:
                                residual[lo:hi] = 0  # wire was exact
                            else:
                                residual[lo:hi] = \
                                    view - wire_codec.decode_chunk(
                                        payload, code_i, scale,
                                        arr.dtype, hi - lo)
                        if pend >= batch:
                            over = outstanding + pend - credit
                            if over > 0:  # honor the credit window FIRST
                                _drain_acks(conn, over)
                                outstanding -= over
                            _send_iov(conn, iov)
                            iov = []
                            outstanding += pend
                            pend = 0
                        if kill_after >= 0 and idx + 1 >= kill_after:
                            from bluefog_tpu_torch.resilience.chaos import \
                                kill_self
                            kill_self()
                    if pend:
                        over = outstanding + pend - credit
                        if over > 0:
                            _drain_acks(conn, over)
                            outstanding -= over
                        _send_iov(conn, iov)
                        outstanding += pend
                    # point of no replay: once any commit-frame byte may
                    # be on the wire the server MAY have advanced the
                    # slot version and mass — re-sending would
                    # double-commit, so failures past here raise
                    commit_sent = True
                    _send_msg(conn, _OP_COMMIT, win_id, slot,
                              (nchunks << 1) | acc, float(p), trace=trace)
                    wire_bytes += _HDR.size
                    _drain_acks(conn, outstanding + 1)
                    break
                except socket.timeout as e:
                    self._evict(rank, conn)
                    raise self._timeout_error(rank, "write_chunked") from e
                except (ConnectionError, OSError):
                    if conn is not None:
                        self._evict(rank, conn)
                    # an UNCOMMITTED stream is replay-safe: the server
                    # advances version/mass only at _OP_COMMIT
                    # (TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD) and its
                    # disconnect handler drained the torn stream, so the
                    # retry re-opens chunk 0 against a clean slot
                    if commit_sent or attempt >= tcp_retries():
                        raise
                    self._backoff(rank, attempt, "write_chunked")
                    attempt += 1
        if reg.enabled:
            reg.counter("tcp.round_trips", op="write_chunked").inc()
            reg.counter("tcp.acks").add(nchunks + 1)
            reg.counter("tcp.chunks_sent").add(nchunks)
            reg.counter("tcp.bytes_sent").add(wire_bytes)
            reg.counter("tcp.bytes_received").add(_HDR.size * (nchunks + 1))
            # raw vs wire payload volume: the measured compression ratio
            # (bench.py wire_compression_ratio) is wire/raw
            reg.counter("tcp.raw_payload_bytes").add(arr.nbytes)
            reg.counter("tcp.wire_payload_bytes").add(wire_bytes)
            reg.histogram("tcp.rtt_s", op="write_chunked").observe(
                (time.perf_counter_ns() - t0) / 1e9)

    def close(self):
        for c in self.conns.values():
            try:
                c.close()
            except OSError:
                pass
        self.conns.clear()


class _JobRuntime:
    """Shared per-process runtime: server + peer table (created once, used
    by the job handle and every window)."""

    _by_key: Dict[Tuple[str, int], "_JobRuntime"] = {}
    _cls_lock = threading.Lock()

    def __init__(self, job: str, rank: int, nranks: int, coord: str):
        self.job = job
        self.rank = rank
        self.nranks = nranks
        host = os.environ.get("BLUEFOG_ISLAND_HOST", "127.0.0.1")
        self.server = _Server(rank, nranks, host)
        self._win_ids: Dict[str, int] = {}
        self._next_win = 0
        chost, cport = coord.rsplit(":", 1)
        if rank == 0:
            # rank 0 additionally runs the coordinator (rendezvous +
            # barrier) on the well-known port
            self._coord_server = _Server(rank, nranks, chost, int(cport))
        else:
            self._coord_server = None
        # register with the coordinator (retry while rank 0 comes up)
        my_addr = f"{host}:{self.server.port}"
        deadline = time.time() + 60
        while True:
            try:
                coord_conn = socket.create_connection(
                    (chost, int(cport)), timeout=5
                )
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        # registration/barrier replies wait on OTHER ranks, but never
        # forever: a dead sibling must surface as PeerTimeoutError(-1)
        # within the configured deadline, not hang the job
        coord_conn.settimeout(peer_timeout_s())
        coord_conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(coord_conn, _OP_REGISTER, slot=rank, payload=my_addr.encode())
        table_raw = _recv_msg(coord_conn)[5]
        self._coord_conn = coord_conn  # kept open: barrier rides on it
        self._coord_addr = (chost, int(cport))
        # leases ride a SEPARATE lazily-created coordinator connection: the
        # heartbeat thread must keep renewing while the main thread blocks
        # inside a barrier on _coord_conn
        self._lease_conn: Optional[socket.socket] = None
        self._lease_lock = threading.Lock()
        table = {}
        for line in table_raw.decode().splitlines():
            k, v = line.split()
            table[int(k)] = v
        self.peers = _Peers(table)

    @classmethod
    def get(cls, job: str, rank: int, nranks: int, coord: str) -> "_JobRuntime":
        with cls._cls_lock:
            key = (job, rank)
            rt = cls._by_key.get(key)
            if rt is None:
                rt = cls(job, rank, nranks, coord)
                cls._by_key[key] = rt
            return rt

    @classmethod
    def drop(cls, job: str, rank: int):
        with cls._cls_lock:
            rt = cls._by_key.pop((job, rank), None)
        if rt is not None:
            rt.peers.close()
            try:
                rt._coord_conn.close()
            except OSError:
                pass
            if rt._lease_conn is not None:
                try:
                    rt._lease_conn.close()
                except OSError:
                    pass
            rt.server.stop()
            if rt._coord_server is not None:
                rt._coord_server.stop()

    def win_id(self, name: str) -> int:
        # window ids must agree across ranks: windows are created
        # collectively in the same order (enforced by the create barrier),
        # so a per-process counter stays in sync
        if name not in self._win_ids:
            self._win_ids[name] = self._next_win
            self._next_win += 1
        return self._win_ids[name]

    def barrier(self, timeout: Optional[float] = None):
        with self.peers.locks.setdefault(-1, threading.Lock()):
            mode = 0
            try:
                if timeout is None:
                    _send_msg(self._coord_conn, _OP_BARRIER)
                    _recv_msg(self._coord_conn)
                else:
                    # the coordinator owns the timed wait AND the arrival
                    # retraction; the socket deadline only covers the
                    # round trip on top of it
                    old = self._coord_conn.gettimeout()
                    self._coord_conn.settimeout(float(timeout) + 30.0)
                    try:
                        _send_msg(self._coord_conn, _OP_BARRIER_T,
                                  p=float(timeout))
                        mode = _recv_msg(self._coord_conn)[3]
                    finally:
                        self._coord_conn.settimeout(old)
            except socket.timeout as e:
                # NB socket.timeout IS TimeoutError (py3.10): only socket
                # waits happen inside this try, so the clause is unambiguous
                addr = "%s:%s" % self._coord_addr
                reg = _telemetry.get_registry()
                if reg.enabled:
                    reg.counter("tcp.timeouts", op="barrier").inc()
                    reg.journal("peer_timeout", peer_rank=0, addr=addr,
                                op="barrier")
                tr = _tracing.get_tracer()
                if tr.enabled:
                    tr.instant("peer_timeout:barrier", aux=0)
                    tr.dump_flight("PeerTimeoutError:barrier")
                raise PeerTimeoutError(
                    "coordinator (rank 0) did not answer the barrier "
                    f"within its deadline ({addr})",
                    rank=-1, addr=addr, op="barrier") from e
            if mode:
                raise TimeoutError(
                    f"barrier timed out after {timeout}s (rank {self.rank})")

    def _lease_request(self, op: int, rank: int) -> float:
        """One heartbeat/liveness round trip to the coordinator (own
        connection + lock: must work while barrier blocks _coord_conn)."""
        with self._lease_lock:
            conn = self._lease_conn
            if conn is None:
                conn = socket.create_connection(self._coord_addr, timeout=5)
                conn.settimeout(peer_timeout_s())
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._lease_conn = conn
            try:
                _send_msg(conn, op, slot=rank)
                return _recv_msg(conn)[4]
            except (socket.timeout, ConnectionError, OSError):
                self._lease_conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                raise


class TcpShmJob:
    """Job handle with the shm-job interface (barrier + mutexes)."""

    def __init__(self, job: str, rank: int, nranks: int, coord: str):
        self.rt = _JobRuntime.get(job, rank, nranks, coord)
        self.job = job
        self.rank = rank

    def barrier(self, timeout: Optional[float] = None) -> None:
        self.rt.barrier(timeout=timeout)

    def mutex_acquire(self, rank: int) -> None:
        self.rt.peers.request(rank, _OP_MUTEX_ACQ)

    def mutex_release(self, rank: int) -> None:
        self.rt.peers.request(rank, _OP_MUTEX_REL)

    # -- liveness leases (coordinator-mediated; see FailureDetector) -------
    def heartbeat(self) -> None:
        """Renew my lease at the rank-0 coordinator."""
        self.rt._lease_request(_OP_HEARTBEAT, self.rank)

    def liveness(self, rank: int) -> float:
        """Last lease renewal of ``rank``, mapped onto MY monotonic clock
        (0.0 = never renewed).  The coordinator reports lease AGE — ages
        transport across hosts; raw stamps do not."""
        age = self.rt._lease_request(_OP_LIVENESS, rank)
        if age < 0:
            return 0.0
        return max(0.0, time.monotonic() - age)

    def clock_probe(self) -> Tuple[float, float, float]:
        """One NTP-style exchange with the rank-0 coordinator: returns
        ``(t0, remote, t1)`` — local send time, the coordinator's
        monotonic clock, local receive time — for
        :class:`bluefog_tpu_torch.tracing.ClockEstimator`.  Rides the lease
        connection, which works while a barrier blocks the main one."""
        t0 = time.monotonic()
        remote = self.rt._lease_request(_OP_CLOCK, self.rank)
        return t0, remote, time.monotonic()

    def close(self, unlink: bool = False) -> None:
        del unlink
        _JobRuntime.drop(self.job, self.rank)


class TcpShmWindow:
    """Window handle with the shm-window interface over the TCP runtime."""

    #: no fused scale: ``write`` has no ``scale`` kwarg — islands
    #: pre-multiplies before a TCP deposit (capability-linted).
    supports_scale = False

    CAPS = _caps.TransportCaps(
        name="tcp",
        fused_accumulate=True,
        fused_scale=False,       # == supports_scale
        fused_combine=False,     # no combine()/update_fused()
        zero_copy_collect=True,  # collect swaps the slot buffer, O(1)
        chunked_streaming=True,  # deposit_chunked + credit window
        wire_quantization=True,  # BFTPU_WIRE_DTYPE + EF residual
        resume=True,             # session resume replays _IDEMPOTENT_OPS
    )

    def __init__(self, job: str, name: str, rank: int, nranks: int,
                 maxd: int, shape, dtype, coord: str):
        self.rt = _JobRuntime.get(job, rank, nranks, coord)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        self._id = self.rt.win_id(name)
        with self.rt.server.lock:
            self.rt.server.windows[self._id] = _WinStore(
                maxd, self.nbytes, self.dtype
            )
        # trace words staged by trace_stamp, consumed (popped) by the
        # immediately-following write() — same-thread call pattern
        self._trace_out: Dict[Tuple[int, int], int] = {}
        # error-feedback residuals, one per (dst, slot) out-edge, created
        # lazily when a quantized wire dtype is configured — the carry
        # survives edge demotion (flushed on the next deposit) and only
        # dies with the window (or the peer)
        self._residual: Dict[Tuple[int, int], np.ndarray] = {}

    # -- local (owner-side) ops --------------------------------------------
    def _store(self) -> _WinStore:
        return self.rt.server.windows[self._id]

    def _await_settled(self, s: _Slot) -> None:
        """Wait out a mid-flight chunk stream (``wseq`` odd) before a
        payload read/reset — the commit or the dead-writer drain
        notifies.  Caller holds ``store_cond`` (== the server lock, which
        ``wait`` releases while blocked, so chunk frames keep landing)."""
        if not s.wseq & 1:
            return
        deadline = time.monotonic() + (peer_timeout_s() or 120.0)
        while s.wseq & 1:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    "mid-stream deposit never settled (writer alive but "
                    "stalled past BFTPU_PEER_TIMEOUT_S)")
            self.rt.server.store_cond.wait(min(left, 0.2))

    def trace_stamp(self, dst: int, slot: int, word: int,
                    writer=None) -> None:
        """Stage the trace-context word for the next write to (dst,
        slot); it rides the frame header of that write."""
        del writer
        self._trace_out[(int(dst), int(slot))] = int(word)

    def trace_peek(self, slot: int, src=None) -> int:
        del src
        with self.rt.server.lock:
            return self._store().mail[slot].trace

    def read(self, slot: int, collect: bool = False, src=None):
        del src
        srv = self.rt.server
        with srv.store_cond:
            s = self._store().mail[slot]
            self._await_settled(s)
            if s.drained == s.version:
                # logically zero: the drained marker spares both the
                # payload copy here and the memset on collect
                a = np.zeros(self.shape, self.dtype)
                p = 0.0
            elif collect:
                # collect takes the buffer itself (the slot is drained
                # anyway) and swaps in a fresh zeroed one — O(1), no
                # payload copy at all
                raw = s.data
                s.data = bytearray(self.nbytes)
                a = np.frombuffer(raw, self.dtype).reshape(self.shape)
                p = s.p
            else:
                a = np.frombuffer(s.data, self.dtype).reshape(
                    self.shape).copy()
                p = s.p
            ver = s.version
            if collect:
                # collect == read + drain in ONE critical section
                # (TCP_DRAINED_COLLECT_IS_ATOMIC)
                s.drained = s.version
                s.p = 0.0
        return a, p, ver

    def read_version(self, slot: int, src=None) -> int:
        # metadata-only: no _await_settled — a mid-stream slot reports
        # its pre-stream version (the stream commits later, by design)
        del src
        with self.rt.server.lock:
            return self._store().mail[slot].version

    def reset(self, slot: int, src=None) -> None:
        del src
        srv = self.rt.server
        with srv.store_cond:
            s = self._store().mail[slot]
            self._await_settled(s)
            s.drained = s.version
            s.p = 0.0

    def force_drain(self, slot: int, src=None) -> None:
        """Owner-side drain of a possibly-torn mail slot: the heal-path
        hook islands' dead-writer accounting calls on every transport
        (shm grew it in v2; this is the TCP twin).  Safe on a settled
        slot (just drops pending mass); on a mid-stream slot it applies
        ``TCP_DEAD_WRITER_DRAIN_STEPS`` without waiting for the
        disconnect handler."""
        del src
        srv = self.rt.server
        with srv.store_cond:
            s = self._store().mail[slot]
            if s.wseq & 1:
                s.wseq += 1            # 1. evenize_wseq
            s.drained = s.version      # 2. mark_drained
            s.p = 0.0
            srv.streams.pop((self._id, slot), None)  # 3. clear_stream
            srv.store_cond.notify_all()
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("tcp.force_drains").inc()

    def expose(self, array, p: float = 1.0) -> None:
        a = np.ascontiguousarray(np.asarray(array, self.dtype))
        if a.nbytes != self.nbytes:
            raise ValueError(
                f"expose payload has {a.nbytes} bytes but window "
                f"expects {self.nbytes} (shape {self.shape})"
            )
        try:
            src = a.view(np.uint8).data  # zero-copy byte view
        except (TypeError, ValueError):
            src = a.tobytes()
        with self.rt.server.lock:
            s = self._store().exposed
            s.data[:] = src  # single copy into the slot
            s.p = float(p)
            s.version += 1

    # -- remote (one-sided) ops --------------------------------------------
    def write(self, dst: int, slot: int, array, p: float = 1.0,
              accumulate: bool = False, writer=None) -> None:
        del writer
        if accumulate and self.dtype.kind != "f":
            raise TypeError(f"accumulate unsupported for dtype {self.dtype}")
        a = np.ascontiguousarray(np.asarray(array, self.dtype))
        if a.nbytes != self.nbytes:
            raise ValueError(
                f"win_put payload has {a.nbytes} bytes but window "
                f"expects {self.nbytes} (shape {self.shape})"
            )
        trace = self._trace_out.pop((int(dst), int(slot)), 0)
        if dst == self.rt.rank:
            # local fast path, same semantics (incl. the drained marker:
            # accumulate onto a logically-zero slot is a put)
            try:
                src = a.view(np.uint8).data  # zero-copy byte view
            except (TypeError, ValueError):
                src = a.tobytes()
            with self.rt.server.lock:
                s = self._store().mail[slot]
                if accumulate and s.drained != s.version:
                    # in-place: frombuffer on the bytearray is writable
                    cur = np.frombuffer(s.data, self.dtype)
                    cur += a.ravel()
                    s.p += float(p)
                else:
                    s.data[:] = src
                    s.p = float(p)
                s.version += 1
                if trace:
                    s.trace = trace
            return
        if tcp_chunked() and a.size:
            residual = None
            if self.dtype.kind == "f" \
                    and wire_codec.wire_code() != wire_codec.WIRE_RAW:
                key = (int(dst), int(slot))
                residual = self._residual.get(key)
                if residual is None:
                    residual = self._residual[key] = np.zeros(
                        a.size, self.dtype)
            self.rt.peers.deposit_chunked(
                dst, self._id, slot, a, float(p), accumulate, trace,
                residual=residual, src_rank=self.rt.rank)
            return
        try:
            # zero-copy byte view; the uint8 reinterpret also covers
            # ml_dtypes (bf16) arrays whose native buffers can't export
            payload = a.view(np.uint8).data
        except (TypeError, ValueError):
            payload = a.tobytes()
        self.rt.peers.request(
            dst, _OP_WRITE, self._id, slot, 1 if accumulate else 0,
            float(p), payload, trace=trace,
        )

    def read_exposed(self, src: int):
        if src == self.rt.rank:
            with self.rt.server.lock:
                s = self._store().exposed
                a = np.frombuffer(s.data, self.dtype).reshape(self.shape)
                return a.copy(), s.p, s.version
        _, _, ver, _, p, payload, _ = self.rt.peers.request(
            src, _OP_READ_EXPOSED, self._id
        )
        a = np.frombuffer(payload, self.dtype).reshape(self.shape)
        return a.copy(), p, ver

    def close(self, unlink: bool = False) -> None:
        del unlink
        self._residual.clear()
        with self.rt.server.lock:
            self.rt.server.windows.pop(self._id, None)

    def unlink_segments(self) -> None:
        pass  # in-memory store, freed at close
