"""TransportSpec: the window/mailbox contract as checked data.

ROADMAP item 1 (tiered transports: device-resident windows, in-mesh
collectives) refactors against ONE seam — the window transport contract —
which until now existed only implicitly, re-derived in four modules
(``native/shm_native.py``, ``native/tcp_transport.py``,
``native/routed_transport.py``, ``sim/transport.py``).  This module makes
it explicit, three ways:

1. **Spec table** (:data:`TRANSPORT_SPEC`): every rule of the contract as
   a :class:`SpecRule` that *pins the constant it governs* — the
   protocol-step tuples, atomicity flags, ordering booleans, and chunk
   geometry in ``shm_native`` / ``tcp_transport``.  This generalizes the
   ad-hoc ``wire_rules.check_spec_parity``: a transport that drifts from
   the contract fails the pin, not a code review.

2. **Executable reference model** (:class:`ReferenceTransport`): the
   contract's observable semantics (slot lifecycle, atomic drain,
   commit-after-payload, epoch quiesce/re-seed, dead-writer drain,
   mass-ledger identity) as a tiny sequential implementation.  The
   conformance harness (``analysis/conformance.py``) drives every real
   transport and this model through identical op schedules and diffs
   observable state after every op.

3. **Capability lint** (``transport.caps-*`` rules): each transport
   declares a :class:`~bluefog_tpu_torch.native.capabilities.TransportCaps`
   record; the lint verifies every declaration is honest against the
   class's actual surface, that composite (routed) capabilities are the
   meet of their legs, and that every adaptive call site — islands'
   scaled-deposit/fused-combine decisions, the progress engine's fusion
   gate, wire-dtype selection, TCP resume — branches on declared
   capabilities, never on transport class identity.

Registered family: ``transport`` (fast, host-only — a few ms).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Severity, registry
from bluefog_tpu_torch.native import capabilities as caps_mod
from bluefog_tpu_torch.native.capabilities import CAP_FIELDS, TransportCaps

__all__ = [
    "Pin",
    "SpecRule",
    "TRANSPORT_SPEC",
    "ReferenceTransport",
    "evaluate_spec",
    "declared_transports",
    "check_caps_declared",
    "check_caps_honest",
    "check_caps_call_sites",
]

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# the spec table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pin:
    """One constant the contract pins: ``module.attr`` must equal
    ``expected`` (tuples compare exactly; booleans must be identical)."""

    module: str
    attr: str
    expected: object

    def problems(self) -> List[str]:
        try:
            mod = importlib.import_module(self.module)
        except Exception as exc:  # pragma: no cover - import breakage
            return [f"{self.module} failed to import: {exc!r}"]
        if not hasattr(mod, self.attr):
            return [f"{self.module}.{self.attr} is gone (spec pins it)"]
        actual = getattr(mod, self.attr)
        if actual != self.expected:
            return [
                f"{self.module}.{self.attr} = {actual!r} but the spec "
                f"pins {self.expected!r}"
            ]
        return []


@dataclasses.dataclass(frozen=True)
class SpecRule:
    """One rule of the transport contract.

    ``pins`` bind the rule to the constants that encode it in the real
    transports; ``check`` (optional) is an executable verification of the
    rule's semantics — usually against :class:`ReferenceTransport` or a
    live pure-Python surface — returning a list of problem strings."""

    name: str
    doc: str
    pins: Tuple[Pin, ...] = ()
    check: Optional[Callable[[], List[str]]] = None

    def problems(self) -> List[str]:
        out: List[str] = []
        for pin in self.pins:
            out.extend(pin.problems())
        if self.check is not None:
            try:
                out.extend(self.check())
            except Exception as exc:
                out.append(f"executable check raised {exc!r}")
        return out


_SHM = "bluefog_tpu_torch.native.shm_native"
_TCP = "bluefog_tpu_torch.native.tcp_transport"


def _check_drain_orders() -> List[str]:
    """mark_drained must precede the final teardown step in BOTH
    dead-writer drain recipes (a drain that clears the lock/stream before
    the marker exposes a torn payload to a racing reader)."""
    from bluefog_tpu_torch.native import shm_native, tcp_transport

    out = []
    for label, steps, last in (
        ("shm", shm_native.DEAD_WRITER_DRAIN_STEPS, "clear_lock"),
        ("tcp", tcp_transport.TCP_DEAD_WRITER_DRAIN_STEPS, "clear_stream"),
    ):
        if "mark_drained" not in steps or last not in steps:
            out.append(f"{label} drain steps {steps!r} lost "
                       f"mark_drained/{last}")
            continue
        if steps.index("mark_drained") > steps.index(last):
            out.append(f"{label} drain marks drained AFTER {last}: {steps!r}")
    if shm_native.DEAD_WRITER_DRAIN_STEPS[0] != "evenize_chunk_seqs":
        out.append("shm drain must even-ize torn chunk seqlocks first, "
                   f"got {shm_native.DEAD_WRITER_DRAIN_STEPS!r}")
    return out


def _check_chunk_geometry() -> List[str]:
    """Both chunked transports must agree on the configured chunk size
    (a reader drains what a writer streamed — mismatched geometry tears
    the frontier invariant at the seam between tiers)."""
    from bluefog_tpu_torch.native import shm_native, tcp_transport

    out = []
    shm_chunk = shm_native.chunk_bytes()
    tcp_chunk = tcp_transport._chunk_bytes()
    if shm_chunk != tcp_chunk:
        out.append(f"chunk geometry diverged: shm {shm_chunk} B vs "
                   f"tcp {tcp_chunk} B")
    if shm_native.pipeline_depth() < 1:
        out.append("pipeline depth < 1")
    return out


def _check_resume_replay_set() -> List[str]:
    """Session resume may replay only idempotent (read-only) ops — a
    replayed WRITE double-counts a deposit.  Chunked deposits are NOT in
    the set: their replay rule (safe up to the commit frame) lives in
    deposit_chunked itself."""
    from bluefog_tpu_torch.native import tcp_transport as t

    out = []
    expected = frozenset({
        t._OP_READ_EXPOSED, t._OP_PING, t._OP_HEARTBEAT, t._OP_LIVENESS,
        t._OP_CLOCK, t._OP_EPOCH,
    })
    if t._IDEMPOTENT_OPS != expected:
        out.append(f"_IDEMPOTENT_OPS = {sorted(t._IDEMPOTENT_OPS)!r}, spec "
                   f"pins {sorted(expected)!r}")
    for op, label in ((t._OP_WRITE, "WRITE"), (t._OP_CHUNK, "CHUNK"),
                      (t._OP_COMMIT, "COMMIT"), (t._OP_MUTEX_ACQ, "MUTEX")):
        if op in t._IDEMPOTENT_OPS:
            out.append(f"mutating op {label} marked replay-safe")
    return out


def _check_holder_board() -> List[str]:
    """Holder-board semantics: the advisory word is stamped right AFTER a
    raw acquire and cleared conditionally right BEFORE a release (so a
    release racing a break never erases the breaker's view), and a break
    clears unconditionally.  Checked two ways: the pure-Python board is
    exercised live, and the acquire/release wrappers' source must order
    the stamp/clear correctly."""
    import struct as _struct
    import tempfile

    from bluefog_tpu_torch.native import shm_native as sn

    out = []
    # live semantics on a throwaway board
    old = sn._FALLBACK_DIR
    tmp = tempfile.mkdtemp(prefix="bftpu_spec_holders_")
    try:
        sn._FALLBACK_DIR = tmp
        board = sn.HolderBoard("specjob", 4)
        try:
            board.set_holder(1, 2)
            if board.holder(1) != 2:
                out.append("holder word not readable after stamp")
            board.clear(1, holder_rank=3)  # conditional clear by non-holder
            if board.holder(1) != 2:
                out.append("conditional clear by a non-holder erased the "
                           "holder word (release/break race unsafe)")
            board.clear(1, holder_rank=2)
            if board.holder(1) is not None:
                out.append("conditional clear by the holder did not clear")
            board.set_holder(0, 1)
            board.clear(0)  # break path: unconditional
            if board.holder(0) is not None:
                out.append("unconditional (break) clear did not clear")
            # torn/stale words must read as free, never a bogus rank
            _struct.pack_into("<Q", board._seg._mm, 3 * 8, 99)
            if board.holder(3) is not None:
                out.append("out-of-range holder word not treated as free")
        finally:
            board.close(unlink=True)
    finally:
        sn._FALLBACK_DIR = old
    # source ordering: stamp after acquire, clear before release
    src = inspect.getsource(sn._timed_mutex_acquire)
    if src.rfind("acquire(rank, timeout)") > src.find("set_holder("):
        out.append("_timed_mutex_acquire stamps the holder word before "
                   "the raw acquire")
    rel = inspect.getsource(sn.FallbackShmJob.mutex_release)
    if rel.find(".clear(") > rel.find("unlock("):
        out.append("FallbackShmJob.mutex_release clears the holder word "
                   "after the unlock")
    return out


def _check_reference_ledger() -> List[str]:
    """Mass-ledger identity on the reference model: over any op sequence,
    committed deposits == collected + drained + retired-pending + live
    (counts and mass both) — the conservation law every transport's
    ledger telemetry reports against."""
    ref = ReferenceTransport(nranks=2)
    ref.deposit(0, 1, 3.0, 1.0)
    ref.deposit(0, 1, 2.0, 1.0)
    x, p, fresh = ref.collect(0, 1)
    out = []
    if (x, p, fresh) != (5.0, 2.0, 2):
        out.append(f"accumulate+collect returned {(x, p, fresh)!r}, "
                   "expected (5.0, 2.0, 2)")
    ref.deposit(0, 1, 7.0, 1.0)
    ref.drain(0, 1)          # uncollected mass must move to the drained bin
    ref.deposit(1, 0, 1.0, 1.0)
    ref.epoch_switch(1)      # quiesce: live mass retires to pending
    ref.deposit(0, 1, 9.0, 1.0)
    led = ref.ledger()
    if not led["balanced"]:
        out.append(f"ledger identity broken: {led!r}")
    if led["pending"] != 1 or led["drained"] != 1:
        out.append(f"retire/drain accounting off: {led!r}")
    return out


def _check_epoch_quiesce() -> List[str]:
    """Epoch switch quiesces the old epoch (late deposits bounce to the
    refused bucket, never silently commit) and re-seeds the new one (every
    slot starts from version 0 / zero mass)."""
    ref = ReferenceTransport(nranks=2)
    ref.deposit(0, 1, 4.0, 1.0)
    ref.epoch_switch(1)
    out = []
    if ref.version(0, 1) != 0:
        out.append("new epoch inherited old slot state (re-seed skipped)")
    ref.deposit_at_epoch(0, 0, 1, 8.0, 1.0)  # late delivery for epoch 0
    if ref.ledger()["refused"] != 1:
        out.append("late deposit into a retired epoch was not refused")
    x, p, fresh = ref.collect(0, 1)
    if fresh != 0:
        out.append("late deposit into a retired epoch became collectable")
    return out


def _check_dead_writer() -> List[str]:
    """Commit-after-payload makes the dead-writer drain sound: a writer
    death loses only uncommitted mass, and the heal-path force-drain
    conserves every committed deposit in the ledger."""
    ref = ReferenceTransport(nranks=2)
    ref.deposit(0, 1, 3.0, 1.0)          # committed before death
    ref.kill(1)
    ref.deposit(0, 1, 5.0, 1.0)          # dies mid-deposit: zero mass
    out = []
    if ref.version(0, 1) != 1:
        out.append("a dead writer's torn deposit committed mass")
    ref.drain(0, 1)                      # heal-path force drain
    led = ref.ledger()
    if not led["balanced"] or led["drained_x"] != 3.0:
        out.append(f"force drain lost committed mass: {led!r}")
    return out


#: The transport contract.  Each row names the rule, states it, pins the
#: constants that encode it in the real transports, and (where the rule
#: has observable semantics) verifies it executably.
TRANSPORT_SPEC: Tuple[SpecRule, ...] = (
    SpecRule(
        "seqlock-writer-order",
        "whole-slot deposits publish via lock / odd / payload / even / "
        "unlock — the bracket that makes the non-atomic copy safe",
        pins=(Pin(_SHM, "SEQLOCK_WRITER_STEPS",
                  ("acquire_lock", "seq_to_odd", "mutate_payload",
                   "seq_to_even", "release_lock")),),
    ),
    SpecRule(
        "seqlock-reader-order",
        "readers are wait-free: retry-if-odd / copy / retry-if-changed",
        pins=(Pin(_SHM, "SEQLOCK_READER_STEPS",
                  ("read_seq_before_retry_if_odd", "copy_payload",
                   "read_seq_after_retry_if_changed")),),
    ),
    SpecRule(
        "collect-atomicity",
        "collect = read + drain in ONE critical section on every "
        "transport (the push-sum mass-conservation primitive)",
        pins=(Pin(_SHM, "COLLECT_IS_ATOMIC", True),
              Pin(_SHM, "DRAINED_COLLECT_IS_ATOMIC", True),
              Pin(_TCP, "TCP_DRAINED_COLLECT_IS_ATOMIC", True)),
    ),
    SpecRule(
        "chunk-stream-order",
        "chunked deposits bracket each chunk with its own seqlock",
        pins=(Pin(_SHM, "CHUNK_WRITER_STEPS",
                  ("chunk_seq_to_odd", "mutate_chunk", "chunk_seq_to_even")),
              Pin(_SHM, "CHUNK_READER_STEPS",
                  ("read_chunk_seq_before_retry_if_odd", "copy_chunk",
                   "read_chunk_seq_after_retry_if_changed"))),
    ),
    SpecRule(
        "ascending-commit",
        "chunks commit in ascending index order on both chunked "
        "transports (the frontier invariant pipelined consumers rely on)",
        pins=(Pin(_SHM, "CHUNK_COMMIT_IN_ORDER", True),
              Pin(_TCP, "TCP_CHUNK_COMMIT_IN_ORDER", True)),
    ),
    SpecRule(
        "commit-after-payload",
        "version/p advance only after the full payload is written — a "
        "writer that dies mid-deposit committed zero mass",
        pins=(Pin(_SHM, "DEPOSIT_COMMITS_AFTER_PAYLOAD", True),
              Pin(_TCP, "TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD", True)),
        check=_check_dead_writer,
    ),
    SpecRule(
        "dead-writer-drain",
        "the heal-path drain marks drained before tearing down, and "
        "even-izes torn seqlocks first on shm",
        pins=(Pin(_SHM, "DEAD_WRITER_DRAIN_STEPS",
                  ("evenize_chunk_seqs", "mark_drained", "evenize_wseq",
                   "clear_lock")),
              Pin(_TCP, "TCP_DEAD_WRITER_DRAIN_STEPS",
                  ("evenize_wseq", "mark_drained", "clear_stream"))),
        check=_check_drain_orders,
    ),
    SpecRule(
        "barrier-reset-order",
        "sense-reversing barrier: the last arriver resets the arrival "
        "count BEFORE bumping the generation (else: lost wakeup)",
        pins=(Pin(_SHM, "BARRIER_RESET_BEFORE_RELEASE", True),),
    ),
    SpecRule(
        "chunk-geometry-parity",
        "chunk size and pipeline depth agree across chunked transports",
        check=_check_chunk_geometry,
    ),
    SpecRule(
        "resume-idempotence",
        "session resume replays only read-only ops (a replayed deposit "
        "would double-count)",
        check=_check_resume_replay_set,
    ),
    SpecRule(
        "holder-board",
        "the mutex holder word is advisory: stamped after acquire, "
        "cleared conditionally before release, unconditionally on break",
        check=_check_holder_board,
    ),
    SpecRule(
        "mass-ledger-identity",
        "deposits == collected + drained + pending (+ live) at every "
        "observation, in both version counts and mass",
        check=_check_reference_ledger,
    ),
    SpecRule(
        "epoch-quiesce-reseed",
        "retiring an epoch refuses late deliveries and re-seeds every "
        "slot of the next epoch from zero",
        check=_check_epoch_quiesce,
    ),
)


def evaluate_spec(spec: Tuple[SpecRule, ...] = TRANSPORT_SPEC,
                  ) -> Dict[str, List[str]]:
    """Evaluate every spec rule; returns {rule name: problem strings}
    (empty lists for clean rules)."""
    return {rule.name: rule.problems() for rule in spec}


# ---------------------------------------------------------------------------
# the executable reference model
# ---------------------------------------------------------------------------


class _RefSlot:
    __slots__ = ("version", "seen", "x", "p", "drained", "severed")

    def __init__(self) -> None:
        self.version = 0   # committed-deposit count (monotone)
        self.seen = 0      # versions retired by collect/drain
        self.x = 0.0
        self.p = 0.0
        self.drained = 0   # marker: slot reads as zeros iff == version
        self.severed = False  # owner died: slot frozen, mass seized


class ReferenceTransport:
    """Sequential reference implementation of the transport contract.

    One object models one job: ``nranks`` ranks, one mail slot per
    (dst, src) pair per epoch — the same addressing the conformance
    adapters reduce every real transport to.  Payloads are scalars (the
    adapters reduce arrays to a scalar plus a uniformity check).

    Observable surface (what the differential harness compares):

    - ``deposit`` (accumulate) / ``put`` (replace): commit-after-payload
      — in this sequential model a call either fully commits or (writer
      dead / epoch retired) bounces to the refused bucket with ZERO
      observable effect.
    - ``collect``: atomic read+drain; returns ``(x, p, fresh)`` with
      ``fresh`` = number of versions retired (0 on a logically-zero
      slot), exactly :meth:`SimTransport.collect`'s contract.
    - ``read`` / ``version``: non-destructive; a drained slot reads as
      zeros with its version intact (the O(1) marker contract).
    - ``reset`` / ``drain``: wipe without collecting; uncollected
      versions/mass move to the *drained* ledger bin (never vanish).
    - ``epoch_switch``: quiesce + re-seed — live uncollected mass
      retires to the *pending* bin, late deposits into the old epoch are
      refused, the new epoch starts from zero.
    - ``kill``: a dead rank's subsequent deposits bounce (commit-
      after-payload: dying mid-op commits nothing) and its inbound
      slots are severed — uncollected mass moves to the *seized* bin
      and later collects at the corpse read as zeros, matching
      ``SimTransport.kill``'s severing.

    Ledger identity (checked by ``ledger()['balanced']``): committed
    deposits == collected + drained + pending + seized + live, in
    version counts and in mass.
    """

    def __init__(self, nranks: int):
        self.nranks = int(nranks)
        self.epoch = 0
        self._slots: Dict[Tuple[int, int, int], _RefSlot] = {}
        self._retired: set = set()
        self._dead: set = set()
        # ledgers (version counts and mass)
        self.deposits = 0
        self.deposited_x = 0.0
        self.collected = 0
        self.collected_x = 0.0
        self.drained = 0
        self.drained_x = 0.0
        self.pending = 0
        self.pending_x = 0.0
        self.seized = 0
        self.seized_x = 0.0
        self.refused = 0

    # -- helpers -----------------------------------------------------------

    def _slot(self, epoch: int, dst: int, src: int) -> _RefSlot:
        key = (int(epoch), int(dst), int(src))
        s = self._slots.get(key)
        if s is None:
            s = self._slots[key] = _RefSlot()
        return s

    def _live(self, s: _RefSlot) -> bool:
        return s.drained != s.version

    # -- writer side -------------------------------------------------------

    def deposit_at_epoch(self, epoch: int, dst: int, src: int,
                         x: float, p: float) -> None:
        """An accumulate-deposit addressed to an explicit epoch — how the
        harness models a LATE delivery racing an epoch switch."""
        if int(epoch) in self._retired or int(src) in self._dead \
                or int(dst) in self._dead:
            self.refused += 1
            return
        s = self._slot(epoch, dst, src)
        if not self._live(s):
            # accumulate onto a logically-zero slot restarts from zero
            # (the drained-marker contract: degrade to a copy)
            s.x, s.p = float(x), float(p)
        else:
            s.x += float(x)
            s.p += float(p)
        s.version += 1
        self.deposits += 1
        self.deposited_x += float(x)

    def deposit(self, dst: int, src: int, x: float, p: float) -> None:
        self.deposit_at_epoch(self.epoch, dst, src, x, p)

    def put(self, dst: int, src: int, x: float, p: float) -> None:
        """Replace-deposit (win_put): last write wins."""
        if self.epoch in self._retired or int(src) in self._dead \
                or int(dst) in self._dead:
            self.refused += 1
            return
        s = self._slot(self.epoch, dst, src)
        # the mass the put overwrites leaves live circulation via the
        # drained bin (a put over uncollected mass is a deliberate drop);
        # ``seen`` is NOT advanced — the real windows count overwritten
        # versions as fresh at the next collect, so the model must too
        if self._live(s):
            self.drained_x += s.x
        s.x, s.p = float(x), float(p)
        s.version += 1
        s.drained = s.version - 1  # live again
        self.deposits += 1
        self.deposited_x += float(x)

    # -- reader (owner) side ----------------------------------------------

    def collect(self, dst: int, src: int) -> Tuple[float, float, int]:
        s = self._slots.get((self.epoch, int(dst), int(src)))
        if s is None or not self._live(s):
            return 0.0, 0.0, 0
        fresh = s.version - s.seen
        x, p = s.x, s.p
        s.x, s.p = 0.0, 0.0
        s.seen = s.version
        s.drained = s.version
        self.collected += fresh
        self.collected_x += x
        return x, p, fresh

    def read(self, dst: int, src: int) -> Tuple[float, float, int]:
        s = self._slots.get((self.epoch, int(dst), int(src)))
        if s is None:
            return 0.0, 0.0, 0
        if not self._live(s):
            return 0.0, 0.0, s.version
        return s.x, s.p, s.version

    def version(self, dst: int, src: int) -> int:
        s = self._slots.get((self.epoch, int(dst), int(src)))
        return 0 if s is None else s.version

    def reset(self, dst: int, src: int) -> None:
        self.drain(dst, src)

    def drain(self, dst: int, src: int) -> None:
        """force_drain: wipe the slot; uncollected mass is accounted to
        the drained bin (the heal path's conservation obligation)."""
        s = self._slots.get((self.epoch, int(dst), int(src)))
        if s is None:
            return
        if self._live(s):
            self.drained_x += s.x
        self.drained += s.version - s.seen
        s.seen = s.version
        s.x, s.p = 0.0, 0.0
        s.drained = s.version

    # -- epochs + death ----------------------------------------------------

    def epoch_switch(self, new_epoch: int) -> None:
        """Quiesce the current epoch (uncollected mass -> pending bin,
        late deliveries refused from now on) and re-seed the next."""
        for (ep, _dst, _src), s in self._slots.items():
            if ep != self.epoch:
                continue
            if self._live(s):
                self.pending_x += s.x
            self.pending += s.version - s.seen
            s.seen = s.version
            s.x, s.p = 0.0, 0.0
            s.drained = s.version
        self._retired.add(self.epoch)
        self.epoch = int(new_epoch)

    def kill(self, rank: int) -> None:
        """A rank dies: its future deposits bounce, and every inbound
        slot it owned (dst == rank) is severed — uncollected mass moves
        to the *seized* bin (nobody will ever collect it; the heal path
        adopts or writes it off), the version stays visible."""
        g = int(rank)
        self._dead.add(g)
        for (ep, dst, _src), s in self._slots.items():
            if ep != self.epoch or dst != g or s.severed:
                continue
            if self._live(s):
                self.seized_x += s.x
            self.seized += s.version - s.seen
            s.seen = s.version
            s.x, s.p = 0.0, 0.0
            s.drained = s.version
            s.severed = True

    # -- observation -------------------------------------------------------

    def observe(self, dst: int, src: int) -> Tuple[float, float, int]:
        """Canonical observable slot state (what the differential
        harness snapshots): non-destructive read + version."""
        return self.read(dst, src)

    def ledger(self) -> Dict[str, object]:
        live = live_x = 0.0
        for (ep, _d, _s), s in self._slots.items():
            if ep in self._retired:
                continue
            live += s.version - s.seen
            if self._live(s):
                live_x += s.x
        counts_ok = self.deposits == (self.collected + self.drained
                                      + self.pending + self.seized + live)
        mass_ok = abs(self.deposited_x - (self.collected_x + self.drained_x
                                          + self.pending_x + self.seized_x
                                          + live_x)) < 1e-9
        return {
            "deposits": self.deposits,
            "collected": self.collected,
            "drained": self.drained,
            "pending": self.pending,
            "seized": self.seized,
            "live": int(live),
            "refused": self.refused,
            "deposited_x": self.deposited_x,
            "collected_x": self.collected_x,
            "drained_x": self.drained_x,
            "pending_x": self.pending_x,
            "seized_x": self.seized_x,
            "balanced": bool(counts_ok and mass_ok),
        }


# ---------------------------------------------------------------------------
# capability lint
# ---------------------------------------------------------------------------


def declared_transports() -> Dict[str, type]:
    """The registered transport classes, by capability-record name."""
    from bluefog_tpu_torch.native.routed_transport import RoutedWindow
    from bluefog_tpu_torch.native.shm_native import (FallbackShmWindow,
                                               NativeShmWindow)
    from bluefog_tpu_torch.native.tcp_transport import TcpShmWindow
    from bluefog_tpu_torch.sim.transport import SimTransport

    return {
        "shm-native": NativeShmWindow,
        "shm-fallback": FallbackShmWindow,
        "tcp": TcpShmWindow,
        "routed": RoutedWindow,
        "sim": SimTransport,
    }


def check_caps_declared(classes: Optional[Dict[str, type]] = None,
                        ) -> List[str]:
    """Every registered transport carries a well-formed CAPS record whose
    name matches its registration."""
    classes = declared_transports() if classes is None else classes
    out = []
    for name, cls in sorted(classes.items()):
        caps = getattr(cls, "CAPS", None)
        if not isinstance(caps, TransportCaps):
            out.append(f"{cls.__name__} declares no TransportCaps record")
            continue
        if caps.name != name:
            out.append(f"{cls.__name__}.CAPS.name = {caps.name!r}, "
                       f"registered as {name!r}")
        for field in CAP_FIELDS:
            if not isinstance(getattr(caps, field), bool):
                out.append(f"{cls.__name__}.CAPS.{field} is not a bool")
    return out


#: zero-copy collect is a structural property the lint cannot derive from
#: a signature; the expected values are pinned here and cross-checked
#: against the drain-atomicity constants of each module.
_ZERO_COPY_EXPECTED = {
    "shm-native": True,    # O(1) drained marker
    "shm-fallback": False,  # memset drain under lockf
    "tcp": True,           # collect swaps the slot buffer
    "routed": False,       # meet: the fallback leg may be in play
    "sim": True,           # collect IS the drain
}

#: same treatment for chunked streaming: the fallback window carries the
#: chunk *attributes* for interface parity but streams nothing, so a
#: signature probe cannot distinguish the claims — pin them.
_CHUNKED_EXPECTED = {
    "shm-native": True,
    "shm-fallback": False,  # whole-slot lockf writes
    "tcp": True,
    "routed": False,        # meet: the fallback leg may be in play
    "sim": False,           # virtual wire delivers whole payloads
}


def check_caps_honest(classes: Optional[Dict[str, type]] = None,
                      ) -> List[str]:
    """Each capability claim must match the class's actual surface:
    ``fused_scale`` ⇔ ``supports_scale`` + a ``scale`` kwarg on write,
    ``fused_accumulate`` ⇔ an ``accumulate`` kwarg (or an accumulating
    deposit), ``fused_combine`` ⇔ ``combine()``, ``chunked_streaming`` /
    ``wire_quantization`` / ``resume`` ⇔ the protocol constants and
    machinery of the defining module, and the routed record must be the
    meet of its legs."""
    classes = declared_transports() if classes is None else classes
    out = []
    for name, cls in sorted(classes.items()):
        caps = getattr(cls, "CAPS", None)
        if not isinstance(caps, TransportCaps):
            continue  # caps-declared already fires
        mod = inspect.getmodule(cls)
        mod_src = inspect.getsource(mod) if mod else ""
        write = getattr(cls, "write", None)
        if write is not None:
            params = inspect.signature(write).parameters
            has_scale = ("scale" in params
                         and getattr(cls, "supports_scale", False))
            if caps.fused_scale != has_scale:
                out.append(f"{name}: fused_scale={caps.fused_scale} but "
                           f"write scale kwarg/supports_scale say "
                           f"{has_scale}")
            if caps.fused_accumulate != ("accumulate" in params):
                out.append(f"{name}: fused_accumulate claim does not match "
                           "write()'s accumulate kwarg")
        elif caps.fused_scale:
            out.append(f"{name}: fused_scale without a write()")
        if caps.fused_combine != callable(getattr(cls, "combine", None)):
            out.append(f"{name}: fused_combine={caps.fused_combine} but "
                       f"combine() {'exists' if not caps.fused_combine else 'is missing'}")
        expected_chunked = _CHUNKED_EXPECTED.get(name)
        if expected_chunked is not None \
                and caps.chunked_streaming != expected_chunked:
            out.append(f"{name}: chunked_streaming={caps.chunked_streaming},"
                       f" pinned expectation is {expected_chunked}")
        if caps.chunked_streaming and name != "routed" \
                and "CHUNK_COMMIT_IN_ORDER" not in mod_src:
            out.append(f"{name}: claims chunked_streaming but its module "
                       "pins no ascending-commit constant")
        quant = "wire_codec" in getattr(mod, "__dict__", {})
        if name != "routed" and caps.wire_quantization != quant:
            out.append(f"{name}: wire_quantization={caps.wire_quantization} "
                       f"but module {'imports' if quant else 'never imports'}"
                       " wire_codec")
        resume = "_IDEMPOTENT_OPS" in getattr(mod, "__dict__", {})
        if name != "routed" and caps.resume != resume:
            out.append(f"{name}: resume={caps.resume} but module "
                       f"{'has' if resume else 'lacks'} a replay rule set")
        expected_zc = _ZERO_COPY_EXPECTED.get(name)
        if expected_zc is not None and caps.zero_copy_collect != expected_zc:
            out.append(f"{name}: zero_copy_collect={caps.zero_copy_collect},"
                       f" pinned expectation is {expected_zc}")
        if caps.device_resident or caps.in_mesh_collective:
            out.append(f"{name}: claims a future tier capability no "
                       "transport provides yet")
    # composite honesty: routed's static record is the meet of its
    # possible legs (it upgrades per instance, never past its legs)
    routed = classes.get("routed")
    if routed is not None and isinstance(getattr(routed, "CAPS", None),
                                         TransportCaps):
        native = classes["shm-native"].CAPS
        fallback = classes["shm-fallback"].CAPS
        tcp = classes["tcp"].CAPS
        floor = caps_mod.meet(caps_mod.meet(native, fallback, "shm"),
                              tcp, "routed")
        if routed.CAPS != floor:
            out.append("routed CAPS is not the meet of its legs: "
                       f"{routed.CAPS} != {floor}")
    return out


def _read_source(rel: str, root: str = _REPO) -> str:
    with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
        return f.read()


#: every adaptive call site the lint covers: (file, what must hold).
#: Each entry is (relative path, [(description, predicate over source)]).
def _call_site_checks() -> List[Tuple[str, str, Callable[[str], bool]]]:
    probe = re.compile(r"getattr\([^)]*[\"']supports_scale[\"']")
    dual = re.compile(r"getattr\([^)]*[\"']put_dual[\"']")
    fused = re.compile(r"getattr\([^)]*[\"']update_fused[\"']")
    fuse_gate = re.compile(r"getattr\([^)]*[\"']fuse[\"']")
    classes = re.compile(
        r"\b(NativeShmWindow|TcpShmWindow|FallbackShmWindow|RoutedWindow)\b")
    return [
        ("bluefog_tpu_torch/islands.py",
         "scaled deposits gate on the supports_scale capability probe",
         lambda s: bool(probe.search(s))),
        ("bluefog_tpu_torch/islands.py",
         "dual-publish deposits probe put_dual, never assume it",
         lambda s: bool(dual.search(s))),
        ("bluefog_tpu_torch/islands.py",
         "fused read sweeps probe update_fused, never assume it",
         lambda s: bool(fused.search(s))),
        ("bluefog_tpu_torch/islands.py",
         "no transport-class identity checks (capabilities only)",
         lambda s: not classes.search(s)),
        ("bluefog_tpu_torch/progress/engine.py",
         "accumulate fusion gates on the backend's declared fuse hook",
         lambda s: bool(fuse_gate.search(s))),
        ("bluefog_tpu_torch/progress/engine.py",
         "no transport-class identity checks (capabilities only)",
         lambda s: not classes.search(s)),
        ("bluefog_tpu_torch/native/wire_codec.py",
         "wire-dtype selection reads BFTPU_WIRE_DTYPE here and only here",
         lambda s: "BFTPU_WIRE_DTYPE" in s),
        ("bluefog_tpu_torch/native/routed_transport.py",
         "tier selection routes purely by host equality (_same_host)",
         lambda s: "_same_host" in s and not re.search(
             r"isinstance\([^)]*(Native|Tcp|Fallback)", s)),
    ]


def check_caps_call_sites(root: Optional[str] = None) -> List[str]:
    """Static pass over every adaptive call site: engine fusion, islands'
    scaled/fused deposits, wire-dtype selection, resume, and routed tier
    selection must rely only on declared capabilities.  ``root`` is the
    checkout whose ``bluefog_tpu_torch/`` sources are read (default: this
    one)."""
    root = _REPO if root is None else root
    out = []
    for rel, desc, pred in _call_site_checks():
        try:
            src = _read_source(rel, root)
        except OSError as exc:
            out.append(f"{rel}: unreadable ({exc})")
            continue
        if not pred(src):
            out.append(f"{rel}: {desc} — violated")
    # the wire-dtype env knob must have exactly one runtime reader
    # (wire_codec); any other runtime module reading it bypasses the
    # wire_quantization capability
    for sub in ("bluefog_tpu_torch/native", "bluefog_tpu_torch/progress"):
        for dirpath, _dirs, files in os.walk(os.path.join(root, sub)):
            for fn in files:
                if not fn.endswith(".py") or fn == "wire_codec.py":
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                src = _read_source(rel, root)
                if re.search(r"environ[^\n]*BFTPU_WIRE_DTYPE", src):
                    out.append(f"{rel}: reads BFTPU_WIRE_DTYPE directly "
                               "(only wire_codec may)")
    # resume machinery stays inside the transport that declares it
    for rel in ("bluefog_tpu_torch/islands.py", "bluefog_tpu_torch/progress/engine.py"):
        if "_IDEMPOTENT_OPS" in _read_source(rel, root):
            out.append(f"{rel}: touches the TCP replay rule set directly")
    return out


# ---------------------------------------------------------------------------
# registered rules
# ---------------------------------------------------------------------------


def _spec_rule_runner(report) -> None:
    for rule in TRANSPORT_SPEC:
        report.subjects_checked += 1
        for problem in rule.problems():
            report.add(Finding("transport.spec", f"spec:{rule.name}",
                               problem))
    report.metric("transport.spec_rules", float(len(TRANSPORT_SPEC)))


registry.register(  # direct registration keeps the callable reusable
    __import__("bluefog_tpu_torch.analysis.engine",
               fromlist=["Rule"]).Rule(
        name="transport.spec",
        family="transport",
        doc="every rule of the window/mailbox contract holds: pinned "
            "constants unchanged, executable semantics verified",
        run=_spec_rule_runner,
    ))


@registry.rule("transport.caps-declared", "transport",
               "every registered transport declares a TransportCaps record")
def _rule_caps_declared(report) -> None:
    classes = declared_transports()
    report.subjects_checked += len(classes)
    for problem in check_caps_declared(classes):
        report.add(Finding("transport.caps-declared", "capability records",
                           problem))


@registry.rule("transport.caps-honest", "transport",
               "capability claims match each transport's actual surface; "
               "routed == meet of its legs")
def _rule_caps_honest(report) -> None:
    classes = declared_transports()
    report.subjects_checked += len(classes) * len(CAP_FIELDS)
    for problem in check_caps_honest(classes):
        report.add(Finding("transport.caps-honest", "capability records",
                           problem))


@registry.rule("transport.caps-call-sites", "transport",
               "engine fusion / scaled deposits / wire dtype / resume / "
               "routing branch only on declared capabilities")
def _rule_caps_call_sites(report) -> None:
    report.subjects_checked += len(_call_site_checks())
    for problem in check_caps_call_sites():
        report.add(Finding("transport.caps-call-sites", "call sites",
                           problem))
