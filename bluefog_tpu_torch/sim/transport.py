"""In-memory mailbox/window transport + membership board for the sim.

``SimTransport`` implements the contract the island runtime's windows
speak — **deposit** (writer-side, commit-on-delivery), **collect**
(reader-side drain), monotone **versions**, per-rank **liveness
words**, a **mutex** with holder attribution, and the **membership
board** — against plain dicts, with an event-queue scheduler standing
in for the wire.  The protocol state machines layered on top
(``FailureDetector``, ``EdgeHealth``, ``AdaptivePolicy``,
``MembershipBoard.grant``/``commit_reweight``, the healing planners)
are the REAL ones, imported from their production modules.

Two ledgers are kept, mirroring the telemetry mass-ledger semantics
(docs/OBSERVABILITY.md):

- **counts** per global rank: ``deposits`` (writer-side, one per
  committed version), ``collected``/``drained``/``pending``
  (reader-side retirement).  Settlement mirrors ``islands.heal``:
  survivors ADOPT a corpse's writer-side version counts on their own
  in-slots and WRITE OFF their own committed deposits to the corpse
  as pending; a dead/fenced rank's own counters are excluded from the
  merged balance exactly like a corpse that never wrote a snapshot.

- **mass** (the push-sum ``x`` and ``p`` floats): every unit lives in
  exactly one of {a live rank, a slot, an in-flight message, the
  ``lost`` bucket}, and every transfer between buckets happens inside
  one event — so ``live + slots + inflight + lost == initial +
  joined`` holds after EVERY event, which is the invariant the
  campaign checker audits continuously.

Fault surface: ``kill`` (mass seized, in-slots severed, messages drop
on dead in both directions), suspension and slow-down are driven by
the fleet (they are scheduling phenomena, not transport state).
"""

from __future__ import annotations

import json
import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple

from bluefog_tpu_torch.native import capabilities as _caps
from bluefog_tpu_torch.resilience.join import MembershipBoard
from bluefog_tpu_torch.sim.clock import Clock, resolve_clock
from bluefog_tpu_torch.sim.events import EventLoop

__all__ = ["SimTransport", "SimBoard", "SimJobView", "Slot"]


class Slot:
    """One (epoch, dst, src) mail slot: a monotone version counter and
    the accumulated (x, p) payload awaiting collect."""

    __slots__ = ("version", "seen", "x", "p", "adopted", "severed")

    def __init__(self):
        self.version = 0   # monotone committed-deposit count
        self.seen = 0      # versions the collector has retired
        self.x = 0.0
        self.p = 0.0
        self.adopted = False
        self.severed = False


class SimJobView:
    """The duck-typed job transport one rank's ``FailureDetector``
    sees: ``heartbeat()`` stamps MY liveness word, ``liveness(local)``
    reads a peer's, with local ranks resolved through this epoch's
    member list — the same global/local split the real epoch-suffixed
    job segments give the detector."""

    def __init__(self, transport: "SimTransport",
                 members: Tuple[int, ...], my_global: int):
        self._t = transport
        self._members = tuple(int(m) for m in members)
        self._g = int(my_global)

    def heartbeat(self) -> None:
        self._t.beat(self._g)

    def liveness(self, rank: int) -> float:
        # partition-aware: across an active cut the reader keeps
        # seeing the stamp frozen at the cut, so its detector times
        # the far side out exactly like a crash
        return self._t.liveness_seen(self._g, self._members[int(rank)])


class SimTransport:
    """See module docstring."""

    CAPS = _caps.TransportCaps(
        name="sim",
        fused_accumulate=True,   # deposit folds (x, p) into the slot
        fused_scale=False,       # campaigns pre-weight their deposits
        fused_combine=False,     # collect returns scalars; nothing to fuse
        zero_copy_collect=True,  # collect IS the atomic drain, no copy
        chunked_streaming=False,  # virtual wire delivers whole payloads
        wire_quantization=False,
        resume=False,            # a severed sim edge stays severed
    )

    def __init__(self, loop: EventLoop, clock: Clock):
        self.loop = loop
        self.clock = clock
        # liveness words: global rank -> last heartbeat stamp
        self._liveness: Dict[int, float] = {}
        # mail slots: (epoch, dst_g, src_g) -> Slot
        self._slots: Dict[Tuple[int, int, int], Slot] = {}
        # writer-side committed-deposit counts: (epoch, src_g, dst_g) -> n
        self._deposited_to: Dict[Tuple[int, int, int], int] = {}
        # in-flight messages: msg id -> (x, p) for exact mass accounting
        self._inflight: Dict[int, Tuple[float, float]] = {}
        self._next_msg = 0
        # epochs a collector has retired: late deliveries bounce
        self._retired: Set[Tuple[int, int]] = set()
        self.killed: Set[int] = set()
        # ranks whose ledgers were adopted by survivors (corpses and
        # fenced zombies) — excluded from the merged count balance
        self.adopted_ranks: Set[int] = set()
        # the 8-byte membership-epoch word (SimBoard publishes here)
        self.epoch_word = 0
        # cheap join-request flag: SimBoard._publish keeps it current
        # so sponsors don't JSON-parse the whole board every round
        self.join_pending = False
        # count ledgers, per global rank
        self.deposits: Dict[int, int] = {}
        self.collected: Dict[int, int] = {}
        self.drained: Dict[int, int] = {}
        self.pending: Dict[int, int] = {}
        # mass buckets
        self.lost_x = 0.0
        self.lost_p = 0.0
        # mutexes: key -> (holder, acquired_at)
        self._mutex: Dict[object, Tuple[object, float]] = {}
        # network partition: global rank -> group id while a cut is
        # active (None = fully connected).  Liveness words and the
        # epoch word freeze ACROSS the cut (the snapshots below are
        # what the far side keeps reading), and cross-group deliveries
        # drop to the lost bucket — a partition severs traffic, it
        # does not destroy state.
        self._partition_groups: Optional[Dict[int, int]] = None
        self._board_group = 0
        self._frozen_liveness: Dict[int, float] = {}
        self._frozen_epoch_word = 0

    # -- network partition -------------------------------------------------

    def set_partition(self, groups: Dict[int, int],
                      board_group: int) -> None:
        """Cut the network along ``groups`` (a COMPLETE global-rank ->
        group-id map; unknown ranks — e.g. a joiner spawned mid-cut —
        land with the board).  ``board_group`` names the side the
        membership board lives on: everyone else sees the epoch word
        frozen and their board ops stall, exactly like an unreachable
        filesystem."""
        self._partition_groups = {int(g): int(i)
                                  for g, i in groups.items()}
        self._board_group = int(board_group)
        self._frozen_liveness = dict(self._liveness)
        self._frozen_epoch_word = self.epoch_word

    def clear_partition(self) -> None:
        self._partition_groups = None
        self._frozen_liveness = {}

    @property
    def partitioned(self) -> bool:
        return self._partition_groups is not None

    def _group_of(self, g: int) -> int:
        assert self._partition_groups is not None
        return self._partition_groups.get(int(g), self._board_group)

    def _crosses(self, a: int, b: int) -> bool:
        return (self._partition_groups is not None
                and self._group_of(a) != self._group_of(b))

    def liveness_seen(self, reader: int, g: int) -> float:
        """The liveness stamp ``reader`` observes for ``g``: the live
        word, unless a partition separates them — then the stamp frozen
        at the cut (the far side looks like it stopped beating)."""
        if self._crosses(reader, g):
            return self._frozen_liveness.get(int(g), 0.0)
        return self.liveness(g)

    def epoch_word_seen(self, reader: int) -> int:
        """The membership-epoch word ``reader`` observes: frozen at the
        cut for ranks partitioned away from the board."""
        if (self._partition_groups is not None
                and self._group_of(reader) != self._board_group):
            return self._frozen_epoch_word
        return self.epoch_word

    def board_reachable(self, g: int) -> bool:
        return (self._partition_groups is None
                or self._group_of(g) == self._board_group)

    # -- liveness words ----------------------------------------------------

    def beat(self, g: int) -> None:
        if g not in self.killed:
            self._liveness[int(g)] = self.clock.now()

    def liveness(self, g: int) -> float:
        return self._liveness.get(int(g), 0.0)

    def job_view(self, members, my_global: int) -> SimJobView:
        return SimJobView(self, members, my_global)

    # -- mailbox -----------------------------------------------------------

    def _slot(self, epoch: int, dst: int, src: int) -> Slot:
        key = (int(epoch), int(dst), int(src))
        s = self._slots.get(key)
        if s is None:
            s = self._slots[key] = Slot()
        return s

    def deposit(self, epoch: int, src: int, dst: int, x: float, p: float,
                latency_s: float) -> None:
        """Writer-side deposit: the payload rides the (virtual) wire
        for ``latency_s`` and COMMITS at delivery — a writer that dies
        in flight committed zero mass (drop-on-dead), mirroring
        DEPOSIT_COMMITS_AFTER_PAYLOAD."""
        self._next_msg += 1
        mid = self._next_msg
        self._inflight[mid] = (float(x), float(p))
        ep, s_, d_ = int(epoch), int(src), int(dst)

        def _deliver():
            mx, mp = self._inflight.pop(mid)
            if (s_ in self.killed or d_ in self.killed
                    or (ep, d_) in self._retired
                    # a delivery caught crossing an active cut drops —
                    # the mass leaves live circulation (lost bucket),
                    # never silently evaporates
                    or self._crosses(s_, d_)):
                self.lost_x += mx
                self.lost_p += mp
                return
            slot = self._slot(ep, d_, s_)
            if slot.severed:
                self.lost_x += mx
                self.lost_p += mp
                return
            slot.version += 1
            slot.x += mx
            slot.p += mp
            self.deposits[s_] = self.deposits.get(s_, 0) + 1
            k = (ep, s_, d_)
            self._deposited_to[k] = self._deposited_to.get(k, 0) + 1

        self.loop.after(latency_s, _deliver)

    def collect(self, epoch: int, dst: int, src: int
                ) -> Tuple[float, float, int]:
        """Reader-side drain: returns the accumulated (x, p) and the
        number of fresh versions retired (0 when the slot is empty)."""
        slot = self._slots.get((int(epoch), int(dst), int(src)))
        if slot is None or slot.severed:
            return 0.0, 0.0, 0
        fresh = slot.version - slot.seen
        if fresh <= 0:
            return 0.0, 0.0, 0
        x, p = slot.x, slot.p
        slot.x = 0.0
        slot.p = 0.0
        slot.seen = slot.version
        self.collected[int(dst)] = self.collected.get(int(dst), 0) + fresh
        return x, p, fresh

    def read_version(self, epoch: int, dst: int, src: int) -> int:
        slot = self._slots.get((int(epoch), int(dst), int(src)))
        return 0 if slot is None else slot.version

    # -- fault + settlement surface ---------------------------------------

    def kill(self, g: int) -> Tuple[float, float]:
        """Mark ``g`` dead: its liveness word freezes, every message
        to/from it drops from now on, and its in-slots are severed
        (their uncollected mass leaves live circulation).  Returns the
        slot mass seized so the fleet can move the rank's own exposed
        mass to ``lost`` in the same event."""
        g = int(g)
        self.killed.add(g)
        self.adopted_ranks.add(g)
        seized_x = seized_p = 0.0
        for key, slot in self._slots.items():
            ep, dst, src = key
            if dst == g:
                if not slot.severed:
                    seized_x += slot.x
                    seized_p += slot.p
                    slot.x = 0.0
                    slot.p = 0.0
                    slot.severed = True
        self.lost_x += seized_x
        self.lost_p += seized_p
        return seized_x, seized_p

    def heal_settle(self, survivor: int, dead: int, epoch: int) -> dict:
        """One survivor's ledger settlement for one corpse, mirroring
        ``islands.heal``: ADOPT the corpse's writer-side version counts
        on my in-slots (the monotone version IS that count), force-DRAIN
        whatever the slots still hold, and WRITE OFF my own committed
        deposits to the corpse (every epoch — the corpse retires
        nothing ever again) as pending.

        Adoption spans EVERY epoch of the (survivor, corpse) pair, not
        just the current one: a corpse declared dead after an epoch
        switch (a suspend-zombie that slept through a join) committed
        its last deposits under the OLD epoch, and those versions were
        already collected/retired by the survivor — skipping them would
        leave the merged ledger short exactly that count once the
        corpse's own counters are excluded from the merge."""
        sg, dg = int(survivor), int(dead)
        self.adopted_ranks.add(dg)
        out = {"adopted": 0, "drained": 0, "written_off": 0}
        for key, slot in self._slots.items():
            if key[1] != sg or key[2] != dg:
                continue
            if slot.adopted:
                continue
            slot.adopted = True
            out["adopted"] += slot.version
            self.deposits[sg] = self.deposits.get(sg, 0) + slot.version
            stale = slot.version - slot.seen
            if stale > 0:
                out["drained"] += stale
                self.drained[sg] = self.drained.get(sg, 0) + stale
                slot.seen = slot.version
            self.lost_x += slot.x
            self.lost_p += slot.p
            slot.x = 0.0
            slot.p = 0.0
            slot.severed = True
        written = 0
        for key in [k for k in self._deposited_to
                    if k[1] == sg and k[2] == dg]:
            written += self._deposited_to.pop(key)
        if written:
            out["written_off"] = written
            self.pending[sg] = self.pending.get(sg, 0) + written
        return out

    def retire_epoch(self, g: int, epoch: int, in_srcs) -> Tuple[int, float]:
        """Collector-side epoch retirement at a switch: probe every
        in-slot's uncollected versions as pending (they cross the
        switch as ledger pending, never combined — their mass leaves
        live circulation), then refuse late deliveries."""
        g, epoch = int(g), int(epoch)
        pend = 0
        mass_x = 0.0
        for src in sorted(int(s) for s in in_srcs):
            slot = self._slots.get((epoch, g, src))
            if slot is None or slot.severed:
                continue
            stale = slot.version - slot.seen
            if stale > 0:
                pend += stale
                slot.seen = slot.version
            mass_x += slot.x
            self.lost_x += slot.x
            self.lost_p += slot.p
            slot.x = 0.0
            slot.p = 0.0
            slot.severed = True
        if pend:
            self.pending[g] = self.pending.get(g, 0) + pend
        self._retired.add((epoch, g))
        return pend, mass_x

    def probe_pending(self, g: int, epoch: int, in_srcs) -> int:
        """Shutdown-style pending probe (no sever): retire whatever
        each in-slot still holds as pending — the quiesce-time
        settlement that closes the count ledger."""
        g, epoch = int(g), int(epoch)
        pend = 0
        for src in sorted(int(s) for s in in_srcs):
            slot = self._slots.get((epoch, g, src))
            if slot is None or slot.severed:
                continue
            stale = slot.version - slot.seen
            if stale > 0:
                pend += stale
                slot.seen = slot.version
        if pend:
            self.pending[g] = self.pending.get(g, 0) + pend
        return pend

    # -- aggregate views for the invariant checkers ------------------------

    def slot_mass(self) -> Tuple[float, float]:
        # fsum is exact, so the sum is order-independent — no need to
        # sort for determinism (this runs after every event)
        x = math.fsum(s.x for s in self._slots.values())
        p = math.fsum(s.p for s in self._slots.values())
        return x, p

    def inflight_mass(self) -> Tuple[float, float]:
        x = math.fsum(v[0] for v in self._inflight.values())
        p = math.fsum(v[1] for v in self._inflight.values())
        return x, p

    def outstanding_slot_mass(self) -> float:
        """Uncollected slot x — diagnostic only."""
        return self.slot_mass()[0]

    def ledger(self, include=None) -> dict:
        """The merged count ledger over ``include`` ranks (default:
        every rank except the adopted/killed, mirroring which ranks
        write snapshots), in ``telemetry.merge.ledger_balance`` shape."""
        if include is None:
            ranks = (set(self.deposits) | set(self.collected)
                     | set(self.drained) | set(self.pending))
            include = ranks - self.adopted_ranks
        inc = {int(r) for r in include}
        dep = sum(self.deposits.get(r, 0) for r in inc)
        col = sum(self.collected.get(r, 0) for r in inc)
        dra = sum(self.drained.get(r, 0) for r in inc)
        pen = sum(self.pending.get(r, 0) for r in inc)
        return {"deposits": dep, "collected": col, "drained": dra,
                "pending": pen,
                "balanced": dep == col + dra + pen}

    # -- mutex (holder-attributed, virtual-clock timed) --------------------

    def mutex_acquire(self, key, holder, timeout_s: float = 5.0,
                      poll_s: float = 0.001) -> bool:
        """Acquire the named mutex, spinning on the virtual clock (the
        re-entrant sleep lets the current holder's release event fire
        mid-acquire, exactly like a blocked thread would observe)."""
        deadline = self.clock.deadline(timeout_s)
        while True:
            cur = self._mutex.get(key)
            if cur is None:
                self._mutex[key] = (holder, self.clock.now())
                return True
            if self.clock.expired(deadline):
                return False
            self.clock.sleep(poll_s)

    def mutex_release(self, key, holder) -> None:
        cur = self._mutex.get(key)
        if cur is not None and cur[0] == holder:
            del self._mutex[key]

    def mutex_holder(self, key):
        cur = self._mutex.get(key)
        return None if cur is None else cur[0]


class SimBoard(MembershipBoard):
    """The membership board against an in-memory document.

    Only the I/O seam is overridden — ``read``/``_publish`` go through
    a JSON round-trip (same torn-write-free semantics as the atomic
    rename, plus a free serializability check), the lock is a no-op
    (single-threaded event loop), request ids are deterministic, and
    the epoch word publishes into the :class:`SimTransport`.  The
    protocol methods — ``ensure``, ``grant`` (grow_topology + monotone
    next_rank + first-wins idempotence), ``commit_reweight``,
    ``wait_for_grant`` (on the virtual clock) — run UNCHANGED from
    :class:`~bluefog_tpu_torch.resilience.join.MembershipBoard`.
    """

    def __init__(self, job: str, transport: SimTransport,
                 clock: Optional[Clock] = None):
        self.job = job
        self._clock = resolve_clock(
            transport.clock if clock is None else clock)
        self._transport = transport
        self._doc: Optional[str] = None  # serialized, like the file
        self._req_seq = 0

    def read(self) -> Optional[dict]:
        return None if self._doc is None else json.loads(self._doc)

    def _publish(self, doc: dict) -> None:
        self._doc = json.dumps(doc)
        self._transport.join_pending = bool(doc.get("requests"))

    def _locked(self):
        @contextmanager
        def cm():
            yield

        return cm()

    def _publish_epoch_word(self, epoch: int) -> None:
        self._transport.epoch_word = int(epoch)

    def post_request(self, retiring: int = -1) -> str:
        """Deterministic request ids (the real board's
        hostname-pid-uuid ids would break bit-identical replay)."""
        self._req_seq += 1
        req_id = f"sim-join-{self._req_seq}"
        with self._locked():
            doc = self.read()
            if doc is None:
                raise RuntimeError(
                    f"no membership board for job {self.job!r} — is the "
                    "fleet initialized (SimFleet publishes the board)?")
            req = {"req": req_id, "pid": self._req_seq,
                   "host": "sim", "t": self._clock.now()}
            if int(retiring) >= 0:
                req["retiring"] = int(retiring)
            doc["requests"].append(req)
            self._publish(doc)
        return req_id
