"""Generative conformance harness: every transport vs the reference model.

``transport_spec.ReferenceTransport`` states what a window transport must
*do*; this module checks the real ones actually do it.  Every registered
transport — native shm, fallback shm, chunked TCP, the legacy
whole-payload TCP arm, and ``SimTransport`` — is wrapped in a small
adapter exposing one op vocabulary (deposit / put / collect / read /
version / drain / reset / epoch-switch / kill), then driven through the
same randomized-but-seeded op schedules as the reference model, with the
observable state (op results + every slot's version) differentially
compared after **every op**.  A divergence is shrunk with the same ddmin
the sim campaigns use (``sim/campaign.shrink_schedule``'s algorithm) to a
1-minimal repro schedule before it is reported.

Vocabulary boundaries (each op runs on every arm that can represent it):

- core (all five transports + reference): deposit / collect / version;
- window (shm native, shm fallback, both TCP arms + reference): adds
  put / read / drain / reset — sim's mailbox has no replace or
  owner-side drain op;
- epoch/death (sim + reference): adds epoch-switch (quiesce + re-seed,
  mapped to ``SimTransport.retire_epoch`` per owner) and mid-schedule
  writer death (``kill``) — real windows have no epochs (the islands
  layer re-creates segments per epoch) and live death is exercised by
  the np=2 chaos e2e in ``tests/test_conformance.py``.

The TCP arms run two REAL ranks of one job in-process (the runtime is
keyed by ``(job, rank)``), so deposits genuinely cross the loopback wire
— chunked arm with a 2-chunk geometry, legacy arm with
``BFTPU_TCP_CHUNKED=0``.

Registered family: ``conformance``.  Runtime: the shm rules are
milliseconds; the TCP rule pays two runtime handshakes (~1 s).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.analysis.engine import Finding, Severity, registry
from bluefog_tpu_torch.analysis.transport_spec import ReferenceTransport

__all__ = [
    "gen_schedule",
    "run_schedule",
    "shrink_ops",
    "differential",
    "ARM_FACTORIES",
    "CORE_ARMS",
    "WINDOW_ARMS",
    "FAMILY_MAP",
    "families_for_paths",
    "selftest_conformance",
]

_NRANKS = 2
_SHAPE = (4,)
_DTYPE = np.float32
_PAIRS = tuple((d, s) for d in range(_NRANKS) for s in range(_NRANKS))

_job_counter = [0]


def _fresh_job(tag: str) -> str:
    _job_counter[0] += 1
    return f"conf_{tag}_{os.getpid()}_{_job_counter[0]}"


# ---------------------------------------------------------------------------
# op schedules
# ---------------------------------------------------------------------------


def gen_schedule(seed: int, nops: int, *, puts: bool = False,
                 drains: bool = False, epochs: bool = False,
                 kills: bool = False) -> List[Tuple]:
    """One seeded op schedule over the 2-rank job.  ``puts``/``drains``
    add the window-only vocabulary; ``epochs``/``kills`` the sim-side
    one.  Deterministic in ``seed``; payload values are small integers
    (exact in f32 and f64, so cross-precision comparison is bitwise)."""
    rng = random.Random(seed)
    ops: List[Tuple] = []
    killed = False
    for _ in range(nops):
        d, s = rng.randrange(_NRANKS), rng.randrange(_NRANKS)
        x = float(rng.randint(1, 9))
        p = rng.choice((0.5, 1.0, 1.5))
        r = rng.random()
        if epochs and r < 0.08:
            ops.append(("epoch",))
        elif kills and not killed and r < 0.14:
            ops.append(("kill", rng.randrange(_NRANKS)))
            killed = True
        elif r < 0.48:
            ops.append(("deposit", d, s, x, p))
        elif puts and r < 0.58:
            ops.append(("put", d, s, x, p))
        elif drains and r < 0.66:
            ops.append((rng.choice(("drain", "reset")), d, s))
        elif r < 0.86:
            ops.append(("collect", d, s))
        elif puts and r < 0.93:
            ops.append(("read", d, s))
        else:
            ops.append(("version", d, s))
    return ops


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------


class RefAdapter:
    """The reference model behind the common adapter surface."""

    name = "reference"

    def __init__(self) -> None:
        self.ref = ReferenceTransport(_NRANKS)

    def apply(self, op: Tuple):
        kind = op[0]
        if kind == "deposit":
            _, d, s, x, p = op
            self.ref.deposit(d, s, x, p)
            return None
        if kind == "put":
            _, d, s, x, p = op
            self.ref.put(d, s, x, p)
            return None
        if kind == "collect":
            return ("collect",) + self.ref.collect(op[1], op[2])
        if kind == "read":
            return ("read",) + self.ref.read(op[1], op[2])
        if kind == "version":
            return ("version", self.ref.version(op[1], op[2]))
        if kind in ("drain", "reset"):
            self.ref.drain(op[1], op[2])
            return None
        if kind == "epoch":
            self.ref.epoch_switch(self.ref.epoch + 1)
            return None
        if kind == "kill":
            self.ref.kill(op[1])
            return None
        raise ValueError(f"unknown op {op!r}")

    def snapshot(self) -> Tuple:
        return tuple(self.ref.version(d, s) for d, s in _PAIRS)

    def ledger(self) -> Optional[dict]:
        return self.ref.ledger()

    def close(self) -> None:
        pass


class SimAdapter:
    """``SimTransport`` on a virtual event loop; deliveries settle
    (zero latency, drained queue) before any observation — the harness
    checks the *quiescent-state* contract, the sim's own invariant rules
    cover in-flight accounting."""

    name = "sim"

    def __init__(self) -> None:
        from bluefog_tpu_torch.sim.events import EventLoop, VirtualClock
        from bluefog_tpu_torch.sim.transport import SimTransport

        self.loop = EventLoop()
        self.t = SimTransport(self.loop, VirtualClock(self.loop))
        self.epoch = 0

    def _settle(self) -> None:
        self.loop.run_until(self.loop.now)

    def apply(self, op: Tuple):
        kind = op[0]
        if kind == "deposit":
            _, d, s, x, p = op
            self.t.deposit(self.epoch, s, d, x, p, 0.0)
            self._settle()
            return None
        if kind == "collect":
            return ("collect",) + self.t.collect(self.epoch, op[1], op[2])
        if kind == "version":
            return ("version",
                    self.t.read_version(self.epoch, op[1], op[2]))
        if kind == "epoch":
            for dst in range(_NRANKS):
                self.t.retire_epoch(dst, self.epoch, range(_NRANKS))
            self.epoch += 1
            return None
        if kind == "kill":
            self.t.kill(op[1])
            return None
        raise ValueError(f"sim arm cannot represent {op!r}")

    def snapshot(self) -> Tuple:
        return tuple(self.t.read_version(self.epoch, d, s)
                     for d, s in _PAIRS)

    def ledger(self) -> Optional[dict]:
        led = self.t.ledger(include=range(_NRANKS))
        return {"deposits": led["deposits"], "collected": led["collected"],
                "pending": led["pending"], "balanced": led["balanced"]}

    def close(self) -> None:
        pass


class _WindowAdapter:
    """Common harness for the window transports: one window object per
    rank of a 2-rank job, mail slot index == writer rank (maxd = 2), and
    per-slot ``seen`` counters turning raw versions into the fresh-count
    contract ``collect`` promises."""

    def __init__(self) -> None:
        self.wins = self._make_windows()  # rank -> window
        self.seen: Dict[Tuple[int, int], int] = {p: 0 for p in _PAIRS}

    # subclasses provide the windows and may wrap writes (env scoping)
    def _make_windows(self):
        raise NotImplementedError

    def _write(self, src: int, dst: int, array, p: float,
               accumulate: bool) -> None:
        self.wins[src].write(dst, slot=src, array=array, p=p,
                             accumulate=accumulate)

    @staticmethod
    def _scalar(a: np.ndarray):
        flat = np.asarray(a).reshape(-1)
        if flat.size and not np.all(flat == flat[0]):
            return ("TORN", tuple(float(v) for v in flat))
        return float(flat[0]) if flat.size else 0.0

    def apply(self, op: Tuple):
        kind = op[0]
        if kind in ("deposit", "put"):
            _, d, s, x, p = op
            arr = np.full(_SHAPE, x, _DTYPE)
            self._write(s, d, arr, p, accumulate=(kind == "deposit"))
            return None
        if kind == "collect":
            _, d, s = op
            a, p, ver = self.wins[d].read(s, collect=True, src=s)
            fresh = ver - self.seen[(d, s)]
            self.seen[(d, s)] = ver
            x = self._scalar(a)
            if fresh <= 0 or p == 0.0:
                # logically-zero slot: the window reports its version,
                # the fresh-count contract reports nothing retired
                return ("collect", 0.0, 0.0, 0)
            return ("collect", x, float(p), int(fresh))
        if kind == "read":
            _, d, s = op
            a, p, ver = self.wins[d].read(s, collect=False, src=s)
            return ("read", self._scalar(a), float(p), int(ver))
        if kind == "version":
            _, d, s = op
            return ("version", int(self.wins[d].read_version(s, src=s)))
        if kind in ("drain", "reset"):
            _, d, s = op
            if kind == "drain":
                self.wins[d].force_drain(s, src=s)
            else:
                self.wins[d].reset(s, src=s)
            # the drain retires the slot's uncollected versions
            self.seen[(d, s)] = int(self.wins[d].read_version(s, src=s))
            return None
        raise ValueError(f"window arm cannot represent {op!r}")

    def snapshot(self) -> Tuple:
        return tuple(int(self.wins[d].read_version(s, src=s))
                     for d, s in _PAIRS)

    def ledger(self) -> Optional[dict]:
        return None

    def close(self) -> None:
        for rank in sorted(self.wins, reverse=True):
            try:
                self.wins[rank].close(unlink=(rank == 0))
            except Exception:
                pass


class NativeShmAdapter(_WindowAdapter):
    name = "shm-native"

    def _make_windows(self):
        from bluefog_tpu_torch.native.shm_native import NativeShmWindow

        job = _fresh_job("shm")
        # chunk=8 bytes -> the 16-byte payload streams as 2 chunks, so
        # the chunk ring genuinely runs even at this tiny size
        return {r: NativeShmWindow(job, "conf", r, _NRANKS, _NRANKS,
                                   _SHAPE, _DTYPE, chunk=8)
                for r in range(_NRANKS)}


class FallbackShmAdapter(_WindowAdapter):
    name = "shm-fallback"

    def _make_windows(self):
        from bluefog_tpu_torch.native.shm_native import FallbackShmWindow

        job = _fresh_job("fb")
        return {r: FallbackShmWindow(job, "conf", r, _NRANKS, _NRANKS,
                                     _SHAPE, _DTYPE)
                for r in range(_NRANKS)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TcpAdapter(_WindowAdapter):
    """Two real TCP ranks in one process (runtime keyed by (job, rank));
    rank 0 hosts the coordinator, deposits cross the loopback wire.
    ``chunked=False`` pins the legacy whole-payload ``_OP_WRITE`` arm."""

    def __init__(self, chunked: bool = True):
        self.chunked = chunked
        self.name = "tcp-chunked" if chunked else "tcp-legacy"
        super().__init__()

    def _make_windows(self):
        from bluefog_tpu_torch.native import tcp_transport as tt

        self._tt = tt
        self.job = _fresh_job("tcp")
        coord = f"127.0.0.1:{_free_port()}"
        built: Dict[int, object] = {}
        errors: List[BaseException] = []

        def _build(rank: int) -> None:
            try:
                # construct OUTSIDE the class lock: both ranks' runtimes
                # must come up concurrently (registration blocks on the
                # full table), then publish under the lock
                rt = tt._JobRuntime(self.job, rank, _NRANKS, coord)
                with tt._JobRuntime._cls_lock:
                    tt._JobRuntime._by_key[(self.job, rank)] = rt
                built[rank] = rt
            except BaseException as exc:  # surfaced to the caller
                errors.append(exc)

        threads = [threading.Thread(target=_build, args=(r,), daemon=True)
                   for r in range(_NRANKS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        if errors or len(built) != _NRANKS:
            raise RuntimeError(f"tcp pair bring-up failed: {errors}")
        return {r: tt.TcpShmWindow(self.job, "conf", r, _NRANKS, _NRANKS,
                                   _SHAPE, _DTYPE, coord)
                for r in range(_NRANKS)}

    def _write(self, src, dst, array, p, accumulate):
        # the arm is selected per write: tcp_chunked()/chunk geometry
        # are env-driven reads at deposit time (single-threaded harness)
        saved = {k: os.environ.get(k)
                 for k in ("BFTPU_TCP_CHUNKED", "BLUEFOG_SHM_CHUNK_BYTES")}
        os.environ["BFTPU_TCP_CHUNKED"] = "1" if self.chunked else "0"
        os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "8"  # 2-chunk streams
        try:
            super()._write(src, dst, array, p, accumulate)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def close(self) -> None:
        super().close()
        for r in range(_NRANKS):
            try:
                self._tt._JobRuntime.drop(self.job, r)
            except Exception:
                pass


#: arm name -> zero-arg factory.  CORE arms accept the core vocabulary;
#: WINDOW arms additionally accept put/read/drain/reset.
ARM_FACTORIES: Dict[str, Callable[[], object]] = {
    "reference": RefAdapter,
    "sim": SimAdapter,
    "shm-native": NativeShmAdapter,
    "shm-fallback": FallbackShmAdapter,
    "tcp-chunked": lambda: TcpAdapter(chunked=True),
    "tcp-legacy": lambda: TcpAdapter(chunked=False),
}
CORE_ARMS = ("reference", "sim", "shm-native", "shm-fallback",
             "tcp-chunked", "tcp-legacy")
WINDOW_ARMS = ("reference", "shm-native", "shm-fallback", "tcp-chunked",
               "tcp-legacy")


# ---------------------------------------------------------------------------
# the differential runner + ddmin shrink
# ---------------------------------------------------------------------------


def run_schedule(arms: Dict[str, object], schedule: Sequence[Tuple],
                 *, compare_ledgers: bool = False) -> Optional[dict]:
    """Drive every arm through ``schedule``; after EVERY op compare the
    op result and the full version snapshot across arms.  Returns None
    (conformant) or a divergence record ``{step, op, field, values}``."""
    names = sorted(arms)
    for i, op in enumerate(schedule):
        results = {}
        for name in names:
            try:
                results[name] = arms[name].apply(op)
            except Exception as exc:
                results[name] = ("EXCEPTION", type(exc).__name__, str(exc))
        if len(set(map(repr, results.values()))) > 1:
            return {"step": i, "op": op, "field": "result",
                    "values": results}
        snaps = {name: arms[name].snapshot() for name in names}
        if len(set(snaps.values())) > 1:
            return {"step": i, "op": op, "field": "versions",
                    "values": snaps}
    if compare_ledgers:
        ledgers = {n: arms[n].ledger() for n in names}
        ledgers = {n: v for n, v in ledgers.items() if v is not None}
        keys = set().union(*(set(v) for v in ledgers.values())) \
            if ledgers else set()
        common = [k for k in sorted(keys)
                  if all(k in v for v in ledgers.values())]
        vals = {n: tuple(v[k] for k in common) for n, v in ledgers.items()}
        if len(set(vals.values())) > 1:
            return {"step": len(schedule), "op": ("ledger",),
                    "field": "ledger", "values": ledgers}
        for n, v in ledgers.items():
            if v.get("balanced") is False:
                return {"step": len(schedule), "op": ("ledger",),
                        "field": "ledger", "values": {n: v}}
    return None


def differential(arm_names: Sequence[str], schedule: Sequence[Tuple],
                 *, compare_ledgers: bool = False,
                 factories: Optional[Dict[str, Callable]] = None,
                 ) -> Optional[dict]:
    """Build fresh arms, run the schedule, tear down.  The re-runnable
    unit ddmin shrinks over."""
    factories = ARM_FACTORIES if factories is None else factories
    arms = {}
    try:
        for name in arm_names:
            arms[name] = factories[name]()
        return run_schedule(arms, schedule,
                            compare_ledgers=compare_ledgers)
    finally:
        for a in arms.values():
            try:
                a.close()
            except Exception:
                pass


def shrink_ops(schedule: Sequence[Tuple],
               reproduces: Callable[[Sequence[Tuple]], bool],
               ) -> Tuple[List[Tuple], int]:
    """ddmin over op schedules (same algorithm as
    ``sim/campaign.shrink_schedule``, on ops instead of fault events):
    repeatedly try dropping chunks (subsets and complements) while the
    divergence still reproduces; returns ``(1-minimal schedule, runs)``.
    """
    current = list(schedule)
    runs = 0
    if not current:
        return current, runs
    granularity = 2
    while len(current) >= 1:
        chunk = max(1, len(current) // granularity)
        pieces = [current[i:i + chunk]
                  for i in range(0, len(current), chunk)]
        reduced = False
        for idx in range(len(pieces)):
            candidate = [op for j, p in enumerate(pieces) for op in p
                         if j != idx]
            runs += 1
            if reproduces(candidate):
                current = candidate
                granularity = max(granularity - 1, 2)
                reduced = True
                break
        if not reduced:
            if granularity >= len(current):
                break
            granularity = min(len(current), granularity * 2)
    # final 1-minimality pass: no single op is droppable
    for i in range(len(current) - 1, -1, -1):
        candidate = current[:i] + current[i + 1:]
        runs += 1
        if reproduces(candidate):
            current = candidate
    return current, runs


def _report_divergence(report, rule: str, arm_names: Sequence[str],
                       seed: int, schedule: List[Tuple], div: dict,
                       *, compare_ledgers: bool = False) -> None:
    """Shrink a divergent schedule to its 1-minimal repro and file it."""
    def _reproduces(sub: Sequence[Tuple]) -> bool:
        try:
            return differential(arm_names, sub,
                                compare_ledgers=compare_ledgers) is not None
        except Exception:
            return False

    minimal, runs = shrink_ops(schedule, _reproduces)
    report.add(Finding(
        rule, f"seed={seed}",
        f"transports diverge on {div['field']} after {div['op']!r} "
        f"(step {div['step']}): {div['values']!r}; 1-minimal repro "
        f"({runs} shrink runs): {minimal!r}"))


# ---------------------------------------------------------------------------
# seeded mutants (the self-test / fixture corpus)
# ---------------------------------------------------------------------------


class ReorderingRefAdapter(RefAdapter):
    """Seeded bug: commits deposits OUT OF ORDER — each deposit is
    buffered and the backlog is flushed last-in-first-out only when a
    non-deposit op arrives.  An intervening collect observes the slot
    empty; the differential must catch it (ascending-commit violation
    made observable)."""

    name = "mutant-out-of-order-commit"

    def __init__(self) -> None:
        super().__init__()
        self._backlog: List[Tuple] = []

    def apply(self, op: Tuple):
        if op[0] == "deposit":
            self._backlog.append(op)
            return None
        for held in reversed(self._backlog):
            super().apply(held)
        self._backlog.clear()
        return super().apply(op)


class LossyDrainReference(ReferenceTransport):
    """Seeded bug: force_drain discards the slot's uncollected mass
    without accounting it — the mass-ledger identity must break."""

    def drain(self, dst: int, src: int) -> None:
        s = self._slots.get((self.epoch, int(dst), int(src)))
        if s is None:
            return
        s.seen = s.version
        s.x, s.p = 0.0, 0.0
        s.drained = s.version  # wiped; never credited to any bin


class StaleReseedReference(ReferenceTransport):
    """Seeded bug: an epoch switch retires the ledger but SKIPS the
    re-seed — the new epoch inherits the old epoch's slot state."""

    def epoch_switch(self, new_epoch: int) -> None:
        carried = {k: s for k, s in self._slots.items()
                   if k[0] == self.epoch}
        super().epoch_switch(new_epoch)
        for (_ep, dst, src), s in carried.items():
            self._slots[(self.epoch, dst, src)] = s


class StaleReseedAdapter(RefAdapter):
    name = "mutant-epoch-reseed-skipped"

    def __init__(self) -> None:
        self.ref = StaleReseedReference(_NRANKS)


class _OverclaimedTransport:
    """Seeded bug for the capability lint: claims a fused scale (and a
    future tier) its write() cannot deliver."""

    from bluefog_tpu_torch.native.capabilities import TransportCaps as _TC

    CAPS = _TC(name="overclaimed", fused_accumulate=True, fused_scale=True,
               fused_combine=True, zero_copy_collect=False,
               chunked_streaming=False, wire_quantization=False,
               resume=False, device_resident=True)

    def write(self, dst, slot, array, p=1.0, accumulate=False):
        pass  # no scale kwarg, no supports_scale attr


#: pinned repro schedules for the mutants (found by the generator, frozen
#: so the self-test replays them bit-identically)
MUTANT_PINS: Dict[str, List[Tuple]] = {
    "out-of-order-commit": [("deposit", 0, 1, 3.0, 1.0),
                            ("deposit", 0, 1, 2.0, 0.5),
                            ("collect", 0, 1)],
    "epoch-reseed-skipped": [("deposit", 1, 0, 4.0, 1.0),
                             ("epoch",),
                             ("version", 1, 0)],
}


def mutant_out_of_order_findings() -> List[Finding]:
    """Differential vs the reordering mutant + ddmin down to the minimal
    repro; ≥1 finding iff the harness catches the seeded bug."""
    factories = dict(ARM_FACTORIES)
    factories["mutant"] = ReorderingRefAdapter
    arms = ("reference", "mutant")
    schedule = gen_schedule(7, 40)
    div = differential(arms, schedule, factories=factories)
    if div is None:
        return []
    minimal, _runs = shrink_ops(
        schedule,
        lambda sub: differential(arms, sub,
                                 factories=factories) is not None)
    return [Finding("conformance.differential",
                    "mutant:out-of-order-commit",
                    f"out-of-order commit diverges at {div['op']!r}; "
                    f"minimal repro: {minimal!r}")]


def mutant_reseed_findings() -> List[Finding]:
    factories = dict(ARM_FACTORIES)
    factories["mutant"] = StaleReseedAdapter
    div = differential(("reference", "mutant"),
                       MUTANT_PINS["epoch-reseed-skipped"],
                       factories=factories)
    if div is None:
        return []
    return [Finding("conformance.differential",
                    "mutant:epoch-reseed-skipped",
                    f"skipped re-seed leaks old-epoch state: {div['op']!r} "
                    f"at step {div['step']}")]


def mutant_lossy_drain_findings() -> List[Finding]:
    ref = LossyDrainReference(_NRANKS)
    ref.deposit(0, 1, 5.0, 1.0)
    ref.drain(0, 1)
    led = ref.ledger()
    if led["balanced"]:
        return []
    return [Finding("conformance.ledger", "mutant:drain-loses-mass",
                    f"drain dropped committed mass from the ledger: {led!r}")]


def mutant_overclaim_findings() -> List[Finding]:
    from bluefog_tpu_torch.analysis.transport_spec import check_caps_honest

    problems = check_caps_honest({"overclaimed": _OverclaimedTransport})
    return [Finding("transport.caps-honest", "mutant:capability-overclaim",
                    p) for p in problems]


# ---------------------------------------------------------------------------
# registered rules
# ---------------------------------------------------------------------------

#: pinned seeds per rule — frozen so CI runs are reproducible; bumping a
#: seed is a reviewed change, not noise
SHM_SEEDS = (11, 12, 13, 14)
TCP_SEEDS = (21, 22)
EPOCH_SEEDS = (31, 32, 33, 34, 35, 36)


@registry.rule("conformance.differential-shm", "conformance",
               "shm windows (native + fallback) match the reference model "
               "and SimTransport on pinned op schedules")
def _rule_differential_shm(report) -> None:
    from bluefog_tpu_torch.native import get_lib

    # builds the C++ mailbox or raises: the native arm is never dropped
    get_lib()
    for seed in SHM_SEEDS:
        # core pass: every in-process transport speaks this vocabulary
        arms = ["reference", "sim", "shm-fallback", "shm-native"]
        schedule = gen_schedule(seed, 60)
        report.subjects_checked += 1
        div = differential(arms, schedule)
        if div is not None:
            _report_divergence(report, "conformance.differential-shm",
                               arms, seed, schedule, div)
        # window pass: puts/reads/drains (sim cannot represent these)
        arms = ["reference", "shm-fallback", "shm-native"]
        schedule = gen_schedule(seed, 60, puts=True, drains=True)
        report.subjects_checked += 1
        div = differential(arms, schedule)
        if div is not None:
            _report_divergence(report, "conformance.differential-shm",
                               arms, seed, schedule, div)


@registry.rule("conformance.differential-tcp", "conformance",
               "both TCP arms (chunked + legacy) match the reference model "
               "across a real loopback wire on pinned op schedules")
def _rule_differential_tcp(report) -> None:
    for seed in TCP_SEEDS:
        arms = ("reference", "tcp-chunked", "tcp-legacy")
        schedule = gen_schedule(seed, 30, puts=True, drains=True)
        report.subjects_checked += 1
        try:
            div = differential(arms, schedule)
        except Exception as exc:
            report.add(Finding("conformance.differential-tcp",
                               f"seed={seed}",
                               f"tcp harness failed to run: {exc!r}"))
            continue
        if div is not None:
            _report_divergence(report, "conformance.differential-tcp",
                               arms, seed, schedule, div)


@registry.rule("conformance.epoch-death", "conformance",
               "epoch quiesce/re-seed and writer death: SimTransport "
               "matches the reference model, ledgers settle balanced")
def _rule_epoch_death(report) -> None:
    for seed in EPOCH_SEEDS:
        kills = seed % 2 == 0  # half the corpus exercises writer death
        schedule = gen_schedule(seed, 50, epochs=True, kills=kills)
        # final quiesce so the count ledgers are comparable (live == 0);
        # ledgers only compare on kill-free runs — death settlement
        # (adoption/write-off) is the sim fleet's own rule family
        schedule = schedule + [("epoch",)]
        arms = ("reference", "sim")
        report.subjects_checked += 1
        div = differential(arms, schedule, compare_ledgers=not kills)
        if div is not None:
            _report_divergence(report, "conformance.epoch-death", arms,
                               seed, schedule, div,
                               compare_ledgers=not kills)


@registry.rule("conformance.shrinker", "conformance",
               "the ddmin shrink reduces a planted divergence to its "
               "1-minimal repro schedule")
def _rule_shrinker(report) -> None:
    factories = dict(ARM_FACTORIES)
    factories["mutant"] = ReorderingRefAdapter
    arms = ("reference", "mutant")
    noise = gen_schedule(99, 24)
    schedule = noise + MUTANT_PINS["out-of-order-commit"]
    report.subjects_checked += 1

    def _reproduces(sub):
        return differential(arms, sub, factories=factories) is not None

    if not _reproduces(schedule):
        report.add(Finding("conformance.shrinker", "planted mutant",
                           "planted out-of-order-commit mutant did not "
                           "diverge — the harness lost its teeth"))
        return
    minimal, runs = shrink_ops(schedule, _reproduces)
    report.metric("conformance.shrink_runs", float(runs))
    report.metric("conformance.shrunk_len", float(len(minimal)))
    if len(minimal) > 3:
        report.add(Finding("conformance.shrinker", "planted mutant",
                           f"ddmin left a non-minimal repro of "
                           f"{len(minimal)} ops: {minimal!r}"))
    if not _reproduces(minimal):
        report.add(Finding("conformance.shrinker", "planted mutant",
                           "shrunk schedule no longer reproduces"))


# ---------------------------------------------------------------------------
# --changed-only support + self-test arm
# ---------------------------------------------------------------------------

#: transport/runtime source file -> the rule families that gate it (the
#: pre-commit mapping behind ``--changed-only``)
FAMILY_MAP: Dict[str, Tuple[str, ...]] = {
    "bluefog_tpu_torch/native/shm_native.py": ("protocol", "resilience",
                                         "transport", "conformance",
                                         "interleave"),
    "bluefog_tpu_torch/native/tcp_transport.py": ("wire", "transport",
                                            "conformance", "interleave"),
    "bluefog_tpu_torch/native/wire_codec.py": ("wire", "transport"),
    "bluefog_tpu_torch/native/routed_transport.py": ("transport", "conformance"),
    "bluefog_tpu_torch/native/capabilities.py": ("transport",),
    "bluefog_tpu_torch/sim/transport.py": ("sim", "partition", "serve",
                                     "transport", "conformance"),
    "bluefog_tpu_torch/progress/engine.py": ("progress", "transport",
                                       "interleave"),
    "bluefog_tpu_torch/islands.py": ("protocol", "transport", "wire"),
    # the replica's double-buffered install (the serve family's buffer
    # model and the interleave explorer's serve machine)
    "bluefog_tpu_torch/serve/replica.py": ("serve", "interleave"),
    # the snapshot distribution plane: tree math, delta codec and the
    # feed protocol are all gated by the distrib family (the codec
    # additionally by wire — deltas ride the wire_codec chunks)
    "bluefog_tpu_torch/serve/distrib/__init__.py": ("distrib",),
    "bluefog_tpu_torch/serve/distrib/tree.py": ("distrib",),
    "bluefog_tpu_torch/serve/distrib/delta.py": ("distrib", "wire"),
    "bluefog_tpu_torch/serve/distrib/feed.py": ("distrib", "wire"),
    "bluefog_tpu_torch/serve/distrib/sub.py": ("distrib", "serve"),
    "bluefog_tpu_torch/analysis/distrib_rules.py": ("distrib",),
    # the fleet monitor: the alert engine and its sim twin are gated by
    # the monitor family; the scraper and store additionally by
    # introspect (they ride the statuspage seqlock protocol) and the
    # report joiner by telemetry (it joins the journal schema)
    "bluefog_tpu_torch/monitor/rules.py": ("monitor",),
    "bluefog_tpu_torch/monitor/scraper.py": ("monitor", "introspect"),
    "bluefog_tpu_torch/monitor/store.py": ("monitor", "introspect"),
    "bluefog_tpu_torch/monitor/tail.py": ("monitor", "telemetry"),
    "bluefog_tpu_torch/monitor/report.py": ("monitor", "telemetry"),
}


def families_for_paths(paths: Sequence[str]) -> List[str]:
    """Map touched files to the families that must re-run.  Unknown
    files under analysis/ select their own family by module name; any
    other unknown file selects everything (safe default)."""
    out = set()
    for raw in paths:
        rel = os.path.normpath(raw).replace(os.sep, "/")
        rel = rel.lstrip("./")
        if rel in FAMILY_MAP:
            out.update(FAMILY_MAP[rel])
            continue
        if rel.startswith("bluefog_tpu_torch/analysis/"):
            stem = os.path.basename(rel)
            for fam in registry.families():
                if stem.startswith(fam.replace("-", "_")):
                    out.add(fam)
                    break
            else:
                return sorted(registry.families())
            continue
        return sorted(registry.families())
    return sorted(out)


def selftest_conformance() -> List[Tuple[str, bool, str]]:
    """The --self-test arm: the live differential corpus must be clean
    AND every seeded conformance mutant must be caught.  Returns
    ``(label, ok, detail)`` rows."""
    from bluefog_tpu_torch.analysis.engine import Report

    rows: List[Tuple[str, bool, str]] = []
    report = Report()
    registry.run(families=["conformance"], report=report)
    clean = [f for f in report.findings if f.severity == Severity.ERROR]
    rows.append(("conformance corpus", not clean,
                 f"{report.subjects_checked} schedules, "
                 f"{len(clean)} divergence(s)"))
    for label, fn in (
            ("mutant out-of-order-commit", mutant_out_of_order_findings),
            ("mutant drain-loses-mass", mutant_lossy_drain_findings),
            ("mutant epoch-reseed-skipped", mutant_reseed_findings),
            ("mutant capability-overclaim", mutant_overclaim_findings)):
        caught = bool(fn())
        rows.append((label, caught,
                     "caught" if caught else "NOT caught"))
    return rows
