"""Rule family 3a: exhaustive model checking of the shm-mailbox protocol.

``native/shm_mailbox.cc`` implements a seqlock mailbox (writers per-slot
spinlocked with an odd/even sequence publish; readers wait-free with a
bracketed retry copy), an atomic read+zero ``collect``, and a
sense-reversing barrier.  MPI gives the reference this machinery for
free; here it is 449 lines of hand-rolled C++ that had never been model
checked.  This module mirrors each protocol as a small explicit-state
machine and exhaustively enumerates ALL interleavings at small bounds
(1-2 writers x 1-2 deposits, 2-word payloads, 2-3 ranks x 2 barrier
episodes), proving within those bounds:

- **no torn read**: every payload a completed reader returns is a single
  deposit's value, never a mix of two (seqlock safety);
- **no lost deposit**: ``collect``'s read+zero critical section conserves
  mass against a concurrent accumulating writer;
- **no lost wakeup / deadlock**: the barrier's reset-then-release order
  can never strand a rank spinning on a generation bump that already
  happened.

The step orders are imported from ``native/shm_native.py``'s protocol
spec constants and asserted to match, so the model cannot silently drift
from the implementation it vouches for.  Seeded-bug variants (writer
skips the odd phase; collect splits read and zero; barrier releases
before resetting) are exported for the fixture corpus — each must make
the checker fire (tests/test_analysis.py).

The model assumes sequential consistency.  The fences in shm_mailbox.cc
(seq_cst store-store before the payload mutation, release before the
even publish, acquire-bracketed reads) are exactly what collapses the
hardware's weaker orders to the interleaving semantics checked here;
the comments at ``slot_write``/``slot_read`` document that mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.native.shm_native import (
    BARRIER_RESET_BEFORE_RELEASE,
    CHUNK_COMMIT_IN_ORDER,
    CHUNK_READER_STEPS,
    CHUNK_WRITER_STEPS,
    COLLECT_IS_ATOMIC,
    DEAD_WRITER_DRAIN_STEPS,
    DEPOSIT_COMMITS_AFTER_PAYLOAD,
    DRAINED_COLLECT_IS_ATOMIC,
    SEQLOCK_READER_STEPS,
    SEQLOCK_WRITER_STEPS,
)

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

__all__ = [
    "Model",
    "explore",
    "seqlock_model",
    "collect_model",
    "barrier_model",
    "chunk_ring_model",
    "drained_collect_model",
    "dead_writer_drain_model",
    "check_model",
]


# ---------------------------------------------------------------------------
# tiny explicit-state explorer
# ---------------------------------------------------------------------------
#
# A process is a list of *steps*.  A step is
#     step(shared: dict, regs: dict) -> list[(shared', regs', next_pc)]
# returning every successor from this state (deterministic steps return
# one; a blocked spin returns none).  Steps must treat their inputs as
# immutable and may set shared["_bad"] to a message to flag a safety
# violation at that transition.


@dataclasses.dataclass
class Model:
    name: str
    shared: Dict
    programs: List[List[Callable]]
    final_check: Optional[Callable[[Dict], Optional[str]]] = None


def _freeze(d: Dict) -> Tuple:
    return tuple(sorted(d.items()))


def _thaw(t: Tuple) -> Dict:
    return dict(t)


def explore(model: Model, max_states: int = 1_000_000) -> List[str]:
    """DFS over every interleaving; returns violation messages.

    Detects three failure shapes: a step-flagged safety violation
    (``shared["_bad"]``), a deadlock (some process unfinished, no process
    can move — the lost-wakeup signature), and a failed ``final_check``
    on a fully-terminated state.
    """
    programs = model.programs
    init = (_freeze(model.shared),
            tuple((0, ()) for _ in programs))
    seen = {init}
    stack = [init]
    violations: List[str] = []
    flagged = set()

    def flag(msg: str) -> None:
        if msg not in flagged:
            flagged.add(msg)
            violations.append(msg)

    while stack:
        shared_t, procs = stack.pop()
        shared = _thaw(shared_t)
        any_move = False
        all_done = True
        for i, (pc, regs_t) in enumerate(procs):
            prog = programs[i]
            if pc >= len(prog):
                continue
            all_done = False
            regs = _thaw(regs_t)
            for sh2, rg2, pc2 in prog[pc](shared, regs):
                any_move = True
                bad = sh2.pop("_bad", None)
                if bad is not None:
                    flag(f"{model.name}: {bad}")
                    continue  # prune past the violation
                nxt = (_freeze(sh2),
                       procs[:i] + ((pc2, _freeze(rg2)),) + procs[i + 1:])
                if nxt not in seen:
                    if len(seen) >= max_states:
                        raise RuntimeError(
                            f"{model.name}: state space exceeded "
                            f"{max_states} states — tighten the bounds")
                    seen.add(nxt)
                    stack.append(nxt)
        if all_done:
            if model.final_check is not None:
                msg = model.final_check(shared)
                if msg:
                    flag(f"{model.name}: {msg}")
        elif not any_move:
            stuck = [i for i, (pc, _) in enumerate(procs)
                     if pc < len(programs[i])]
            flag(f"{model.name}: deadlock — process(es) {stuck} blocked "
                 "forever (lost wakeup)")
    return violations


def _s(shared, regs, pc, **updates):
    """One successor with shared-var updates applied."""
    sh = dict(shared)
    sh.update(updates)
    return [(sh, regs, pc)]


def _r(shared, regs, pc, **updates):
    """One successor with register updates applied."""
    rg = dict(regs)
    rg.update(updates)
    return [(shared, rg, pc)]


# ---------------------------------------------------------------------------
# model 1: seqlock write/read (torn-read safety)
# ---------------------------------------------------------------------------


def _writer_program(writer_id: int, deposits: int, words: int,
                    use_lock: bool, odd_phase: bool,
                    early_publish: bool) -> Tuple[List[Callable], Tuple[str, ...]]:
    """One writer: ``deposits`` sequential slot_write calls, each writing
    the deposit's unique value to every payload word, one word per step
    (the memcpy is not atomic — that is the whole point)."""
    prog: List[Callable] = []
    steps: List[str] = []

    for dep in range(deposits):
        value = writer_id * 100 + dep + 1

        # Each closure captures its own next-pc at construction time.
        def mk_acquire(next_pc):
            def step(sh, rg):
                if sh["lock"]:
                    return []
                return _s(sh, rg, next_pc, lock=1)
            return step

        def mk_seq_bump(next_pc):
            def step(sh, rg):
                return _s(sh, rg, next_pc, seq=sh["seq"] + 1)
            return step

        def mk_write_word(w, v, next_pc):
            def step(sh, rg):
                return _s(sh, rg, next_pc, **{f"w{w}": v})
            return step

        def mk_release(next_pc):
            def step(sh, rg):
                return _s(sh, rg, next_pc, lock=0)
            return step

        base = len(prog)
        seq_bumps = ([("seq_to_odd", mk_seq_bump)] if odd_phase else [])
        publish = [("seq_to_even", mk_seq_bump)]
        body: List[Tuple[str, Callable]] = []
        if use_lock:
            body.append(("acquire_lock", mk_acquire))
        body.extend(seq_bumps)
        if early_publish:
            body.extend(publish)
        body.extend(("mutate_payload", lambda nxt, w=w, v=value:
                     mk_write_word(w, v, nxt)) for w in range(words))
        if not early_publish:
            body.extend(publish)
        if use_lock:
            body.append(("release_lock", mk_release))
        for k, (name, maker) in enumerate(body):
            prog.append(maker(base + k + 1))
            steps.append(name)
    return prog, tuple(steps)


def _reader_program(words: int, check_after: bool = True) -> List[Callable]:
    """slot_read: bracketed retry copy, no lock.  Registers: ``before``
    and one ``r<w>`` per word.  On completion the snapshot must be a
    single deposit's value."""
    pc_start = 0

    def read_before(sh, rg):
        if sh["seq"] & 1:
            return [(sh, rg, pc_start)]  # odd: retry (self-loop via state)
        return _r(sh, rg, 1, before=sh["seq"])

    prog: List[Callable] = [read_before]

    def mk_copy(w, next_pc):
        def step(sh, rg):
            return _r(sh, rg, next_pc, **{f"r{w}": sh[f"w{w}"]})
        return step

    for w in range(words):
        prog.append(mk_copy(w, len(prog) + 1))

    def read_after(sh, rg):
        if check_after and sh["seq"] != rg["before"]:
            return [(sh, {}, pc_start)]  # retry from scratch
        vals = {rg[f"r{w}"] for w in range(words)}
        if len(vals) > 1:
            sh2 = dict(sh)
            sh2["_bad"] = (f"torn read: completed snapshot mixes deposits "
                           f"{sorted(vals)}")
            return [(sh2, rg, len(prog))]
        return [(sh, rg, len(prog))]

    prog.append(read_after)
    return prog


def seqlock_model(n_writers: int = 1, deposits: int = 2, words: int = 2,
                  use_lock: bool = True, odd_phase: bool = True,
                  early_publish: bool = False,
                  reader_checks_after: bool = True) -> Model:
    """The mailbox slot under concurrent writers and one wait-free reader.

    Default parameters mirror ``slot_write``/``slot_read`` exactly (order
    asserted against the shm_native protocol spec); the keyword knobs
    produce the seeded-bug variants for the fixture corpus."""
    shared = {"lock": 0, "seq": 0}
    for w in range(words):
        shared[f"w{w}"] = 0
    programs = []
    for i in range(n_writers):
        prog, steps = _writer_program(i, deposits, words, use_lock,
                                      odd_phase, early_publish)
        if (use_lock and odd_phase and not early_publish):
            # one deposit's step-name sequence must equal the impl spec
            per_dep = steps[:len(steps) // deposits]
            collapsed = tuple(
                name for k, name in enumerate(per_dep)
                if name != "mutate_payload" or
                (k == 0 or per_dep[k - 1] != "mutate_payload"))
            assert collapsed == SEQLOCK_WRITER_STEPS, (
                f"model drifted from shm_native.SEQLOCK_WRITER_STEPS: "
                f"{collapsed}")
        programs.append(prog)
    programs.append(_reader_program(words, check_after=reader_checks_after))
    assert len(SEQLOCK_READER_STEPS) == 3  # spec sync (retry-bracketed copy)
    return Model(name="seqlock", shared=shared, programs=programs)


# ---------------------------------------------------------------------------
# model 2: collect vs concurrent accumulate (mass conservation)
# ---------------------------------------------------------------------------


def collect_model(deposits: int = 2, atomic_collect: bool = COLLECT_IS_ATOMIC
                  ) -> Model:
    """One accumulating writer (``bf_shm_win_write`` mode 1) racing one
    ``collect`` drain (``bf_shm_win_read`` collect=1).  Mass conservation:
    every deposited unit is either collected or still in the slot when
    both finish.  ``atomic_collect=False`` models the seeded bug — a
    seqlock *read* followed by a separate locked zero — which loses any
    deposit that lands in between."""
    shared = {"lock": 0, "seq": 0, "m": 0, "collected": 0}

    writer: List[Callable] = []
    for dep in range(deposits):
        base = len(writer)

        def mk(step_idx):
            def acquire(sh, rg):
                if sh["lock"]:
                    return []
                return _s(sh, rg, step_idx + 1, lock=1)
            return acquire

        writer.append(mk(base))

        def mk_read(nxt):
            def step(sh, rg):
                return _r(sh, rg, nxt, tmp=sh["m"])
            return step

        writer.append(mk_read(base + 2))

        def mk_addback(nxt):
            def step(sh, rg):
                return _s(sh, rg, nxt, m=rg["tmp"] + 1)
            return step

        writer.append(mk_addback(base + 3))

        def mk_release(nxt):
            def step(sh, rg):
                return _s(sh, rg, nxt, lock=0)
            return step

        writer.append(mk_release(base + 4))

    if atomic_collect:
        def c_acquire(sh, rg):
            if sh["lock"]:
                return []
            return _s(sh, rg, 1, lock=1)

        def c_read_zero(sh, rg):
            sh2 = dict(sh)
            sh2["collected"] = sh["collected"] + sh["m"]
            sh2["m"] = 0
            return [(sh2, rg, 2)]

        def c_release(sh, rg):
            return _s(sh, rg, 3, lock=0)

        collector = [c_acquire, c_read_zero, c_release]
    else:
        # seeded bug: read outside the critical section, zero inside
        def c_read(sh, rg):
            return _r(sh, rg, 1, got=sh["m"])

        def c_acquire(sh, rg):
            if sh["lock"]:
                return []
            return _s(sh, rg, 2, lock=1)

        def c_zero(sh, rg):
            sh2 = dict(sh)
            sh2["collected"] = sh["collected"] + rg["got"]
            sh2["m"] = 0
            return [(sh2, rg, 3)]

        def c_release(sh, rg):
            return _s(sh, rg, 4, lock=0)

        collector = [c_read, c_acquire, c_zero, c_release]

    def conserved(sh) -> Optional[str]:
        if sh["collected"] + sh["m"] != deposits:
            return (f"lost deposit: {deposits} deposited but "
                    f"collected={sh['collected']} + remaining={sh['m']}")
        return None

    return Model(name="collect", shared=shared,
                 programs=[writer, collector], final_check=conserved)


# ---------------------------------------------------------------------------
# model 2b: chunk-ring commit protocol (protocol v2 — torn chunk /
# reordered commit / missing commit fence)
# ---------------------------------------------------------------------------
#
# slot_deposit in the v2 transport splits the payload into chunks, each
# guarded by its OWN seqlock, committed in ascending index order:
#     for c in chunks: cs[c] -> odd; fence; write chunk c; release; cs[c] -> even
# Two consumer shapes depend on different halves of that contract:
#   * the per-chunk bracketed reader (slot_read, probe's drain leg) needs
#     each chunk's odd/even bracket to actually cover the chunk's bytes —
#     a commit published before the payload lands (missing fence) lets a
#     bracket with before == after return a half-written chunk;
#   * the pipelined frontier reader (bf_shm_win_probe's consumer chasing
#     the commit frontier) additionally needs the ASCENDING commit order:
#     observing chunk LAST committed at episode d must imply every earlier
#     chunk already carries episode >= d.
# Both are modeled below; the seeded-bug knobs break exactly one promise
# each and must make the corresponding reader fire.


def _chunk_writer_program(nchunks: int, deposits: int, words: int,
                          in_order_commit: bool, commit_fence: bool
                          ) -> List[Callable]:
    """One depositing writer: per episode e (value e+1), commit every
    chunk under its own seqlock.  ``in_order_commit=False`` commits in
    DESCENDING index order (the reordered-commit bug); ``commit_fence=
    False`` publishes the even value BEFORE the chunk's words are written
    (the missing release-fence bug, modeled at SC as the reordered
    publish it permits on hardware)."""
    prog: List[Callable] = []

    def mk_seq_bump(c, next_pc):
        def step(sh, rg):
            return _s(sh, rg, next_pc, **{f"cs{c}": sh[f"cs{c}"] + 1})
        return step

    def mk_write_word(c, w, v, next_pc):
        def step(sh, rg):
            return _s(sh, rg, next_pc, **{f"c{c}w{w}": v})
        return step

    spec_names: List[str] = []
    for dep in range(deposits):
        value = dep + 1
        order = range(nchunks) if in_order_commit else \
            range(nchunks - 1, -1, -1)
        for c in order:
            body: List[Tuple[str, Callable]] = []
            body.append(("chunk_seq_to_odd", lambda nxt, c=c:
                         mk_seq_bump(c, nxt)))
            mutate = [("mutate_chunk", lambda nxt, c=c, w=w, v=value:
                       mk_write_word(c, w, v, nxt)) for w in range(words)]
            publish = [("chunk_seq_to_even", lambda nxt, c=c:
                        mk_seq_bump(c, nxt))]
            if commit_fence:
                body.extend(mutate + publish)
            else:
                body.extend(publish + mutate)
            base = len(prog)
            for k, (name, maker) in enumerate(body):
                prog.append(maker(base + k + 1))
                if dep == 0 and c == (0 if in_order_commit else nchunks - 1):
                    spec_names.append(name)
    if in_order_commit and commit_fence:
        collapsed = tuple(
            name for k, name in enumerate(spec_names)
            if name != "mutate_chunk"
            or (k == 0 or spec_names[k - 1] != "mutate_chunk"))
        assert collapsed == CHUNK_WRITER_STEPS, (
            f"model drifted from shm_native.CHUNK_WRITER_STEPS: {collapsed}")
    return prog


def _chunk_reader_program(nchunks: int, words: int) -> List[Callable]:
    """Per-chunk bracketed consumer: for each chunk, retry-bracketed copy
    under that chunk's seqlock; a completed bracket whose words mix two
    episodes is a torn chunk."""
    prog: List[Callable] = []
    for c in range(nchunks):
        pc_start = len(prog)

        def read_before(sh, rg, c=c, pc_start=pc_start):
            if sh[f"cs{c}"] & 1:
                return [(sh, rg, pc_start)]  # odd: retry
            return _r(sh, rg, pc_start + 1, before=sh[f"cs{c}"])

        prog.append(read_before)

        def mk_copy(c, w, next_pc):
            def step(sh, rg):
                return _r(sh, rg, next_pc, **{f"r{w}": sh[f"c{c}w{w}"]})
            return step

        for w in range(words):
            prog.append(mk_copy(c, w, len(prog) + 1))

        def read_after(sh, rg, c=c, pc_start=pc_start, end=pc_start + words + 2):
            if sh[f"cs{c}"] != rg["before"]:
                return [(sh, {}, pc_start)]  # changed: retry from scratch
            vals = {rg[f"r{w}"] for w in range(words)}
            if len(vals) > 1:
                sh2 = dict(sh)
                sh2["_bad"] = (f"torn chunk {c}: completed bracket mixes "
                               f"episodes {sorted(vals)}")
                return [(sh2, rg, end)]
            return [(sh, {}, end)]

        prog.append(read_after)
    assert len(CHUNK_READER_STEPS) == 3  # spec sync (retry-bracketed copy)
    return prog


def _frontier_reader_program(nchunks: int, words: int) -> List[Callable]:
    """Pipelined consumer chasing the commit frontier: once the LAST
    chunk's seqlock shows d completed commits (even, >= 2), ascending
    commit order guarantees every chunk already carries episode >= d —
    in every word, even mid-write (older words are episode >= d, newer
    ones are > d).  This is what lets bf_shm_win_probe's reader start
    draining chunk 0 while the writer is still depositing chunk k."""
    last = nchunks - 1

    def observe_frontier(sh, rg):
        s = sh[f"cs{last}"]
        if (s & 1) or s < 2:
            return [(sh, rg, 0)]  # spin until a commit of the last chunk
        return _r(sh, rg, 1, d=s // 2)

    prog: List[Callable] = [observe_frontier]
    for c in range(nchunks):
        def check_chunk(sh, rg, c=c, next_pc=len(prog) + 1):
            lo = min(sh[f"c{c}w{w}"] for w in range(words))
            if lo < rg["d"]:
                sh2 = dict(sh)
                sh2["_bad"] = (
                    f"commit frontier violated: chunk {nchunks - 1} shows "
                    f"episode {rg['d']} committed but chunk {c} still "
                    f"carries episode {lo}")
                return [(sh2, rg, next_pc)]
            return [(sh, rg, next_pc)]

        prog.append(check_chunk)
    return prog


def chunk_ring_model(nchunks: int = 2, deposits: int = 2, words: int = 2,
                     in_order_commit: bool = CHUNK_COMMIT_IN_ORDER,
                     commit_fence: bool = True,
                     frontier_reader: bool = False) -> Model:
    """The v2 chunk-ring slot under one depositing writer and one
    consumer.  Defaults mirror ``slot_deposit`` (order asserted against
    the shm_native protocol spec); ``commit_fence=False`` and
    ``in_order_commit=False`` are the seeded-bug variants, caught by the
    bracketed and frontier readers respectively."""
    shared: Dict = {}
    for c in range(nchunks):
        shared[f"cs{c}"] = 0
        for w in range(words):
            shared[f"c{c}w{w}"] = 0
    writer = _chunk_writer_program(nchunks, deposits, words,
                                   in_order_commit, commit_fence)
    reader = (_frontier_reader_program(nchunks, words) if frontier_reader
              else _chunk_reader_program(nchunks, words))
    return Model(name="chunk-ring", shared=shared,
                 programs=[writer, reader])


# ---------------------------------------------------------------------------
# model 2c: drained-marker collect (protocol v2 — O(1) drain)
# ---------------------------------------------------------------------------


def drained_collect_model(deposits: int = 2,
                          atomic_collect: bool = DRAINED_COLLECT_IS_ATOMIC
                          ) -> Model:
    """The v2 drain: collect stores ``drained = version`` under the slot
    lock instead of zeroing the payload — a slot whose ``drained ==
    version`` READS as zero, and an accumulating deposit into it degrades
    to a copy (``add = drained != version``).  Mass conservation: with
    one accumulating writer racing one collector, every deposited unit is
    either collected or still logically in the slot.  The seeded bug
    (``atomic_collect=False``) samples ``m``/``version`` OUTSIDE the
    critical section and only takes the lock to store the marker — a
    deposit landing in between is marked drained without ever being read."""
    shared = {"lock": 0, "m": 0, "version": 0, "drained": 0, "collected": 0}

    def logical(sh) -> int:
        return 0 if sh["drained"] == sh["version"] else sh["m"]

    writer: List[Callable] = []
    for dep in range(deposits):
        base = len(writer)

        def w_acquire(sh, rg, nxt=base + 1):
            if sh["lock"]:
                return []
            return _s(sh, rg, nxt, lock=1)

        def w_deposit(sh, rg, nxt=base + 2):
            # add = (drained != version): accumulate into a drained slot
            # restarts from zero — the marker makes stale mass invisible
            return _s(sh, rg, nxt, m=logical(sh) + 1,
                      version=sh["version"] + 1)

        def w_release(sh, rg, nxt=base + 3):
            return _s(sh, rg, nxt, lock=0)

        writer.extend([w_acquire, w_deposit, w_release])

    if atomic_collect:
        def c_acquire(sh, rg):
            if sh["lock"]:
                return []
            return _s(sh, rg, 1, lock=1)

        def c_drain(sh, rg):
            return _s(sh, rg, 2, collected=sh["collected"] + logical(sh),
                      drained=sh["version"])

        def c_release(sh, rg):
            return _s(sh, rg, 3, lock=0)

        collector = [c_acquire, c_drain, c_release]
    else:
        # seeded bug: sample the logical mass lock-free, then only take
        # the lock to store the drained marker
        def c_sample(sh, rg):
            return _r(sh, rg, 1, got=logical(sh))

        def c_acquire(sh, rg):
            if sh["lock"]:
                return []
            return _s(sh, rg, 2, lock=1)

        def c_mark(sh, rg):
            return _s(sh, rg, 3, collected=sh["collected"] + rg["got"],
                      drained=sh["version"])

        def c_release(sh, rg):
            return _s(sh, rg, 4, lock=0)

        collector = [c_sample, c_acquire, c_mark, c_release]

    def conserved(sh) -> Optional[str]:
        if sh["collected"] + logical(sh) != deposits:
            return (f"lost deposit: {deposits} deposited but "
                    f"collected={sh['collected']} + "
                    f"logical-remaining={logical(sh)} "
                    f"(drained marker {sh['drained']} vs version "
                    f"{sh['version']})")
        return None

    return Model(name="drained-collect", shared=shared,
                 programs=[writer, collector], final_check=conserved)


# ---------------------------------------------------------------------------
# model 2d: dead-writer force-drain (resilience — no deposited mass lost)
# ---------------------------------------------------------------------------


def dead_writer_drain_model(deposits: int = 2, collects: int = 1,
                            commits_after_payload: bool =
                            DEPOSIT_COMMITS_AFTER_PAYLOAD,
                            account_wiped: bool = True) -> Model:
    """A writer that may DIE at any protocol step (SIGKILL: no cleanup,
    lock possibly held mid-deposit) against the slot owner, who collects
    normally until the failure detector fires and then applies the
    force-drain rule (``bf_shm_win_force_drain``: mark the slot drained,
    then break the dead writer's lock — DEAD_WRITER_DRAIN_STEPS).

    Proves, over every death point and interleaving:

    - **no unbacked mass**: every unit that ever becomes visible
      (``version``/``m`` committed) has its payload fully written first —
      the reason ``slot_deposit`` commits AFTER the chunk writes
      (DEPOSIT_COMMITS_AFTER_PAYLOAD).  Seeded bug
      ``commits_after_payload=False``: a writer dying between commit and
      payload makes the owner collect a unit that was never deposited.
    - **no lost deposit**: every committed unit is collected, wiped by
      the accounted force-drain, or still logically in the slot —
      ``collected + wiped + logical == committed`` in every final state.
      Seeded bug ``account_wiped=False``: the drain marks the slot
      drained without accounting the in-transit mass to the dead rank's
      excised ledger, silently destroying deposits that had committed.
    - **no stranded survivor**: the owner never deadlocks on the dead
      writer's lock (the drain breaks it) — the built-in deadlock check.

    A writer that dies BEFORE committing leaves ``paid`` > ``committed``:
    that mass died with the writer and is charged to the dead rank by the
    healing rules, not to this slot — the model deliberately does not
    count it.
    """
    shared = {"lock": 0, "m": 0, "version": 0, "drained": 0,
              "dead": 0, "paid": 0, "committed": 0, "collected": 0,
              "wiped": 0}

    def logical(sh) -> int:
        return 0 if sh["drained"] == sh["version"] else sh["m"]

    def dying(step):
        """Wrap a writer step: at every pc the writer may also die in
        place — pc jumps past the program end, shared state (including a
        held lock) frozen as-is."""
        def wrapped(sh, rg):
            succ = list(step(sh, rg))
            succ.extend(_s(sh, rg, 10_000, dead=1))
            return succ
        return wrapped

    def w_acquire(sh, rg, nxt):
        if sh["lock"]:
            return []
        return _s(sh, rg, nxt, lock=1)

    def w_payload(sh, rg, nxt):
        return _s(sh, rg, nxt, paid=sh["paid"] + 1)

    def w_commit(sh, rg, nxt):
        return _s(sh, rg, nxt, m=logical(sh) + 1,
                  version=sh["version"] + 1,
                  committed=sh["committed"] + 1)

    def w_release(sh, rg, nxt):
        return _s(sh, rg, nxt, lock=0)

    order = ([w_acquire, w_payload, w_commit, w_release]
             if commits_after_payload
             # seeded bug: visibility before the payload lands
             else [w_acquire, w_commit, w_payload, w_release])
    writer: List[Callable] = []
    for _dep in range(deposits):
        base = len(writer)
        for i, s in enumerate(order):
            def pinned(sh, rg, s=s, nxt=base + i + 1):
                return s(sh, rg, nxt)
            writer.append(dying(pinned))

    owner: List[Callable] = []
    for _c in range(collects):
        nxt = len(owner) + 1

        def c_try_collect(sh, rg, nxt=nxt):
            # atomic read+mark under the lock (the v2 locked collect,
            # coarsened: the lock serializes it against the writer), or
            # skip this round — both orders are explored
            succ = _s(sh, rg, nxt)  # skip
            if not sh["lock"]:
                got = logical(sh)
                succ += _s(sh, rg, nxt,
                           collected=sh["collected"] + got,
                           drained=sh["version"])
            return succ
        owner.append(c_try_collect)

    base = len(owner)

    def o_detect(sh, rg, base=base):
        # the failure detector: fires only once the writer is truly dead;
        # the no-failure path skips the drain entirely
        succ = _s(sh, rg, base + 3)  # no drain (detector never fired)
        if sh["dead"]:
            succ += _s(sh, rg, base + 1)
        return succ

    def o_wipe(sh, rg, base=base):
        # mark_drained: in-transit mass is charged to the dead rank's
        # excised ledger (account_wiped) and the slot reads as zero
        got = logical(sh)
        return _s(sh, rg, base + 2, drained=sh["version"],
                  wiped=sh["wiped"] + (got if account_wiped else 0))

    def o_break_lock(sh, rg, base=base):
        # clear_lock comes LAST in DEAD_WRITER_DRAIN_STEPS: nobody can
        # slip into a half-drained slot
        return _s(sh, rg, base + 3, lock=0)

    owner.extend([o_detect, o_wipe, o_break_lock])

    # spec sync: the drain rule this model vouches for must mark the
    # drained slot before clearing the dead writer's lock
    assert DEAD_WRITER_DRAIN_STEPS.index("mark_drained") \
        < DEAD_WRITER_DRAIN_STEPS.index("clear_lock"), \
        "model drifted from shm_native.DEAD_WRITER_DRAIN_STEPS"

    def conserved(sh) -> Optional[str]:
        if sh["committed"] > sh["paid"]:
            return (f"unbacked mass: {sh['committed']} unit(s) committed "
                    f"but only {sh['paid']} payload(s) fully written — a "
                    "torn deposit became visible (commit must follow the "
                    "payload)")
        if sh["collected"] + sh["wiped"] + logical(sh) != sh["committed"]:
            return (f"lost deposit: committed={sh['committed']} but "
                    f"collected={sh['collected']} + wiped={sh['wiped']} + "
                    f"logical-remaining={logical(sh)} — the drain rule "
                    "destroyed committed mass without accounting it")
        return None

    return Model(name="dead-writer-drain", shared=shared,
                 programs=[writer, owner], final_check=conserved)


# ---------------------------------------------------------------------------
# model 3: sense-reversing barrier (lost wakeup)
# ---------------------------------------------------------------------------


def barrier_model(nranks: int = 2, episodes: int = 2,
                  reset_before_release: bool = BARRIER_RESET_BEFORE_RELEASE
                  ) -> Model:
    """``bf_shm_job_barrier`` at small bounds.  The last arriver resets
    ``arrived`` then bumps ``generation``; every other rank spins on the
    bump.  ``reset_before_release=False`` is the seeded bug — releasing
    first lets a fast rank enter the next episode and have its arrival
    wiped by the late reset, deadlocking everyone (the lost wakeup)."""
    shared = {"arrived": 0, "generation": 0}

    def make_rank() -> List[Callable]:
        prog: List[Callable] = []
        for _ in range(episodes):
            base = len(prog)
            # pcs within one episode: base+0 read gen / fetch_add,
            # base+1 reset-or-spin, base+2 release (last arriver only)
            def arrive(sh, rg, base=base):
                a = sh["arrived"] + 1
                rg2 = dict(rg)
                rg2["gen"] = sh["generation"]
                rg2["last"] = 1 if a == nranks else 0
                return [(dict(sh, arrived=a), rg2, base + 1)]

            def reset_or_spin(sh, rg, base=base):
                if rg["last"]:
                    if reset_before_release:
                        return _s(sh, rg, base + 2, arrived=0)
                    return _s(sh, rg, base + 2,
                              generation=sh["generation"] + 1)
                if sh["generation"] == rg["gen"]:
                    return []  # spin on the bump
                return [(sh, rg, base + 3)]

            def release(sh, rg, base=base):
                if not rg["last"]:
                    return [(sh, rg, base + 3)]
                if reset_before_release:
                    return _s(sh, rg, base + 3,
                              generation=sh["generation"] + 1)
                return _s(sh, rg, base + 3, arrived=0)

            prog.extend([arrive, reset_or_spin, release])
        return prog

    return Model(name="barrier", shared=shared,
                 programs=[make_rank() for _ in range(nranks)])


# ---------------------------------------------------------------------------
# report plumbing + registration
# ---------------------------------------------------------------------------


def check_model(model: Model, report: Optional[Report] = None,
                rule: str = "protocol.model") -> Report:
    report = report if report is not None else Report()
    report.subjects_checked += 1
    for msg in explore(model):
        report.add(Finding(rule, model.name, msg))
    return report


@registry.rule("protocol.seqlock-torn-read", "protocol",
               "no interleaving of seqlock writers with a wait-free "
               "reader yields a torn snapshot")
def _run_seqlock(report: Report) -> None:
    for n_writers, deposits in ((1, 2), (2, 1), (2, 2)):
        check_model(
            seqlock_model(n_writers=n_writers, deposits=deposits),
            report, rule="protocol.seqlock-torn-read")


@registry.rule("protocol.collect-mass-conservation", "protocol",
               "collect's read+zero critical section loses no concurrent "
               "deposit")
def _run_collect(report: Report) -> None:
    for deposits in (1, 2, 3):
        check_model(collect_model(deposits=deposits), report,
                    rule="protocol.collect-mass-conservation")


@registry.rule("protocol.barrier-lost-wakeup", "protocol",
               "the sense-reversing barrier can never strand a rank")
def _run_barrier(report: Report) -> None:
    for nranks, episodes in ((2, 2), (3, 2)):
        check_model(barrier_model(nranks=nranks, episodes=episodes),
                    report, rule="protocol.barrier-lost-wakeup")


@registry.rule("protocol.chunk-ring-commit", "protocol",
               "v2 chunk-ring deposits: no bracketed reader returns a "
               "torn chunk and no frontier reader overtakes an ascending "
               "commit")
def _run_chunk_ring(report: Report) -> None:
    # bracketed per-chunk consumer: torn-chunk safety (words > 1 so a
    # half-written chunk is representable)
    for nchunks, deposits in ((2, 2), (3, 1)):
        check_model(
            chunk_ring_model(nchunks=nchunks, deposits=deposits, words=2),
            report, rule="protocol.chunk-ring-commit")
    # pipelined frontier consumer: ascending commit order (one word per
    # chunk — ordering, not tearing, is what this reader depends on)
    for nchunks, deposits in ((2, 2), (3, 2)):
        check_model(
            chunk_ring_model(nchunks=nchunks, deposits=deposits, words=1,
                             frontier_reader=True),
            report, rule="protocol.chunk-ring-commit")


@registry.rule("protocol.chunk-drained-mass-conservation", "protocol",
               "the v2 O(1) drained-marker drain loses no concurrent "
               "accumulating deposit")
def _run_drained_collect(report: Report) -> None:
    for deposits in (1, 2, 3):
        check_model(drained_collect_model(deposits=deposits), report,
                    rule="protocol.chunk-drained-mass-conservation")


@registry.rule("resilience.dead-writer-drain", "resilience",
               "a writer dying at ANY protocol step: the force-drain "
               "rule neither loses committed mass nor surfaces a torn "
               "deposit nor strands the surviving slot owner")
def _run_dead_writer_drain(report: Report) -> None:
    for deposits, collects in ((1, 1), (2, 1), (2, 2), (3, 1)):
        check_model(
            dead_writer_drain_model(deposits=deposits, collects=collects),
            report, rule="resilience.dead-writer-drain")
