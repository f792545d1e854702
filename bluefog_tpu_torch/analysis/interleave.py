"""Unified interleaving explorer: one little language for the protocol
state machines, one exhaustive checker, one happens-before race scan.

The seqlock, chunk-ring and drained-collect models in
:mod:`.seqlock_model` are three hand-rolled variations on the same
pattern: processes as lists of step closures, shared words, a DFS over
every interleaving.  This module factors the pattern into a declarative
**op language** — a process is a list of :class:`Op` rows (``acquire`` /
``release`` / ``rd`` / ``rdf`` / ``w`` / ``rmw`` / ``guard`` /
``branch`` / ``chk`` plus :class:`Label` jump targets) — compiled down
to the *same* :class:`~bluefog_tpu_torch.analysis.seqlock_model.Model` the
legacy explorer runs, so one engine (``explore``) checks everything.

On top of the compiled form the module adds what the legacy models never
had: a **vector-clock race scan** (:func:`race_scan`).  Ops declare
which shared vars they read/write, and the spec classifies vars as
*sync* (lock words, seqlock sequence words, the packed serve header) or
*data* (payload words).  Over seeded random linearizations the scan
maintains one vector clock per process and per sync var (write =
release-join, read = acquire-join) and flags any **committed**
observation of a data var whose producing write is not happens-before
ordered — speculative seqlock-style copies are held pending and only
checked when the bracket validates (``chk(commits=True)``), exactly the
retroactive justification a real seqlock provides.  A torn-window bug
the interleaving verdict sees as "torn snapshot" the race scan
independently sees as "no happens-before edge": two detectors, one spec.

The three legacy protocols are re-expressed in the language
(:func:`seqlock_spec`, :func:`chunk_ring_spec`, :func:`drain_spec`) and
a **subsumption rule** asserts verdict parity with the legacy models on
the healthy builds AND every seeded-bug variant, so the unified explorer
provably covers what the old ones did (the legacy rules stay registered;
this family fences them).  Two new machines extend the coverage: the
async progress-engine submit queue (:func:`progress_queue_spec`:
exactly-once, order-preserving, nothing executes while parked) and the
serving double-buffer under a publisher death matrix
(:func:`serve_death_spec`: a completed read only ever returns a
committed version's canonical bytes, at every death point).

Registered family: ``interleave``.  Runtime: a few seconds (small
explicit-state bounds + pinned-seed scans).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.seqlock_model import (
    Model,
    chunk_ring_model,
    drained_collect_model,
    explore,
    seqlock_model,
)
from bluefog_tpu_torch.native.shm_native import (
    CHUNK_WRITER_STEPS,
    SEQLOCK_WRITER_STEPS,
)

__all__ = [
    "Op",
    "Label",
    "Proc",
    "ProtoSpec",
    "compile_spec",
    "verdict",
    "race_scan",
    "rd_when",
    "seqlock_spec",
    "chunk_ring_spec",
    "drain_spec",
    "progress_queue_spec",
    "serve_death_spec",
    "selftest_interleave",
]


# ---------------------------------------------------------------------------
# the op language
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str                 # acquire|acquire_when|release|rd|rdf|w|rmw|guard|branch|chk
    doc: str = ""             # step name (asserted against the spec tuples)
    var: Optional[str] = None          # acquire/release/rd/w target
    reg: Optional[str] = None          # rd/rdf destination register
    val: object = None                 # w value (constant or fn(sh, rg))
    fn: Optional[Callable] = None      # rdf/rmw/guard/branch/chk semantics
    reads: Tuple[str, ...] = ()        # shared vars read (race bookkeeping)
    reads_fn: Optional[Callable] = None   # dynamic actual-read set
    goto: Optional[str] = None         # branch target label
    reset: bool = False                # branch: clear registers on jump
    spec: bool = False                 # rd/rdf: speculative (validated later)
    commits: bool = False              # chk: success commits pending reads


class Label:
    """Jump target marker inside a process's op list."""

    def __init__(self, name: str):
        self.name = name


def acquire(var: str, doc: str = "") -> Op:
    return Op("acquire", doc=doc, var=var, reads=(var,))


def release(var: str, doc: str = "") -> Op:
    return Op("release", doc=doc, var=var)


def rd(reg: str, var: str, spec: bool = False, doc: str = "") -> Op:
    return Op("rd", doc=doc, var=var, reg=reg, reads=(var,), spec=spec)


def rd_when(reg: str, var: str, fn: Callable,
            reads: Tuple[str, ...] = (), doc: str = "") -> Op:
    """Atomic guarded read: blocks until ``fn(sh, rg)`` holds, then
    reads ``var`` in the SAME step — the seqlock reader's
    spin-while-odd-then-record, whose atomicity is what keeps an odd
    sequence value out of the bracket."""
    return Op("rd_when", doc=doc, var=var, reg=reg, fn=fn,
              reads=tuple(reads) + (var,))


def rdf(reg: str, fn: Callable, reads: Tuple[str, ...] = (),
        reads_fn: Optional[Callable] = None, spec: bool = False,
        doc: str = "") -> Op:
    return Op("rdf", doc=doc, reg=reg, fn=fn, reads=reads,
              reads_fn=reads_fn, spec=spec)


def w(var: str, val, doc: str = "", reads: Tuple[str, ...] = ()) -> Op:
    return Op("w", doc=doc, var=var, val=val, reads=reads)


def rmw(fn: Callable, reads: Tuple[str, ...] = (), doc: str = "") -> Op:
    return Op("rmw", doc=doc, fn=fn, reads=reads)


def guard(fn: Callable, reads: Tuple[str, ...] = (), doc: str = "") -> Op:
    return Op("guard", doc=doc, fn=fn, reads=reads)


def acquire_when(fn: Callable, var: str = "lock",
                 reads: Tuple[str, ...] = (), doc: str = "") -> Op:
    """Blocking conditional lock acquire: proceeds (taking ``var``) only
    when ``fn(sh, rg)`` holds and the lock is free — the coarsened
    test-and-set the real engines do under their mutex."""
    return Op("acquire_when", doc=doc, var=var, fn=fn,
              reads=tuple(reads) + (var,))


def branch(fn: Callable, goto: str, reads: Tuple[str, ...] = (),
           reset: bool = False, doc: str = "") -> Op:
    return Op("branch", doc=doc, fn=fn, goto=goto, reads=reads, reset=reset)


def chk(fn: Callable, reads: Tuple[str, ...] = (), commits: bool = False,
        doc: str = "") -> Op:
    return Op("chk", doc=doc, fn=fn, reads=reads, commits=commits)


@dataclasses.dataclass
class Proc:
    ops: List[object]           # Op | Label
    dying: bool = False         # every op also offers a die-in-place successor


@dataclasses.dataclass
class ProtoSpec:
    name: str
    shared: Dict
    procs: List[Proc]
    sync: Tuple[str, ...] = ()   # release/acquire vars for the race scan
    data: Tuple[str, ...] = ()   # payload vars the race scan guards
    final: Optional[Callable[[Dict], Optional[str]]] = None


def _resolve(proc: Proc) -> Tuple[List[Op], Dict[str, int]]:
    ops: List[Op] = []
    labels: Dict[str, int] = {}
    for item in proc.ops:
        if isinstance(item, Label):
            labels[item.name] = len(ops)
        else:
            ops.append(item)
    return ops, labels


def _value(val, sh, rg):
    return val(sh, rg) if callable(val) else val


def _step_for(op: Op, pc: int, labels: Dict[str, int], dying: bool
              ) -> Callable:
    """Compile one Op into a legacy-explorer step function."""
    nxt = pc + 1

    def successors(sh, rg):
        if op.kind == "acquire":
            if sh[op.var]:
                return []
            return [(dict(sh, **{op.var: 1}), rg, nxt)]
        if op.kind == "acquire_when":
            if sh[op.var] or not op.fn(sh, rg):
                return []
            return [(dict(sh, **{op.var: 1}), rg, nxt)]
        if op.kind == "release":
            return [(dict(sh, **{op.var: 0}), rg, nxt)]
        if op.kind == "rd":
            return [(sh, dict(rg, **{op.reg: sh[op.var]}), nxt)]
        if op.kind == "rd_when":
            if not op.fn(sh, rg):
                return []
            return [(sh, dict(rg, **{op.reg: sh[op.var]}), nxt)]
        if op.kind == "rdf":
            return [(sh, dict(rg, **{op.reg: op.fn(sh, rg)}), nxt)]
        if op.kind == "w":
            return [(dict(sh, **{op.var: _value(op.val, sh, rg)}), rg, nxt)]
        if op.kind == "rmw":
            return [(dict(sh, **op.fn(sh, rg)), rg, nxt)]
        if op.kind == "guard":
            return [(sh, rg, nxt)] if op.fn(sh, rg) else []
        if op.kind == "branch":
            if op.fn(sh, rg):
                return [(sh, {} if op.reset else rg, labels[op.goto])]
            return [(sh, rg, nxt)]
        if op.kind == "chk":
            msg = op.fn(sh, rg)
            if msg:
                return [(dict(sh, _bad=msg), rg, nxt)]
            return [(sh, rg, nxt)]
        raise ValueError(f"unknown op kind {op.kind!r}")

    if not dying:
        return successors

    def with_death(sh, rg):
        succ = list(successors(sh, rg))
        succ.append((dict(sh, dead=1), rg, 10_000))  # SIGKILL in place
        return succ

    return with_death


def compile_spec(spec: ProtoSpec) -> Model:
    """Compile the declarative spec to the legacy explorer's Model — the
    one engine both generations of models run on."""
    programs = []
    for proc in spec.procs:
        ops, labels = _resolve(proc)
        programs.append([_step_for(op, i, labels, proc.dying)
                         for i, op in enumerate(ops)])
    return Model(name=spec.name, shared=dict(spec.shared),
                 programs=programs, final_check=spec.final)


def verdict(spec: ProtoSpec) -> List[str]:
    """Exhaustively explore the compiled spec; returns violations."""
    return explore(compile_spec(spec))


def _collapsed_docs(ops: List[object]) -> Tuple[str, ...]:
    """The op-doc sequence with repeats collapsed — compared against the
    implementation's pinned step tuples so specs cannot silently drift."""
    out: List[str] = []
    for item in ops:
        if isinstance(item, Label) or not item.doc:
            continue
        if not out or out[-1] != item.doc:
            out.append(item.doc)
    return tuple(out)


# ---------------------------------------------------------------------------
# vector-clock race scan
# ---------------------------------------------------------------------------


def _join(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(max(x, y) for x, y in zip(a, b))


def _hb(earlier: Optional[Tuple[int, ...]], later: Tuple[int, ...]) -> bool:
    return earlier is None or all(x <= y for x, y in zip(earlier, later))


def race_scan(spec: ProtoSpec, seeds: Tuple[int, ...] = tuple(range(20)),
              max_steps: int = 4000) -> List[str]:
    """Happens-before race check over seeded random linearizations.

    Sync vars carry release/acquire clocks; every non-speculative read
    (and every write) of a data var must be happens-after the var's last
    write; speculative reads go to a pending set that is checked when a
    ``chk(commits=True)`` succeeds and discarded when a resetting branch
    retries.  Returns deduplicated race/violation messages."""
    races: List[str] = []
    seen = set()

    def flag(msg: str) -> None:
        if msg not in seen:
            seen.add(msg)
            races.append(f"{spec.name}: {msg}")

    nprocs = len(spec.procs)
    resolved = [_resolve(p) for p in spec.procs]
    sync, data = set(spec.sync), set(spec.data)

    for seed in seeds:
        rng = random.Random(seed)
        sh = dict(spec.shared)
        pcs = [0] * nprocs
        regs: List[Dict] = [{} for _ in range(nprocs)]
        vc = [tuple(1 if j == i else 0 for j in range(nprocs))
              for i in range(nprocs)]
        var_clock: Dict[str, Tuple[int, ...]] = {}
        last_write: Dict[str, Tuple[Optional[Tuple[int, ...]], int]] = {}
        pending: List[List[Tuple[str, Optional[Tuple[int, ...]], int]]] = \
            [[] for _ in range(nprocs)]

        for _ in range(max_steps):
            enabled = []
            for i in range(nprocs):
                ops, _labels = resolved[i]
                if pcs[i] >= len(ops):
                    continue
                op = ops[pcs[i]]
                if op.kind in ("guard", "rd_when") and not op.fn(sh, regs[i]):
                    continue
                if op.kind == "acquire" and sh[op.var]:
                    continue
                if op.kind == "acquire_when" and (
                        sh[op.var] or not op.fn(sh, regs[i])):
                    continue
                enabled.append(i)
            if not enabled:
                break
            i = rng.choice(enabled)
            ops, labels = resolved[i]
            op = ops[pcs[i]]
            rg = regs[i]
            vc[i] = tuple(c + (1 if j == i else 0)
                          for j, c in enumerate(vc[i]))

            reads = (op.reads_fn(sh, rg) if op.reads_fn is not None
                     else op.reads)
            # acquire-join every sync var FIRST: within one op the
            # synchronization precedes the data observation (an
            # acquire_when guard evaluates under the lock it takes)
            for v in reads:
                if v in sync:
                    vc[i] = _join(vc[i], var_clock.get(v, vc[i]))
            for v in reads:
                if v in data and not op.spec:
                    wvc, wproc = last_write.get(v, (None, -1))
                    if wproc not in (-1, i) and not _hb(wvc, vc[i]):
                        flag(f"race: process {i} reads data var {v!r} "
                             f"concurrently with process {wproc}'s write "
                             f"(no happens-before edge)")
            if op.spec:
                for v in reads:
                    if v in data:
                        wvc, wproc = last_write.get(v, (None, -1))
                        pending[i].append((v, wvc, wproc))

            # execute with the compiled semantics
            if op.kind in ("acquire", "acquire_when"):
                sh[op.var] = 1
                var_clock[op.var] = _join(
                    var_clock.get(op.var, vc[i]), vc[i])
                pcs[i] += 1
            elif op.kind == "release":
                sh[op.var] = 0
                var_clock[op.var] = _join(
                    var_clock.get(op.var, vc[i]), vc[i])
                pcs[i] += 1
            elif op.kind in ("rd", "rd_when"):
                rg[op.reg] = sh[op.var]
                pcs[i] += 1
            elif op.kind == "rdf":
                rg[op.reg] = op.fn(sh, rg)
                pcs[i] += 1
            elif op.kind in ("w", "rmw"):
                updates = ({op.var: _value(op.val, sh, rg)}
                           if op.kind == "w" else op.fn(sh, rg))
                for v, nv in updates.items():
                    sh[v] = nv
                    if v in sync:
                        var_clock[v] = _join(var_clock.get(v, vc[i]), vc[i])
                    elif v in data:
                        wvc, wproc = last_write.get(v, (None, -1))
                        if wproc not in (-1, i) and not _hb(wvc, vc[i]):
                            flag(f"race: processes {wproc} and {i} write "
                                 f"data var {v!r} concurrently")
                        last_write[v] = (vc[i], i)
                pcs[i] += 1
            elif op.kind == "guard":
                pcs[i] += 1
            elif op.kind == "branch":
                if op.fn(sh, rg):
                    if op.reset:
                        regs[i] = {}
                        pending[i].clear()
                    pcs[i] = labels[op.goto]
                else:
                    pcs[i] += 1
            elif op.kind == "chk":
                msg = op.fn(sh, rg)
                if msg:
                    flag(msg)
                elif op.commits:
                    for v, wvc, wproc in pending[i]:
                        if wproc not in (-1, i) and not _hb(wvc, vc[i]):
                            flag(f"race: process {i} COMMITTED a "
                                 f"speculative read of {v!r} whose "
                                 f"producing write (process {wproc}) it "
                                 f"does not happen-after")
                    pending[i].clear()
                pcs[i] += 1
    return races


# ---------------------------------------------------------------------------
# the three legacy protocols, re-expressed in the language
# ---------------------------------------------------------------------------


def seqlock_spec(bug: Optional[str] = None, deposits: int = 2,
                 words: int = 2) -> ProtoSpec:
    """The mailbox slot seqlock: locked writer with odd/even publish, one
    wait-free bracketed reader.  ``bug`` in {"early_publish", "no_odd",
    "no_validate"} builds the seeded-bug variants (each must fire)."""
    shared = {"lock": 0, "seq": 0}
    shared.update({f"w{k}": 0 for k in range(words)})

    wops: List[object] = []
    for dep in range(deposits):
        v = dep + 1
        body: List[Op] = [acquire("lock", doc="acquire_lock")]
        bump = rmw(lambda sh, rg: {"seq": sh["seq"] + 1}, reads=("seq",))
        if bug != "no_odd":
            body.append(dataclasses.replace(bump, doc="seq_to_odd"))
        payload = [w(f"w{k}", v, doc="mutate_payload") for k in range(words)]
        publish = [dataclasses.replace(bump, doc="seq_to_even")]
        body += (publish + payload if bug == "early_publish"
                 else payload + publish)
        body.append(w("lock", 0, doc="release_lock"))
        wops += body
    if bug is None:
        per_dep = wops[:len(wops) // deposits]
        assert _collapsed_docs(per_dep) == SEQLOCK_WRITER_STEPS, (
            "unified seqlock spec drifted from "
            "shm_native.SEQLOCK_WRITER_STEPS")

    rops: List[object] = [
        Label("retry"),
        rd_when("before", "seq", lambda sh, rg: sh["seq"] % 2 == 0,
                doc="read_seq_before_retry_if_odd"),
    ]
    rops += [rd(f"r{k}", f"w{k}", spec=True, doc="copy_payload")
             for k in range(words)]
    if bug != "no_validate":
        rops.append(branch(lambda sh, rg: sh["seq"] != rg["before"],
                           goto="retry", reads=("seq",), reset=True,
                           doc="read_seq_after_retry_if_changed"))

    def torn(sh, rg, words=words):
        vals = {rg[f"r{k}"] for k in range(words)}
        if len(vals) > 1:
            return f"torn read: completed snapshot mixes {sorted(vals)}"
        return None

    rops.append(chk(torn, commits=True))
    return ProtoSpec(name=f"u-seqlock[{bug or 'healthy'}]", shared=shared,
                     procs=[Proc(wops), Proc(rops)],
                     sync=("lock", "seq"),
                     data=tuple(f"w{k}" for k in range(words)))


def chunk_ring_spec(bug: Optional[str] = None, nchunks: int = 2,
                    deposits: int = 2, words: int = 2,
                    frontier: bool = False) -> ProtoSpec:
    """The v2 chunk ring: per-chunk seqlocks committed in ascending
    order.  ``bug`` in {"no_fence", "descending"}; ``frontier=True``
    swaps the bracketed per-chunk reader for the pipelined
    commit-frontier consumer (the one that needs the ascending order)."""
    shared: Dict = {}
    for c in range(nchunks):
        shared[f"cs{c}"] = 0
        shared.update({f"c{c}w{k}": 0 for k in range(words)})

    wops: List[object] = []
    for dep in range(deposits):
        v = dep + 1
        order = (range(nchunks - 1, -1, -1) if bug == "descending"
                 else range(nchunks))
        for c in order:
            bump = rmw(lambda sh, rg, c=c: {f"cs{c}": sh[f"cs{c}"] + 1},
                       reads=(f"cs{c}",))
            mutate = [w(f"c{c}w{k}", v, doc="mutate_chunk")
                      for k in range(words)]
            publish = [dataclasses.replace(bump, doc="chunk_seq_to_even")]
            body = [dataclasses.replace(bump, doc="chunk_seq_to_odd")]
            body += (publish + mutate if bug == "no_fence"
                     else mutate + publish)
            wops += body
    if bug is None:
        per_chunk = wops[:len(wops) // (deposits * nchunks)]
        assert _collapsed_docs(per_chunk) == CHUNK_WRITER_STEPS, (
            "unified chunk spec drifted from shm_native.CHUNK_WRITER_STEPS")

    rops: List[object] = []
    if frontier:
        last = nchunks - 1

        def at_frontier(sh, rg, last=last):
            s = sh[f"cs{last}"]
            return s % 2 == 0 and s >= 2

        rops.append(rd_when("dlast", f"cs{last}", at_frontier))
        for c in range(nchunks):
            def ordered(sh, rg, c=c, words=words, last=last):
                d = rg["dlast"] // 2
                lo = min(sh[f"c{c}w{k}"] for k in range(words))
                if lo < d:
                    return (f"commit frontier violated: chunk {last} shows "
                            f"episode {d} committed but chunk {c} still "
                            f"carries episode {lo}")
                return None

            rops.append(chk(ordered,
                            reads=tuple(f"c{c}w{k}" for k in range(words))))
    else:
        for c in range(nchunks):
            lbl = f"retry{c}"
            rops.append(Label(lbl))
            rops.append(rd_when("before", f"cs{c}",
                                lambda sh, rg, c=c: sh[f"cs{c}"] % 2 == 0))
            rops += [rd(f"r{k}", f"c{c}w{k}", spec=True)
                     for k in range(words)]
            rops.append(branch(
                lambda sh, rg, c=c: sh[f"cs{c}"] != rg["before"],
                goto=lbl, reads=(f"cs{c}",), reset=True))

            def torn(sh, rg, c=c, words=words):
                vals = {rg[f"r{k}"] for k in range(words)}
                if len(vals) > 1:
                    return (f"torn chunk {c}: completed bracket mixes "
                            f"episodes {sorted(vals)}")
                return None

            rops.append(chk(torn, commits=True))
    return ProtoSpec(
        name=f"u-chunk-ring[{bug or 'healthy'}"
             f"{'+frontier' if frontier else ''}]",
        shared=shared, procs=[Proc(wops), Proc(rops)],
        sync=tuple(f"cs{c}" for c in range(nchunks)),
        data=tuple(f"c{c}w{k}" for c in range(nchunks)
                   for k in range(words)))


def drain_spec(bug: Optional[str] = None, deposits: int = 2) -> ProtoSpec:
    """The v2 O(1) drained-marker collect racing an accumulating writer;
    final mass conservation.  ``bug="lockfree_sample"`` samples the
    logical mass outside the critical section (the seeded bug)."""
    shared = {"lock": 0, "m": 0, "version": 0, "drained": 0, "collected": 0}

    def logical(sh) -> int:
        return 0 if sh["drained"] == sh["version"] else sh["m"]

    wops: List[object] = []
    for _dep in range(deposits):
        wops += [
            acquire("lock"),
            rmw(lambda sh, rg: {"m": logical(sh) + 1,
                                "version": sh["version"] + 1},
                reads=("m", "version", "drained")),
            release("lock"),
        ]

    cops: List[object]
    if bug == "lockfree_sample":
        cops = [
            rdf("got", lambda sh, rg: logical(sh),
                reads=("m", "version", "drained")),
            acquire("lock"),
            rmw(lambda sh, rg: {"collected": sh["collected"] + rg["got"],
                                "drained": sh["version"]},
                reads=("version",)),
            release("lock"),
        ]
    else:
        cops = [
            acquire("lock"),
            rmw(lambda sh, rg: {"collected": sh["collected"] + logical(sh),
                                "drained": sh["version"]},
                reads=("m", "version", "drained")),
            release("lock"),
        ]

    def conserved(sh) -> Optional[str]:
        if sh["collected"] + logical(sh) != deposits:
            return (f"lost deposit: {deposits} deposited but "
                    f"collected={sh['collected']} + "
                    f"logical-remaining={logical(sh)}")
        return None

    return ProtoSpec(name=f"u-drain[{bug or 'healthy'}]", shared=shared,
                     procs=[Proc(wops), Proc(cops)],
                     sync=("lock",), data=("m", "version", "drained"),
                     final=conserved)


# ---------------------------------------------------------------------------
# new coverage: the progress-engine queue and the serve death matrix
# ---------------------------------------------------------------------------


def progress_queue_spec(bug: Optional[str] = None,
                        handles: int = 3) -> ProtoSpec:
    """The async progress engine's submit queue at small bounds: one
    submitter enqueuing ``handles`` handles, one worker executing them,
    one quiescer parking the engine mid-stream.

    Invariants (the engine contract the progress family lints on
    traces, here proved over every interleaving): every handle executes
    exactly once, in submit order, and NOTHING executes while parked.
    ``bug`` in {"runs_while_parked", "double_execute"}."""
    shared = {"lock": 0, "parked": 0, "head": 0, "tail": 0, "snap": 0}
    shared.update({f"q{k}": 0 for k in range(handles)})
    shared.update({f"done{h}": 0 for h in range(1, handles + 1)})

    sops: List[object] = []
    for h in range(1, handles + 1):
        sops += [
            acquire("lock"),
            rmw(lambda sh, rg, h=h: {f"q{sh['tail']}": h,
                                     "tail": sh["tail"] + 1},
                reads=("tail",), doc="enqueue"),
            release("lock"),
        ]

    wops: List[object] = []
    for it in range(handles):
        def runnable(sh, rg, bug=bug):
            if sh["head"] >= sh["tail"]:
                return False
            return bug == "runs_while_parked" or sh["parked"] == 0

        skip_bump = bug == "double_execute" and it == 0
        wops += [
            acquire_when(runnable, reads=("head", "tail", "parked"),
                         doc="claim"),
            rdf("h", lambda sh, rg: sh[f"q{sh['head']}"],
                reads=("head",) + tuple(f"q{k}" for k in range(handles))),
            chk(lambda sh, rg: None if rg["h"] == rg.get("last", 0) + 1
                else (f"out-of-order execution: handle {rg['h']} ran "
                      f"after {rg.get('last', 0)}"),
                doc="order"),
            rmw(lambda sh, rg, skip=skip_bump: {
                    f"done{rg['h']}": sh[f"done{rg['h']}"] + 1,
                    "head": sh["head"] + (0 if skip else 1),
                    "ran_parked": max(sh.get("ran_parked", 0),
                                      sh["parked"])},
                reads=("head", "parked"), doc="execute"),
            rdf("last", lambda sh, rg: rg["h"]),
            release("lock"),
        ]
    shared["ran_parked"] = 0

    qops: List[object] = [
        acquire("lock"),
        rmw(lambda sh, rg: {"parked": 1,
                            "snap": sum(sh[f"done{h}"]
                                        for h in range(1, handles + 1))},
            reads=("parked",) + tuple(f"done{h}"
                                      for h in range(1, handles + 1)),
            doc="park"),
        release("lock"),
        acquire("lock"),
        chk(lambda sh, rg: None
            if sum(sh[f"done{h}"] for h in range(1, handles + 1))
            == sh["snap"] and not sh["ran_parked"]
            else "handle executed while the engine was parked",
            doc="quiesce-check"),
        rmw(lambda sh, rg: {"parked": 0}, doc="unpark"),
        release("lock"),
    ]

    def final(sh) -> Optional[str]:
        for h in range(1, handles + 1):
            if sh[f"done{h}"] != 1:
                return (f"handle {h} executed {sh[f'done{h}']} time(s) — "
                        "exactly-once broken")
        if sh["ran_parked"]:
            return "handle executed while the engine was parked"
        return None

    return ProtoSpec(name=f"u-progress-queue[{bug or 'healthy'}]",
                     shared=shared,
                     procs=[Proc(sops), Proc(wops), Proc(qops)],
                     sync=("lock",),
                     data=tuple(f"q{k}" for k in range(handles))
                     + ("head", "tail"),
                     final=final)


def serve_death_spec(bug: Optional[str] = None,
                     rounds: int = 2) -> ProtoSpec:
    """The serving double-buffer under a publisher death matrix.

    ``hdr`` packs (version, active-index) as ``version * 10 + idx`` —
    the single seq_cst word the real region flips.  The publisher writes
    the INACTIVE buffer's canonical bytes (modeled as ``100 + version``)
    and then flips hdr in one step; it may DIE at any op (SIGKILL, no
    cleanup).  The reader brackets its copy with two hdr reads.  A
    completed read must return the canonical bytes of the version its
    bracket pinned — at every death point.  ``bug="flip_before_payload"``
    publishes the flip before the payload lands (the torn-publish bug)."""
    shared = {"hdr": 0, "b0": 100, "b1": 0}

    pops: List[object] = []
    for _r in range(rounds):
        plan = [
            rdf("idx", lambda sh, rg: 1 - sh["hdr"] % 10, reads=("hdr",),
                doc="pick_inactive"),
            rdf("nv", lambda sh, rg: sh["hdr"] // 10 + 1, reads=("hdr",)),
            rmw(lambda sh, rg: {f"b{rg['idx']}": 100 + rg["nv"]},
                doc="write_payload"),
            rmw(lambda sh, rg: {"hdr": rg["nv"] * 10 + rg["idx"]},
                reads=("hdr",), doc="flip"),
        ]
        if bug == "flip_before_payload":
            plan[2], plan[3] = plan[3], plan[2]
        pops += plan

    rops: List[object] = [
        Label("retry"),
        rd("h1", "hdr"),
        rdf("x", lambda sh, rg: sh[f"b{rg['h1'] % 10}"],
            reads=("b0", "b1"),
            reads_fn=lambda sh, rg: (f"b{rg['h1'] % 10}",),
            spec=True, doc="copy_active"),
        branch(lambda sh, rg: sh["hdr"] != rg["h1"], goto="retry",
               reads=("hdr",), reset=True, doc="revalidate"),
        chk(lambda sh, rg: None if rg["x"] == 100 + rg["h1"] // 10
            else (f"completed read returned {rg['x']} for committed "
                  f"version {rg['h1'] // 10} (canonical "
                  f"{100 + rg['h1'] // 10}) — uncommitted/torn bytes "
                  "served"),
            commits=True, doc="canonical"),
    ]

    return ProtoSpec(name=f"u-serve-death[{bug or 'healthy'}]",
                     shared=shared,
                     procs=[Proc(pops, dying=True), Proc(rops)],
                     sync=("hdr",), data=("b0", "b1"))


# ---------------------------------------------------------------------------
# subsumption matrix + registered rules
# ---------------------------------------------------------------------------

#: (label, legacy model factory, unified spec factory, must_fire) — the
#: unified explorer must agree with the legacy model on every row, clean
#: AND seeded-bug builds both.
SUBSUMPTION: Tuple[Tuple[str, Callable[[], Model],
                         Callable[[], ProtoSpec], bool], ...] = (
    ("seqlock healthy", lambda: seqlock_model(),
     lambda: seqlock_spec(), False),
    ("seqlock early-publish", lambda: seqlock_model(early_publish=True),
     lambda: seqlock_spec("early_publish"), True),
    ("seqlock no-odd-phase", lambda: seqlock_model(odd_phase=False),
     lambda: seqlock_spec("no_odd"), True),
    ("seqlock no-validate",
     lambda: seqlock_model(reader_checks_after=False),
     lambda: seqlock_spec("no_validate"), True),
    ("chunk-ring healthy", lambda: chunk_ring_model(),
     lambda: chunk_ring_spec(), False),
    ("chunk-ring no-fence", lambda: chunk_ring_model(commit_fence=False),
     lambda: chunk_ring_spec("no_fence"), True),
    ("chunk-ring descending",
     lambda: chunk_ring_model(in_order_commit=False, words=1,
                              frontier_reader=True),
     lambda: chunk_ring_spec("descending", words=1, frontier=True), True),
    ("chunk-ring frontier healthy",
     lambda: chunk_ring_model(words=1, frontier_reader=True),
     lambda: chunk_ring_spec(words=1, frontier=True), False),
    ("drained-collect healthy", lambda: drained_collect_model(),
     lambda: drain_spec(), False),
    ("drained-collect lock-free sample",
     lambda: drained_collect_model(atomic_collect=False),
     lambda: drain_spec("lockfree_sample"), True),
)


@registry.rule("interleave.unified-explorer", "interleave",
               "every protocol spec written in the unified op language "
               "explores clean: seqlock, chunk ring (both readers), "
               "drained collect, progress queue, serve death matrix")
def _run_unified(report: Report) -> None:
    healthy = (
        seqlock_spec(),
        chunk_ring_spec(),
        chunk_ring_spec(words=1, frontier=True),
        drain_spec(),
        progress_queue_spec(),
        serve_death_spec(),
    )
    for spec in healthy:
        report.subjects_checked += 1
        for msg in verdict(spec):
            report.add(Finding("interleave.unified-explorer", spec.name,
                               msg))


@registry.rule("interleave.subsumes-legacy", "interleave",
               "the unified explorer's verdict matches the three legacy "
               "models on healthy AND seeded-bug builds — the old "
               "checkers are provably subsumed")
def _run_subsumption(report: Report) -> None:
    for label, legacy_fn, unified_fn, must_fire in SUBSUMPTION:
        report.subjects_checked += 1
        legacy_fired = bool(explore(legacy_fn()))
        unified_fired = bool(verdict(unified_fn()))
        if legacy_fired != unified_fired:
            report.add(Finding(
                "interleave.subsumes-legacy", label,
                f"verdict split: legacy model "
                f"{'fires' if legacy_fired else 'is clean'} but the "
                f"unified spec "
                f"{'fires' if unified_fired else 'is clean'}"))
        if unified_fired != must_fire:
            report.add(Finding(
                "interleave.subsumes-legacy", label,
                f"expected the unified spec to "
                f"{'fire' if must_fire else 'stay clean'} but it "
                f"{'fired' if unified_fired else 'stayed clean'}"))


@registry.rule("interleave.race-scan", "interleave",
               "the vector-clock happens-before scan: healthy specs are "
               "race-free over pinned seeds, and the planted "
               "early-publish bug IS caught (the scan has teeth)")
def _run_race_scan(report: Report) -> None:
    for spec in (seqlock_spec(), chunk_ring_spec(), drain_spec(),
                 progress_queue_spec(), serve_death_spec()):
        report.subjects_checked += 1
        for msg in race_scan(spec):
            report.add(Finding("interleave.race-scan", spec.name,
                               f"unexpected race in a healthy spec: "
                               f"{msg}"))
    report.subjects_checked += 1
    planted = race_scan(seqlock_spec("early_publish"))
    if not planted:
        report.add(Finding(
            "interleave.race-scan", "u-seqlock[early_publish]",
            "planted early-publish bug produced NO race/violation — "
            "the happens-before scan lost its teeth"))


def selftest_interleave() -> List[Tuple[str, bool, str]]:
    """The --self-test arm: every seeded-bug spec must make the unified
    explorer fire; the healthy builds must stay clean."""
    rows: List[Tuple[str, bool, str]] = []
    for label, _legacy_fn, unified_fn, must_fire in SUBSUMPTION:
        fired = bool(verdict(unified_fn()))
        ok = fired == must_fire
        rows.append((f"unified {label}", ok,
                     ("fires" if fired else "clean")
                     + ("" if ok else " — UNEXPECTED")))
    for bug in ("runs_while_parked", "double_execute"):
        fired = bool(verdict(progress_queue_spec(bug)))
        rows.append((f"progress-queue {bug}", fired,
                     "caught" if fired else "NOT caught"))
    fired = bool(verdict(serve_death_spec("flip_before_payload")))
    rows.append(("serve flip-before-payload", fired,
                 "caught" if fired else "NOT caught"))
    fired = bool(race_scan(seqlock_spec("early_publish")))
    rows.append(("race-scan early-publish", fired,
                 "caught" if fired else "NOT caught"))
    return rows
