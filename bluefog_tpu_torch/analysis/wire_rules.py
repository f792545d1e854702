"""Rule family: the ONE wire protocol, model-checked for both carriers.

PR "one wire protocol everywhere" ported the shm v2 chunk state machine
to the TCP transport: chunked deposits streamed under a credit window,
ascending chunk commits, version/mass advancing only at the commit
frame, a drained-marker collect, and a dead-writer drain run by the
disconnect handler.  :mod:`seqlock_model` already proves the shm side;
this family proves the properties that are NEW on the socket carrier —
and pins both transports to one shared protocol spec so they cannot
drift apart silently.

Models (same explicit-state explorer as :mod:`seqlock_model`):

- **chunk stream integrity** — a commit that checks only the chunk
  COUNT accepts a stream where one chunk was duplicated and another
  lost (the out-of-order/duplication race a multiplexed carrier can
  produce); the ascending-index check (``TCP_CHUNK_COMMIT_IN_ORDER``)
  refuses such a stream before it can commit a hole.
- **credit window liveness** — the server must ack EVERY chunk frame
  (the sender's flow-control credit); a receiver that acks only at
  commit deadlocks any deposit with more chunks than the window
  (sender blocked on a credit, receiver blocked on the commit frame).
- **error-feedback residual conservation** —
  ``sum(delivered) + residual == sum(inputs)`` at every step; the
  residual must survive edge DEMOTION (a paused edge flushes the carry
  on its next deposit) — zeroing it there silently destroys value mass
  that the quantizer had borrowed.
- **mid-stream writer death** — the disconnect drain
  (``TCP_DEAD_WRITER_DRAIN_STEPS``) conserves committed mass and never
  strands a reader waiting on an odd ``wseq``; committing at stream
  OPEN instead of at the commit frame (the seeded bug) lets a torn
  deposit become visible.
- **spec parity** — the TCP protocol constants must equal shm_native's
  and both transports must share one chunk geometry.

Seeded-bug variants feed the fixture corpus (``--self-test``): each
must make its checker fire.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.seqlock_model import (
    Model,
    _s,
    check_model,
)

__all__ = [
    "chunk_stream_model",
    "credit_window_model",
    "residual_feedback_model",
    "stream_death_model",
    "check_spec_parity",
]


# ---------------------------------------------------------------------------
# model 1: chunk stream integrity (ascending commit vs count-only commit)
# ---------------------------------------------------------------------------


def chunk_stream_model(nchunks: int = 3, writer_in_order: bool = True,
                       enforce_order: Optional[bool] = None) -> Model:
    """A writer streams ``nchunks`` chunk frames through a FIFO and then
    commits; the server applies each frame into the slot.

    ``writer_in_order=False`` seeds the duplication race: the writer
    emits chunk 0 twice and never emits chunk 1 — the chunk COUNT still
    matches, so a server that validates only the count commits a slot
    with a hole (stale bytes where chunk 1 should be).  The ascending
    check (``enforce_order``, the implementation's
    ``TCP_CHUNK_COMMIT_IN_ORDER`` behaviour: expected-index mismatch
    drops the connection) refuses the stream before commit, so the
    deposit dies with zero mass instead of committing torn.
    """
    if enforce_order is None:
        from bluefog_tpu_torch.native.tcp_transport import TCP_CHUNK_COMMIT_IN_ORDER
        enforce_order = TCP_CHUNK_COMMIT_IN_ORDER

    idxs = list(range(nchunks))
    if not writer_in_order:
        idxs[1] = idxs[0]  # duplicate chunk 0, lose chunk 1 — count intact

    shared = {"q": (), "slot": (0,) * nchunks, "refused": 0,
              "committed": 0, "commit_sent": 0}

    writer: List[Callable] = []
    for i, idx in enumerate(idxs):
        def send(sh, rg, idx=idx, nxt=i + 1):
            return _s(sh, rg, nxt, q=sh["q"] + (idx,))
        writer.append(send)

    def send_commit(sh, rg, nxt=len(idxs) + 1):
        return _s(sh, rg, nxt, commit_sent=1)
    writer.append(send_commit)

    server: List[Callable] = []
    for i in range(nchunks):
        def apply_chunk(sh, rg, expected=i, nxt=i + 1):
            if sh["refused"]:
                return [(sh, rg, nchunks + 1)]  # stream dropped
            if not sh["q"]:
                return []  # nothing arrived yet
            idx, rest = sh["q"][0], sh["q"][1:]
            if enforce_order and idx != expected:
                # the ascending check: drop the stream, never commit
                return _s(sh, rg, nchunks + 1, q=rest, refused=1)
            slot = list(sh["slot"])
            slot[idx] = idx + 1  # chunk idx's payload value
            return _s(sh, rg, nxt, q=rest, slot=tuple(slot))
        server.append(apply_chunk)

    def apply_commit(sh, rg, nxt=nchunks + 1):
        if sh["refused"]:
            return [(sh, rg, nxt)]
        if not sh["commit_sent"]:
            return []
        return _s(sh, rg, nxt, committed=1)
    server.append(apply_commit)

    def complete(sh) -> Optional[str]:
        if sh["committed"] and any(w == 0 for w in sh["slot"]):
            holes = [i for i, w in enumerate(sh["slot"]) if w == 0]
            return (f"deposit committed with hole(s) at chunk {holes} — "
                    "a duplicated/reordered stream passed the count-only "
                    "commit check (ascending chunk commit required)")
        return None

    return Model(name="chunk-stream", shared=shared,
                 programs=[writer, server], final_check=complete)


# ---------------------------------------------------------------------------
# model 2: credit-window liveness (per-chunk acks vs ack-at-commit)
# ---------------------------------------------------------------------------


def credit_window_model(nchunks: int = 3, window: int = 1,
                        ack_per_chunk: bool = True) -> Model:
    """The pipelined sender keeps at most ``window`` unacked chunk
    frames outstanding; the server processes frames and (correctly)
    acks each one — the flow-control credit.

    ``ack_per_chunk=False`` seeds the deadlock: a server that acks only
    at commit starves the sender of credits once
    ``nchunks > window`` — the sender blocks waiting for an ack before
    chunk ``window``+1, the server blocks waiting for the commit frame,
    and the explorer's deadlock detector fires (lost wakeup shape).
    """
    shared = {"sent": 0, "acked": 0, "delivered": 0,
              "commit_sent": 0, "committed": 0}

    sender: List[Callable] = []
    for i in range(nchunks):
        def send_chunk(sh, rg, nxt=i + 1):
            if sh["sent"] - sh["acked"] >= window:
                return []  # out of credit: wait for one ack
            return _s(sh, rg, nxt, sent=sh["sent"] + 1)
        sender.append(send_chunk)

    def send_commit(sh, rg, nxt=nchunks + 1):
        return _s(sh, rg, nxt, commit_sent=1)
    sender.append(send_commit)

    def drain_acks(sh, rg, nxt=nchunks + 2):
        if sh["acked"] < sh["sent"] or not sh["committed"]:
            return []  # collect every credit + the commit ack
        return [(sh, rg, nxt)]
    sender.append(drain_acks)

    server: List[Callable] = []
    for i in range(nchunks):
        def recv_chunk(sh, rg, nxt=i + 1):
            if sh["delivered"] >= sh["sent"]:
                return []  # frame not here yet
            upd = {"delivered": sh["delivered"] + 1}
            if ack_per_chunk:
                upd["acked"] = sh["acked"] + 1
            return _s(sh, rg, nxt, **upd)
        server.append(recv_chunk)

    def recv_commit(sh, rg, nxt=nchunks + 1):
        if not sh["commit_sent"]:
            return []
        upd = {"committed": 1}
        if not ack_per_chunk:
            upd["acked"] = sh["delivered"]  # the deferred bulk ack
        return _s(sh, rg, nxt, **upd)
    server.append(recv_commit)

    def done(sh) -> Optional[str]:
        if not sh["committed"]:
            return "deposit never committed"
        return None

    return Model(name="credit-window", shared=shared,
                 programs=[sender, server], final_check=done)


# ---------------------------------------------------------------------------
# model 3: error-feedback residual conservation across demotion
# ---------------------------------------------------------------------------


def residual_feedback_model(rounds: int = 3,
                            drop_on_demote: bool = False) -> Model:
    """Integer miniature of the EF quantizer: each round folds the
    residual into the outgoing value, ships ``floor((x+r)/Q)*Q`` down
    the wire, and carries the remainder.  The invariant —
    ``delivered + residual == inputs`` — is checked at EVERY step, over
    every interleaving with an adaptive-topology DEMOTE event.

    ``drop_on_demote=True`` seeds the bug this family exists to catch:
    zeroing the per-edge residual when the edge is demoted.  Demotion
    merely PAUSES an edge (the peer is alive; promotion resumes it), so
    the carry must survive and flush on the next deposit — dropping it
    silently destroys the value mass the quantizer had borrowed.
    """
    Q, X = 2, 3  # quantum and per-round input: 3 = 2 + carry 1
    shared = {"r": 0, "inputs": 0, "delivered": 0, "demoted": 0}

    sender: List[Callable] = []
    for i in range(rounds):
        def send_round(sh, rg, nxt=i + 1):
            buf = X + sh["r"]
            q = (buf // Q) * Q
            sh2 = dict(sh, inputs=sh["inputs"] + X,
                       delivered=sh["delivered"] + q, r=buf - q)
            if sh2["delivered"] + sh2["r"] != sh2["inputs"]:
                sh2["_bad"] = (
                    f"error-feedback residual lost: delivered="
                    f"{sh2['delivered']} + residual={sh2['r']} != "
                    f"inputs={sh2['inputs']}")
            return [(sh2, rg, nxt)]
        sender.append(send_round)

    def demote(sh, rg):
        # the adaptive layer may demote the edge between ANY two rounds
        upd = {"demoted": 1}
        if drop_on_demote:
            upd["r"] = 0  # seeded bug: the carry dies with the demotion
        return _s(sh, rg, 1, **upd)

    def conserved(sh) -> Optional[str]:
        if sh["delivered"] + sh["r"] != sh["inputs"]:
            return (f"error-feedback residual lost across demotion: "
                    f"delivered={sh['delivered']} + residual={sh['r']} "
                    f"!= inputs={sh['inputs']} — the residual must "
                    "survive demote (the edge is paused, not dead)")
        return None

    return Model(name="residual-feedback", shared=shared,
                 programs=[sender, [demote]], final_check=conserved)


# ---------------------------------------------------------------------------
# model 4: mid-stream writer death (the disconnect drain)
# ---------------------------------------------------------------------------


def stream_death_model(nchunks: int = 2,
                       commits_after_payload: Optional[bool] = None,
                       drain_evenizes: bool = True) -> Model:
    """A TCP writer streams ``nchunks`` chunk frames then commits, and
    may DIE (SIGKILL — connection drops, no cleanup) at any step.  The
    owner reads (waiting while ``wseq`` is odd) and, on death, the
    disconnect handler runs ``TCP_DEAD_WRITER_DRAIN_STEPS``.

    Properties over every death point and interleaving:

    - **no unbacked mass** (``commits_after_payload=False`` seeds the
      bug): the version/mass must advance only at the commit frame,
      after every chunk landed — committing at stream OPEN lets the
      owner collect a deposit whose payload never fully arrived;
    - **no lost committed mass**: collected + wiped + logical ==
      committed, with the drain charging in-transit mass to the dead
      rank's ledger;
    - **no stranded reader** (``drain_evenizes=False`` seeds the bug):
      the drain must make ``wseq`` even again, or a reader waiting out
      the stream spins forever — the deadlock detector fires.
    """
    if commits_after_payload is None:
        from bluefog_tpu_torch.native.tcp_transport import (
            TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD,
        )
        commits_after_payload = TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD

    # chunk-granular accounting: paid counts chunks written, committed/m
    # count chunks made visible (a whole deposit = nchunks units)
    shared = {"wseq_odd": 0, "m": 0, "version": 0, "drained": 0,
              "dead": 0, "wdone": 0, "paid": 0, "committed": 0,
              "collected": 0, "wiped": 0}

    def logical(sh) -> int:
        return 0 if sh["drained"] == sh["version"] else sh["m"]

    def dying(step):
        def wrapped(sh, rg):
            succ = list(step(sh, rg))
            succ.extend(_s(sh, rg, 10_000, dead=1))
            return succ
        return wrapped

    writer: List[Callable] = []

    def w_open(sh, rg, nxt=1):
        return _s(sh, rg, nxt, wseq_odd=1,
                  # seeded bug: visibility granted at stream open
                  **({} if commits_after_payload
                     else {"m": nchunks, "version": sh["version"] + 1,
                           "committed": sh["committed"] + nchunks}))
    writer.append(dying(w_open))

    for i in range(nchunks):
        def w_chunk(sh, rg, nxt=i + 2):
            return _s(sh, rg, nxt, paid=sh["paid"] + 1)
        writer.append(dying(w_chunk))

    def w_commit(sh, rg, nxt=nchunks + 2):
        upd = {"wseq_odd": 0}
        if commits_after_payload:
            upd.update(m=nchunks, version=sh["version"] + 1,
                       committed=sh["committed"] + nchunks)
        return _s(sh, rg, nxt, **upd)
    writer.append(dying(w_commit))

    def w_linger(sh, rg, nxt=nchunks + 3):
        # the writer may still die AFTER the commit (connection drops
        # later) — the drain must then conserve the committed deposit
        return _s(sh, rg, nxt, wdone=1)
    writer.append(dying(w_linger))

    # the reader: _await_settled blocks while the stream is open; it
    # relies on the DRAINER (a separate actor — the server's disconnect
    # handler, not the reader itself) to evenize wseq on writer death
    def o_collect(sh, rg, nxt=1):
        if sh["wseq_odd"]:
            return []  # a drain that forgot to evenize strands us HERE
        return _s(sh, rg, nxt, collected=sh["collected"] + logical(sh),
                  drained=sh["version"])

    def d_drain(sh, rg, nxt=1):
        if sh["dead"]:
            # the disconnect handler: 1. evenize_wseq  2. mark_drained
            # (wipe accounted)  3. clear_stream (stream key dropped)
            upd = {"drained": sh["version"],
                   "wiped": sh["wiped"] + logical(sh)}
            if drain_evenizes:
                upd["wseq_odd"] = 0
            return _s(sh, rg, nxt, **upd)
        if sh["wdone"]:
            return [(sh, rg, nxt)]  # writer exited cleanly: nothing to do
        return []  # connection still up: wait for EOF or clean close

    owner = [o_collect]
    drainer = [d_drain]

    def conserved(sh) -> Optional[str]:
        if sh["committed"] > sh["paid"]:
            return (f"unbacked mass: {sh['committed']} chunk-unit(s) "
                    f"visible but only {sh['paid']} chunk(s) landed — "
                    "the deposit must commit at the COMMIT frame, after "
                    "the payload")
        if sh["collected"] + sh["wiped"] + logical(sh) != sh["committed"]:
            return (f"lost deposit: committed={sh['committed']} but "
                    f"collected={sh['collected']} + wiped={sh['wiped']} "
                    f"+ logical={logical(sh)}")
        return None

    return Model(name="stream-death", shared=shared,
                 programs=[writer, owner, drainer], final_check=conserved)


# ---------------------------------------------------------------------------
# spec parity: one protocol, two carriers
# ---------------------------------------------------------------------------


def check_spec_parity(report: Optional[Report] = None,
                      rule: str = "wire.spec-parity") -> Report:
    """The TCP transport's protocol constants must equal shm_native's,
    the dead-writer drain must mark-drained before clearing in BOTH,
    and the two carriers must share one chunk geometry."""
    from bluefog_tpu_torch.native import shm_native, tcp_transport

    report = report if report is not None else Report()
    report.subjects_checked += 1
    pairs = [
        ("CHUNK_COMMIT_IN_ORDER",
         tcp_transport.TCP_CHUNK_COMMIT_IN_ORDER,
         shm_native.CHUNK_COMMIT_IN_ORDER),
        ("DEPOSIT_COMMITS_AFTER_PAYLOAD",
         tcp_transport.TCP_DEPOSIT_COMMITS_AFTER_PAYLOAD,
         shm_native.DEPOSIT_COMMITS_AFTER_PAYLOAD),
        ("DRAINED_COLLECT_IS_ATOMIC",
         tcp_transport.TCP_DRAINED_COLLECT_IS_ATOMIC,
         shm_native.DRAINED_COLLECT_IS_ATOMIC),
    ]
    for name, tcp_v, shm_v in pairs:
        if tcp_v != shm_v:
            report.add(Finding(
                rule, "tcp-vs-shm",
                f"protocol constant drift: TCP_{name}={tcp_v} but "
                f"shm {name}={shm_v} — one wire protocol, two carriers"))
    for steps, clear in (
            (tcp_transport.TCP_DEAD_WRITER_DRAIN_STEPS, "clear_stream"),
            (shm_native.DEAD_WRITER_DRAIN_STEPS, "clear_lock")):
        if "mark_drained" not in steps or clear not in steps \
                or steps.index("mark_drained") > steps.index(clear):
            report.add(Finding(
                rule, "drain-order",
                f"dead-writer drain {steps} must mark_drained before "
                f"{clear} — nobody may slip into a half-drained slot"))
    if tcp_transport._chunk_bytes() != shm_native.chunk_bytes():
        report.add(Finding(
            rule, "chunk-geometry",
            "TCP and shm disagree on chunk size — the stream framing "
            "must follow BLUEFOG_SHM_CHUNK_BYTES on both carriers"))
    return report


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


@registry.rule("wire.chunk-stream-order", "wire",
               "the ascending chunk-commit check refuses a "
               "duplicated/reordered stream before it can commit a hole")
def _run_chunk_stream(report: Report) -> None:
    for nchunks in (2, 3):
        check_model(chunk_stream_model(nchunks=nchunks), report,
                    rule="wire.chunk-stream-order")
    # the enforcing server must also neutralize a buggy writer: refused
    # streams never commit (zero findings = the check works)
    check_model(chunk_stream_model(nchunks=3, writer_in_order=False,
                                   enforce_order=True),
                report, rule="wire.chunk-stream-order")


@registry.rule("wire.credit-window", "wire",
               "per-chunk acks keep the pipelined sender live for every "
               "deposit size vs window setting")
def _run_credit_window(report: Report) -> None:
    for nchunks, window in ((2, 1), (3, 1), (3, 2), (2, 4)):
        check_model(credit_window_model(nchunks=nchunks, window=window),
                    report, rule="wire.credit-window")


@registry.rule("wire.residual-conservation", "wire",
               "the error-feedback residual conserves value mass at "
               "every step, across edge demotion")
def _run_residual(report: Report) -> None:
    for rounds in (2, 3, 4):
        check_model(residual_feedback_model(rounds=rounds), report,
                    rule="wire.residual-conservation")


@registry.rule("wire.stream-death-drain", "wire",
               "a TCP writer dying mid-chunk-stream: the disconnect "
               "drain conserves committed mass and frees waiting readers")
def _run_stream_death(report: Report) -> None:
    for nchunks in (1, 2, 3):
        check_model(stream_death_model(nchunks=nchunks), report,
                    rule="wire.stream-death-drain")


@registry.rule("wire.spec-parity", "wire",
               "TCP and shm expose identical protocol spec constants "
               "and one chunk geometry")
def _run_spec_parity(report: Report) -> None:
    check_spec_parity(report, rule="wire.spec-parity")
