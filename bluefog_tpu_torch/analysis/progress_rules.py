"""Rule family: the async progress engine's queue state machine.

:mod:`bluefog_tpu_torch.progress` promises three invariants (engine.py module
docstring) that nothing in the type system enforces:

- **queue-state-machine** — every submitted op resolves its handle
  exactly once, no op executes while the engine is quiesced, and a
  quiesce/resume cycle loses nothing: the parked queue replays intact.
  Checked by driving a REAL manual-mode :class:`ProgressEngine` through
  every bounded interleaving of submit/step/quiesce/resume (exhaustive
  at small bounds, the seqlock-model playbook).
- **handle-lifecycle** — a :class:`WinHandle` resolves at most once and
  is only observed (``result``) after it resolved.  Checked as a trace
  lint over handle event sequences.
- **fusion-order** — coalescing preserves per-window submission order:
  a batch is a CONTIGUOUS run of queue-front ops sharing kind, window,
  and weights, within the byte budget; ``update`` never fuses.  Checked
  against the batches a real engine actually pops (the recording
  backend's ``fuse`` concatenates op tags, so each execute call exposes
  its batch composition).

The fixture corpus seeds the matching bugs: a quiesce that drops the
queue, a handle completed twice, a fuser that reorders across windows.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, Severity, registry
from bluefog_tpu_torch.progress import ProgressEngine

__all__ = ["run_schedule", "check_schedule", "check_handle_events",
           "check_batches", "schedule_corpus", "FUSION_STREAMS"]

_SM = "progress.queue-state-machine"
_HL = "progress.handle-lifecycle"
_FO = "progress.fusion-order"


class _RecordingBackend:
    """Backend whose ``fuse`` concatenates op tags: every ``execute``
    call then records exactly which submitted ops the engine coalesced,
    and in what order."""

    def __init__(self):
        self.batches: List[Tuple[str, str, Tuple[int, ...]]] = []
        self.parked = False           # harness-maintained quiesce mirror
        self.parked_executes = 0

    def execute(self, kind, window, payload, weights, kwargs):
        if self.parked:
            self.parked_executes += 1
        if kind == "update":
            seqs = (int(kwargs.get("seq", -1)),)
        else:
            seqs = tuple(payload) if isinstance(payload, tuple) else ()
        self.batches.append((kind, window, seqs))
        return ("ok", kind, window)

    def fuse(self, kind, window, payloads):
        out: Tuple[int, ...] = ()
        for p in payloads:
            out = out + tuple(p)
        return out


def run_schedule(schedule: Sequence[Any],
                 engine_cls=ProgressEngine,
                 fusion_bytes: int = 1 << 20):
    """Drive one manual-mode engine through ``schedule`` then drain.

    Schedule atoms: ``("put"|"accumulate"|"update", window)`` submits,
    ``"step"`` processes one batch, ``"quiesce"``/``"resume"`` park and
    unpark.  Returns ``(backend, submissions, handles, crashes)`` where
    ``submissions`` is ``[(seq, kind, window, weights, nbytes)]``.
    """
    be = _RecordingBackend()
    eng = engine_cls(be, start_worker=False, queue_depth=64,
                     fusion_bytes=fusion_bytes)
    submissions: List[Tuple[int, str, str, Any, int]] = []
    handles = []
    crashes: List[str] = []
    seq = 0
    for act in schedule:
        try:
            if act == "step":
                eng.step()
            elif act == "quiesce":
                eng.quiesce()
                be.parked = True
            elif act == "resume":
                eng.resume()
                be.parked = False
            else:
                kind, window = act
                if kind == "update":
                    h = eng.submit("update", window, seq=seq)
                    submissions.append((seq, kind, window, None, 0))
                else:
                    h = eng.submit(kind, window, payload=(seq,),
                                   nbytes=8)
                    submissions.append((seq, kind, window, None, 8))
                handles.append((seq, h))
                seq += 1
        except Exception as e:  # noqa: BLE001 - a crash IS a finding
            crashes.append(f"{act!r}: {e!r}")
    eng.resume()
    be.parked = False
    try:
        while eng.step():
            pass
        eng.stop()
    except Exception as e:  # noqa: BLE001
        crashes.append(f"drain: {e!r}")
    return be, submissions, handles, crashes


def check_schedule(schedule: Sequence[Any], subject: str = "schedule",
                   engine_cls=ProgressEngine) -> List[Finding]:
    """Model-check one interleaving against the state-machine contract."""
    be, submissions, handles, crashes = run_schedule(
        schedule, engine_cls=engine_cls)
    findings: List[Finding] = []

    def add(msg: str, severity: str = Severity.ERROR) -> None:
        findings.append(Finding(_SM, subject, msg, severity))

    for c in crashes:
        add(f"engine raised on the caller thread: {c}")
    if be.parked_executes:
        add(f"{be.parked_executes} op(s) executed while quiesced — the "
            "park must gate execution until resume")
    for seq, h in handles:
        if not h.done():
            add(f"op {seq} submitted but its handle never resolved "
                "after a full drain (lost across quiesce/resume?)")
        elif h.exception() is not None:
            add(f"op {seq} failed spuriously: {h.exception()!r}")
    executed = [s for _, _, seqs in be.batches for s in seqs]
    if sorted(executed) != list(range(len(submissions))):
        add(f"executed op set {sorted(executed)} != submitted "
            f"{list(range(len(submissions)))} (dropped or duplicated)")
    else:
        per_window: dict = {}
        for kind, window, seqs in be.batches:
            per_window.setdefault(window, []).extend(seqs)
        for window, seqs in per_window.items():
            if seqs != sorted(seqs):
                add(f"window {window!r} executed out of submission "
                    f"order: {seqs}")
    return findings


def schedule_corpus(length: int = 4) -> List[Tuple[Any, ...]]:
    """Every schedule of ``length`` atoms over the two-window alphabet —
    exhaustive at this bound, the same playbook as the seqlock models."""
    alphabet = (("put", "a"), ("put", "b"), ("update", "a"),
                "step", "quiesce", "resume")
    return list(itertools.product(alphabet, repeat=length))


def check_handle_events(events: Sequence[Tuple[str, str]],
                        subject: str = "events") -> List[Finding]:
    """Lint one handle event trace: ``(handle_id, action)`` with actions
    ``create`` / ``complete`` / ``fail`` / ``result``."""
    findings: List[Finding] = []
    state: dict = {}  # id -> "pending" | "resolved"

    def add(msg: str, severity: str = Severity.ERROR) -> None:
        findings.append(Finding(_HL, subject, msg, severity))

    for i, (hid, action) in enumerate(events):
        if action == "create":
            if hid in state:
                add(f"event {i}: handle {hid!r} created twice",
                    Severity.WARNING)
            state[hid] = "pending"
        elif action in ("complete", "fail"):
            if state.get(hid) == "resolved":
                add(f"event {i}: {action} on already-resolved handle "
                    f"{hid!r} — resolution must happen exactly once")
            elif hid not in state:
                add(f"event {i}: {action} on unknown handle {hid!r}")
            state[hid] = "resolved"
        elif action == "result":
            if state.get(hid) != "resolved":
                add(f"event {i}: result() returned on handle {hid!r} "
                    "before it resolved")
        else:
            add(f"event {i}: unknown action {action!r}", Severity.WARNING)
    return findings


def check_batches(submissions: Sequence[Tuple[int, str, str, Any, int]],
                  batches: Sequence[Tuple[str, str, Tuple[int, ...]]],
                  budget: int, subject: str = "batches") -> List[Finding]:
    """Verify a batch partition against the fusion-order contract."""
    findings: List[Finding] = []

    def add(msg: str) -> None:
        findings.append(Finding(_FO, subject, msg, Severity.ERROR))

    by_seq = {s[0]: s for s in submissions}
    flat = [s for _, _, seqs in batches for s in seqs]
    if sorted(flat) != sorted(by_seq):
        add(f"batches {flat} are not a partition of the submissions "
            f"{sorted(by_seq)}")
        return findings
    if flat != sorted(flat):
        add(f"global execution order {flat} reorders submissions — a "
            "batch may only take a CONTIGUOUS run off the queue front")
    for kind, window, seqs in batches:
        for s in seqs:
            _, k, w, _, _ = by_seq[s]
            if (k, w) != (kind, window):
                add(f"op {s} ({k}:{w}) landed in a {kind}:{window} "
                    "batch — fusion must not mix kinds or windows")
        weights = {repr(by_seq[s][3]) for s in seqs}
        if len(weights) > 1:
            add(f"batch {seqs} mixes weight maps {weights} — a fused "
                "deposit would apply one map to all of them")
        if kind == "update" and len(seqs) > 1:
            add(f"update batch {seqs} fused — combines are never "
                "coalesced")
        if len(seqs) > 1:
            total = sum(by_seq[s][4] for s in seqs)
            if total > budget:
                add(f"batch {seqs} totals {total} bytes over the "
                    f"{budget}-byte fusion budget")
    return findings


#: canonical op streams the fusion rule replays through a real engine:
#: (label, schedule, fusion_bytes)
FUSION_STREAMS = [
    ("same-window-run",
     [("put", "a"), ("put", "a"), ("put", "a"), "step", "step"], 1 << 20),
    ("window-switch-cuts",
     [("put", "a"), ("put", "b"), ("put", "a"), "step", "step", "step"],
     1 << 20),
    ("update-never-fuses",
     [("put", "a"), ("update", "a"), ("update", "a"), "step", "step",
      "step"], 1 << 20),
    ("budget-cuts",
     [("put", "a"), ("put", "a"), ("put", "a"), "step", "step"], 12),
    ("accumulate-run",
     [("accumulate", "a"), ("accumulate", "a"), "step"], 1 << 20),
]


@registry.rule(_SM, "progress",
               "exhaustive submit/step/quiesce/resume interleavings on a "
               "real manual-mode engine: nothing lost, nothing doubled")
def _run_state_machine(report: Report) -> None:
    for schedule in schedule_corpus(length=4):
        report.subjects_checked += 1
        report.extend(check_schedule(schedule,
                                     subject="sched" + repr(schedule)))


@registry.rule(_HL, "progress",
               "handle event traces from the canonical engine paths "
               "resolve exactly once, observed only after resolution")
def _run_handle_lifecycle(report: Report) -> None:
    canonical = {
        "submit-execute-result": [("h0", "create"), ("h0", "complete"),
                                  ("h0", "result")],
        "submit-fail": [("h0", "create"), ("h0", "fail")],
        "two-handles-interleaved": [("h0", "create"), ("h1", "create"),
                                    ("h1", "complete"), ("h0", "complete"),
                                    ("h0", "result"), ("h1", "result")],
        "completed-factory": [("h0", "create"), ("h0", "complete"),
                              ("h0", "result"), ("h0", "result")],
    }
    for label, events in canonical.items():
        report.subjects_checked += 1
        report.extend(check_handle_events(events, subject=label))


@registry.rule(_FO, "progress",
               "the batches a real engine pops preserve per-window "
               "submission order, compatibility, and the byte budget")
def _run_fusion_order(report: Report) -> None:
    for label, schedule, budget in FUSION_STREAMS:
        report.subjects_checked += 1
        be, submissions, _, crashes = run_schedule(schedule,
                                                   fusion_bytes=budget)
        for c in crashes:
            report.add(Finding(_FO, label, f"engine crashed: {c}"))
        report.extend(check_batches(submissions, be.batches, budget,
                                    subject=label))
