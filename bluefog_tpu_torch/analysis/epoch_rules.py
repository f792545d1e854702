"""Rule family 3b: epoch-ordering lint for window-op sequences.

MPI RMA imposes epoch discipline (ops only inside access/exposure
epochs); the mailbox emulation in ``windows.py`` is looser — there is no
fence call — but it still has a real ordering contract, and violating it
corrupts data silently rather than raising:

- an op on a never-created (or already-freed) window raises at runtime,
  but only at the first op — a trace lint catches it in review/CI;
- ``win_get`` and ``win_put``/``win_accumulate`` deposit into the SAME
  mailbox slots, so both in one epoch (between combines) means the later
  one silently overwrites the earlier's deposits before ``win_update``
  ever reads them;
- a plain ``win_put`` after ``win_accumulate`` in one epoch silently
  discards the accumulated partial sums the same way.

``check_trace`` lints a ``(op, window_name)`` event list — either canned
(the fixture corpus) or recorded from a live run via
``windows.record_win_ops()``, which is how tests/test_analysis.py lints
the real push-sum idiom end to end.  Epochs are delimited by the combine
ops (``win_update`` / ``win_put_update`` / ``win_update_then_collect``)
and by ``win_create``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, Severity, registry

__all__ = ["check_trace", "CANONICAL_TRACES"]

Trace = Sequence[Tuple[str, str]]

_CREATE = "win_create"
_FREE = "win_free"
_PUTS = frozenset({"win_put", "win_put_update"})
_ACCS = frozenset({"win_accumulate"})
_GETS = frozenset({"win_get"})
# combine reads the mailbox and (with reset / collect) drains it: a new
# epoch starts after it.  win_put_update is both a deposit in the old
# epoch and the combine that closes it.
_COMBINES = frozenset({"win_update", "win_put_update",
                       "win_update_then_collect"})
_KNOWN = (_PUTS | _ACCS | _GETS | _COMBINES
          | {_CREATE, _FREE, "win_set_exposed"})

_RULE = "protocol.win-epoch"


def check_trace(trace: Trace, subject: str = "trace") -> List[Finding]:
    """Lint one window-op event sequence.  Returns findings for:

    use-before-create / use-after-free (ERROR), duplicate create
    (WARNING), free of an unknown window (WARNING), get+put in one epoch
    (ERROR: the later op overwrites the earlier's slot deposits), and
    put-after-accumulate in one epoch (WARNING: discards partial sums).
    """
    findings: List[Finding] = []
    live = set()
    ever = set()
    # per-window deposits since the last epoch boundary
    epoch: dict = {}

    def add(msg: str, severity: Severity = Severity.ERROR) -> None:
        findings.append(Finding(_RULE, subject, msg, severity))

    for i, (op, name) in enumerate(trace):
        if op not in _KNOWN:
            add(f"event {i}: unknown op {op!r}", Severity.WARNING)
            continue
        if op == _CREATE:
            if name in live:
                add(f"event {i}: win_create({name!r}) on a live window "
                    "(silently returns False; free it first)",
                    Severity.WARNING)
            live.add(name)
            ever.add(name)
            epoch[name] = set()
            continue
        if op == _FREE:
            if name == "*":
                live.clear()
                epoch.clear()
            elif name in live:
                live.discard(name)
                epoch.pop(name, None)
            else:
                add(f"event {i}: win_free({name!r}) on an unknown window",
                    Severity.WARNING)
            continue
        if name not in live:
            kind = "freed" if name in ever else "never-created"
            add(f"event {i}: {op}({name!r}) on a {kind} window")
            continue
        dep = epoch.setdefault(name, set())
        if op in _GETS and (dep & (_PUTS | _ACCS)):
            add(f"event {i}: win_get({name!r}) in an epoch that already "
                "deposited via put/accumulate — the get overwrites those "
                "slot deposits before any combine reads them")
        elif op in (_PUTS | _ACCS) and (dep & _GETS):
            add(f"event {i}: {op}({name!r}) in an epoch that already "
                "deposited via win_get — the put overwrites the pulled "
                "slot values before any combine reads them")
        elif op in _PUTS and (dep & _ACCS):
            add(f"event {i}: {op}({name!r}) after win_accumulate in the "
                "same epoch — the plain put discards the accumulated "
                "partial sums", Severity.WARNING)
        if op in _COMBINES:
            # win_update_then_collect also logs its inner win_update;
            # clearing here makes that second boundary a no-op.
            epoch[name] = set()
        else:
            dep.add(op)
    return findings


# Known-good idioms from the optimizer / push-sum code paths; the
# registered rule proves the lint accepts every one of them (the fixture
# corpus proves it rejects the seeded-bug traces).
CANONICAL_TRACES = {
    "pushsum-loop": [
        ("win_create", "w"),
        ("win_accumulate", "w"),
        ("win_update_then_collect", "w"), ("win_update", "w"),
        ("win_set_exposed", "w"),
        ("win_accumulate", "w"),
        ("win_update_then_collect", "w"), ("win_update", "w"),
        ("win_free", "w"),
    ],
    "put-optimizer-loop": [
        ("win_create", "w"),
        ("win_put_update", "w"),
        ("win_put_update", "w"),
        ("win_free", "*"),
    ],
    "get-then-average": [
        ("win_create", "w"),
        ("win_get", "w"),
        ("win_update", "w"),
        ("win_get", "w"),
        ("win_update", "w"),
        ("win_free", "w"),
    ],
    "two-windows-interleaved": [
        ("win_create", "a"), ("win_create", "b"),
        ("win_put", "a"), ("win_get", "b"),
        ("win_update", "a"), ("win_update", "b"),
        ("win_free", "*"),
    ],
}


@registry.rule(_RULE, "protocol",
               "canonical window-op idioms pass the epoch-ordering lint")
def _run_epoch(report: Report) -> None:
    for label, trace in CANONICAL_TRACES.items():
        report.subjects_checked += 1
        report.extend(check_trace(trace, subject=label))
