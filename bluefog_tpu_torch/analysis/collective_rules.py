"""Declarative lint rules over a torch program's collective inventory
(counterpart of ``bluefog_tpu/analysis/hlo_rules.py``).

The reference's rules read post-partitioner HLO text; here they read the
:class:`~bluefog_tpu_torch.common.collective_inspect.CollectiveInventory`
of a program that ran under it (or any sequence of its
:class:`~bluefog_tpu_torch.common.collective_inspect.CollectiveOp`\\ s).
Rule ids keep the reference's with ``hlo.`` spelled ``collective.``:

- :class:`CollectiveBudget` — exact (or max) per-opcode collective
  counts, unlisted collectives pinned to zero in exact mode.  The
  O(deg)-gossip story is exactly "collective-permute == #shift classes,
  everything else zero".
- :class:`NoFullAxisAllGather` — no ``all-gather`` per-rank result may
  carry a given axis extent in its two leading dims.
- :class:`NoReplicatedLargeBuffer` — no all-gather/broadcast per-rank
  result may exceed a byte threshold.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence

from bluefog_tpu_torch.common.collective_inspect import (
    COLLECTIVES,
    collective_counts,
    collective_ops,
)

from bluefog_tpu_torch.analysis.engine import Finding, Severity

__all__ = [
    "CollectiveBudget",
    "NoFullAxisAllGather",
    "NoReplicatedLargeBuffer",
    "check_program",
    "assert_clean",
]


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Per-program collective-count budget.

    ``exact=True`` (the contract-test mode): every listed opcode must
    appear exactly its budgeted number of times and every *unlisted*
    collective exactly zero times.  ``exact=False``: budgets are upper
    bounds and unlisted collectives are unconstrained.
    """

    budgets: Mapping[str, int]
    exact: bool = True
    subject: str = "program"

    def __post_init__(self):
        unknown = set(self.budgets) - set(COLLECTIVES)
        if unknown:
            raise ValueError(
                f"unknown collective opcode(s) {sorted(unknown)}; known: "
                f"{list(COLLECTIVES)}")

    def check_counts(self, counts: Mapping[str, int]) -> List[Finding]:
        out: List[Finding] = []
        for op in COLLECTIVES:
            have = counts.get(op, 0)
            want = self.budgets.get(op, 0 if self.exact else None)
            if want is None:
                continue
            bad = have != want if self.exact else have > want
            if bad:
                rel = "expected exactly" if self.exact else "budget"
                out.append(Finding(
                    "collective.collective-budget", self.subject,
                    f"{have} x {op} ({rel} {want}); full inventory "
                    f"{dict(counts)}"))
        return out

    def check(self, program) -> List[Finding]:
        return self.check_counts(collective_counts(program))


@dataclasses.dataclass(frozen=True)
class NoFullAxisAllGather:
    """No all-gather per-rank result may carry ``axis_size`` as either of
    its two leading dims: a gather that hands every rank the whole axis
    as a leading dimension has re-materialized it."""

    axis_size: int
    subject: str = "program"

    def check(self, program) -> List[Finding]:
        out: List[Finding] = []
        for op in collective_ops(program):
            if op.opcode != "all-gather":
                continue
            for _, dims in op.shapes:
                if dims[:1] == (self.axis_size,) or dims[1:2] == (self.axis_size,):
                    out.append(Finding(
                        "collective.full-axis-all-gather", self.subject,
                        f"all-gather result carries the full axis extent "
                        f"{self.axis_size}: {op.line.strip()[:160]}"))
                    break
        return out


@dataclasses.dataclass(frozen=True)
class NoReplicatedLargeBuffer:
    """No all-gather or broadcast per-rank result may exceed
    ``max_bytes``: the opcode budget can balance while a single gather
    blows the memory story."""

    max_bytes: int
    opcodes: Sequence[str] = ("all-gather", "broadcast")
    subject: str = "program"

    def check(self, program) -> List[Finding]:
        out: List[Finding] = []
        for op in collective_ops(program):
            if op.opcode not in self.opcodes:
                continue
            nbytes = op.result_bytes()
            if nbytes > self.max_bytes:
                out.append(Finding(
                    "collective.replicated-large-buffer", self.subject,
                    f"{op.opcode} result is {nbytes / 1e6:.1f} MB "
                    f"(> {self.max_bytes / 1e6:.1f} MB): "
                    f"{op.line.strip()[:160]}"))
        return out


def check_program(program, rules: Sequence) -> List[Finding]:
    """Run a rule set over one program's inventory."""
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(program))
    return findings


def assert_clean(program, rules: Sequence) -> None:
    """pytest integration: raise AssertionError listing every finding."""
    findings = check_program(program, rules)
    errors = [f for f in findings if f.severity == Severity.ERROR]
    if errors:
        raise AssertionError(
            "collective contract violated:\n"
            + "\n".join(f"  {f}" for f in errors))
