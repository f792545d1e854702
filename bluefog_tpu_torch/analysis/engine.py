"""Rule-engine core for the static verifier (`bluefog_tpu_torch.analysis`).

Every rule family (plan/topology, HLO lint, protocol model checking,
win-op epoch ordering) produces the same currency — :class:`Finding` —
so the CLI, the pytest integration, and future CI gates share one
severity model and one exit-code policy.  A *rule* is any callable
returning a list of findings; families register their rules in a
:class:`Registry` so the CLI can enumerate and select them by name.

Design note: the checker is deliberately *static* — it inspects compiled
plans, HLO text, and abstract protocol models, never live device state —
so a full default-corpus run is cheap enough to gate every PR (the
ROADMAP's "every future perf/refactor PR is safe to land" goal).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional

__all__ = [
    "Severity",
    "Finding",
    "Report",
    "Rule",
    "Registry",
    "registry",
]


class Severity:
    ERROR = "error"      # contract violation: CLI exits nonzero
    WARNING = "warning"  # suspicious but not proven wrong
    INFO = "info"        # reported metric (e.g. spectral gap)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule firing on one subject."""

    rule: str      # dotted rule id, e.g. "plan.class-permutation"
    subject: str   # what was checked, e.g. "exp2@8 class 1"
    message: str
    severity: str = Severity.ERROR

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} ({self.subject}): {self.message}"


class Report:
    """Accumulated findings plus reported metrics for one verifier run."""

    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.metrics: Dict[str, float] = {}
        self.subjects_checked = 0

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def metric(self, name: str, value: float) -> None:
        self.metrics[name] = value

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def summary(self) -> str:
        n_err = len(self.errors())
        n_warn = sum(f.severity == Severity.WARNING for f in self.findings)
        verdict = "OK" if self.ok else "FAIL"
        return (f"{verdict}: {self.subjects_checked} subjects checked, "
                f"{n_err} errors, {n_warn} warnings")

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "subjects_checked": self.subjects_checked,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "metrics": self.metrics,
        }


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named check: ``run()`` yields findings over the default corpus.

    ``check``-style helpers (pure functions over one subject) live in the
    family modules and are what tests call directly; the Rule wrapper is
    the CLI-facing registration that binds a helper to its corpus.
    """

    name: str     # dotted id, e.g. "plan.edge-cover"
    family: str   # "plan" | "hlo" | "protocol" | "epoch"
    doc: str
    run: Callable[[Report], None]


class Registry:
    """Rule registry keyed by family; the CLI's source of truth."""

    def __init__(self) -> None:
        self._rules: Dict[str, Rule] = {}

    def register(self, rule: Rule) -> Rule:
        if rule.name in self._rules:
            raise ValueError(f"duplicate rule name {rule.name!r}")
        self._rules[rule.name] = rule
        return rule

    def rule(self, name: str, family: str, doc: str = ""):
        """Decorator: register ``fn(report) -> None`` as a corpus rule."""

        def deco(fn):
            self.register(Rule(name=name, family=family,
                               doc=doc or (fn.__doc__ or "").strip(),
                               run=fn))
            return fn

        return deco

    def families(self) -> List[str]:
        return sorted({r.family for r in self._rules.values()})

    def select(self, families: Optional[Iterable[str]] = None) -> List[Rule]:
        fams = set(families) if families is not None else None
        return [r for _, r in sorted(self._rules.items())
                if fams is None or r.family in fams]

    def run(self, families: Optional[Iterable[str]] = None,
            report: Optional[Report] = None,
            verbose: bool = False) -> Report:
        report = report if report is not None else Report()
        for rule in self.select(families):
            t0 = time.perf_counter()
            rule.run(report)
            if verbose:
                dt = (time.perf_counter() - t0) * 1e3
                print(f"  {rule.name:<40s} {dt:7.1f} ms")
        return report


#: Process-wide registry the family modules register into on import.
registry = Registry()
