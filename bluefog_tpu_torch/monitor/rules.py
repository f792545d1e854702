"""Declarative alert rules + the gap-closed alert engine.

The fleet monitor's rule table names the standing conditions an
operator pages on — the same conditions the analysis corpus audits
post-mortem, compiled down to threshold checks over sampled series:

==================  =========================  ==============================
rule                series it consumes         fires when
==================  =========================  ==============================
mass_imbalance      ``mass_err``               ledger residual beyond
                                               ``BFTPU_MON_MASS_TOL``
epoch_stall         ``epoch_stall_s``          no rank made step progress for
                                               ``BFTPU_MON_EPOCH_STALL_S``
epoch_fork          ``epoch_fork``             two live member groups commit
                                               the same epoch (split brain)
suspect_storm       ``suspect_rate``           edge-state demotion/suspect
                                               transitions per minute above
                                               ``BFTPU_MON_SUSPECT_RATE``
demote_storm        ``demote_excess``          committed demotions exceed the
                                               minority cap ``(n-1)//2``
edge_dead           ``dead_edges``             a live page reports a DEAD
                                               edge (kill observed, heal
                                               not yet committed)
orphan              ``orphan``                 a rank entered quorum-lost
                                               ORPHAN quiesce
serve_lag           ``serve_lag``              a replica trails the committed
                                               head past
                                               ``BFTPU_MON_SERVE_MAX_LAG``
distrib_staleness   ``distrib_staleness``      a tree-fed replica lags past
                                               ``BFTPU_MON_DISTRIB_STALENESS``
request_slo         ``request_slo``            a replica is inside an open
                                               request-SLO violation window
                                               (or, in the sim, holds
                                               overdue unserved requests)
conv_divergence     ``conv_ratio``             ``lab.conv_err`` grew past
                                               ``BFTPU_MON_CONV_DIVERGE`` ×
                                               its best value (divergence)
conv_plateau        ``conv_plateau_s``         ``lab.conv_err`` stopped
                                               improving for
                                               ``BFTPU_MON_CONV_PLATEAU_S``
==================  =========================  ==============================

A rule only ever fires on a series the sampler actually produced, so a
plane that is not armed (no serve replicas, probe off) cannot false-
alarm — the same "absent = disarmed" convention the status page uses.

Individual firing samples are noise; the engine folds them into
**gap-closed alert windows** exactly like the serve SLO monitor
(:mod:`bluefog_tpu_torch.serve.loadgen.slo`): a window stays open while the
rule keeps firing and closes once it has been quiet for more than
``gap_s``.  Each closed window is journaled as one ``alert`` event with
monotonic *and* wall-clock bounds, which is what lets ``python -m
bluefog_tpu_torch.monitor --report`` join it to the cause events
(kill/heal/join/demote/publish/reparent/resync) other processes
journaled inside it.  Without the gap hysteresis one incident shreds
into a window per scrape — the ``monitor-flapping-alert`` fixture
keeps that property honest.

Thresholds come from the env (``BFTPU_MON_*``), individually
overridable — and wholesale configurable — via ``BFTPU_MON_RULES``:
either inline JSON or a path to a JSON file mapping rule name to
``{"threshold": x}`` / ``{"disabled": true}``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "AlertRule",
    "AlertEngine",
    "default_rules",
    "load_rules",
    "mon_gap_s",
    "ALERT_STATE_NONE",
    "ALERT_STATE_OK",
    "ALERT_STATE_FIRING",
]

#: statuspage v8 alert-lamp encoding (mirrors the slo_state lamp):
#: -1 = no monitor attached / no samples yet, 0 = sampled and quiet,
#: 1 = at least one alert window currently open.
ALERT_STATE_NONE = -1
ALERT_STATE_OK = 0
ALERT_STATE_FIRING = 1


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


def mon_gap_s(default: float = 0.25) -> float:
    """``BFTPU_MON_GAP_S``: the window-close hysteresis in seconds."""
    return max(0.0, _env_float("BFTPU_MON_GAP_S", default))


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule: fire when ``series`` crosses ``threshold``
    under ``op`` (``gt`` = value > threshold, ``nonzero`` = value != 0)."""

    name: str
    series: str
    op: str = "gt"
    threshold: float = 0.0
    doc: str = ""

    def fires(self, value: float) -> bool:
        if self.op == "nonzero":
            return bool(value)
        return float(value) > self.threshold


def default_rules() -> Tuple[AlertRule, ...]:
    """The built-in table with env-resolved thresholds (read at call
    time, so a harness's monkeypatched env is honored)."""
    return (
        AlertRule("mass_imbalance", "mass_err", "gt",
                  _env_float("BFTPU_MON_MASS_TOL", 1e-6),
                  "mass-ledger residual beyond tolerance"),
        AlertRule("epoch_stall", "epoch_stall_s", "gt",
                  _env_float("BFTPU_MON_EPOCH_STALL_S", 30.0),
                  "no rank made step progress for this many seconds"),
        AlertRule("epoch_fork", "epoch_fork", "nonzero", 0.0,
                  "two member groups committed the same epoch "
                  "(split brain)"),
        AlertRule("suspect_storm", "suspect_rate", "gt",
                  _env_float("BFTPU_MON_SUSPECT_RATE", 30.0),
                  "suspect/demote edge transitions per minute"),
        AlertRule("demote_storm", "demote_excess", "gt", 0.0,
                  "committed demotions exceed the minority cap"),
        AlertRule("edge_dead", "dead_edges", "nonzero", 0.0,
                  "a live page reports a DEAD edge"),
        AlertRule("orphan", "orphan", "nonzero", 0.0,
                  "a rank entered quorum-lost ORPHAN quiesce"),
        AlertRule("serve_lag", "serve_lag", "gt",
                  _env_float("BFTPU_MON_SERVE_MAX_LAG",
                             _env_float("BFTPU_SERVE_MAX_LAG", 8.0)),
                  "a replica trails the committed head"),
        AlertRule("distrib_staleness", "distrib_staleness", "gt",
                  _env_float("BFTPU_MON_DISTRIB_STALENESS", 8.0),
                  "a tree-fed replica lags its staleness SLO"),
        AlertRule("request_slo", "request_slo", "nonzero", 0.0,
                  "open request-SLO violation window / overdue "
                  "unserved requests"),
        AlertRule("conv_divergence", "conv_ratio", "gt",
                  _env_float("BFTPU_MON_CONV_DIVERGE", 50.0),
                  "conv_err grew this many times past its best"),
        AlertRule("conv_plateau", "conv_plateau_s", "gt",
                  _env_float("BFTPU_MON_CONV_PLATEAU_S", 60.0),
                  "conv_err stopped improving for this many seconds"),
    )


def load_rules(spec: Optional[str] = None) -> Tuple[AlertRule, ...]:
    """The effective rule table: :func:`default_rules` with
    ``BFTPU_MON_RULES`` overrides applied.  ``spec`` (inline JSON or a
    file path) wins over the env when given; unknown rule names are
    ignored (a newer config against an older build must not crash the
    monitor)."""
    raw = spec if spec is not None else os.environ.get("BFTPU_MON_RULES", "")
    rules = default_rules()
    if not raw:
        return rules
    text = raw.strip()
    if not text.startswith("{"):
        try:
            with open(text, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return rules
    try:
        overrides = json.loads(text)
    except ValueError:
        return rules
    if not isinstance(overrides, dict):
        return rules
    out: List[AlertRule] = []
    for rule in rules:
        ov = overrides.get(rule.name)
        if not isinstance(ov, dict):
            out.append(rule)
            continue
        if ov.get("disabled"):
            continue
        if "threshold" in ov:
            try:
                rule = replace(rule, threshold=float(ov["threshold"]))
            except (TypeError, ValueError):
                pass
        out.append(rule)
    return tuple(out)


class AlertEngine:
    """Fold per-sample rule firings into gap-closed alert windows.

    Feed it one batch of ``(series, subject, value)`` points per scrape
    via :meth:`feed` and :meth:`close` it at teardown.  Windows are
    kept in-process (``self.windows``, flush order) *and* journaled
    through ``journal_fn`` when given, mirroring
    :class:`~bluefog_tpu_torch.serve.loadgen.slo.SLOMonitor` — tests assert
    on the list, the attribution CLI joins the journal.

    The engine is clock-agnostic: the caller passes each sample's
    monotonic instant (and optionally its wall twin), so the SAME
    engine runs against ``time.monotonic()`` under the scraper and
    against the virtual clock inside ``SimConfig(monitor=True)`` —
    which is what makes "seeded bug ⇒ alert" a deterministic,
    bit-identical sim invariant.
    """

    def __init__(self, rules: Optional[Iterable[AlertRule]] = None, *,
                 gap_s: Optional[float] = None, journal_fn=None):
        self.rules: Tuple[AlertRule, ...] = tuple(
            rules if rules is not None else load_rules())
        self.gap_s = mon_gap_s() if gap_s is None else max(0.0, float(gap_s))
        self.journal_fn = journal_fn
        self.samples = 0
        self.firings = 0
        self.windows: List[dict] = []
        self._open: Dict[Tuple[str, str], dict] = {}
        self._by_series: Dict[str, List[AlertRule]] = {}
        for r in self.rules:
            self._by_series.setdefault(r.series, []).append(r)

    @property
    def state(self) -> int:
        """The statuspage v8 alert lamp for this engine."""
        if self.samples == 0:
            return ALERT_STATE_NONE
        return ALERT_STATE_FIRING if self._open else ALERT_STATE_OK

    @property
    def last_alert(self) -> str:
        """Rule name of the newest open (preferred) or closed window."""
        if self._open:
            w = max(self._open.values(), key=lambda w: w["t1_mono"])
            return w["rule"]
        return self.windows[-1]["rule"] if self.windows else ""

    def feed(self, t_mono: float,
             points: Iterable[Tuple[str, str, float]],
             wall: Optional[float] = None) -> List[dict]:
        """One sample batch; returns the windows it closed (if any)."""
        self.samples += 1
        t = float(t_mono)
        off = (time.time() - time.monotonic() if wall is None
               else float(wall) - t)
        firing: Dict[Tuple[str, str], Tuple[AlertRule, float]] = {}
        for series, subject, value in points:
            for rule in self._by_series.get(series, ()):
                if rule.fires(value):
                    key = (rule.name, str(subject))
                    prev = firing.get(key)
                    if prev is None or abs(value) > abs(prev[1]):
                        firing[key] = (rule, float(value))
        for key in sorted(firing):
            rule, value = firing[key]
            self.firings += 1
            w = self._open.get(key)
            if w is not None and t - w["t1_mono"] <= self.gap_s:
                w["t1_mono"] = max(w["t1_mono"], t)
                w["t1_wall"] = w["t1_mono"] + off
                w["samples"] += 1
                if abs(value) > abs(w["worst"]):
                    w["worst"] = value
            else:
                if w is not None:
                    self._flush(key)
                self._open[key] = {
                    "rule": rule.name,
                    "subject": key[1],
                    "series": rule.series,
                    "threshold": rule.threshold,
                    "t0_mono": t, "t1_mono": t,
                    "t0_wall": t + off, "t1_wall": t + off,
                    "samples": 1,
                    "worst": value,
                }
        closed: List[dict] = []
        for key in sorted(self._open):
            if key not in firing and t - self._open[key]["t1_mono"] > self.gap_s:
                closed.append(self._flush(key))
        return closed

    def _flush(self, key: Tuple[str, str]) -> dict:
        w = self._open.pop(key)
        self.windows.append(w)
        if self.journal_fn is not None:
            self.journal_fn("alert", **w)
        return w

    def close(self) -> List[dict]:
        """Flush every open window (monitor teardown)."""
        return [self._flush(key) for key in sorted(self._open)]
