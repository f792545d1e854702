"""Adaptive topology: the straggler-aware edge-health control loop.

The heartbeat detector (detector.py) answers "is the rank's process
alive?"; this module answers the harder gray-failure question — "is the
EDGE healthy enough to sit on my critical path?" — and drives the
three-state machine (:class:`~bluefog_tpu_torch.resilience.detector.
EdgeHealth`) that routes gossip around ranks that are slow but
responsive.

Two signals feed the machine, both observed on the win-op path with no
extra communication:

- **deposit freshness** — each ``win_update`` probes every in-edge's
  slot version (a monotone deposit count).  A changed version is a
  fresh deposit: the elapsed *gap* since the previous change is a clean
  observation and a sample for the pooled gap histogram.  An unchanged
  version older than the **edge deadline** is a miss — counted ONCE per
  stale gap, however long, so a synchronous caller polling at ms
  cadence cannot turn one marginal gap into a SUSPECT streak (only a
  rank that misses gap after gap accumulates one).
- **mutex acquire time** — a straggler sleeping inside its critical
  section convoys every neighbor's ``win_mutex``.  Acquire durations
  past the acquire deadline are misses.  Acquires never count as
  *clean* observations: a fast lock proves the lock word is free, not
  that the rank is gossiping (a rank sleeping outside its critical
  section acquires fast while depositing nothing).

The deadlines are adaptive: ``max(floor, factor × pooled p50)`` over
the respective histogram (:meth:`~bluefog_tpu_torch.telemetry.registry.
Histogram.quantile` on the same fixed buckets telemetry exports).  The
p50 — not the p99 — is the baseline on purpose: under a convoy every
edge slows down together, so a tail quantile would chase the straggler
and never fire, while the median tracks the healthy cadence.  Until
``min_obs`` samples arrive nothing can miss (cold-start warmup: the
first rounds of a job are legitimately slow).

The policy object is **registry-independent** (it owns bare
:class:`~bluefog_tpu_torch.telemetry.registry.Histogram` instances), so
adaptivity works with telemetry off; when a registry IS enabled the
state transitions publish ``adaptive.edge_state`` gauges and
``edge_state`` journal events (see EdgeHealth), and the policy mirrors
its deadline and miss counts as gauges/counters.

It is also keyed by **global** rank and owned by the island context —
NOT by the per-epoch FailureDetector — so hysteresis clocks and streaks
survive the membership-epoch switches its own demotions trigger.

Env knobs (see docs/RESILIENCE.md, "Adaptive topology"):

- ``BFTPU_ADAPTIVE`` (default 0) — enable the control loop;
- ``BFTPU_EDGE_DEADLINE_S`` (default 0.25) — deadline floor, seconds;
- ``BFTPU_EDGE_DEADLINE_FACTOR`` (default 8) — deadline as a multiple
  of the pooled p50;
- plus the machine's own ``BFTPU_SUSPECT_MISSES`` /
  ``BFTPU_PROMOTE_CLEAN`` / ``BFTPU_DEMOTE_FLOOR_S`` (detector.py).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from bluefog_tpu_torch.resilience.detector import EdgeHealth
from bluefog_tpu_torch.sim.clock import now_fn as _now_fn
from bluefog_tpu_torch.telemetry import registry as _telemetry

__all__ = [
    "AdaptivePolicy",
    "adaptive_enabled",
    "edge_deadline_floor_s",
    "edge_deadline_factor",
    "MIN_OBSERVATIONS",
]

# pooled samples below which no deadline exists (cold-start warmup)
MIN_OBSERVATIONS = 8


def adaptive_enabled() -> bool:
    """Whether the adaptive edge-health control loop runs
    (``BFTPU_ADAPTIVE``; default off — demotion changes the topology,
    which a training script must opt into)."""
    return os.environ.get("BFTPU_ADAPTIVE", "0") not in ("0", "", "false")


def edge_deadline_floor_s() -> float:
    """Edge-deadline floor in seconds (``BFTPU_EDGE_DEADLINE_S``)."""
    try:
        return float(os.environ.get("BFTPU_EDGE_DEADLINE_S", "0.25"))
    except ValueError:
        return 0.25


def edge_deadline_factor() -> float:
    """Edge deadline as a multiple of the pooled p50
    (``BFTPU_EDGE_DEADLINE_FACTOR``)."""
    try:
        return float(os.environ.get("BFTPU_EDGE_DEADLINE_FACTOR", "8"))
    except ValueError:
        return 8.0


class AdaptivePolicy:
    """Edge observations in, EdgeHealth transitions out.

    Thread-compatible with the island runtime: observations arrive from
    the win-op path (one thread), reads (``suspects`` via ``health``)
    from the same thread; the internal lock only guards the pooled
    histograms against a concurrent metrics scrape.
    """

    def __init__(self, floor_s: Optional[float] = None,
                 factor: Optional[float] = None,
                 min_obs: Optional[int] = None,
                 health: Optional[EdgeHealth] = None,
                 clock=time.monotonic):
        self.floor_s = (edge_deadline_floor_s() if floor_s is None
                        else float(floor_s))
        self.factor = (edge_deadline_factor() if factor is None
                       else float(factor))
        self.min_obs = MIN_OBSERVATIONS if min_obs is None else int(min_obs)
        self.health = EdgeHealth(clock=clock) if health is None else health
        self._clock = _now_fn(clock)
        self._lock = threading.Lock()
        # bare histograms (no registry): pooled over ALL edges — the
        # healthy-cadence baseline the per-edge deadline compares against
        self._gap = _telemetry.Histogram("adaptive.edge_gap_s", {})
        self._acq = _telemetry.Histogram("adaptive.acquire_s", {})
        self.gap_misses = 0
        self.acquire_misses = 0
        # peer -> clock time of the last demote/promote epoch switch
        # that changed the peer's standing (the commit-level floor gate:
        # even if per-member machine states diverge, no peer's epoch
        # standing may flap faster than the hysteresis floor)
        self._epoch_changed: dict = {}
        # critical-path corroboration (tracing feed): peer -> count of
        # rounds the peer's edge lengthened.  Only consulted while the
        # feed is live — see corroborated().
        self._cp_live = False
        self._cp_blame: dict = {}

    # -- deadlines ---------------------------------------------------------

    def _deadline(self, hist) -> Optional[float]:
        with self._lock:
            if hist.count < self.min_obs:
                return None
            p50 = hist.quantile(0.5)
        if p50 != p50:  # NaN: empty histogram
            return None
        return max(self.floor_s, self.factor * p50)

    def gap_deadline_s(self) -> Optional[float]:
        """Current deposit-gap deadline, or None during warmup."""
        return self._deadline(self._gap)

    def acquire_deadline_s(self) -> Optional[float]:
        """Current mutex-acquire deadline, or None during warmup."""
        return self._deadline(self._acq)

    # -- the commit-level hysteresis gate ----------------------------------

    def note_epoch_change(self, peers) -> None:
        """Record that a reweight epoch switch just changed the standing
        (demoted <-> member) of ``peers`` — starts their commit floor."""
        now = self._clock()
        for p in peers:
            self._epoch_changed[int(p)] = now

    def epoch_floor_open(self, peer: int) -> bool:
        """Whether enough time has passed since ``peer``'s standing last
        changed to commit another change (the machine's own floor gates
        local transitions; this gates the fleet-level epoch cycle, which
        must hold even when member machines disagree)."""
        t = self._epoch_changed.get(int(peer))
        return t is None or self._clock() - t >= self.health.floor_s

    # -- observations ------------------------------------------------------

    def note_fresh(self, peer: int, gap_s: float,
                   clean: bool = True) -> None:
        """A deposit arrived on ``peer``'s edge after ``gap_s`` seconds
        — a pooled-baseline sample and, when the gap made the deadline,
        a clean observation.  ``clean=False`` is the gap-end of a
        MISSED gap: its miss was already counted mid-gap, and crediting
        the straggler a clean for finally depositing would reset the
        streak — a rank missing gap after gap would alternate
        miss/clean forever and ``suspect_misses`` consecutive misses
        would be unreachable."""
        with self._lock:
            self._gap.observe(float(gap_s))
        if clean:
            self.health.note_clean(peer)

    def note_stale(self, peer: int, age_s: float) -> bool:
        """``peer``'s edge has produced nothing for ``age_s`` seconds.
        Returns True when that is past the deadline (a miss — the
        caller applies the round-local ABSORB combine).  Callers
        deduplicate to ONE call per stale gap (``_adaptive_probe``
        tracks per-edge whether the current gap already missed) — each
        call here IS one machine miss."""
        d = self.gap_deadline_s()
        if d is None or float(age_s) <= d:
            return False
        self.gap_misses += 1
        self.health.note_miss(peer)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("adaptive.gap_misses").inc()
            reg.gauge("adaptive.edge_deadline_s").set(d)
        return True

    def note_acquire(self, peer: int, dur_s: float) -> bool:
        """One ``win_mutex`` acquire of ``peer``'s lock took ``dur_s``
        seconds.  Returns True when that is past the acquire deadline
        (a miss).  Never counts as clean — see module docstring.

        Attribution: the shm transports keep an acquire-time holder
        word (``HolderBoard`` in shm_native), so the islands caller
        passes the rank that actually HELD the lock during the wait —
        a straggler asleep inside its critical section is blamed
        directly, not the innocent owner of the contended window.  On
        transports without the board (TCP/routed) the caller falls back
        to the window owner, and the streak machinery absorbs the
        error: an innocent rank keeps depositing, and every fresh
        deposit resets its miss streak — only a rank that both misses
        and produces nothing accumulates the ``suspect_misses``
        consecutive misses a demotion needs."""
        d = self.acquire_deadline_s()
        with self._lock:
            self._acq.observe(float(dur_s))
        if d is None or float(dur_s) <= d:
            return False
        self.acquire_misses += 1
        self.health.note_miss(peer)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("adaptive.acquire_misses").inc()
        return True

    # -- critical-path corroboration (tracing feed) ------------------------

    def set_live_feed(self, active: bool) -> None:
        """Whether the tracer is currently live (the caller checks each
        round — tracing can be flipped at runtime via ``bftpu-top``).
        While live, :meth:`corroborated` requires critical-path blame;
        while off, it passes everything through (gap staleness alone
        decides, exactly the PR-8 behavior)."""
        self._cp_live = bool(active)

    def note_round_blame(self, peer: int, n: int = 1) -> None:
        """``peer``'s edge lengthened ``n`` of my rounds — the live,
        rank-local form of the tracer's per-round critical-path
        attribution (a deadline-missed in-edge is by construction the
        op my round waited on).  Monotone: counts only accumulate."""
        p = int(peer)
        self._cp_blame[p] = self._cp_blame.get(p, 0) + max(0, int(n))
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("adaptive.cp_blame", peer=p).inc(max(0, int(n)))

    def feed_critical_path(self, rounds_lengthened_by_rank) -> None:
        """Merge a merged-trace attribution map (``tracing
        --critical-path``'s ``rounds_lengthened_by_rank``) into the
        blame counts.  Max-merge per rank keeps the feed monotone when
        the same trace window is fed twice."""
        for peer, count in dict(rounds_lengthened_by_rank).items():
            p = int(peer)
            self._cp_blame[p] = max(self._cp_blame.get(p, 0), int(count))

    def critical_path_blame(self, peer: int) -> int:
        """Rounds ``peer`` is currently blamed for lengthening."""
        return int(self._cp_blame.get(int(peer), 0))

    def corroborated(self, peer: int) -> bool:
        """The demote AND-gate: with the tracing feed live, a suspect
        may only be demoted when the critical path also blames it — a
        rank can go gap-stale from MY vantage (a convoy, a dropped
        deposit) without ever lengthening a round, and demoting it
        would re-route gossip around a healthy member.  With the feed
        off this is a pass-through, not a veto: staleness alone
        decides, as before the feed existed."""
        return (not self._cp_live) or self.critical_path_blame(peer) >= 1
