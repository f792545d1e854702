"""The passive fleet scraper: status pages → time series → alerts.

One daemon per job (spawned by ``bftpu-run --monitor`` /
``BFTPU_MONITOR=1``, or attached after the fact with ``bftpu-run
--attach JOB monitor``) polls every rank's seqlock'd status page on a
``BFTPU_MON_SCRAPE_S`` cadence.  It carries the same passive-read
guarantee as ``bftpu-top``: seqlock double-reads only, no locks, no
writes into any rank's segments — the < 2% ``monitor_overhead_pct``
bench gate holds the line.

Each scrape derives the monitor series from the raw pages
(:class:`FleetSampler` keeps the between-scrape state — last step
progress, previous suspect set, per-rank convergence bests), appends
every point to the mmap'd :class:`~bluefog_tpu_torch.monitor.store
.MonitorStore` (history survives monitor death), and feeds the batch
to the :class:`~bluefog_tpu_torch.monitor.rules.AlertEngine`, journaling
each gap-closed window as an ``alert`` event when telemetry is on.

The scraper also publishes its OWN v8 status page at rank
``MONITOR_RANK`` (2000 — above the 1000+ replica band) carrying the
alert lamp (``alert_state``: -1 none / 0 quiet / 1 firing) and the
last-alert word, so ``bftpu-top`` shows the fleet's alarm state with
zero extra plumbing.

Lifecycle: the daemon waits for pages to appear, follows them while
the job lives, and exits on its own once every page has been reclaimed
for ``BFTPU_MON_LINGER`` consecutive scrapes (default 10) — or
immediately on SIGTERM from the launcher's teardown, flushing open
alert windows either way.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.introspect import statuspage
from bluefog_tpu_torch.monitor.rules import AlertEngine
from bluefog_tpu_torch.monitor.store import MonitorStore

__all__ = ["FleetSampler", "MonitorDaemon", "MONITOR_RANK",
           "scrape_interval"]

#: The scraper's own status-page rank: above the 1000+ serve-replica
#: band so it can never collide with a real rank or replica.
MONITOR_RANK = 2000

Point = Tuple[str, str, float]


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


def scrape_interval() -> float:
    """``BFTPU_MON_SCRAPE_S``: seconds between scrapes (default 1.0,
    floored at 10 ms so a typo cannot busy-spin the box)."""
    return max(0.01, _env_float("BFTPU_MON_SCRAPE_S", 1.0))


class FleetSampler:
    """Derive monitor series from one ``read_fleet`` snapshot.

    Stateless rules need stateful series — a stall is *time since*
    progress, a storm is a *rate* — so the sampler carries the small
    between-scrape memory and emits plain ``(series, subject, value)``
    points the engine and store consume.  Subjects are ``fleet`` for
    whole-job series and ``r<rank>`` for per-rank ones.
    """

    def __init__(self):
        self._last_step: Optional[int] = None
        self._last_step_t: Optional[float] = None
        self._prev_suspects: Optional[frozenset] = None
        self._prev_t: Optional[float] = None
        self._conv_best: Dict[int, float] = {}
        self._conv_best_t: Dict[int, float] = {}

    def sample(self, fleet: Dict[int, dict], t_mono: float) -> List[Point]:
        points: List[Point] = []
        pages = {r: p for r, p in fleet.items() if "error" not in p}
        if not pages:
            return points
        # mass ledger: only NET OVER-COLLECTION alarms.  A positive
        # fleet balance is legitimate in-flight mass mid-window; more
        # collected+drained than was ever deposited never is.
        balance = sum(p["ledger"]["balance"] for p in pages.values())
        points.append(("mass_err", "fleet", max(0.0, -balance)))
        # step progress → stall seconds
        step = max(int(p.get("step", 0)) for p in pages.values())
        if self._last_step is None or step > self._last_step:
            self._last_step, self._last_step_t = step, t_mono
        points.append(("epoch_stall_s", "fleet",
                       t_mono - (self._last_step_t or t_mono)))
        # suspect transitions per minute
        suspects = frozenset(
            (r, e["peer"]) for r, p in pages.items()
            for e in p.get("edges", ()) if e.get("state") == "suspect")
        if self._prev_suspects is not None and self._prev_t is not None:
            dt = max(1e-9, t_mono - self._prev_t)
            fresh = len(suspects - self._prev_suspects)
            points.append(("suspect_rate", "fleet", fresh / dt * 60.0))
        self._prev_suspects, self._prev_t = suspects, t_mono
        # dead edges (kill observed, heal not yet committed)
        dead = sum(1 for p in pages.values()
                   for e in p.get("edges", ()) if e.get("state") == "dead")
        points.append(("dead_edges", "fleet", float(dead)))
        # committed demotions vs the minority cap
        nranks = max(int(p.get("nranks", 1)) for p in pages.values())
        demoted = len({e["peer"] for p in pages.values()
                       for e in p.get("edges", ())
                       if e.get("state") == "demoted"})
        points.append(("demote_excess", "fleet",
                       float(demoted - (max(1, nranks) - 1) // 2)))
        for r, p in sorted(pages.items()):
            sub = f"r{r}"
            points.append(("orphan", sub, 1.0 if p.get("orphan") else 0.0))
            serve = p.get("serve", {})
            if serve.get("version", -1) >= 0 and serve.get("lag", -1) >= 0:
                points.append(("serve_lag", sub, float(serve["lag"])))
                if p.get("distrib", {}).get("slot", -1) >= 0:
                    # tree-fed replica: its lag IS its staleness
                    points.append(("distrib_staleness", sub,
                                   float(serve["lag"])))
            if serve.get("slo_state", -1) >= 0:
                points.append(("request_slo", sub,
                               1.0 if serve["slo_state"] == 1 else 0.0))
            conv = p.get("conv", {})
            if conv.get("round", -1) >= 0 and conv.get("err", -1.0) >= 0.0:
                err = float(conv["err"])
                best = self._conv_best.get(r)
                if best is None or err < best:
                    self._conv_best[r] = err
                    self._conv_best_t[r] = t_mono
                    best = err
                if best > 0.0:
                    points.append(("conv_ratio", sub, err / best))
                points.append(("conv_plateau_s", sub,
                               t_mono - self._conv_best_t[r]))
        return points


class MonitorDaemon:
    """The scrape loop: pages → sampler → store + engine → lamp page."""

    def __init__(self, job: str, *, interval: Optional[float] = None,
                 journal_fn=None, lamp: bool = True):
        self.job = str(job)
        self.interval = scrape_interval() if interval is None else max(
            0.01, float(interval))
        self.linger = max(1, int(_env_float("BFTPU_MON_LINGER", 10)))
        self.sampler = FleetSampler()
        self.store = MonitorStore(self.job, create=True)
        self._registry = None
        if journal_fn is None:
            journal_fn = self._default_journal()
        # gap must outlast the scrape cadence or every incident shreds
        # into one window per scrape (the flapping-alert fixture)
        from bluefog_tpu_torch.monitor.rules import mon_gap_s
        gap = max(mon_gap_s(), 2.5 * self.interval)
        self.engine = AlertEngine(gap_s=gap, journal_fn=journal_fn)
        self._page = (statuspage.StatusPage(self.job, MONITOR_RANK)
                      if lamp else None)
        self._seen_pages = False
        self._misses = 0
        self.scrapes = 0
        self.stop = False

    def _default_journal(self):
        """Journal alerts like any rank journals events — through a
        Registry at MONITOR_RANK — when telemetry is on; silent no-op
        otherwise (the in-process ``engine.windows`` list still fills)."""
        from bluefog_tpu_torch.telemetry import registry as _reg

        out_dir = _reg.telemetry_dir()
        if out_dir is None:
            return None
        self._registry = _reg.Registry(out_dir=out_dir, rank=MONITOR_RANK,
                                       job=self.job)
        return self._registry.journal

    def step(self) -> bool:
        """One scrape; returns False once the daemon should exit."""
        # chaos seam: BFTPU_CHAOS_MON_DROP_SCRAPE=N drops every Nth
        # scrape (reads nothing, feeds nothing) — the chaos e2e uses it
        # to prove the engine's gap-closing rides out scrape loss
        drop = int(_env_float("BFTPU_CHAOS_MON_DROP_SCRAPE", 0))
        if drop > 0 and self.scrapes > 0 and self.scrapes % drop == 0:
            self.scrapes += 1
            return not self.stop
        fleet = {r: p for r, p in statuspage.read_fleet(self.job).items()
                 if r != MONITOR_RANK}
        live = [p for p in fleet.values() if "error" not in p]
        if live:
            self._seen_pages = True
            self._misses = 0
        elif self._seen_pages:
            self._misses += 1
            if self._misses >= self.linger:
                return False
        t_mono = time.monotonic()
        t_wall = time.time()
        points = self.sampler.sample(fleet, t_mono)
        for series, subject, value in points:
            self.store.append(series, subject, t_wall, value)
        self.engine.feed(t_mono, points, wall=t_wall)
        self.scrapes += 1
        if self._page is not None:
            epoch = max((int(p.get("epoch", 0)) for p in live), default=0)
            self._page.publish(
                nranks=len(live), step=self.scrapes, epoch=epoch,
                op_id=self.engine.firings, last_op="monitor",
                alert_state=self.engine.state,
                last_alert=self.engine.last_alert)
        return not self.stop

    def run(self) -> int:
        """Blocking scrape loop; returns the count of alert windows."""
        try:
            while self.step():
                time.sleep(self.interval)
        finally:
            self.close()
        return len(self.engine.windows)

    def close(self) -> None:
        self.engine.close()
        if self._page is not None:
            self._page.close(unlink=True)
            self._page = None
        if self._registry is not None:
            self._registry.close()
            self._registry = None
        self.store.close()
