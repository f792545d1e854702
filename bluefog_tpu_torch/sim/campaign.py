"""Campaign runner: seeded fault campaigns + shrink-to-seed replay.

A **campaign** is one deterministic run of :class:`~bluefog_tpu_torch.sim.
fleet.SimFleet`: ``N`` ranks, a seeded :class:`~bluefog_tpu_torch.sim.
schedule.FaultSchedule`, a named topology, and the standing invariants
audited after every protocol event.  Everything derives from
``(SimConfig, FaultSchedule)`` — same pair, same event log, bit for
bit (the ``digest`` is a sha256 over the canonical event-log JSON, so
"bit-identical" is one string comparison).

When a campaign violates an invariant, :func:`shrink_schedule` runs
delta debugging (ddmin) over the fault set: it re-runs the campaign on
ever-smaller subsets, keeping any subset that still reproduces the
SAME violation, until the schedule is 1-minimal — removing any single
fault makes the violation vanish.  The result is written as a **repro
file** (config + minimal schedule + the violation it reproduces) that
:func:`replay` re-runs from nothing but the file — the artifact a bug
report attaches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.sim.fleet import SimFleet
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

__all__ = [
    "SimConfig",
    "CampaignResult",
    "run_campaign",
    "shrink_schedule",
    "write_repro",
    "load_repro",
    "replay",
    "REPRO_SCHEMA",
]

REPRO_SCHEMA = "bftpu-sim-repro/1"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Everything a campaign derives from (beyond the schedule).

    The timing constants are explicit — NOT read from the ``BFTPU_*``
    env — so a repro file replays identically regardless of the
    environment it runs in.  The defaults are scaled-down versions of
    the production ones (rounds are 0.2 virtual seconds, failure
    timeout 1 s ≈ 5 rounds, edge deadline floor 0.3 s) so a
    ``duration_s ≈ 0.5–1.5 s`` slow fault actually trips the adaptive
    deadline and a kill is detected within a handful of rounds.
    """

    ranks: int = 64
    rounds: int = 50
    seed: int = 0
    topology: str = "exp2"
    faults: Tuple[str, ...] = ("kill", "slow", "join")
    quiesce_rounds: int = 40
    job: str = "sim"
    # timing (virtual seconds)
    round_period: float = 0.2
    hb_interval: float = 0.05
    hb_timeout: float = 1.0
    join_timeout_s: float = 30.0
    latency_s: Tuple[float, float] = (0.002, 0.02)
    # adaptive topology (sim-scaled: factor 2 over the pooled p50 —
    # the production default of 8 would put the deadline past every
    # slow fault the generator emits)
    adaptive: bool = True
    suspect_misses: int = 3
    promote_clean: int = 5
    demote_floor_s: float = 1.0
    edge_deadline_floor_s: float = 0.3
    edge_deadline_factor: float = 1.5
    adaptive_min_obs: int = 8
    # invariant tolerances
    mass_tol: float = 1e-8
    # a demoted straggler mixes through one anchor edge, so its
    # estimate trails the fleet by ~1e-3 relative after a 40-round
    # quiesce; the seeded-bug magnitudes the check exists to catch
    # (leaked mass, non-stochastic plans) sit orders above this
    consensus_tol: float = 2e-3
    # quorum fencing for membership commits (mirrors BFTPU_QUORUM,
    # but explicit so repro files replay identically regardless of the
    # environment): "majority" fences heal/demote commits on a
    # strict-majority live set — the partition minority ORPHANs and
    # merges back on heal; "off" lets every side heal (pre-quorum
    # behavior, split-brain territory under partitions)
    quorum: str = "majority"
    # serving plane: serve_every > 0 arms a publisher analog — the
    # lowest live rank commits its debiased estimate as snapshot
    # version v+1 every serve_every rounds (quorum-fenced exactly like
    # islands.serve_publish) — and serve_replicas > 0 spawns hot-swap
    # replica models that flip to the newest committed version and
    # serve from it each round.  Both default OFF, and every serve
    # event is gated on them, so a serve-disabled config logs zero new
    # events: existing digests and repro files are unchanged.
    serve_every: int = 0
    serve_replicas: int = 0
    # distribution tree (serve.distrib model): distrib_fanout > 0 (with
    # the serve plane armed) organizes the replica models into a
    # bounded-degree fan-out tree — each replica adopts a committed
    # version only after its parent installed it plus a seeded per-edge
    # latency, a dead parent re-parents the child via the same greedy
    # repair the real coordinator runs (serve.distrib.tree.reassign),
    # and tree validity (connected / acyclic / degree-capped) is
    # checked after every distrib event.  distrib_slo > 0 additionally
    # bounds per-replica staleness (versions behind the publisher) as a
    # standing invariant.  distrib_join_round/N arm a join storm: N
    # fresh replicas grafted into the tree at that round.  All default
    # OFF — a distrib-disabled config logs zero new events, so existing
    # digests and repro files are unchanged.
    distrib_fanout: int = 0
    distrib_slo: int = 0
    distrib_join_round: int = 0
    distrib_join_n: int = 0
    # serve traffic model (bluefog_tpu_torch.serve.loadgen analog): arrivals
    # = "poisson" | "fixed" replays the load generator's open-loop
    # arrival process against the replica models on the VIRTUAL clock —
    # arrival_rate requests/virtual-second per replica, schedules drawn
    # from the same pure arrival_times() the real driver uses (a
    # dedicated seed stream: arming traffic never perturbs existing
    # digests).  Two standing invariants arm with it: every admitted
    # request is served within request_slo_s (0 = 2×round_period) or
    # its violation overlaps an injected fault window (replica kill /
    # publish churn / tree re-parent), and request_staleness_slo > 0
    # bounds the served version lag the same way.  Requests are charged
    # open-loop (latency from the SCHEDULED send), and the open-loop
    # invariant fires if a drain ever re-anchors a send time
    # (coordinated omission).  All default OFF.
    arrivals: str = ""
    arrival_rate: float = 2.0
    request_slo_s: float = 0.0
    request_staleness_slo: int = 0
    # trace-fitted gossip latency (ROADMAP item 4): per-edge empirical
    # quantile anchors ((edge_key, p50_s, p99_s), ...) with edge_key
    # "u->v" or "*" — loaded from a merged trace's critical-path report
    # by ``python -m bluefog_tpu_torch.sim --latency-from-trace``.  Empty ()
    # keeps the uniform latency_s draw (existing digests unchanged).
    latency_table: Tuple = ()
    # plumbing
    max_events: int = 20_000_000
    journal_dir: Optional[str] = None
    # seeded bugs the campaign should CATCH: mass_leak (combine leaks
    # mass), cap_bypass (no minority demotion cap), split_brain (the
    # quorum fence is skipped, so both partition sides heal and the
    # single-lineage invariant fires), serve_version_reset (a publisher
    # handoff restarts snapshot versions at 1 — the serve-monotone
    # invariant fires), serve_torn (replica swaps mix old and new
    # buffer bytes — the serve-committed invariant fires),
    # distrib_degree_overflow (tree repair ignores the fan-out cap, so
    # a re-parent overloads a relay — the tree-validity invariant
    # fires), distrib_stall (children of a dead relay never re-parent —
    # the staleness-SLO invariant fires), slo_silent_violation (a
    # replica drains its request queue only every third poll, so
    # queueing delay silently exceeds the request SLO with no fault to
    # blame — the request-slo invariant fires), loadgen_omission (the
    # drain re-anchors each request's send time to "now", hiding the
    # queueing delay — the open-loop invariant fires), mon_silent (the
    # monitor twin scrapes but never feeds its alert engine — the
    # alert-completeness audit fires), mon_flap (the twin's gap-close
    # is set below the sample cadence, so one sustained breach flaps a
    # window per sample — the window-coalescing audit fires),
    # mon_naive_fork (the fork detector alarms on ANY view divergence,
    # so a clean heal transient raises a spurious epoch_fork — the
    # false-alarm-free audit fires)
    debug_bugs: Tuple[str, ...] = ()
    # convergence observatory (bluefog_tpu_torch.lab): record per-rank
    # successive-estimate differences each round.  The trace rides in
    # CampaignResult, NOT the event log — digests (and every existing
    # repro file) are unchanged whether it is on or off.
    trace_consensus: bool = False
    # fleet-monitor twin (bluefog_tpu_torch.monitor): run the SAME declarative
    # alert engine the live scraper runs, against the virtual clock —
    # sampling the fleet once per round_period.  Alert windows ride the
    # final dict ("monitor"), NOT the event log, so digests (and every
    # existing repro file) are unchanged whether it is on or off.  The
    # monitor rule family holds two standing invariants over it: every
    # seeded runtime-fault bug raises its matching alert, and the
    # pinned clean campaigns raise zero, bit-identically.
    monitor: bool = False
    # lockstep=True drops the per-rank start stagger so every round
    # fires at the same virtual instant; with deposit latency > 0 each
    # round then collects exactly the previous round's deposits — the
    # synchronous ``x ← Wx`` iterate a barriered real fleet runs, which
    # is what makes the sim usable as the lab sweep's rate oracle.
    lockstep: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = list(self.faults)
        d["latency_s"] = list(self.latency_s)
        d["debug_bugs"] = list(self.debug_bugs)
        d["latency_table"] = [list(row) for row in self.latency_table]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        for tup in ("faults", "latency_s", "debug_bugs"):
            if tup in kw and kw[tup] is not None:
                kw[tup] = tuple(kw[tup])
        if kw.get("latency_table") is not None:
            # nested: JSON round-trips the anchor rows as lists
            kw["latency_table"] = tuple(
                tuple(row) for row in kw["latency_table"])
        return cls(**kw)


@dataclasses.dataclass
class CampaignResult:
    """One campaign's verdict + the determinism artifact."""

    ok: bool
    violations: List[dict]
    digest: str                    # sha256 of the canonical event log
    events: int                    # protocol events logged
    loop_events: int               # scheduler events fired
    final: dict                    # members / ledger / estimates
    schedule: FaultSchedule
    config: SimConfig
    event_log: List[tuple] = dataclasses.field(default_factory=list)
    # (round, rank, err) samples when cfg.trace_consensus (lab oracle)
    consensus_trace: List[tuple] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        est = self.final.get("estimates", {})
        vals = sorted(est.values())
        return {
            "ok": self.ok,
            "violations": len(self.violations),
            "digest": self.digest[:16],
            "members": len(self.final.get("members", ())),
            "ledger": self.final.get("ledger"),
            "estimate_spread": (vals[-1] - vals[0]) if len(vals) > 1
            else 0.0,
            "events": self.events,
            "loop_events": self.loop_events,
            "faults": len(self.schedule),
            **({"arrivals": self.final["arrivals"]}
               if "arrivals" in self.final else {}),
        }


def _event_log_digest(event_log: Sequence[tuple]) -> str:
    payload = json.dumps(event_log, sort_keys=True,
                         separators=(",", ":")).encode()
    return hashlib.sha256(payload).hexdigest()


def run_campaign(cfg: SimConfig,
                 schedule: Optional[FaultSchedule] = None
                 ) -> CampaignResult:
    """One deterministic campaign.  ``schedule=None`` generates the
    canonical schedule for ``cfg.seed``."""
    if schedule is None:
        schedule = FaultSchedule.generate(cfg.seed, cfg.ranks,
                                          cfg.rounds, cfg.faults)
    fleet = SimFleet(cfg, schedule)
    fleet.run()
    final = fleet.finalize()
    return CampaignResult(
        ok=not fleet.violations,
        violations=list(fleet.violations),
        digest=_event_log_digest(fleet.event_log),
        events=len(fleet.event_log),
        loop_events=fleet.loop.events_fired,
        final=final,
        schedule=schedule,
        config=cfg,
        event_log=list(fleet.event_log),
        consensus_trace=list(fleet.consensus_trace),
    )


# -- delta-debugging shrink ------------------------------------------------


def _reproduces(cfg: SimConfig, schedule: FaultSchedule,
                faults: Sequence[Fault], target: str) -> bool:
    res = run_campaign(cfg, schedule.subset(faults))
    return any(v["name"] == target for v in res.violations)


def shrink_schedule(cfg: SimConfig, schedule: FaultSchedule,
                    target: Optional[str] = None
                    ) -> Tuple[FaultSchedule, Optional[dict], int]:
    """ddmin over the fault set: the smallest sub-schedule that still
    reproduces the first violation (or ``target`` by name).

    Returns ``(minimal_schedule, violation, campaigns_run)`` —
    ``violation`` is None when the full schedule doesn't violate
    anything (nothing to shrink).  The result is 1-minimal: removing
    any single remaining fault makes the violation vanish.
    """
    base = run_campaign(cfg, schedule)
    runs = 1
    if not base.violations:
        return schedule, None, runs
    if target is None:
        target = base.violations[0]["name"]

    faults = list(schedule.faults)
    n = 2
    while len(faults) >= 2:
        chunk = max(1, len(faults) // n)
        subsets = [faults[i:i + chunk]
                   for i in range(0, len(faults), chunk)]
        reduced = False
        # try each subset alone, then each complement
        for cand in subsets + [
                [f for f in faults if f not in set(s)]
                for s in subsets if len(subsets) > 2]:
            if not cand or len(cand) == len(faults):
                continue
            runs += 1
            if _reproduces(cfg, schedule, cand, target):
                faults = list(cand)
                n = max(2, min(n - 1, len(faults)))
                reduced = True
                break
        if not reduced:
            if n >= len(faults):
                break
            n = min(len(faults), n * 2)

    # a violation that reproduces with NO faults at all (a seeded code
    # bug rather than a fault interaction) shrinks to the empty
    # schedule — the repro then blames the config alone
    if faults:
        runs += 1
        if _reproduces(cfg, schedule, [], target):
            faults = []

    minimal = schedule.subset(faults)
    res = run_campaign(cfg, minimal)
    runs += 1
    viol = next((v for v in res.violations if v["name"] == target),
                res.violations[0] if res.violations else None)
    return minimal, viol, runs


# -- repro files -----------------------------------------------------------


def write_repro(path: str, cfg: SimConfig, schedule: FaultSchedule,
                violation: Optional[dict],
                digest: Optional[str] = None) -> str:
    doc = {
        "schema": REPRO_SCHEMA,
        "config": cfg.to_dict(),
        "schedule": json.loads(schedule.to_json()),
        "violation": violation,
        "digest": digest,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_repro(path: str) -> Tuple[SimConfig, FaultSchedule, dict]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != REPRO_SCHEMA:
        raise ValueError(f"not a sim repro file (schema="
                         f"{doc.get('schema')!r}, want {REPRO_SCHEMA!r})")
    cfg = SimConfig.from_dict(doc["config"])
    schedule = FaultSchedule.from_json(json.dumps(doc["schedule"]))
    return cfg, schedule, doc


def replay(path: str) -> CampaignResult:
    """Re-run a repro file's campaign from nothing but the file."""
    cfg, schedule, _ = load_repro(path)
    return run_campaign(cfg, schedule)
