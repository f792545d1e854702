"""The fleet driver: N simulated ranks running the REAL protocol.

Each :class:`SimRank` owns the same state-machine objects a live
island rank owns — a :class:`~bluefog_tpu_torch.resilience.detector.
FailureDetector` over the transport's liveness words, an
:class:`~bluefog_tpu_torch.resilience.detector.EdgeHealth` gray-failure
machine keyed by global rank, an :class:`~bluefog_tpu_torch.resilience.
adaptive.AdaptivePolicy` fed deposit-gap observations off the mailbox
versions, and the shared :class:`~bluefog_tpu_torch.sim.transport.SimBoard`
(the real ``MembershipBoard`` protocol methods).  Topology changes go
through the real planners (``heal_topology`` / ``grow_topology`` /
``demote_topology`` / ``record_graph``), memoized fleet-wide — the
planners are pure, so every rank that heals the same view shares one
compile.

The gossip itself is scalar push-sum: each rank's round collects its
in-slots (all-ones collect rows: a late deposit is simply picked up
next round — the mass-conserving plain drop of ``islands.win_update``
ABSORB), then deposits ``W[v,u]·x`` to each out-neighbor and keeps
the column residual — so Σx and Σp are conserved by construction and
the transport can audit conservation after every event.

Faults (from a :class:`~bluefog_tpu_torch.sim.schedule.FaultSchedule`) fire
on the victim's own round counter, exactly like
``chaos.checkpoint`` counts steps:

- ``kill`` — the rank's mass is seized to the lost bucket, its
  in-slots sever, survivors detect via heartbeat timeout and run the
  heal/settlement path;
- ``suspend`` — heartbeats and rounds stall for ``duration_s``; past
  the failure timeout the fleet declares it dead and a resumed zombie
  finds itself fenced (adopted) and exits;
- ``slow`` — the round cadence stretches by ``duration_s`` while
  heartbeats keep beating: the gray failure only the adaptive
  edge-health machine catches (demote to anchor, promote on
  recovery);
- ``join`` — a joiner posts on the board and blocks in
  ``wait_for_grant`` on the virtual clock; the sponsor (lowest live
  global rank) grants via the real ``grant`` path and the joiner
  enters with unit mass at the sponsor's debiased estimate;
- ``partition`` — cross-group traffic drops and liveness/epoch words
  freeze across the cut for a window of rounds; each side's detector
  times the other out, the quorum fence (same rule as
  ``bluefog_tpu_torch.resilience.quorum``) lets only a strict-majority side
  heal while the minority ORPHANs (parks its rounds, touches neither
  the board nor the shared ledgers), and on heal the orphans merge
  back through the real join machinery carrying their debiased
  estimates with their stale mass written off;
- ``serve_kill`` — a serving replica (see ``cfg.serve_replicas``)
  dies mid-hot-swap on its ``step``-th swap attempt and, when
  ``stop`` is set, respawns at that round as a fresh incarnation;
- ``serve_pub_kill`` — the publisher dies on its ``step``-th publish,
  mid-payload (``group="payload"``: the standby buffer is torn,
  nothing commits, survivors keep the previous version) or mid-flip
  (``group="flip"``: the buffer is whole, the successor's attach
  repairs forward to the new version).

Invariants are checked after every protocol event (see
:mod:`bluefog_tpu_torch.sim.invariants`); violations are recorded, never
raised — the campaign layer decides whether to shrink.
"""

from __future__ import annotations

import bisect
import math
import random
from typing import Dict, List, Optional, Set, Tuple

from bluefog_tpu_torch.resilience import healing as _healing
from bluefog_tpu_torch.resilience import quorum as _quorum
from bluefog_tpu_torch.resilience.adaptive import AdaptivePolicy
from bluefog_tpu_torch.resilience.detector import (
    EDGE_ALIVE, EdgeHealth, FailureDetector)
from bluefog_tpu_torch.resilience.join import record_graph
from bluefog_tpu_torch.sim import invariants as _inv
from bluefog_tpu_torch.sim.events import EventLoop, VirtualClock
from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule
from bluefog_tpu_torch.sim.transport import SimBoard, SimTransport
from bluefog_tpu_torch.topology_util import DiGraph, relabel_nodes

__all__ = ["SimRank", "SimFleet"]

_T0 = 1.0  # virtual launch instant (nonzero: a 0.0 heartbeat stamp
           # would read as "never beat" to the detector)


class SimRank:
    """One simulated rank: real state machines + scalar push-sum."""

    def __init__(self, g: int, x: float, p: float):
        self.g = int(g)
        self.x = float(x)
        self.p = float(p)
        self.epoch = 0
        self.epoch_members: Tuple[int, ...] = ()
        self.members: Tuple[int, ...] = ()
        self.graph: Optional[DiGraph] = None
        self.base_key = None          # memo key of the pre-demotion base
        self.cfg_key = None           # memo key of the current topology
        self.known_dead: Set[int] = set()
        self.demoted: Set[int] = set()
        self.round_idx = 0
        self.done = False
        self.suspended_until = 0.0
        self.slow_until_step: Optional[int] = None
        self.slow_delay = 0.0
        self.exited = False
        self.killed = False
        self.orphaned = False
        self.detector: Optional[FailureDetector] = None
        self.health: Optional[EdgeHealth] = None
        self.policy: Optional[AdaptivePolicy] = None
        # per in-edge adaptive probe state: src_g -> [version, t, missed]
        self.edge_seen: Dict[int, list] = {}

    @property
    def estimate(self) -> float:
        return self.x / self.p if self.p > 0 else float("nan")

    def live_members(self) -> List[int]:
        return [m for m in self.members if m not in self.known_dead]


class SimFleet:
    """Drives ``cfg.ranks`` SimRanks through ``cfg.rounds`` fault-laden
    rounds plus ``cfg.quiesce_rounds`` clean ones on one event loop."""

    def __init__(self, cfg, schedule: Optional[FaultSchedule] = None):
        self.cfg = cfg
        self.schedule = schedule or FaultSchedule()
        self.loop = EventLoop(start=_T0)
        self.clock = VirtualClock(self.loop)
        self.transport = SimTransport(self.loop, self.clock)
        self.board = SimBoard(cfg.job, self.transport)
        self.rng = random.Random(int(cfg.seed) ^ 0x5EED0F)
        self.event_log: List[tuple] = []
        self.violations: List[dict] = []
        # lab oracle feed: (round, rank, |Δestimate|) per round when
        # cfg.trace_consensus — same observable as the islands probe
        # (bluefog_tpu_torch.lab.probe), kept OUT of event_log so digests
        # and repro files are byte-identical with tracing on or off
        self.consensus_trace: List[tuple] = []
        self._conv_prev: Dict[int, float] = {}
        # fleet-monitor twin (cfg.monitor): the live scraper's
        # AlertEngine run against the VIRTUAL clock, sampled once per
        # round_period.  Rules are built explicitly from cfg — never
        # the BFTPU_MON_* env — so a monitored campaign replays
        # bit-identically anywhere; alert windows ride the final dict
        # ("monitor"), NOT the event_log, so digests and repro files
        # are unchanged whether the twin is on or off.
        self._monitor = None
        self._mon_next = 0.0
        self._mon_samples = 0
        self._mon_demote_ex = 0.0
        if getattr(cfg, "monitor", False):
            from bluefog_tpu_torch.monitor.rules import AlertEngine, AlertRule

            self._monitor = AlertEngine(rules=(
                AlertRule("mass_imbalance", "mass_err", "gt",
                          float(cfg.mass_tol),
                          "sim: conservation residual past cfg.mass_tol"),
                AlertRule("epoch_fork", "epoch_fork", "nonzero", 0.0,
                          "sim: two live member views of one epoch"),
                AlertRule("demote_storm", "demote_excess", "gt", 0.0,
                          "sim: committed demotions exceed the cap"),
                AlertRule("request_slo", "request_slo", "nonzero", 0.0,
                          "sim: admitted request overdue unserved"),
            ), gap_s=(0.01 if "mon_flap" in cfg.debug_bugs else 2.5)
                * float(cfg.round_period))
            self._mon_next = float(_T0)
        self._epoch_word_seen = 0
        self._topo_cache: Dict[object, tuple] = {}
        # graphs already audited doubly stochastic (id -> graph ref)
        self._graphs_ok: Dict[int, object] = {}
        # committed epoch records, cached fleet-wide (read-only)
        self._epoch_recs: Dict[int, dict] = {}
        self._registries: Dict[int, object] = {}
        self.ranks: Dict[int, SimRank] = {}
        self.joiners_spawned = 0
        self.orphans_merged = 0
        # quorum fencing mirrors the production rule (cfg.quorum is
        # explicit so repro files replay identically regardless of
        # BFTPU_QUORUM); the split_brain seeded bug disables the fence
        # so the single-lineage invariant can catch the violation
        self._quorum_on = (
            getattr(cfg, "quorum", "majority") != "off"
            and "split_brain" not in getattr(cfg, "debug_bugs", ()))
        # active partition window state: global rank -> group id while
        # a cut is live, the set of group ids that committed membership
        # progress during the window, and the cut-time mass anchor for
        # the partition+merge conservation invariant
        self._partition: Optional[Dict[int, int]] = None
        self._board_group = 0
        self._lineage: Set[int] = set()
        self._partition_anchor: Optional[Tuple[float, float]] = None
        # serving plane (armed only when cfg.serve_every > 0): the
        # committed snapshot history (version, payload), the region
        # header's persisted version word, the fleet-wide publish
        # ordinal (serve_pub_kill faults index it), and the replica
        # models keyed by replica id (rank 1000+i in logs, mirroring
        # REPLICA_RANK_BASE)
        self._serve_every = int(getattr(cfg, "serve_every", 0) or 0)
        self._serve_replica_n = int(
            getattr(cfg, "serve_replicas", 0) or 0)
        self._serve_committed: List[Tuple[int, float]] = []
        self._serve_version = 0
        self._serve_pub_count = 0
        self._serve_replicas: Dict[int, dict] = {}
        # distribution tree (cfg.distrib_fanout > 0 with the serve
        # plane armed): replica id -> parent replica id
        # (serve.distrib.tree.PUBLISHER = fed by the region directly)
        # plus a per-feed-edge propagation latency.  The latency stream
        # is DEDICATED (seed ^ 0xD157), so arming the tree never
        # perturbs the seeded streams existing digests derive from.
        self._distrib_fanout = (
            int(getattr(cfg, "distrib_fanout", 0) or 0)
            if self._serve_every > 0 and self._serve_replica_n > 0
            else 0)
        self._distrib_parents: Dict[int, int] = {}
        self._distrib_lat: Dict[int, float] = {}
        self._distrib_rng = random.Random(int(cfg.seed) ^ 0xD157)
        self._distrib_reparents = 0
        self._distrib_joins = 0
        #: committed version -> virtual commit instant (feeds the
        #: per-edge propagation gate; never reaches the event log)
        self._serve_commit_t: Dict[int, float] = {}
        # serve traffic model (cfg.arrivals, armed only with the serve
        # plane): per-replica open-loop request schedules precomputed
        # from the SAME pure arrival_times() the real load generator
        # uses (its dedicated ^0x10AD seed stream — arming traffic
        # draws nothing from self.rng, so existing digests hold).
        # Fault windows carry the attribution story: a request-SLO or
        # staleness-SLO miss is a violation only when NO injected
        # fault window overlaps it.
        self._arrivals = (str(getattr(cfg, "arrivals", "") or "")
                          if self._serve_every > 0
                          and self._serve_replica_n > 0 else "")
        self._req_slo = float(getattr(cfg, "request_slo_s", 0.0) or 0.0)
        if self._arrivals and self._req_slo <= 0:
            self._req_slo = 2.0 * cfg.round_period
        self._req_stale_slo = int(
            getattr(cfg, "request_staleness_slo", 0) or 0)
        self._req_served = 0
        self._req_violations = 0
        self._req_attributed = 0
        self._arr_windows: List[dict] = []
        self._arr_kill_open: Dict[int, dict] = {}
        self._arr_stale_open: List[dict] = []
        # trace-fitted per-edge gossip latency (cfg.latency_table):
        # replaces the uniform draw in _send with an empirical quantile
        # sampler consuming exactly one rng.random() per edge
        self._lat_model = None
        _table = getattr(cfg, "latency_table", ()) or ()
        if _table:
            from bluefog_tpu_torch.sim.latency import EmpiricalLatency
            self._lat_model = EmpiricalLatency(_table)
        # faults indexed by (victim global rank, step); joins and
        # partitions fire on their own timers (no single victim);
        # serve faults key on replica id / publish ordinal instead of
        # global rank, so they must not land in the rank-fault map
        self._faults: Dict[Tuple[int, int], Fault] = {}
        self._join_faults: List[Fault] = []
        self._partition_faults: List[Fault] = []
        self._serve_kill_faults: Dict[int, Fault] = {}
        self._serve_pub_faults: Dict[int, Fault] = {}
        for f in self.schedule:
            if f.kind == "join":
                self._join_faults.append(f)
            elif f.kind == "partition":
                self._partition_faults.append(f)
            elif f.kind == "serve_kill":
                self._serve_kill_faults[f.rank] = f
            elif f.kind == "serve_pub_kill":
                self._serve_pub_faults[f.step] = f
            else:
                self._faults[(f.rank, f.step)] = f
        self._build()

    # -- construction ------------------------------------------------------

    def _mk_registry(self, g: int):
        if not self.cfg.journal_dir:
            return None
        reg = self._registries.get(g)
        if reg is None:
            from bluefog_tpu_torch.telemetry.registry import Registry

            reg = Registry(out_dir=self.cfg.journal_dir, rank=g,
                           job=self.cfg.job)
            self._registries[g] = reg
        return reg

    def _journal(self, g: int, event: str, **fields) -> None:
        reg = self._mk_registry(g)
        if reg is not None and reg.enabled:
            reg.journal(event, **fields)

    def _base_topology(self) -> DiGraph:
        from bluefog_tpu_torch import topology_util as tu

        n = int(self.cfg.ranks)
        builders = {
            "exp2": tu.ExponentialTwoGraph,
            "exp": tu.ExponentialGraph,
            "sym_exp4": tu.SymmetricExponentialGraph,
            "ring": tu.RingGraph,
            "ring_uni": lambda n: tu.RingGraph(n, connect_style=1),
            "star": tu.StarGraph,
            "mesh2d": tu.MeshGrid2DGraph,
            "full": tu.FullyConnectedGraph,
        }
        try:
            build = builders[self.cfg.topology]
        except KeyError:
            raise ValueError(
                f"unknown sim topology {self.cfg.topology!r} "
                f"(one of {sorted(builders)})") from None
        return build(n)

    def _rows(self, G: DiGraph):
        """Per-local-rank send rows: (keep_fraction, [(dst_local, w)]).
        Edge (u, v) carries W[v, u] — the weight v applies to u's
        value — so u's column residual is 1 - Σ out-weights; with the
        MH weights doubly stochastic, depositing ``w·x`` per edge and
        keeping the residual conserves Σx exactly (up to fp)."""
        rows = {}
        for u in sorted(G.nodes):
            out = [(int(v), float(G[u][v]["weight"]))
                   for v in sorted(G.successors(u))]
            keep = 1.0 - sum(w for _, w in out)
            rows[int(u)] = (keep, out)
        return rows

    def _topo_entry(self, key, build):
        """Fleet-wide memo for pure topology computations: every rank
        healing/adopting the same view shares one planner run (the
        planners cost ~70 ms at N=256 — per-rank recompute would
        dominate the whole campaign)."""
        ent = self._topo_cache.get(key)
        if ent is None:
            ent = self._topo_cache[key] = build()
        return ent

    def _build(self) -> None:
        cfg = self.cfg
        G = self._topo_entry(("epoch", 0), lambda: self._base_topology())
        members = tuple(range(cfg.ranks))
        rows = self._rows(G)
        self.board.ensure(cfg.ranks)
        for g in range(cfg.ranks):
            r = SimRank(g, x=float(g), p=1.0)
            r.members = r.epoch_members = members
            r.graph = G
            r.cfg_key = r.base_key = ("epoch", 0)
            self.ranks[g] = r
            self._wire_rank(r)
        self.initial_x = sum(r.x for r in self.ranks.values())
        self.initial_p = sum(r.p for r in self.ranks.values())
        self.joined_x = 0.0
        self.joined_p = 0.0
        self._rows_cache = {("epoch", 0): rows}
        # stagger starts so rounds interleave like free-running
        # processes (deterministically); cfg.lockstep zeroes the
        # stagger so the fleet iterates synchronously (lab oracle mode)
        for g in range(cfg.ranks):
            off = 0.0 if getattr(cfg, "lockstep", False) \
                else (g * 37 % 101) / 101.0
            self.loop.at(_T0 + off * cfg.hb_interval, self._hb_event(g))
            self.loop.at(_T0 + off * cfg.round_period,
                         self._round_event(g))
        if self._serve_every > 0:
            for i in range(self._serve_replica_n):
                self._serve_replicas[i] = {
                    "version": 0, "payload": None, "swaps": 0,
                    "steps": 0, "killed": False, "fired": False,
                    "install_t": 0.0}
                # traffic starts after the first publish + one adopt
                # poll can have landed — a request against a replica
                # that CANNOT have a snapshot yet is a model artifact,
                # not an SLO story
                self._arm_arrivals(
                    self._serve_replicas[i], i,
                    _T0 + (self._serve_every + 2) * cfg.round_period)
                if self._distrib_fanout > 0:
                    from bluefog_tpu_torch.serve.distrib import tree as _dtree
                    self._distrib_parents[i] = _dtree.parent_of(
                        i, self._distrib_fanout)
                    self._distrib_lat[i] = self._distrib_edge_latency()
                off = 0.0 if getattr(cfg, "lockstep", False) \
                    else ((1000 + i) * 37 % 101) / 101.0
                self.loop.at(_T0 + off * cfg.round_period,
                             self._serve_replica_event(i))
            jr = int(getattr(cfg, "distrib_join_round", 0) or 0)
            jn = int(getattr(cfg, "distrib_join_n", 0) or 0)
            if self._distrib_fanout > 0 and jr > 0 and jn > 0:
                self.loop.at(_T0 + jr * cfg.round_period,
                             self._distrib_join_storm_event(jn))
        for f in self._join_faults:
            self.loop.at(_T0 + f.step * cfg.round_period,
                         self._joiner_event(f))
        for f in self._partition_faults:
            t0 = _T0 + f.step * cfg.round_period
            if f.stop is not None:
                t1 = _T0 + f.stop * cfg.round_period
            else:
                t1 = t0 + (f.duration_s or 5 * cfg.round_period)
            self.loop.at(t0, self._partition_start_event(f))
            self.loop.at(max(t1, t0), self._partition_end_event(f))
        self.end_time = _T0 + (cfg.rounds + cfg.quiesce_rounds + 2) \
            * cfg.round_period

    def _wire_rank(self, r: SimRank) -> None:
        cfg = self.cfg
        view = self.transport.job_view(r.epoch_members, r.g)
        local = r.epoch_members.index(r.g)
        r.detector = FailureDetector(
            view, local, len(r.epoch_members),
            timeout=cfg.hb_timeout, interval=cfg.hb_interval,
            clock=self.clock.now)
        if r.health is None:
            r.health = EdgeHealth(misses=cfg.suspect_misses,
                                  clean=cfg.promote_clean,
                                  floor_s=cfg.demote_floor_s,
                                  clock=self.clock.now)
            r.policy = AdaptivePolicy(floor_s=cfg.edge_deadline_floor_s,
                                      factor=cfg.edge_deadline_factor,
                                      min_obs=cfg.adaptive_min_obs,
                                      health=r.health,
                                      clock=self.clock.now)
        r.detector.edge_health = r.health
        members = r.epoch_members
        r.detector.to_peer = lambda lr, _m=members: _m[lr]

    # -- event bodies ------------------------------------------------------

    def _all_done(self) -> bool:
        """Every live rank has finished its rounds — the campaign's
        quiesce point.  Heartbeats must keep beating until HERE, not
        until a fixed wall time: rounds stretch under slow faults and
        suspensions, and a straggler still running rounds after its
        peers stopped stamping would declare the whole fleet dead."""
        return all(r.done or r.killed or r.exited
                   for r in self.ranks.values())

    def _hb_event(self, g: int):
        def fire():
            r = self.ranks.get(g)
            if r is None or r.killed or r.exited:
                return
            if self._all_done():
                return
            if self.loop.now >= r.suspended_until:
                r.detector.beat()
            self.loop.after(self.cfg.hb_interval, self._hb_event(g))
        return fire

    def _round_event(self, g: int):
        def fire():
            r = self.ranks.get(g)
            if r is None or r.killed or r.exited:
                return
            if r.orphaned:
                # parked: an orphan runs no rounds (windows frozen,
                # progress engine quiesced).  The partition-heal event
                # owns its future — merge-back or fencing.
                return
            now = self.loop.now
            if now < r.suspended_until:
                self.loop.at(r.suspended_until, self._round_event(g))
                return
            r.round_idx += 1
            step = r.round_idx
            if step > self.cfg.rounds + self.cfg.quiesce_rounds:
                r.done = True
                return
            fault = self._faults.get((g, step))
            if fault is not None and self._apply_fault(r, fault):
                return  # killed (or suspended: round deferred)
            self._round_body(r)
            delay = 0.0
            if (r.slow_until_step is not None
                    and step >= 0 and r.round_idx < r.slow_until_step):
                delay = r.slow_delay
            elif (r.slow_until_step is not None
                  and r.round_idx >= r.slow_until_step):
                r.slow_until_step = None
                self._log("slow_end", r.g)
            self.loop.after(self.cfg.round_period + delay,
                            self._round_event(g))
        return fire

    def _apply_fault(self, r: SimRank, f: Fault) -> bool:
        """Returns True when the round body must not run (kill or
        suspend — a stopped process executes nothing)."""
        if f.kind == "kill":
            self._log("kill", r.g, step=r.round_idx)
            r.killed = True
            self.transport.kill(r.g)
            self.transport.lost_x += r.x
            self.transport.lost_p += r.p
            r.x = 0.0
            r.p = 0.0
            if self._arrivals:
                # a gossip-rank death can stall the publish cadence
                # (heal + quorum re-fence) — staleness is excused
                # fleet-wide until the next successful commit
                self._arr_stale_open.append(self._arr_window(
                    "rank_fault", -1, ("staleness",), None))
            self._check("kill", r.g)
            return True
        if f.kind == "suspend":
            dur = f.duration_s or 2.5
            self._log("suspend", r.g, step=r.round_idx, duration=dur)
            r.suspended_until = self.loop.now + dur
            self.loop.at(r.suspended_until, self._round_event(r.g))
            if self._arrivals:
                self._arr_stale_open.append(self._arr_window(
                    "rank_fault", -1, ("staleness",), None))
            self._check("suspend", r.g)
            return True
        if f.kind == "slow":
            self._log("slow_start", r.g, step=r.round_idx,
                      delay=f.duration_s)
            r.slow_delay = f.duration_s or 0.5
            r.slow_until_step = f.stop if f.stop is not None else 10 ** 9
            return False
        return False

    def _round_body(self, r: SimRank) -> None:
        # 1. failure detection -> heal
        dead_local = r.detector.dead_ranks()
        dead_global = {r.epoch_members[d] for d in dead_local}
        new_dead = dead_global - r.known_dead
        if new_dead:
            self._heal(r, new_dead)
        # 2. membership-epoch probe (the cheap word, then the board)
        self._probe_epochs(r)
        if r.exited:
            return
        # 3. sponsor-side admission (every round, like a round barrier
        # with a chaos join schedule of rank=-1).  The transport-level
        # flag (kept current by SimBoard._publish) makes the common
        # no-joiner round skip the board's JSON parse entirely.
        if self.transport.join_pending \
                and self.transport.board_reachable(r.g) \
                and self.board.pending_requests():
            live = r.live_members()
            if live and r.g == min(live):
                self._grant(r)
        # 4. adaptive demote/promote
        if self.cfg.adaptive:
            self._adaptive_step(r)
        # 5. combine whatever the in-slots hold
        self._combine(r)
        # 6. deposit this round's shares
        self._send(r)
        # 6b. lab oracle: per-rank successive-estimate difference, the
        # sim twin of the islands convergence probe
        if getattr(self.cfg, "trace_consensus", False):
            est = r.estimate
            prev = self._conv_prev.get(r.g)
            if prev is not None and est == est and prev == prev:
                self.consensus_trace.append(
                    (r.round_idx, r.g, abs(est - prev)))
            self._conv_prev[r.g] = est
        # 7. continuous audit: the lowest live rank checks the global
        # mass balance once per round (every protocol event above
        # checked it already; this catches combine/send-path leaks)
        live = r.live_members()
        if live and r.g == min(live):
            self._check("round", r.g)
        # 8. serving plane: the lowest live rank is the publisher —
        # every cfg.serve_every rounds it commits its debiased
        # estimate as the next snapshot version (quorum-fenced like
        # the real islands.serve_publish; an orphan never reaches this
        # line because its rounds are parked)
        if (self._serve_every > 0 and live and r.g == min(live)
                and r.round_idx % self._serve_every == 0):
            self._serve_publish(r)

    # -- membership machinery ---------------------------------------------

    def _heal(self, r: SimRank, new_dead: Set[int]) -> None:
        # quorum fence BEFORE any settlement: a minority-side heal
        # would adopt a live peer's ledger and fork the lineage — the
        # orphan must park without touching shared state
        if self._quorum_on:
            total = len(r.epoch_members)
            dead_all = (r.known_dead | new_dead) & set(r.epoch_members)
            live = total - len(dead_all)
            if not _quorum.quorum_met(live, total):
                self._enter_orphan(r, live, total)
                return
        for d in sorted(new_dead):
            settlement = self.transport.heal_settle(r.g, d, r.epoch)
            self._journal(r.g, "heal", dead=[d], epoch=r.epoch,
                          **settlement)
        r.known_dead |= new_dead
        dead_local = sorted(r.members.index(d) for d in new_dead
                            if d in r.members)
        if not dead_local:
            self._log("heal", r.g, dead=sorted(new_dead), noop=True)
            return
        old_members = r.members
        key = ("heal", r.cfg_key, tuple(dead_local))
        healed = self._topo_entry(
            key, lambda: _healing.heal_topology(r.graph, dead_local))
        survivors = tuple(old_members[l] for l in healed.to_global)
        if r.base_key == r.cfg_key:
            r.base_key = key
        else:
            # demoted view: heal the pre-demotion base in parallel so a
            # later promote restores from a corpse-free base
            bkey = ("heal", r.base_key, tuple(dead_local))
            base_graph = self._graph_of(r.base_key)
            self._topo_entry(
                bkey,
                lambda: _healing.heal_topology(base_graph, dead_local))
            r.base_key = bkey
            r.demoted &= set(survivors)
        r.members = survivors
        r.graph = healed.topology
        r.cfg_key = key
        self._note_lineage(r.g)
        self._log("heal", r.g, dead=sorted(new_dead),
                  members=len(survivors))
        self._check("heal", r.g, graph=r.graph)

    def _graph_of(self, key) -> DiGraph:
        ent = self._topo_cache[key]
        if isinstance(ent, DiGraph):
            return ent
        # planner results carry .topology
        return ent.topology

    def _rows_of(self, key, G: DiGraph):
        rows = self._rows_cache.get(key)
        if rows is None:
            rows = self._rows_cache[key] = self._rows(G)
        return rows

    def _probe_epochs(self, r: SimRank) -> None:
        """Adopt every committed epoch past mine.  Committed records
        are immutable, so the first prober's board read is shared
        fleet-wide (adopters only READ the record)."""
        # partition-aware read: a rank cut away from the board keeps
        # seeing the epoch word frozen at the cut, so it can neither
        # adopt nor be fenced by the far side's commits
        while self.transport.epoch_word_seen(r.g) > r.epoch \
                and not r.exited:
            rec = self._epoch_recs.get(r.epoch + 1)
            if rec is None:
                rec = self.board.epoch_record(r.epoch + 1)
                if rec is None:
                    break
                self._epoch_recs[r.epoch + 1] = rec
            self._adopt(r, rec)

    def _adopt(self, r: SimRank, rec: dict) -> None:
        new_members = tuple(int(m) for m in rec["members"])
        old_epoch = r.epoch
        # collector-side retirement of the old epoch's in-slots
        in_srcs = [r.members[u] for u in r.graph.predecessors(
            r.members.index(r.g))] if r.g in r.members else []
        pend, _ = self.transport.retire_epoch(r.g, old_epoch, in_srcs)
        led = self.transport.ledger(include={r.g})
        self._journal(r.g, "epoch_switch", old_epoch=old_epoch,
                      new_epoch=int(rec["epoch"]), global_rank=r.g,
                      joined=list(rec.get("joined", ())),
                      demoted=list(rec.get("demoted", ())),
                      **{f"ledger_{k}": v for k, v in led.items()
                         if k != "balanced"})
        if r.g not in new_members:
            # fenced: the fleet moved on without me (a zombie resumed
            # past its own death declaration).  Exit without a
            # snapshot — survivors adopted my ledger.
            self.transport.adopted_ranks.add(r.g)
            self.transport.lost_x += r.x
            self.transport.lost_p += r.p
            r.x = 0.0
            r.p = 0.0
            r.exited = True
            self._log("fenced", r.g, epoch=int(rec["epoch"]))
            self._check("fenced", r.g)
            return
        ekey = ("rec", int(rec["epoch"]))
        G = self._topo_entry(ekey, lambda: record_graph(rec))
        r.epoch = int(rec["epoch"])
        r.epoch_members = r.members = new_members
        r.graph = G
        r.cfg_key = ekey
        if rec.get("reweight"):
            r.demoted = {int(d) for d in rec.get("demoted", ())}
            bkey = ("recbase", int(rec["epoch"]))
            r.base_key = bkey
            if bkey not in self._topo_cache:
                B = DiGraph()
                B.add_nodes_from(range(len(new_members)))
                B.add_edges_from((int(u), int(v))
                                 for u, v in rec["base_edges"])
                from bluefog_tpu_torch import topology_util as tu

                tu.MetropolisHastingsWeights(B)
                self._topo_cache[bkey] = B
        else:
            r.demoted = set()
            r.base_key = ekey
        for d in rec.get("promoted", ()):
            r.health.absolve(int(d))
        changed = set(rec.get("demoted", ())) | set(rec.get("promoted", ()))
        if changed and r.policy is not None:
            r.policy.note_epoch_change(changed)
        # fresh detector over the new epoch's member view (the real
        # switch restarts it over the new job namespace)
        self._wire_rank(r)
        # known dead stay dead only if still relevant; new epochs never
        # include a declared corpse granted by a healed sponsor
        r.known_dead &= set(new_members)
        r.edge_seen = {}
        self._log("epoch_switch", r.g, epoch=r.epoch,
                  members=len(new_members),
                  reweight=bool(rec.get("reweight")))
        self._check("epoch_switch", r.g, graph=G,
                    demoted=r.demoted, members=new_members)

    def _grant(self, r: SimRank) -> None:
        # the grown view must not include a corpse (mirror
        # islands.admit_pending's pre-grant heal)
        dead_local = r.detector.dead_ranks()
        new_dead = {r.epoch_members[d] for d in dead_local} - r.known_dead
        if new_dead:
            self._heal(r, new_dead)
        live = r.live_members()
        if r.g != min(live):
            return
        Gg = relabel_nodes(r.graph,
                           {l: g for l, g in enumerate(r.members)},
                           copy=True)
        rec = self.board.grant(r.g, live, Gg, [], True, r.epoch)
        if rec is not None:
            self._note_lineage(r.g)
            self._log("grant", r.g, epoch=int(rec["epoch"]),
                      joined=list(rec["joined"]))
            self._journal(r.g, "join_admitted",
                          joined=list(rec["joined"]),
                          epoch=int(rec["epoch"]), sponsor=r.g)
            self._check("grant", r.g)

    def _joiner_event(self, f: Fault):
        def fire():
            if self.loop.now >= self.end_time:
                return
            self.joiners_spawned += 1
            req = self.board.post_request()
            self._log("join_post", -1, req=req)
            try:
                grant = self.board.wait_for_grant(
                    req, timeout=self.cfg.join_timeout_s)
            except TimeoutError:
                self._log("join_timeout", -1, req=req)
                return
            rec = grant.record
            sponsor = self.ranks.get(int(rec["sponsor"]))
            if sponsor is None or sponsor.killed:
                alive = [m for m in rec["members"]
                         if m in self.ranks
                         and not self.ranks[m].killed]
                sponsor = self.ranks[alive[0]] if alive else None
            est = sponsor.estimate if sponsor is not None else 0.0
            j = SimRank(grant.rank, x=est, p=1.0)
            self.joined_x += j.x
            self.joined_p += j.p
            j.epoch = int(rec["epoch"])
            j.epoch_members = j.members = tuple(
                int(m) for m in rec["members"])
            ekey = ("rec", j.epoch)
            j.graph = self._topo_entry(ekey, lambda: record_graph(rec))
            j.cfg_key = j.base_key = ekey
            self.ranks[j.g] = j
            self._wire_rank(j)
            self._journal(j.g, "epoch_switch", old_epoch=None,
                          new_epoch=j.epoch, global_rank=j.g,
                          joined=list(rec.get("joined", ())),
                          mass_admitted=j.x)
            self._log("join_enter", j.g, epoch=j.epoch,
                      sponsor=int(rec["sponsor"]))
            off = (j.g * 37 % 101) / 101.0
            self.loop.after(off * self.cfg.hb_interval,
                            self._hb_event(j.g))
            self.loop.after(off * self.cfg.round_period,
                            self._round_event(j.g))
            self._check("join", j.g)
        return fire

    # -- partition + orphan machinery -------------------------------------

    def _enter_orphan(self, r: SimRank, live: int, total: int) -> None:
        """The minority verdict: park the rank (rounds stop, shared
        state untouched) until the partition heals and the merge event
        re-admits it through the join machinery."""
        if r.orphaned:
            return
        r.orphaned = True
        self._journal(r.g, "orphan_entered", epoch=r.epoch,
                      global_rank=r.g, live=live, total=total,
                      floor=_quorum.majority_floor(total))
        self._log("orphan", r.g, live=live, total=total)
        self._check("orphan", r.g)

    def _note_lineage(self, g: int) -> None:
        """Record which partition side just committed membership
        progress (heal / grant / reweight) — the single-lineage
        invariant's feed.  A no-op outside a partition window."""
        if self._partition is not None:
            self._lineage.add(self._partition.get(int(g),
                                                  self._board_group))

    def _mass_anchor(self) -> Tuple[float, float]:
        """The conserved quantity ``live + slots + inflight + lost -
        joined`` — constant across every event, snapshotted at a cut
        as the partition+merge conservation anchor."""
        lx = math.fsum(r.x for r in self.ranks.values()
                       if not r.killed and not r.exited)
        lp = math.fsum(r.p for r in self.ranks.values()
                       if not r.killed and not r.exited)
        sx, sp = self.transport.slot_mass()
        ix, ip = self.transport.inflight_mass()
        return (lx + sx + ix + self.transport.lost_x - self.joined_x,
                lp + sp + ip + self.transport.lost_p - self.joined_p)

    def _partition_start_event(self, f: Fault):
        def fire():
            if self._partition is not None:
                return  # one cut at a time
            current = {g for g, r in self.ranks.items()
                       if not r.killed and not r.exited}
            groups: Dict[int, int] = {}
            for i, side in enumerate(f.groups()):
                for g in side:
                    groups[int(g)] = i + 1
            for g in current:
                groups.setdefault(g, 0)  # the implicit "rest" side
            # the board lives with the lowest live rank's side (the
            # real board sits on the sponsor host's filesystem)
            live_now = sorted(current)
            board_group = groups.get(live_now[0], 0) if live_now else 0
            self.transport.set_partition(groups, board_group)
            self._partition = groups
            self._board_group = board_group
            self._lineage = set()
            self._partition_anchor = self._mass_anchor()
            self._log("partition_start", -1, groups=f.group,
                      board_side=board_group)
            self._check("partition_start", -1)
        return fire

    def _partition_end_event(self, f: Fault):
        def fire():
            if self._partition is None:
                return
            self.transport.clear_partition()
            orphans = sorted(g for g, r in self.ranks.items()
                             if r.orphaned and not r.killed
                             and not r.exited)
            self._log("partition_heal", -1, orphans=orphans)
            self._partition = None
            self._lineage = set()
            # the anchor stays armed: the conserved quantity must
            # still hold through every merge-back below
            for g in orphans:
                self.loop.after(0.0, self._merge_orphan_event(g))
            self._check("partition_heal", -1)
        return fire

    def _merge_orphan_event(self, g: int):
        def fire():
            r = self.ranks.get(g)
            if r is None or r.killed or r.exited or not r.orphaned:
                return
            est = r.estimate
            carried = est if est == est else 0.0
            # the old identity retires: survivors healed it out and
            # adopted its ledger, so its stale mass is written off and
            # it re-enters below with unit mass at its carried
            # (debiased) estimate — mirroring islands.merge_orphan
            self.transport.adopted_ranks.add(g)
            self.transport.lost_x += r.x
            self.transport.lost_p += r.p
            r.x = 0.0
            r.p = 0.0
            r.exited = True
            self._log("merge_post", g, carried=round(carried, 9))
            self._check("merge_post", g)
            req = self.board.post_request()
            try:
                grant = self.board.wait_for_grant(
                    req, timeout=self.cfg.join_timeout_s)
            except TimeoutError:
                # nobody left to sponsor (e.g. an even split orphaned
                # everyone): the rank stays fenced, mass written off
                self._log("merge_timeout", g, req=req)
                self._check("merge_timeout", g)
                return
            rec = grant.record
            j = SimRank(grant.rank, x=carried, p=1.0)
            self.joined_x += j.x
            self.joined_p += j.p
            j.epoch = int(rec["epoch"])
            j.epoch_members = j.members = tuple(
                int(m) for m in rec["members"])
            ekey = ("rec", j.epoch)
            j.graph = self._topo_entry(ekey, lambda: record_graph(rec))
            j.cfg_key = j.base_key = ekey
            self.ranks[j.g] = j
            self._wire_rank(j)
            self.orphans_merged += 1
            self._journal(j.g, "orphan_merged", old_rank=g,
                          new_rank=j.g, epoch=j.epoch,
                          carried_estimate=carried)
            self._log("merge_enter", j.g, epoch=j.epoch, old=g,
                      sponsor=int(rec["sponsor"]))
            off = (j.g * 37 % 101) / 101.0
            self.loop.after(off * self.cfg.hb_interval,
                            self._hb_event(j.g))
            self.loop.after(off * self.cfg.round_period,
                            self._round_event(j.g))
            self._check("merge", j.g)
        return fire

    # -- serving plane ------------------------------------------------------

    def _kill_rank(self, r: SimRank) -> None:
        """SIGKILL semantics shared with the ``kill`` fault: mass is
        seized to the lost bucket and the in-slots sever; survivors
        detect via heartbeat timeout and heal."""
        r.killed = True
        self.transport.kill(r.g)
        self.transport.lost_x += r.x
        self.transport.lost_p += r.p
        r.x = 0.0
        r.p = 0.0

    def _serve_publish(self, r: SimRank) -> None:
        """The publisher analog of ``islands.serve_publish``: fence on
        quorum, then commit (version, debiased estimate) — the version
        word persists fleet-wide (the region header survives publisher
        death), so a successor continues strictly monotone."""
        if r.orphaned:
            # the quorum denial can land mid-round (the detector
            # verdict at step 1 orphans the rank, but this round body
            # keeps running) — the real serve_publish raises
            # OrphanedError here via its _orphan_guard
            self._log("serve_fenced", r.g, orphaned=True)
            return
        if self._quorum_on:
            total = len(r.epoch_members)
            dead = r.known_dead & set(r.epoch_members)
            live_n = total - len(dead)
            if not _quorum.quorum_met(live_n, total):
                self._log("serve_fenced", r.g, live=live_n, total=total)
                return
        self._serve_pub_count += 1
        version = self._serve_version + 1
        if ("serve_version_reset" in self.cfg.debug_bugs
                and self._serve_pub_count > 1):
            version = 1  # seeded bug: handoff forgets the header word
        f = self._serve_pub_faults.get(self._serve_pub_count)
        payload = r.estimate
        if f is not None:
            phase = f.group or "payload"
            self._log("serve_pub_kill", r.g,
                      publish=self._serve_pub_count, phase=phase)
            if phase == "flip":
                # payload buffer whole, death mid-header-flip: the
                # successor's attach repairs forward to this version
                self._serve_commit(r.g, version, payload, repaired=True)
            # payload phase: standby buffer torn (odd seq), header
            # intact — nothing commits, survivors keep the old version
            if self._arrivals:
                self._arr_stale_open.append(self._arr_window(
                    "pub_kill", -1, ("staleness",), None))
            self._kill_rank(r)
            self._check("serve_pub_kill", r.g)
            return
        self._serve_commit(r.g, version, payload)

    def _serve_commit(self, g: int, version: int, payload: float,
                      repaired: bool = False) -> None:
        err = _inv.check_serve_version_monotone(self._serve_version,
                                                version)
        if err:
            self._violate("serve-monotone", f"at publish: {err}", g)
        self._serve_version = max(self._serve_version, version)
        self._serve_committed.append((version, payload))
        self._serve_commit_t[version] = self.loop.now
        if self._arrivals:
            # a successful commit bounds every open staleness excuse:
            # replicas have one propagation pad to catch up, then the
            # staleness SLO re-arms
            pad = self._arr_pad()
            for w in self._arr_stale_open:
                w["t1"] = self.loop.now + pad
            self._arr_stale_open = []
            self._arr_window("publish", -1, ("staleness",),
                             self.loop.now + pad)
        aux = {"repaired": True} if repaired else {}
        self._log("serve_publish", g, version=version, **aux)

    def _serve_replica_event(self, i: int):
        def fire():
            rep = self._serve_replicas[i]
            if rep["killed"] or self._all_done() \
                    or self.loop.now >= self.end_time:
                return
            self._serve_replica_step(i, rep)
            self.loop.after(self.cfg.round_period,
                            self._serve_replica_event(i))
        return fire

    def _serve_replica_join_event(self, i: int):
        def fire():
            rep = self._serve_replicas[i]
            if self._all_done() or self.loop.now >= self.end_time:
                return
            # a respawned replica is a fresh incarnation: nothing
            # installed, version floor back at 0 (per-replica
            # monotonicity is per incarnation, as in the real fleet);
            # in a distribution tree it re-joins as a leaf (its old
            # slot was reassigned away when it died)
            rep.update(version=0, payload=None, killed=False)
            if (self._distrib_fanout > 0
                    and i not in self._distrib_parents):
                self._distrib_place(i)
            self._log("serve_replica_join", 1000 + i)
            w = self._arr_kill_open.pop(i, None)
            if w is not None:
                # the respawn needs to re-adopt (possibly down a fresh
                # tree edge) and drain its backlog before the SLO
                # re-arms for this replica
                w["t1"] = self.loop.now + self._arr_pad() \
                    + self.cfg.round_period
            self.loop.after(0.0, self._serve_replica_event(i))
        return fire

    def _serve_replica_step(self, i: int, rep: dict) -> None:
        if self._distrib_fanout > 0:
            # tree-fed: adopt only what has propagated down the feed
            # edge, and only FORWARD (a re-parent under a lagging
            # relay must not regress the served version — mirrors
            # Replica.poll_swap's monotone skip)
            avail = self._distrib_visible(i, rep)
            if avail is not None and avail[0] > rep["version"]:
                if not self._serve_replica_adopt(i, rep, *avail):
                    return
            slo = int(getattr(self.cfg, "distrib_slo", 0) or 0)
            err = _inv.check_distrib_staleness(
                i, self._serve_version - rep["version"], slo)
            if err:
                self._violate("distrib-staleness", err, 1000 + i)
        elif self._serve_committed:
            version, payload = self._serve_committed[-1]
            if version != rep["version"]:
                if not self._serve_replica_adopt(i, rep, version,
                                                 payload):
                    return
        # serve from whatever is installed; every served byte must be
        # some committed snapshot (the torn-read invariant)
        if rep["payload"] is not None:
            err = _inv.check_serve_snapshot_committed(
                rep["payload"], self._serve_committed)
            if err:
                self._violate("serve-committed",
                              f"replica {i}: {err}", 1000 + i)
            rep["steps"] += 1
            if self._arrivals:
                self._drain_requests(i, rep)

    def _serve_replica_adopt(self, i: int, rep: dict, version: int,
                             payload: float) -> bool:
        """One hot-swap attempt at replica ``i``.  Returns False when
        the chaos kill fault fires instead (the replica died mid-swap
        and must not serve this step)."""
        f = self._serve_kill_faults.get(i)
        if (f is not None and not rep["fired"]
                and rep["swaps"] + 1 == f.step):
            # die mid-swap (between the read and the flip): nothing
            # torn lands — the installed snapshot is still whole when
            # the process dies
            rep["fired"] = True
            rep["killed"] = True
            self._log("serve_replica_kill", 1000 + i,
                      swap=rep["swaps"] + 1, version=version)
            if self._distrib_fanout > 0:
                self._distrib_on_kill(i)
            if f.stop is not None:
                self.loop.at(
                    _T0 + f.stop * self.cfg.round_period,
                    self._serve_replica_join_event(i))
            if self._arrivals:
                # every request this replica queues from here until its
                # respawn (plus one adopt+drain pad) has a cause
                self._arr_kill_open[i] = self._arr_window(
                    "replica_kill", i, ("latency", "staleness"), None)
            return False
        err = _inv.check_serve_version_monotone(rep["version"],
                                                version)
        if err:
            self._violate("serve-monotone",
                          f"replica {i}: {err}", 1000 + i)
        new_payload = payload
        if ("serve_torn" in self.cfg.debug_bugs
                and rep["payload"] is not None):
            # seeded bug: the swap mixes old and new buffer
            # bytes instead of flipping one whole generation
            new_payload = 0.5 * (rep["payload"] + payload)
        rep["version"] = version
        rep["payload"] = new_payload
        rep["swaps"] += 1
        rep["install_t"] = self.loop.now
        self._log("serve_swap", 1000 + i, version=version)
        return True

    # -- serve traffic model (loadgen analog) ------------------------------

    def _arm_arrivals(self, rep: dict, i: int, t_start: float) -> None:
        """Precompute replica ``i``'s open-loop arrival schedule on the
        virtual clock (absolute instants).  The schedule is fixed here,
        before any request fires, and NEVER re-anchored — a killed
        replica's requests keep arriving and queue against its respawn,
        exactly like the real driver's overdue backlog."""
        if not self._arrivals:
            return
        cfg = self.cfg
        horizon = _T0 + (cfg.rounds + cfg.quiesce_rounds) \
            * cfg.round_period
        dur = horizon - t_start
        rep["drains"] = 0
        rep["arr_i"] = 0
        if dur <= 0:
            rep["arr"] = []
            return
        from bluefog_tpu_torch.serve.loadgen.arrivals import arrival_times
        offs = arrival_times(self._arrivals, cfg.arrival_rate, dur,
                             int(cfg.seed), stream=i)
        rep["arr"] = [t_start + o for o in offs]

    def _arr_pad(self) -> float:
        """How long after a cause event its staleness effect may
        legitimately linger: one adopt poll plus propagation down the
        deepest feed chain (tree-fed fleets adopt one hop per poll)."""
        depth = 0
        if self._distrib_fanout > 0:
            from bluefog_tpu_torch.serve.distrib import tree as _dtree
            depth = _dtree.tree_depth(self._distrib_parents)
        lo, hi = self.cfg.latency_s
        return (depth + 1) * (self.cfg.round_period + float(hi)) \
            + self.cfg.round_period

    def _arr_window(self, kind: str, replica: int, covers: tuple,
                    t1: Optional[float]) -> dict:
        w = {"kind": kind, "replica": int(replica),
             "t0": self.loop.now, "t1": t1, "covers": covers}
        self._arr_windows.append(w)
        return w

    def _arr_attributed(self, i: int, kind: str, t0: float,
                        t1: float) -> bool:
        """Does any injected-fault window that covers failure mode
        ``kind`` (for replica ``i`` or fleet-wide) overlap [t0, t1]?"""
        for w in self._arr_windows:
            if kind not in w["covers"]:
                continue
            if w["replica"] not in (-1, i):
                continue
            wt1 = w["t1"] if w["t1"] is not None else float("inf")
            if t0 <= wt1 and w["t0"] <= t1:
                return True
        return False

    def _drain_requests(self, i: int, rep: dict) -> None:
        """Serve every admitted request (scheduled instant <= now) at
        replica ``i``, charging open-loop latency and auditing both
        request invariants per request."""
        arr = rep.get("arr")
        if not arr:
            return
        rep["drains"] += 1
        if ("slo_silent_violation" in self.cfg.debug_bugs
                and rep["drains"] % 3 != 1):
            return  # seeded bug: the queue sits through two polls
        now = self.loop.now
        k = rep["arr_i"]
        n = 0
        worst = 0.0
        lag = self._serve_version - rep["version"]
        while k < len(arr) and arr[k] <= now:
            sched = arr[k]
            charged = sched
            if "loadgen_omission" in self.cfg.debug_bugs:
                charged = now  # seeded bug: re-anchor the send time
            err = _inv.check_open_loop(sched, charged)
            if err:
                self._req_violations += 1
                self._violate("open-loop", err, 1000 + i)
            latency = now - charged
            self._req_served += 1
            if self._req_slo > 0 and latency > self._req_slo:
                att = self._arr_attributed(i, "latency", sched, now)
                if att:
                    self._req_attributed += 1
                err = _inv.check_request_slo(i, latency, self._req_slo,
                                             att)
                if err:
                    self._req_violations += 1
                    self._violate("request-slo", err, 1000 + i)
            if self._req_stale_slo > 0 and lag > self._req_stale_slo:
                att = self._arr_attributed(i, "staleness", sched, now)
                if att:
                    self._req_attributed += 1
                err = _inv.check_request_staleness(
                    i, lag, self._req_stale_slo, att)
                if err:
                    self._req_violations += 1
                    self._violate("request-staleness", err, 1000 + i)
            worst = max(worst, latency)
            k += 1
            n += 1
        if n:
            rep["arr_i"] = k
            self._log("serve_requests", 1000 + i, n=n,
                      worst=round(worst, 9), lag=lag)

    def _check_arrivals(self, point: str, g: int) -> None:
        """The standing form of the two request invariants, audited
        after every protocol event: no live replica may be sitting on
        a queued request already past the SLO, or serving further
        behind the head than the staleness SLO, without a fault window
        to blame — catches a silent stall BEFORE the drain would."""
        if not self._arrivals:
            return
        now = self.loop.now
        for i, rep in self._serve_replicas.items():
            arr = rep.get("arr")
            if not arr or rep["killed"] or rep["payload"] is None:
                continue  # kill/warmup paths are audited at drain time
            k = rep["arr_i"]
            if k < len(arr) and self._req_slo > 0:
                age = now - arr[k]
                if age > self._req_slo and not self._arr_attributed(
                        i, "latency", arr[k], now):
                    err = _inv.check_request_slo(i, age, self._req_slo,
                                                 False)
                    if err:
                        self._req_violations += 1
                        self._violate("request-slo",
                                      f"at {point} (queued): {err}",
                                      1000 + i)
            if self._req_stale_slo > 0:
                lag = self._serve_version - rep["version"]
                if lag > self._req_stale_slo \
                        and not self._arr_attributed(
                            i, "staleness", now, now):
                    err = _inv.check_request_staleness(
                        i, lag, self._req_stale_slo, False)
                    if err:
                        self._req_violations += 1
                        self._violate("request-staleness",
                                      f"at {point}: {err}", 1000 + i)

    # -- distribution tree (serve.distrib model) ---------------------------

    def _distrib_edge_latency(self) -> float:
        lo, hi = self.cfg.latency_s
        return self._distrib_rng.uniform(float(lo), float(hi))

    def _distrib_check_tree(self, g: int) -> None:
        err = _inv.check_distrib_tree(self._distrib_parents,
                                      self._distrib_fanout)
        if err:
            self._violate("distrib-tree", err, g)

    def _distrib_dead(self) -> set:
        return {j for j, rj in self._serve_replicas.items()
                if rj["killed"]}

    def _distrib_visible(self, i: int, rep: dict):
        """What replica ``i`` sees through its feed edge right now:
        the newest snapshot its parent installed (or the newest region
        commit when publisher-fed) whose per-edge propagation latency
        has elapsed, or None while the edge has nothing newer."""
        now = self.loop.now
        lat = self._distrib_lat.get(i, 0.0)
        parent = self._distrib_parents.get(i, -1)
        if parent >= 0:
            prep = self._serve_replicas.get(parent)
            if prep is None or prep["killed"]:
                # dead feed edge with no reassignment (the
                # distrib_stall seeded bug): the subtree freezes and
                # the staleness SLO catches it
                return None
            if prep["payload"] is None or now < prep["install_t"] + lat:
                return None
            return prep["version"], prep["payload"]
        for version, payload in reversed(self._serve_committed):
            if now >= self._serve_commit_t.get(version, 0.0) + lat:
                return version, payload
        return None

    def _distrib_on_kill(self, i: int) -> None:
        """A tree node died: its direct children re-parent via the
        SAME greedy repair the real coordinator runs
        (serve.distrib.tree.reassign — subtrees ride along), and tree
        validity is re-audited.  The distrib_stall seeded bug skips
        the repair, so the orphaned subtree freezes and the staleness
        SLO fires instead."""
        from bluefog_tpu_torch.serve.distrib import tree as _dtree

        if "distrib_stall" in self.cfg.debug_bugs:
            return
        old = dict(self._distrib_parents)
        cap = "distrib_degree_overflow" not in self.cfg.debug_bugs
        self._distrib_parents = _dtree.reassign(
            old, i, self._distrib_fanout, degree_cap=cap)
        self._distrib_lat.pop(i, None)
        for c in sorted(self._distrib_parents):
            if old.get(c) != self._distrib_parents[c]:
                self._distrib_reparents += 1
                self._distrib_lat[c] = self._distrib_edge_latency()
                self._log("distrib_reparent", 1000 + c, dead=i,
                          parent=self._distrib_parents[c])
        self._distrib_check_tree(1000 + i)

    def _distrib_place(self, i: int) -> None:
        """Graft replica ``i`` into the tree as a leaf (a join-storm
        arrival, or a respawned incarnation re-joining)."""
        from bluefog_tpu_torch.serve.distrib import tree as _dtree

        cap = "distrib_degree_overflow" not in self.cfg.debug_bugs
        p = _dtree.choose_parent(i, self._distrib_parents,
                                 self._distrib_fanout,
                                 dead=self._distrib_dead(),
                                 degree_cap=cap)
        self._distrib_parents[i] = p
        self._distrib_lat[i] = self._distrib_edge_latency()
        self._distrib_joins += 1
        self._log("distrib_join", 1000 + i, parent=p)
        self._distrib_check_tree(1000 + i)

    def _distrib_join_storm_event(self, n: int):
        def fire():
            if self._all_done() or self.loop.now >= self.end_time:
                return
            base = max(self._serve_replicas, default=-1) + 1
            for j in range(n):
                i = base + j
                self._serve_replicas[i] = {
                    "version": 0, "payload": None, "swaps": 0,
                    "steps": 0, "killed": False, "fired": False,
                    "install_t": 0.0}
                self._arm_arrivals(
                    self._serve_replicas[i], i,
                    self.loop.now + 2 * self.cfg.round_period)
                self._distrib_place(i)
                off = ((1000 + i) * 37 % 101) / 101.0
                self.loop.after(off * self.cfg.round_period,
                                self._serve_replica_event(i))
        return fire

    # -- adaptive demote/promote ------------------------------------------

    def _adaptive_step(self, r: SimRank) -> None:
        if r.health is None or len(r.members) < 3:
            return
        live = set(r.live_members())
        suspects = {s for s in r.health.suspects()
                    if s in live and s not in r.demoted and s != r.g}
        gated = sorted(
            (s for s in suspects
             if r.policy.epoch_floor_open(s) and r.policy.corroborated(s)),
            key=lambda s: (-r.health.time_in_state(s), s))
        cap = (len(live) - 1) // 2
        if "cap_bypass" in self.cfg.debug_bugs:
            cap = len(live)  # seeded bug: no minority cap
        room = cap - len(r.demoted)
        if gated and room > 0:
            picks = set(gated[:room])
            self._commit_reweight(r, r.demoted | picks, promoted=())
            return
        promo = [d for d in sorted(r.demoted)
                 if d in live and r.health.state(d) == EDGE_ALIVE
                 and self._is_anchor(r, d)
                 and r.policy.epoch_floor_open(d)]
        if promo:
            self._commit_reweight(r, r.demoted - set(promo),
                                  promoted=tuple(promo))

    def _is_anchor(self, r: SimRank, straggler_g: int) -> bool:
        if straggler_g not in r.members:
            return False
        sl = r.members.index(straggler_g)
        nbrs = set(r.graph.predecessors(sl)) | set(r.graph.successors(sl))
        nbrs.discard(sl)
        return len(nbrs) == 1 and r.members.index(r.g) in nbrs

    def _commit_reweight(self, r: SimRank, demote_set: Set[int],
                         promoted: Tuple[int, ...]) -> None:
        if not self.transport.board_reachable(r.g):
            return  # cut away from the board: the commit would stall
        base_graph = self._graph_of(r.base_key)
        demote_local = sorted(r.members.index(d) for d in demote_set
                              if d in r.members)
        key = ("demote", r.base_key, tuple(demote_local))
        if demote_local:
            plan = self._topo_entry(
                key,
                lambda: _healing.demote_topology(base_graph,
                                                 demote_local))
            edges = list(plan.topology.edges)
        else:
            plan = self._topo_entry(
                ("restore", r.base_key),
                lambda: _healing.heal_topology(base_graph, []))
            edges = list(plan.topology.edges)
        rec = self.board.commit_reweight(
            r.g, r.epoch, list(r.members), edges, [], True,
            sorted(demote_set), sorted(promoted),
            list(base_graph.edges))
        if rec is not None and rec.get("reweight") \
                and int(rec["sponsor"]) == r.g \
                and int(rec["epoch"]) == r.epoch + 1:
            self._note_lineage(r.g)
            kind = "promote_commit" if promoted else "demote_commit"
            self._log(kind, r.g, epoch=int(rec["epoch"]),
                      demoted=sorted(demote_set),
                      promoted=sorted(promoted))
            self._check("reweight", r.g,
                        commit_members=len(r.live_members()),
                        commit_demoted=len(demote_set))

    # -- gossip ------------------------------------------------------------

    def _combine(self, r: SimRank) -> None:
        if r.g not in r.members:
            return
        me = r.members.index(r.g)
        now = self.loop.now
        dl = r.policy.gap_deadline_s() if (
            self.cfg.adaptive and r.policy is not None) else None
        for u in sorted(r.graph.predecessors(me)):
            src = r.members[u]
            if src in r.known_dead:
                continue
            ver = self.transport.read_version(r.epoch, r.g, src)
            seen = r.edge_seen.get(src)
            if seen is None:
                r.edge_seen[src] = [ver, now, False]
            elif ver > seen[0]:
                gap = now - seen[1]
                if self.cfg.adaptive:
                    clean = dl is None or gap <= dl
                    r.policy.note_fresh(src, gap, clean=clean)
                r.edge_seen[src] = [ver, now, False]
            else:
                age = now - seen[1]
                if (self.cfg.adaptive and dl is not None and age > dl
                        and not seen[2]):
                    r.policy.note_stale(src, age)
                    seen[2] = True
            cx, cp, fresh = self.transport.collect(r.epoch, r.g, src)
            if fresh:
                if "mass_leak" in self.cfg.debug_bugs:
                    cx *= 1.0 - 1e-3  # seeded bug: combine leaks mass
                r.x += cx
                r.p += cp

    def _send(self, r: SimRank) -> None:
        if r.g not in r.members:
            return
        me = r.members.index(r.g)
        rows = self._rows_of(r.cfg_key, r.graph)
        keep, out = rows[me]
        if not out:
            return
        sent_x = 0.0
        sent_p = 0.0
        lo, hi = self.cfg.latency_s
        for v, w in out:
            dst = r.members[v]
            if dst in r.known_dead:
                # degraded send: the weight a dead neighbor would have
                # received stays with the sender (mass-conserving)
                continue
            lat = (self.rng.uniform(lo, hi) if self._lat_model is None
                   else self._lat_model.sample(r.g, dst, self.rng))
            mx = w * r.x
            mp = w * r.p
            sent_x += mx
            sent_p += mp
            self.transport.deposit(r.epoch, r.g, dst, mx, mp, lat)
        r.x -= sent_x
        r.p -= sent_p

    # -- invariants, logging, results -------------------------------------

    def _log(self, kind: str, g: int, **aux) -> None:
        t = round(self.loop.now, 9)
        items = tuple(sorted(aux.items()))
        self.event_log.append((t, kind, int(g), items))

    def _violate(self, name: str, detail: str, g: int = -1) -> None:
        v = {"t": round(self.loop.now, 9), "name": name,
             "detail": detail, "rank": int(g)}
        self.violations.append(v)
        self._log("violation", g, name=name)
        if len(self.violations) >= 50:
            # runaway guard: a broken invariant fires on every
            # subsequent event; 50 samples are plenty for the shrinker
            self._faults.clear()

    def _check(self, point: str, g: int, graph: Optional[DiGraph] = None,
               demoted: Optional[Set[int]] = None,
               members: Optional[Tuple[int, ...]] = None,
               commit_members: Optional[int] = None,
               commit_demoted: Optional[int] = None) -> None:
        """The standing invariants, audited after every protocol
        event (see module docstring)."""
        err = _inv.check_mass_conservation(
            live_x=math.fsum(r.x for r in self.ranks.values()
                             if not r.killed and not r.exited),
            live_p=math.fsum(r.p for r in self.ranks.values()
                             if not r.killed and not r.exited),
            transport=self.transport,
            initial=(self.initial_x, self.initial_p),
            joined=(self.joined_x, self.joined_p),
            tol=self.cfg.mass_tol)
        if err:
            self._violate("mass-conservation", f"at {point}: {err}", g)
        word = self.transport.epoch_word
        err = _inv.check_epoch_monotone(self._epoch_word_seen, word)
        if err:
            self._violate("epoch-monotone", f"at {point}: {err}", g)
        self._epoch_word_seen = max(self._epoch_word_seen, word)
        # partition-window invariants (standing: audited after every
        # event, like the rest — they just only arm once a cut lands)
        if self._lineage:
            err = _inv.check_single_lineage(self._lineage)
            if err:
                self._violate("single-lineage", f"at {point}: {err}", g)
        if self._partition_anchor is not None:
            err = _inv.check_partition_merge_mass(
                self._partition_anchor, self._mass_anchor(),
                tol=self.cfg.mass_tol)
            if err:
                self._violate("partition-mass", f"at {point}: {err}", g)
        if graph is not None and id(graph) not in self._graphs_ok:
            err = _inv.check_doubly_stochastic(graph)
            if err:
                self._violate("doubly-stochastic",
                              f"at {point}: {err}", g)
            else:
                # memoized plan graphs are shared fleet-wide; verify
                # each object once (the dict keeps it alive so the id
                # can't be recycled)
                self._graphs_ok[id(graph)] = graph
        if demoted is not None and members is not None:
            err = _inv.check_minority_demotion(len(members), len(demoted))
            if err:
                self._violate("minority-demotion",
                              f"adopted at {point}: {err}", g)
        if commit_members is not None and commit_demoted is not None:
            err = _inv.check_minority_demotion(commit_members,
                                               commit_demoted)
            if err:
                self._violate("minority-demotion",
                              f"committed at {point}: {err}", g)
        self._check_arrivals(point, g)
        if self._monitor is not None:
            if commit_members is not None and commit_demoted is not None:
                # demotion pressure is event-borne, not state-borne:
                # remember the worst excess seen since the last sample
                self._mon_demote_ex = max(
                    self._mon_demote_ex,
                    float(commit_demoted - _inv.demotion_cap(
                        commit_members)))
            while self.loop.now >= self._mon_next:
                self._monitor_sample(self._mon_next)
                self._mon_next += float(self.cfg.round_period)

    def _monitor_sample(self, t: float) -> None:
        """One virtual-clock scrape: derive the monitor series from the
        fleet state and feed the SAME engine the live scraper runs.
        Virtual time serves as both monotonic and wall twin."""
        points: List[Tuple[str, str, float]] = []
        # conservation residual over the same buckets the standing
        # invariant sums (live + slots + inflight + lost vs initial +
        # joined, relative to scale)
        sx, sp = self.transport.slot_mass()
        ix, ip = self.transport.inflight_mass()
        live_x = math.fsum(r.x for r in self.ranks.values()
                           if not r.killed and not r.exited)
        live_p = math.fsum(r.p for r in self.ranks.values()
                           if not r.killed and not r.exited)
        want_x = self.initial_x + self.joined_x
        want_p = self.initial_p + self.joined_p
        dx = abs(live_x + sx + ix + self.transport.lost_x - want_x) \
            / max(1.0, abs(want_x))
        dp = abs(live_p + sp + ip + self.transport.lost_p - want_p) \
            / max(1.0, abs(want_p))
        points.append(("mass_err", "fleet", max(dx, dp)))
        # split brain: two live, non-orphan groups at one epoch whose
        # views MUTUALLY exclude each other's live holders.  Merely
        # different views are a normal heal-adoption transient (the
        # laggard's view is a superset of the adopter's); a fork means
        # each side has healed the other side out while both still run.
        by_epoch: Dict[int, Dict[tuple, List[int]]] = {}
        for g, r in sorted(self.ranks.items()):
            if r.killed or r.exited or r.orphaned:
                continue
            by_epoch.setdefault(r.epoch, {}).setdefault(
                tuple(r.members), []).append(g)
        fork = 0.0
        for vs in by_epoch.values():
            items = sorted(vs.items())
            for a in range(len(items)):
                for b in range(a + 1, len(items)):
                    va, ha = items[a]
                    vb, hb = items[b]
                    if "mon_naive_fork" in self.cfg.debug_bugs:
                        # seeded defect: a detector that alarms on ANY
                        # view divergence — heal transients included
                        fork = 1.0
                    elif (any(g not in va for g in hb)
                            and any(g not in vb for g in ha)):
                        fork = 1.0
        points.append(("epoch_fork", "fleet", fork))
        points.append(("demote_excess", "fleet", self._mon_demote_ex))
        self._mon_demote_ex = 0.0
        # overdue admitted-but-unserved requests per replica model
        if self._arrivals:
            for i, rep in sorted(self._serve_replicas.items()):
                arr = rep.get("arr")
                if not arr:
                    continue
                k = bisect.bisect_right(arr, t)
                overdue = any(t - arr[j] > self._req_slo
                              for j in range(rep["arr_i"], k))
                points.append(("request_slo", f"replica{i}",
                               1.0 if overdue else 0.0))
        self._mon_samples += 1
        if "mon_silent" in self.cfg.debug_bugs:
            # seeded defect: a monitor that scrapes but never feeds its
            # engine — every alert goes silent
            points = []
        self._monitor.feed(t, points, wall=t)

    def run(self) -> None:
        self.loop.run(max_events=self.cfg.max_events)

    def finalize(self) -> dict:
        """Quiesce-time settlement + the final invariant audit."""
        # fence zombies that never noticed (suspended past the end)
        for g, r in sorted(self.ranks.items()):
            if not r.killed and not r.exited and r.g not in self._members_now():
                self.transport.adopted_ranks.add(g)
                self.transport.lost_x += r.x
                self.transport.lost_p += r.p
                r.x = 0.0
                r.p = 0.0
                r.exited = True
                self._log("fenced", g, at="finalize")
        # shutdown-style board sync: a rank that finished its rounds
        # early stops probing, but stragglers may have committed
        # later epochs behind its back (demote/promote churn) — adopt
        # them now so the pending probe runs against the slots peers
        # actually deposited into (the real shutdown barrier does the
        # same final sync before settling)
        for g, r in sorted(self.ranks.items()):
            if not r.killed and not r.exited:
                self._probe_epochs(r)
        members = self._members_now()
        for g in members:
            r = self.ranks[g]
            me = r.members.index(r.g)
            in_srcs = [r.members[u] for u in r.graph.predecessors(me)]
            self.transport.probe_pending(g, r.epoch, in_srcs)
        self._check("finalize", -1)
        ledger = self.transport.ledger()
        if not ledger["balanced"]:
            self._violate(
                "ledger-balance",
                f"deposits {ledger['deposits']} != collected "
                f"{ledger['collected']} + drained {ledger['drained']} "
                f"+ pending {ledger['pending']}")
        ests = {g: self.ranks[g].estimate for g in members}
        err = _inv.check_consensus(ests, tol=self.cfg.consensus_tol,
                                   scale=max(1.0, abs(self.initial_x)
                                             / max(1, self.initial_p)))
        if err:
            self._violate("consensus", err)
        if self.cfg.journal_dir:
            self._write_snapshots(members)
        epoch = max((self.ranks[g].epoch for g in members), default=0)
        out = {"members": sorted(members), "epoch": epoch,
               "ledger": ledger, "estimates": ests}
        if self._serve_every > 0:
            # replicas outlive the training rounds: one final poll so
            # a replica whose cadence straddled the last publish still
            # converges to the committed head before the audit (a
            # tree-fed fleet needs one sweep per relay level — the
            # head propagates one hop per poll)
            from bluefog_tpu_torch.serve.distrib import tree as _dtree
            sweeps = 1 if self._distrib_fanout <= 0 else \
                max(1, _dtree.tree_depth(self._distrib_parents) + 1)
            # virtual time is frozen here, so in-flight edge latency
            # would never elapse: the quiesce drain zeroes it (every
            # real edge has long since delivered by end_time)
            self._distrib_lat = {k: 0.0 for k in self._distrib_lat}
            for _ in range(sweeps):
                for i, rep in sorted(self._serve_replicas.items()):
                    if not rep["killed"]:
                        self._serve_replica_step(i, rep)
            out["serve"] = {
                "published": self._serve_version,
                "commits": len(self._serve_committed),
                "replicas": {
                    i: {"version": rep["version"],
                        "swaps": rep["swaps"], "steps": rep["steps"],
                        "killed": rep["killed"]}
                    for i, rep in sorted(self._serve_replicas.items())}}
            if self._distrib_fanout > 0:
                out["serve"]["distrib"] = {
                    "fanout": self._distrib_fanout,
                    "parents": dict(sorted(
                        self._distrib_parents.items())),
                    "depth": _dtree.tree_depth(self._distrib_parents),
                    "reparents": self._distrib_reparents,
                    "joins": self._distrib_joins,
                }
            if self._arrivals:
                # requests admitted before end-of-campaign that never
                # drained (their replica died and stayed dead) must
                # still be accounted: attributed to the open kill
                # window, or a silent drop
                now = self.loop.now
                for i, rep in sorted(self._serve_replicas.items()):
                    arr = rep.get("arr")
                    if not arr:
                        continue
                    k = rep["arr_i"]
                    while k < len(arr) and arr[k] <= now:
                        if self._arr_attributed(i, "latency",
                                                arr[k], now):
                            self._req_attributed += 1
                        else:
                            self._req_violations += 1
                            self._violate(
                                "request-slo",
                                f"at finalize (unserved): replica {i} "
                                f"request scheduled at t={arr[k]:.3f} "
                                "was never served and no fault window "
                                "explains the drop", 1000 + i)
                        k += 1
                    rep["arr_i"] = k
                out["arrivals"] = {
                    "process": self._arrivals,
                    "rate": self.cfg.arrival_rate,
                    "slo_s": self._req_slo,
                    "staleness_slo": self._req_stale_slo,
                    "admitted": sum(
                        rep["arr_i"]
                        for rep in self._serve_replicas.values()
                        if rep.get("arr") is not None),
                    "served": self._req_served,
                    "violations": self._req_violations,
                    "attributed": self._req_attributed,
                    "windows": len(self._arr_windows),
                }
        if self._monitor is not None:
            # catch up the sample grid to the quiesce instant, then
            # flush every still-open window — an alert that never got
            # its quiet gap is an alert, not a lost record
            while self._mon_next <= self.loop.now:
                self._monitor_sample(self._mon_next)
                self._mon_next += float(self.cfg.round_period)
            self._monitor.close()
            out["monitor"] = {
                "samples": self._mon_samples,
                "firings": self._monitor.firings,
                "alerts": [dict(w) for w in self._monitor.windows],
            }
        return out

    def _members_now(self) -> Set[int]:
        alive = [r for _, r in sorted(self.ranks.items())
                 if not r.killed and not r.exited]
        if not alive:
            return set()
        # an orphan's member view is frozen pre-cut — never let it
        # define the fleet (a still-parked orphan at quiesce is fenced,
        # not consulted)
        pool = [r for r in alive if not r.orphaned] or alive
        top = max(pool, key=lambda r: (r.epoch, -r.g))
        view = set(top.members) - self.transport.adopted_ranks \
            - self.transport.killed
        return {g for g in view
                if g in self.ranks and not self.ranks[g].killed
                and not self.ranks[g].exited}

    def _write_snapshots(self, members: Set[int]) -> None:
        from bluefog_tpu_torch.telemetry import registry as _treg

        t = self.transport
        for g in sorted(members):
            reg = self._mk_registry(g)
            if reg is None or not reg.enabled:
                continue
            reg.counter(_treg.LEDGER_DEPOSITS).add(t.deposits.get(g, 0))
            reg.counter(_treg.LEDGER_COLLECTED).add(t.collected.get(g, 0))
            reg.counter(_treg.LEDGER_DRAINED).add(t.drained.get(g, 0))
            reg.counter(_treg.LEDGER_PENDING).add(t.pending.get(g, 0))
            reg.write_snapshot()
