"""Heartbeat failure detector, piggybacked on the job transport.

Every island rank stamps a per-rank liveness word with the system-wide
monotonic clock; the detector declares a peer dead once its stamp is
older than the configured timeout.  The liveness word lives wherever
the job segment lives, so the detector rides the existing transports:

- **shm**: one cache line per rank in the native job segment
  (``bf_shm_job_heartbeat`` / ``bf_shm_job_liveness``), or the
  heartbeat u64 array in the lockf fallback segment;
- **tcp**: coordinator-mediated leases — each rank heartbeats the
  rank-0 coordinator, which serves the lease table back to
  ``liveness()`` queries (see native/tcp_transport.py).

The job object is duck-typed: any transport exposing ``heartbeat()``
and ``liveness(rank) -> float`` (seconds on ``time.monotonic``'s
clock; 0.0 = never beat) participates.  A transport without the
surface degrades to "everyone is alive" — resilience is opt-in per
transport, never a crash.

Env knobs:

- ``BFTPU_HEARTBEAT_INTERVAL_S`` (default 0.05) — background beat
  period;
- ``BFTPU_FAILURE_TIMEOUT_S`` (default 2.0) — stamp age past which a
  peer is declared dead.  Ranks that have NEVER beaten get a startup
  grace of the same length measured from detector construction.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Set

from bluefog_tpu_torch.sim.clock import now_fn as _now_fn
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.tracing import tracer as _tracing

__all__ = [
    "PeerTimeoutError",
    "FailureDetector",
    "EdgeHealth",
    "EDGE_ALIVE",
    "EDGE_SUSPECT",
    "EDGE_DEAD",
    "heartbeat_interval_s",
    "failure_timeout_s",
    "suspect_misses",
    "promote_clean",
    "demote_floor_s",
]


class PeerTimeoutError(RuntimeError):
    """A peer rank failed to respond within its deadline.

    ``rank`` names the unresponsive peer (-1 = the coordinator),
    ``addr`` its transport address ("host:port", when known) and ``op``
    the in-flight operation that hit the deadline.  Raised by the tcp
    transport's bounded waits and by degraded-step retries once the
    retry budget is exhausted.
    """

    def __init__(self, message: str, rank: int = -1,
                 addr: Optional[str] = None, op: Optional[str] = None):
        super().__init__(message)
        self.rank = rank
        self.addr = addr
        self.op = op


def heartbeat_interval_s() -> float:
    try:
        return float(os.environ.get("BFTPU_HEARTBEAT_INTERVAL_S", "0.05"))
    except ValueError:
        return 0.05


def failure_timeout_s() -> float:
    try:
        return float(os.environ.get("BFTPU_FAILURE_TIMEOUT_S", "2.0"))
    except ValueError:
        return 2.0


def suspect_misses() -> int:
    """Consecutive deadline-missed deposit gaps (one miss per stale
    gap, however long — see ``islands._adaptive_probe``) before
    ALIVE -> SUSPECT (``BFTPU_SUSPECT_MISSES``)."""
    try:
        return max(1, int(os.environ.get("BFTPU_SUSPECT_MISSES", "3")))
    except ValueError:
        return 3


def promote_clean() -> int:
    """Consecutive clean (on-deadline) observations before a SUSPECT
    rank is promoted back to ALIVE (``BFTPU_PROMOTE_CLEAN``)."""
    try:
        return max(1, int(os.environ.get("BFTPU_PROMOTE_CLEAN", "5")))
    except ValueError:
        return 5


def demote_floor_s() -> float:
    """Hysteresis floor: minimum seconds between consecutive edge-state
    transitions for one peer (``BFTPU_DEMOTE_FLOOR_S``) — no
    demote/promote cycle can be shorter, so a flapping rank cannot
    thrash membership epochs."""
    try:
        return float(os.environ.get("BFTPU_DEMOTE_FLOOR_S", "1.0"))
    except ValueError:
        return 1.0


# -- the three-state gray-failure machine ----------------------------------
#
# The heartbeat detector above answers one binary question: has the rank
# stamped its liveness word recently?  A GRAY failure — throttled,
# SIGSTOP'd-and-resumed, swapping — keeps stamping (the heartbeat thread
# is cheap) while its win ops crawl, so it convoys its neighbors without
# ever tripping the timeout.  EdgeHealth tracks the per-peer *edge*
# signal instead (deadline misses observed on the win-op path) through
# three states:
#
#     ALIVE --(>= suspect_misses consecutive misses)--> SUSPECT
#     SUSPECT --(>= promote_clean consecutive cleans)--> ALIVE
#     any --(death declaration)--> DEAD (absorbing)
#
# with one hysteresis rule: transitions for a peer are at least
# ``floor_s`` apart (DEAD excepted — death is never delayed), so the
# demote/promote cycle a flapping rank can induce is bounded below by
# the floor.  The clock is injectable for deterministic simulation (the
# analysis ``adaptive.hysteresis`` rule drives adversarial schedules
# through a fake clock).

EDGE_ALIVE = "alive"
EDGE_SUSPECT = "suspect"
EDGE_DEAD = "dead"

_EDGE_STATE_CODE = {EDGE_ALIVE: 0, EDGE_SUSPECT: 1, EDGE_DEAD: 2}


class EdgeHealth:
    """Per-peer three-state gray-failure machine (see module comment).

    Peers are identified by whatever ids the caller feeds (the island
    runtime uses GLOBAL ranks so the machine survives membership-epoch
    switches).  Thread-safe; all mutation happens under one lock.
    """

    def __init__(self, misses: Optional[int] = None,
                 clean: Optional[int] = None,
                 floor_s: Optional[float] = None,
                 clock=time.monotonic):
        self.misses = suspect_misses() if misses is None else int(misses)
        self.clean = promote_clean() if clean is None else int(clean)
        self.floor_s = demote_floor_s() if floor_s is None else float(floor_s)
        self._clock = _now_fn(clock)
        self._lock = threading.Lock()
        self._state: dict = {}        # peer -> state string
        self._miss_streak: dict = {}  # peer -> consecutive misses
        self._clean_streak: dict = {} # peer -> consecutive cleans
        self._since: dict = {}        # peer -> last transition time
        self._log: list = []          # [{t, peer, frm, to}]

    def state(self, peer: int) -> str:
        with self._lock:
            return self._state.get(int(peer), EDGE_ALIVE)

    def suspects(self):
        with self._lock:
            return {p for p, s in self._state.items() if s == EDGE_SUSPECT}

    def time_in_state(self, peer: int) -> float:
        with self._lock:
            since = self._since.get(int(peer))
        return float("inf") if since is None else self._clock() - since

    def transitions(self):
        """The transition log ``[{t, peer, frm, to}, ...]`` (copies) —
        the artifact the hysteresis verifier rule audits."""
        with self._lock:
            return [dict(e) for e in self._log]

    def _floor_open(self, peer: int, now: float) -> bool:
        since = self._since.get(peer)
        return since is None or now - since >= self.floor_s

    def _transition(self, peer: int, to: str, now: float,
                    adopted: bool = False) -> None:
        frm = self._state.get(peer, EDGE_ALIVE)
        self._state[peer] = to
        self._since[peer] = now
        self._miss_streak[peer] = 0
        self._clean_streak[peer] = 0
        ev = {"t": now, "peer": peer, "frm": frm, "to": to}
        if adopted:
            ev["adopted"] = True
        self._log.append(ev)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.gauge("adaptive.edge_state", peer=peer).set(
                _EDGE_STATE_CODE[to])
            reg.journal("edge_state", peer=peer, frm=frm, to=to,
                        adopted=adopted)

    def note_miss(self, peer: int) -> str:
        """One edge-deadline miss observed on ``peer``.  Returns the
        (possibly new) state."""
        peer = int(peer)
        now = self._clock()
        with self._lock:
            st = self._state.get(peer, EDGE_ALIVE)
            if st == EDGE_DEAD:
                return st
            self._clean_streak[peer] = 0
            self._miss_streak[peer] = self._miss_streak.get(peer, 0) + 1
            if (st == EDGE_ALIVE
                    and self._miss_streak[peer] >= self.misses
                    and self._floor_open(peer, now)):
                self._transition(peer, EDGE_SUSPECT, now)
            return self._state.get(peer, EDGE_ALIVE)

    def note_clean(self, peer: int) -> str:
        """One on-deadline observation of ``peer`` (a fresh deposit, a
        fast acquire).  Returns the (possibly new) state."""
        peer = int(peer)
        now = self._clock()
        with self._lock:
            st = self._state.get(peer, EDGE_ALIVE)
            if st == EDGE_DEAD:
                return st
            self._miss_streak[peer] = 0
            self._clean_streak[peer] = self._clean_streak.get(peer, 0) + 1
            if (st == EDGE_SUSPECT
                    and self._clean_streak[peer] >= self.clean
                    and self._floor_open(peer, now)):
                self._transition(peer, EDGE_ALIVE, now)
            return self._state.get(peer, EDGE_ALIVE)

    def absolve(self, peer: int) -> str:
        """Adopt a fleet-level PROMOTE verdict for ``peer``.

        After a demotion only the anchor keeps an edge to the straggler,
        so every other member's machine is starved of observations and
        holds the peer SUSPECT forever; when the anchor's (floored,
        evidence-based) promote commits, those stale verdicts would
        instantly re-demote — an epoch thrash no local floor can stop,
        because no local state ever transitions.  Absolving mirrors the
        anchor's verdict: the peer resets to ALIVE with fresh streaks
        and a fresh floor clock (so a relapse is again floored locally).
        Logged with ``adopted=True`` — the hysteresis audit exempts
        mirrored verdicts, whose floor was paid at the anchor.  DEAD
        stays absorbing."""
        peer = int(peer)
        now = self._clock()
        with self._lock:
            st = self._state.get(peer, EDGE_ALIVE)
            if st in (EDGE_DEAD, EDGE_ALIVE):
                return st
            self._transition(peer, EDGE_ALIVE, now, adopted=True)
            return EDGE_ALIVE

    def note_dead(self, peer: int) -> str:
        """Absorbing death (the heartbeat detector's verdict outranks
        the gray-failure machine; never floor-delayed)."""
        peer = int(peer)
        now = self._clock()
        with self._lock:
            if self._state.get(peer) != EDGE_DEAD:
                self._transition(peer, EDGE_DEAD, now)
            return EDGE_DEAD


class FailureDetector:
    """Background heartbeater + liveness judge over a job transport."""

    def __init__(self, job, rank: int, nranks: int,
                 timeout: Optional[float] = None,
                 interval: Optional[float] = None,
                 clock=None):
        self._job = job
        self.rank = int(rank)
        self.nranks = int(nranks)
        self.timeout = failure_timeout_s() if timeout is None else timeout
        self.interval = (heartbeat_interval_s() if interval is None
                         else interval)
        self._supported = (hasattr(job, "heartbeat")
                           and hasattr(job, "liveness"))
        # injectable monotonic clock (sim/clock.py seam): ``None`` is
        # wall time — production behavior unchanged
        self._clock = _now_fn(clock)
        self._born = self._clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._declared: Set[int] = set()
        self._lock = threading.Lock()
        # optional gray-failure machine (resilience/adaptive.py attaches
        # one keyed by GLOBAL rank): death declarations flow into it so
        # DEAD outranks SUSPECT; ``to_peer`` maps this detector's local
        # ranks to the machine's peer ids (identity when unset)
        self.edge_health: Optional[EdgeHealth] = None
        self.to_peer = None
        self.beat()

    @property
    def supported(self) -> bool:
        return self._supported

    def beat(self) -> None:
        """One heartbeat now (the background thread calls this; ops on
        the hot path may too — it is one relaxed store)."""
        if self._supported:
            try:
                self._job.heartbeat()
            except Exception:
                return
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("resilience.heartbeats_sent").inc()
        tr = _tracing.get_tracer()
        if tr.enabled:
            # ride the heartbeat cadence: one clock probe per beat keeps
            # the min-RTT offset estimator fresh without a second timer
            tr.resample_clock(self._job)

    def start(self) -> "FailureDetector":
        if self._thread is None and self._supported:
            self._thread = threading.Thread(
                target=self._run, name="bf-heartbeat", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def is_alive(self, rank: int) -> bool:
        if not self._supported or rank == self.rank:
            return True
        with self._lock:
            if rank in self._declared:
                return False
        try:
            stamp = float(self._job.liveness(rank))
        except Exception:
            return True
        now = self._clock()
        if stamp <= 0.0:
            # never beat: startup grace measured from detector birth
            alive = now - self._born <= self.timeout
        else:
            alive = now - stamp <= self.timeout
        reg = _telemetry.get_registry()
        if reg.enabled:
            which = ("resilience.heartbeats_observed" if alive
                     else "resilience.heartbeats_missed")
            reg.counter(which).inc()
        return alive

    def dead_ranks(self) -> Set[int]:
        """All ranks currently considered dead.  A rank once declared
        dead STAYS dead (the healing rules assume monotone membership
        loss; a restarted rank must rejoin as a new job)."""
        dead = {r for r in range(self.nranks)
                if r != self.rank and not self.is_alive(r)}
        with self._lock:
            new = dead - self._declared
            self._declared |= dead
            declared = set(self._declared)
        for r in sorted(new):
            self._note_declared(r, how="heartbeat")
        return declared

    def declare_dead(self, rank: int) -> None:
        """Externally assert a rank is dead (e.g. the tcp transport saw
        its connection reset, or a test injected the failure)."""
        with self._lock:
            new = int(rank) not in self._declared
            self._declared.add(int(rank))
        if new:
            self._note_declared(int(rank), how="external")

    def _note_declared(self, rank: int, how: str) -> None:
        if self.edge_health is not None:
            peer = rank if self.to_peer is None else self.to_peer(rank)
            self.edge_health.note_dead(peer)
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("resilience.death_declarations").inc()
            reg.journal("death_declared", peer_rank=rank, how=how,
                        timeout_s=self.timeout)

    def __enter__(self) -> "FailureDetector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
