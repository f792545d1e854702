"""Fault-injection harness for the resilience e2e tests.

Faults are injected two ways:

- **from outside**: :func:`kill`, :func:`suspend`, :func:`resume` act
  on a worker pid (SIGKILL / SIGSTOP / SIGCONT) — the test process
  steers its spawned islands;
- **from inside**: workers call :func:`checkpoint(rank, step)` at
  instrumented points; a schedule published through env vars
  (``BFTPU_CHAOS_KILL_RANK`` / ``BFTPU_CHAOS_KILL_STEP`` /
  ``BFTPU_CHAOS_DELAY_S``) makes the matching rank kill itself with
  SIGKILL mid-op — deterministic death at a protocol-relevant point
  (e.g. between the expose and the deposit of a win_put), which no
  external signal can time reliably.  The same machinery schedules
  **gray failures** (``BFTPU_CHAOS_SUSPEND_RANK`` /
  ``BFTPU_CHAOS_SUSPEND_STEP`` / ``BFTPU_CHAOS_SUSPEND_S``: SIGSTOP
  past the heartbeat timeout, then SIGCONT — see :func:`suspend_self`)
  **stragglers** (``BFTPU_CHAOS_SLOW_RANK`` / ``BFTPU_CHAOS_SLOW_STEP``
  / ``BFTPU_CHAOS_SLOW_S`` / ``BFTPU_CHAOS_SLOW_STOP``: a main-thread
  sleep at every checkpoint from the scheduled step on, heartbeats
  unimpaired — see :func:`schedule_slow`), and **join admissions**
  (``BFTPU_CHAOS_JOIN_RANK`` / ``BFTPU_CHAOS_JOIN_STEP``: the rank
  calls ``islands.admit_pending()`` at the scheduled step).

Mailbox corruption for protocol tests goes through
:func:`corrupt_chunk` on a :class:`~bluefog_tpu_torch.native.shm_native.
ChunkRingMirror` — it freezes a deposit mid-chunk exactly the way a
dead writer does, so the dead-writer drain path is exercised without
an actual process death.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

from bluefog_tpu_torch.sim.clock import resolve_clock as _resolve_clock

__all__ = [
    "kill",
    "suspend",
    "resume",
    "kill_self",
    "suspend_self",
    "checkpoint",
    "schedule_kill",
    "schedule_join",
    "schedule_suspend",
    "schedule_slow",
    "schedule_partition",
    "schedule_serve_kill",
    "schedule_serve_pub_kill",
    "schedule_distrib_kill",
    "schedule_to_json",
    "apply_schedule_json",
    "clear_schedule",
    "set_clock",
    "corrupt_chunk",
]

_KILL_RANK = "BFTPU_CHAOS_KILL_RANK"
_KILL_STEP = "BFTPU_CHAOS_KILL_STEP"
_DELAY_S = "BFTPU_CHAOS_DELAY_S"
_JOIN_RANK = "BFTPU_CHAOS_JOIN_RANK"
_JOIN_STEP = "BFTPU_CHAOS_JOIN_STEP"
_SUSPEND_RANK = "BFTPU_CHAOS_SUSPEND_RANK"
_SUSPEND_STEP = "BFTPU_CHAOS_SUSPEND_STEP"
_SUSPEND_S = "BFTPU_CHAOS_SUSPEND_S"
_SLOW_RANK = "BFTPU_CHAOS_SLOW_RANK"
_SLOW_STEP = "BFTPU_CHAOS_SLOW_STEP"
_SLOW_S = "BFTPU_CHAOS_SLOW_S"
_SLOW_STOP = "BFTPU_CHAOS_SLOW_STOP"
_PARTITION_GROUP = "BFTPU_CHAOS_PARTITION_GROUP"
_PARTITION_STEP = "BFTPU_CHAOS_PARTITION_STEP"
_PARTITION_STOP = "BFTPU_CHAOS_PARTITION_STOP"
_SERVE_KILL_REPLICA = "BFTPU_CHAOS_SERVE_KILL_REPLICA"
_SERVE_KILL_SWAP = "BFTPU_CHAOS_SERVE_KILL_SWAP"
_SERVE_KILL_STOP = "BFTPU_CHAOS_SERVE_KILL_STOP"
_SERVE_PUB_KILL_PUBLISH = "BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH"
_SERVE_PUB_KILL_PHASE = "BFTPU_CHAOS_SERVE_PUB_KILL_PHASE"
_DISTRIB_KILL_RELAY = "BFTPU_CHAOS_DISTRIB_KILL_RELAY"
_DISTRIB_KILL_SYNC = "BFTPU_CHAOS_DISTRIB_KILL_SYNC"

_ALL_KEYS = (_KILL_RANK, _KILL_STEP, _DELAY_S,
             _JOIN_RANK, _JOIN_STEP,
             _SUSPEND_RANK, _SUSPEND_STEP, _SUSPEND_S,
             _SLOW_RANK, _SLOW_STEP, _SLOW_S, _SLOW_STOP,
             _PARTITION_GROUP, _PARTITION_STEP, _PARTITION_STOP,
             _SERVE_KILL_REPLICA, _SERVE_KILL_SWAP, _SERVE_KILL_STOP,
             _SERVE_PUB_KILL_PUBLISH, _SERVE_PUB_KILL_PHASE,
             _DISTRIB_KILL_RELAY, _DISTRIB_KILL_SYNC)

# sim-campaign knobs (bluefog_tpu_torch/sim/__main__.py reads these as CLI
# defaults) — scrubbed by clear_schedule() alongside the chaos keys,
# because a stale campaign seed or schedule would replay faults into
# the next test's campaign exactly like a stale kill schedule would
_SIM_KEYS = ("BFTPU_SIM_SEED", "BFTPU_SIM_RANKS", "BFTPU_SIM_ROUNDS",
             "BFTPU_SIM_FAULTS", "BFTPU_SIM_TOPOLOGY",
             "BFTPU_SIM_SCHEDULE", "BFTPU_SIM_QUIESCE_ROUNDS",
             "BFTPU_SIM_LATENCY_MS", "BFTPU_SIM_REPRO_DIR",
             "BFTPU_SIM_QUORUM")

# convergence-observatory knobs (bluefog_tpu_torch.lab): a stale probe or
# auto-topology flag leaking across tests changes the next fleet's hot
# path (probe ticks) or its launch topology — schedule-grade state
_LAB_KEYS = ("BFTPU_LAB_PROBE", "BFTPU_LAB_AUTO_TOPOLOGY",
             "BFTPU_LAB_PAYLOAD_BYTES", "BFTPU_LAB_ARTIFACT",
             "BFTPU_LAB_SAMPLE", "BFTPU_LAB_FLUSH")

# serving-plane knobs (bluefog_tpu_torch.serve): a stale lag bound or stale
# policy leaking across tests flips the next replica fleet from warn to
# refuse (or vice versa) — schedule-grade state, same as the lab keys
_SERVE_KEYS = ("BFTPU_SERVE_MAX_LAG", "BFTPU_SERVE_STALE_POLICY",
               "BFTPU_SERVE_RETRIES", "BFTPU_SERVE_BACKOFF_S",
               "BFTPU_SERVE_REPLICAS")

# distribution-plane knobs (bluefog_tpu_torch.serve.distrib): a stale fanout
# reshapes the next fleet's tree, a stale horizon flips delta vs
# full-resync paths, and the BFTPU_CHAOS_DISTRIB_* kill schedules are
# literal fault schedules — all scrubbed with the rest
_DISTRIB_KEYS = ("BFTPU_DISTRIB_FANOUT", "BFTPU_DISTRIB_HORIZON",
                 "BFTPU_DISTRIB_CHUNK_KB", "BFTPU_DISTRIB_TIMEOUT_S",
                 "BFTPU_DISTRIB_RETRIES")

# load-generator + serve-SLO knobs (bluefog_tpu_torch.serve.loadgen): a
# stale rate or schedule changes the next test's offered load, and a
# stale SLO objective arms violation windows the next fleet never
# asked for — schedule-grade state like everything above
_LOADGEN_KEYS = ("BFTPU_LOADGEN_RATE_HZ", "BFTPU_LOADGEN_SCHEDULE",
                 "BFTPU_LOADGEN_SEED", "BFTPU_LOADGEN_DURATION_S",
                 "BFTPU_SERVE_SLO_MS", "BFTPU_SERVE_SLO_STALENESS")

# fleet-monitor knobs (bluefog_tpu_torch/monitor): stale alert thresholds or
# a stale rules override re-arm the previous test's alert policy in the
# next monitor's engine, and a stale scrape cadence or gap changes its
# window coalescing — schedule-grade state like the loadgen SLO keys
_MON_KEYS = ("BFTPU_MONITOR", "BFTPU_MON_SCRAPE_S", "BFTPU_MON_GAP_S",
             "BFTPU_MON_RULES", "BFTPU_MON_SLOTS", "BFTPU_MON_RING",
             "BFTPU_MON_LINGER", "BFTPU_MON_MASS_TOL",
             "BFTPU_MON_EPOCH_STALL_S", "BFTPU_MON_SUSPECT_RATE",
             "BFTPU_MON_SERVE_MAX_LAG", "BFTPU_MON_DISTRIB_STALENESS",
             "BFTPU_MON_CONV_DIVERGE", "BFTPU_MON_CONV_PLATEAU_S",
             "BFTPU_CHAOS_MON_DROP_SCRAPE")

# injectable clock (sim/clock.py seam) for the delay/straggler sleeps;
# process-level signals (suspend_self) always use wall time — you
# cannot virtualize a SIGSTOP
_clock = _resolve_clock(None)


def set_clock(clock=None) -> None:
    """Install the clock used by :func:`checkpoint`'s scheduled sleeps
    (``None`` restores wall time).  The simulator installs its virtual
    clock so a chaos schedule replayed inside a campaign burns virtual
    seconds, not wall seconds."""
    global _clock
    _clock = _resolve_clock(clock)


def kill(pid: int) -> None:
    """SIGKILL a worker process (no cleanup runs — the hard failure)."""
    os.kill(pid, signal.SIGKILL)


def suspend(pid: int) -> None:
    """SIGSTOP a worker — it looks dead to the detector while stopped
    but resumes mid-instruction on :func:`resume` (the gray failure)."""
    os.kill(pid, signal.SIGSTOP)


def resume(pid: int) -> None:
    os.kill(pid, signal.SIGCONT)


def kill_self() -> None:
    """Immediate SIGKILL of the calling process: no atexit, no teardown
    barrier, no segment unlink — exactly what rank death looks like to
    the survivors."""
    os.kill(os.getpid(), signal.SIGKILL)


def suspend_self(duration_s: float) -> None:
    """Gray-failure injection from inside: SIGSTOP the calling process
    for ``duration_s`` seconds, then resume.  A stopped process cannot
    un-stop itself, so a forked helper (immune to the parent's stop)
    sleeps out the outage and delivers the SIGCONT.  Pick a duration
    past the failure timeout and the detector declares the rank dead
    while it is merely slow — the flapping-rank scenario the monotone
    dead set exists for."""
    pid = os.getpid()
    child = os.fork()
    if child == 0:
        time.sleep(duration_s)
        try:
            os.kill(pid, signal.SIGCONT)
        finally:
            os._exit(0)
    os.kill(pid, signal.SIGSTOP)  # execution stops HERE until SIGCONT
    os.waitpid(child, 0)  # reap the resumer


def schedule_kill(env: dict, rank: int, step: int,
                  delay_s: float = 0.0) -> dict:
    """Publish a kill schedule into an env mapping (pass to the worker
    spawn): rank ``rank`` dies at its ``step``-th matching checkpoint."""
    env[_KILL_RANK] = str(int(rank))
    env[_KILL_STEP] = str(int(step))
    if delay_s:
        env[_DELAY_S] = str(float(delay_s))
    return env


def schedule_join(env: dict, rank: int, step: int) -> dict:
    """Publish a join-admission schedule: rank ``rank`` (or every rank,
    with ``rank=-1`` — admission is a membership-wide switch, so -1 is
    the common spelling) calls ``islands.admit_pending()`` at its
    ``step``-th matching checkpoint."""
    env[_JOIN_RANK] = str(int(rank))
    env[_JOIN_STEP] = str(int(step))
    return env


def schedule_suspend(env: dict, rank: int, step: int,
                     duration_s: float = 2.5) -> dict:
    """Publish a gray-failure schedule: rank ``rank`` SIGSTOPs itself
    for ``duration_s`` seconds at its ``step``-th matching checkpoint
    (default 2.5s — past the 2s default failure timeout, so the outage
    is long enough to be declared a death)."""
    env[_SUSPEND_RANK] = str(int(rank))
    env[_SUSPEND_STEP] = str(int(step))
    env[_SUSPEND_S] = str(float(duration_s))
    return env


def schedule_slow(env: dict, rank: int, step: int, delay_s: float,
                  stop: Optional[int] = None) -> dict:
    """Publish a STRAGGLER schedule: rank ``rank`` sleeps ``delay_s``
    seconds in its MAIN thread at every matching checkpoint from step
    ``step`` on (until step ``stop``, exclusive, when given — the
    recovery scenario).  Unlike :func:`schedule_suspend` the heartbeat
    thread keeps beating throughout, so the failure detector never
    declares the rank dead: this is the gray failure — slow but
    responsive — that only the adaptive edge-health machine catches."""
    env[_SLOW_RANK] = str(int(rank))
    env[_SLOW_STEP] = str(int(step))
    env[_SLOW_S] = str(float(delay_s))
    if stop is not None:
        env[_SLOW_STOP] = str(int(stop))
    return env


def schedule_partition(env: dict, group: str, step: int,
                       stop: Optional[int] = None) -> dict:
    """Publish a NETWORK PARTITION schedule: from step ``step`` until
    step ``stop`` (exclusive), cross-group traffic drops and liveness
    goes stale across the cut.  ``group`` is the side spec — a
    pipe-separated list of comma-separated global ranks (``"3"`` =
    rank 3 vs everyone else; see
    :meth:`bluefog_tpu_torch.sim.schedule.Fault.partition`).

    Unlike the other chaos kinds, :func:`checkpoint` does NOT act on
    these keys — a worker cannot self-inject a network property.  The
    keys exist so a partition campaign round-trips through the shared
    fault-schedule format (``schedule_to_json`` /
    ``apply_schedule_json``) and so harnesses that DO own the network
    (the fleet simulator; an iptables-driven e2e rig) can read one
    schedule spelling."""
    env[_PARTITION_GROUP] = str(group)
    env[_PARTITION_STEP] = str(int(step))
    if stop is not None:
        env[_PARTITION_STOP] = str(int(stop))
    return env


def schedule_serve_kill(env: dict, replica: int, swap: int,
                        stop: Optional[int] = None) -> dict:
    """Publish a REPLICA MID-SWAP kill schedule: replica ``replica``
    SIGKILLs itself at its ``swap``-th hot-swap, precisely between
    reading the new committed snapshot and the atomic version flip
    (``Replica.poll_swap``).  ``stop`` is the respawn round — like the
    partition stop it is acted on by harnesses that own the fleet (the
    simulator; an e2e respawning the replica), not by the replica
    itself, and exists so the fault round-trips the shared schedule
    format."""
    env[_SERVE_KILL_REPLICA] = str(int(replica))
    env[_SERVE_KILL_SWAP] = str(int(swap))
    if stop is not None:
        env[_SERVE_KILL_STOP] = str(int(stop))
    return env


def schedule_serve_pub_kill(env: dict, publish: int,
                            phase: str = "payload") -> dict:
    """Publish a PUBLISHER MID-PUBLISH kill schedule: the publisher
    SIGKILLs itself during its ``publish``-th snapshot publication —
    ``phase="payload"`` dies with the standby buffer half-written (seq
    odd), ``phase="flip"`` dies with the payload whole but the header
    not yet flipped.  Both must leave every replica on the previous
    committed version (``SnapshotRegion``'s death matrix)."""
    if phase not in ("payload", "flip"):
        raise ValueError(f"serve_pub_kill phase {phase!r} "
                         "(want 'payload' or 'flip')")
    env[_SERVE_PUB_KILL_PUBLISH] = str(int(publish))
    env[_SERVE_PUB_KILL_PHASE] = phase
    return env


def schedule_distrib_kill(env: dict, relay: Optional[int] = None,
                          sync: Optional[int] = None,
                          n: int = 1) -> dict:
    """Publish a DISTRIBUTION-TREE kill schedule (value format
    ``"replica_id:n"``).  ``relay`` SIGKILLs that subscriber right
    after it installs its ``n``-th generation — its committed store
    flipped (children may already be pulling the new version) but its
    own replica never swapped: mid-fanout relay death, the subtree
    must re-parent.  ``sync`` SIGKILLs the subscriber mid-delta — the
    stream received but the staged generation NOT yet flipped: the
    previous version must keep serving."""
    if relay is not None:
        env[_DISTRIB_KILL_RELAY] = f"{int(relay)}:{int(n)}"
    if sync is not None:
        env[_DISTRIB_KILL_SYNC] = f"{int(sync)}:{int(n)}"
    return env


def schedule_to_json() -> str:
    """Serialize the calling process's env-published chaos schedule to
    the shared fault-schedule JSON (see
    :class:`bluefog_tpu_torch.sim.schedule.FaultSchedule`) — the round-trip
    that lets a flaky chaos e2e be replayed as a deterministic sim
    campaign."""
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    return FaultSchedule.from_env(os.environ).to_json()


def apply_schedule_json(payload: str, env: Optional[dict] = None) -> dict:
    """Publish a shared-format JSON fault schedule into ``env``
    (default: this process's environment) as chaos keys — the inverse
    of :func:`schedule_to_json`."""
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    return FaultSchedule.from_json(payload).to_env(
        os.environ if env is None else env)


def clear_schedule() -> None:
    """Scrub EVERY chaos key from the calling process's environment —
    kill, join, and suspend schedules alike (a stale key would replay
    the fault in the next test's workers) — plus the sim-campaign,
    lab, serving-plane, and monitor keys, which are schedules by
    another name."""
    for k in _ALL_KEYS + _SIM_KEYS + _LAB_KEYS + _SERVE_KEYS \
            + _DISTRIB_KEYS + _LOADGEN_KEYS + _MON_KEYS:
        os.environ.pop(k, None)


_counters = {}


def _matches(scheduled: Optional[str], rank: int) -> bool:
    return scheduled is not None and int(scheduled) in (int(rank), -1)


def checkpoint(rank: int, tag: str = "step") -> None:
    """Chaos instrumentation point: count invocations per (rank, tag)
    and execute the scheduled fault(s) when the counter hits the
    scheduled step.  A no-op (a few dict lookups) when no schedule is
    set.  Suspend and join fire exactly once (``==`` their step); kill
    fires at or after its step (``>=`` — the process is gone either
    way)."""
    env = os.environ
    if (_KILL_RANK not in env and _JOIN_RANK not in env
            and _SUSPEND_RANK not in env and _SLOW_RANK not in env):
        return
    delay = env.get(_DELAY_S)
    if delay:
        _clock.sleep(float(delay))
    key = (int(rank), tag)
    n = _counters.get(key, 0) + 1
    _counters[key] = n
    if _matches(env.get(_SLOW_RANK), rank) \
            and n >= int(env.get(_SLOW_STEP, "1")) \
            and (_SLOW_STOP not in env or n < int(env[_SLOW_STOP])):
        _clock.sleep(float(env.get(_SLOW_S, "0.5")))
    if _matches(env.get(_SUSPEND_RANK), rank) \
            and n == int(env.get(_SUSPEND_STEP, "1")):
        suspend_self(float(env.get(_SUSPEND_S, "2.5")))
    if _matches(env.get(_JOIN_RANK), rank) \
            and n == int(env.get(_JOIN_STEP, "1")):
        from bluefog_tpu_torch import islands

        islands.admit_pending()
    if _matches(env.get(_KILL_RANK), rank) \
            and n >= int(env.get(_KILL_STEP, "1")):
        kill_self()


def corrupt_chunk(mirror, data: Optional[bytes] = None,
                  tear_at: int = 0) -> None:
    """Freeze a deposit mid-chunk on a ChunkRingMirror: chunk
    ``tear_at`` is left odd with half its bytes stored and ``wseq``
    stays odd — the exact state a dead writer leaves behind.  Recover
    with ``mirror.force_drain()`` (or resume with
    ``mirror.complete_write()``)."""
    if data is None:
        data = os.urandom(mirror.nbytes)
    mirror.begin_torn_write(data, p=1.0, tear_at=tear_at)
