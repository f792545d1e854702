"""Asynchronous islands — true one-sided window ops across processes.

Counterpart of ``bluefog_tpu/islands.py``.  The rank-major emulation
(:mod:`bluefog_tpu_torch.windows`) realizes the *synchronous schedule* of
asynchronous algorithms: all ranks live in one process and deposits land at
exchange points.  Here each rank is its own OS process — an **island** with
its own torch runtime — and window deposits travel through the native
shared-memory mailbox (``native/shm_mailbox.cc``, built from this package's
copy of the source) with genuine passive-target semantics: a ``win_put``
completes with NO participation by the receiver, ranks step at their own
pace, and staleness is whatever the wall clock makes it.

Scope: the window op family (the asynchronous algorithms), plus ``barrier``
and a REAL ``win_mutex`` (shared-memory locks).  The transport is host code
by nature: a tensor on the card is staged through a pinned host buffer
(:mod:`bluefog_tpu_torch.progress.staging`), and what comes back goes to the
device the window was created from.  Tensors here are THIS rank's tensor
(no leading ``size`` axis): ``torch`` tensors (CPU or CUDA) or numpy arrays,
and the same kind comes back.  Weight arguments are plain ``{rank: weight}``
dicts — the reference's per-process convention.

The segment layout and the ctypes ABI are the reference's, so islands of
this package and of ``bluefog_tpu`` can share one job.

Mass conservation: ``win_accumulate`` + ``win_update_then_collect`` use the
transport's atomic read+zero ``collect``, so asynchronous push-sum conserves
Σx and Σp under ANY interleaving — the property that makes x/p debiasing
converge to the exact average.
"""

from __future__ import annotations

import contextlib
import faulthandler
import itertools
import os
import signal
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as _pytree

from bluefog_tpu_torch import progress as _progress
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import adaptive as _adaptive
from bluefog_tpu_torch.resilience import degraded as _degraded
from bluefog_tpu_torch.resilience import healing as _healing
from bluefog_tpu_torch.resilience import join as _join
from bluefog_tpu_torch.resilience import quorum as _quorum
from bluefog_tpu_torch.resilience.detector import (
    _EDGE_STATE_CODE,
    EDGE_ALIVE,
    FailureDetector,
)
from bluefog_tpu_torch.resilience.quorum import OrphanedError
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.timeline import timeline_context
from bluefog_tpu_torch.tracing import tracer as _tracing

__all__ = [
    "init",
    "shutdown",
    "initialized",
    "rank",
    "size",
    "barrier",
    "set_topology",
    "load_topology",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "win_create",
    "win_free",
    "win_put",
    "win_accumulate",
    "win_get",
    "win_update",
    "win_put_async",
    "win_accumulate_async",
    "win_update_async",
    "progress_engine",
    "win_absorbed",
    "win_update_then_collect",
    "win_sync",
    "win_mutex",
    "win_associated_p",
    "win_set_exposed",
    "push_sum_round",
    "broadcast",
    "broadcast_parameters",
    "DistributedWinPutOptimizer",
    "get_win_version",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "dead_ranks",
    "heal",
    "resilience_detector",
    "global_rank",
    "members",
    "membership_epoch",
    "join",
    "admit_pending",
    "adaptive_step",
    "adaptive_leave",
    "adaptive_policy",
    "demoted_ranks",
    "OrphanedError",
    "is_orphaned",
    "merge_orphan",
    "serve_publish",
    "spawn",
]

WeightDict = Optional[Dict[int, float]]


class _IslandWindow:
    def __init__(self, name: str, tensor: np.ndarray, ctx: "_IslandContext",
                 zero_init: bool):
        topo = ctx.topology
        self.name = name
        self.in_neighbors: List[int] = sorted(topo.predecessors(ctx.rank))
        self.out_neighbors: List[int] = sorted(topo.successors(ctx.rank))
        # slot order at EVERY rank must be derivable by every writer: slot k
        # of rank d is d's k-th in-neighbor in ascending rank order (the
        # reference's per-writer registered-buffer model, SURVEY §2.4)
        self.slot_of: Dict[int, Dict[int, int]] = {
            d: {s: k for k, s in enumerate(sorted(topo.predecessors(d)))}
            for d in topo.nodes
        }
        maxd = max((len(v) for v in self.slot_of.values()), default=0)
        self.self_tensor = np.array(tensor, copy=True)
        self.p_self = 1.0
        self._scratch: Optional[np.ndarray] = None  # win_update staging
        self._tel_cache = None  # (registry, {key: metric handle}) memo
        # last trace-context word consumed per slot: a combine that finds
        # the word unchanged consumed no NEW deposit on that edge, so no
        # duplicate flow arrow is recorded
        self._trace_seen: Dict[int, int] = {}
        # adaptive edge-health probe state: slot -> (version, time the
        # version last CHANGED, miss already counted for this gap) — an
        # unchanged version past the edge deadline is ONE deadline miss
        # per gap (resilience/adaptive.py)
        self._edge_seen: Dict[int, Tuple[int, float, bool]] = {}
        # GLOBAL ranks the most recent combine dropped via the
        # round-local ABSORB (read back by win_absorbed: a synchronous
        # caller treats an absorbed edge as handled for this round)
        self._last_absorbed: Tuple[int, ...] = ()
        # writer-side deposit tally per destination, and the version the
        # creation seed left in each slot: together they let heal()
        # settle the ledger for a dead peer (adopt its lost writer-side
        # counts, write off deposits it will never combine)
        self._deposited_to: Dict[int, int] = {}
        self._seed_ver = 0 if zero_init else 1
        # progress-engine prefetch state: per-slot persistent warm buffer
        # + the slot version it holds.  The idle worker re-reads a slot
        # (read-only, no collect — zero semantic/mass effect) only when
        # its deposit count moved, leaving the mailbox pages cache-warm
        # for the caller's next combine.
        self._warm: Dict[int, np.ndarray] = {}
        self._warm_ver: Dict[int, int] = {}
        self.shm = shm_native.make_window(
            ctx.job, name, ctx.rank, ctx.size, maxd,
            tensor.shape, tensor.dtype,
        )
        # windows are created collectively (like MPI_Win_create): barrier so
        # every rank's segment view exists before anyone deposits.  Unless
        # zero_init, each rank seeds its OWN slots with its OWN tensor (the
        # reference initializes every in-neighbor buffer from the local
        # value so a pre-put win_update is a no-op average — see
        # windows._Window).
        self.shm.expose(self.self_tensor, self.p_self)
        if not zero_init:
            for k, s in enumerate(self.in_neighbors):
                self.shm.write(ctx.rank, k, tensor, p=1.0, writer=s)
        # mass-ledger bookkeeping (telemetry conservation invariant): slot
        # ``version`` is a monotone deposit count; ``_ledger_seen[slot]`` is
        # the last version this reader retired (collected/drained/pending).
        # The seed writes above are pre-retired — they are not deposits any
        # writer counted.
        self._ledger_seen: Dict[int, int] = {
            k: (0 if zero_init else 1)
            for k in range(len(self.in_neighbors))
        }
        ctx.shm_job.barrier()


class _IslandContext:
    def __init__(self, rank_: int, size_: int, job: str):
        self.rank = rank_
        self.size = size_
        self.job = job
        self.topology: topology_util.DiGraph = _default_topology(size_)
        self.windows: Dict[str, _IslandWindow] = {}
        self.created_names: set = set()  # for shm unlink at shutdown
        self.win_fusion: Dict[str, object] = {}  # name -> pytree pack meta
        # name -> torch device the window was created from (None: numpy)
        self.win_device: Dict[str, Optional[torch.device]] = {}
        self.associated_p = False
        self.shm_job = shm_native.make_job(job, rank_, size_)
        # resilience state: the detector heartbeats in the background on
        # transports exposing liveness words (shm native/fallback, tcp
        # leases); ``dead`` is the excised-rank set the degraded win ops
        # consult, populated by heal()
        self.detector = FailureDetector(self.shm_job, rank_, size_).start()
        self.dead: set = set()
        self.healed: Optional[_healing.HealedTopology] = None
        # quorum fencing (resilience/quorum.py): True once this rank
        # lost a strict-majority live view and quiesced — windows go
        # read-only, healing stops, merge_orphan() is the way back
        self.orphaned = False
        # elastic membership (resilience/join.py): epoch 0 is the launch
        # view, where local and global ranks coincide.  After an epoch
        # switch ``rank``/``size``/``job`` describe the CURRENT epoch's
        # dense world while these fields keep the stable identity.
        self.base_job = job
        self.epoch = 0
        self.global_rank = rank_
        self.members_global: Tuple[int, ...] = tuple(range(size_))
        # adaptive topology (resilience/adaptive.py): the edge-health
        # policy OUTLIVES epoch switches (it is keyed by global rank and
        # holds the hysteresis clocks), unlike the per-epoch detector.
        # ``demoted`` is the degree-capped global-rank set of the current
        # reweight record; ``base_edges`` the pre-demotion global edge
        # list a promote restores.
        self.adaptive: Optional[_adaptive.AdaptivePolicy] = (
            _adaptive.AdaptivePolicy() if _adaptive.adaptive_enabled()
            else None)
        self.demoted: set = set()
        self.base_edges: Optional[List[Tuple[int, int]]] = None
        _attach_edge_health(self)
        # live introspection plane (bluefog_tpu_torch.introspect): the status
        # page and the trace-control poller are keyed by the STABLE
        # identity (base job + global rank), so an attached bftpu-top
        # survives the epoch switches adaptive demotions trigger
        self.statuspage = None
        self.tracectl = None
        self.op_rounds = 0
        # convergence observatory (bluefog_tpu_torch.lab): per-window probes,
        # created lazily on the first win_update so the env decision is
        # made after spawn() has propagated the lab env keys to workers.
        # None = not yet checked, False = probe disabled, dict = live.
        self.lab_probes = None
        self.conv_err = -1.0
        self.conv_round = -1
        # per-rank background progress engine (bluefog_tpu_torch.progress),
        # created lazily on the first *_async call so synchronous
        # programs never pay for the worker thread
        self.progress: Optional[_progress.ProgressEngine] = None
        # serving plane (bluefog_tpu_torch.serve): the snapshot region this
        # rank publishes into (lazily created by serve_publish) and the
        # last committed version, mirrored onto the v5 status page
        self.serve_region = None
        self.serve_version = -1
        if shm_native.statuspage_enabled():
            from bluefog_tpu_torch.introspect import statuspage as _statuspage

            try:
                self.statuspage = _statuspage.StatusPage(job, rank_)
                self.tracectl = _statuspage.TraceControl(job, rank_, size_)
            except OSError:
                self.statuspage = None  # read-only shm dir: run blind


def _trivial_graph() -> topology_util.DiGraph:
    g = topology_util.DiGraph()
    g.add_node(0)
    return g


def _default_topology(size_: int) -> topology_util.DiGraph:
    """The launch topology for an island fleet of ``size_``.

    Static default: exponential-2 (the paper's workhorse).  With
    ``BFTPU_LAB_AUTO_TOPOLOGY=1`` the choice is delegated to the lab's
    measured scaling laws (:func:`bluefog_tpu_torch.lab.recommend`), sized
    by ``BFTPU_LAB_PAYLOAD_BYTES``; any failure there (no artifact, bad
    env) falls back to the static default, as in the reference — opting
    in to auto-topology must never be able to fail init."""
    if size_ <= 1:
        return _trivial_graph()
    if os.environ.get("BFTPU_LAB_AUTO_TOPOLOGY", "0").lower() in (
            "1", "true", "yes", "on"):
        try:
            from bluefog_tpu_torch import lab as _lab

            payload = int(os.environ.get("BFTPU_LAB_PAYLOAD_BYTES",
                                         "1048576"))
            rec = _lab.recommend(size_, payload)
            return _lab.build_topology(rec["topology"], size_)
        except Exception:
            pass
    return topology_util.ExponentialTwoGraph(size_)


def _attach_edge_health(ctx: "_IslandContext") -> None:
    """Wire the (epoch-persistent) edge-health machine into the
    (per-epoch) failure detector, translating the detector's local
    ranks to the machine's global ids — death declarations must reach
    the machine (DEAD outranks SUSPECT, and is never floor-delayed)."""
    if ctx.adaptive is None:
        return
    members = ctx.members_global
    ctx.detector.edge_health = ctx.adaptive.health
    ctx.detector.to_peer = (
        lambda l: members[l] if 0 <= l < len(members) else l)


def _peer_global(ctx: "_IslandContext", local: int) -> int:
    m = ctx.members_global
    return m[local] if 0 <= local < len(m) else local


_context: Optional[_IslandContext] = None


def _ctx() -> _IslandContext:
    if _context is None:
        raise RuntimeError("islands not initialized; call islands.init() "
                           "(or launch via bftpu-run --islands N)")
    return _context


def init(rank_: Optional[int] = None, size_: Optional[int] = None,
         job: Optional[str] = None) -> None:
    """Join the island job.  Arguments default to the env the launcher sets
    (``BLUEFOG_ISLAND_RANK/SIZE/JOB``) — the analogue of ``bf.init()`` under
    ``bfrun`` reading MPI env [U]."""
    global _context
    if _context is not None:
        return
    if rank_ is None and os.environ.get("BLUEFOG_ISLAND_JOINER") == "1":
        # a launcher-spawned replacement/scale-out process (bftpu-run
        # --self-heal / --attach scale): rendezvous as a JOINER instead
        # of binding a launch rank — the script's init() call needs no
        # changes to run elastically
        join(job=job)
        return
    if rank_ is None or size_ is None:
        if "BLUEFOG_ISLAND_RANK" not in os.environ:
            raise RuntimeError(
                "islands.init() needs rank/size: either pass them explicitly "
                "or launch under `bftpu-run --islands N` (which sets "
                "BLUEFOG_ISLAND_RANK/SIZE/JOB), or use islands.spawn()"
            )
    r = int(os.environ["BLUEFOG_ISLAND_RANK"]) if rank_ is None else int(rank_)
    n = int(os.environ["BLUEFOG_ISLAND_SIZE"]) if size_ is None else int(size_)
    j = os.environ.get("BLUEFOG_ISLAND_JOB", "default") if job is None else job
    if not (0 <= r < n):
        raise ValueError(f"rank {r} out of range for size {n}")
    reg = _telemetry.get_registry()
    if reg.enabled:
        # spawn() passes rank/size/job as arguments, not env — point the
        # registry at the real identity so per-rank snapshot files do not
        # collide on the env-derived default (rank 0)
        reg.rank, reg.job = r, j
        reg.journal("island_init", size=n)
    tr = _tracing.get_tracer()
    if tr.enabled:
        # same identity handoff as telemetry, plus the SIGTERM flight-dump
        # handler and the per-rank flight ring at its final path
        tr.set_identity(r, n, j)
        tr.instant("island_init")
    _context = _IslandContext(r, n, j)
    try:
        # publish the elastic-membership board (idempotent, first writer
        # wins) so a later joiner can rendezvous; see resilience/join.py
        _join.MembershipBoard(j).ensure(n)
    except OSError:
        pass  # read-only shm dir: the job simply is not elastic
    _context.shm_job.barrier()


def shutdown(unlink: bool = False) -> None:
    """Leave the job; ``unlink=True`` (call on exactly one rank, after a
    barrier) removes the shm segments.

    Hierarchical transport: shared memory is only reachable from its own
    host, so each host group's leader additionally reclaims ITS host's
    segments regardless of ``unlink`` — a global rank cannot clean a
    remote /dev/shm.
    """
    global _context
    if _context is None:
        return
    ctx = _context
    if ctx.progress is not None:
        # the engine dies BEFORE the segments it deposits into: stop()
        # drains the remaining queue through the still-open windows
        ctx.progress.stop(drain=True)
        ctx.progress = None
    ctx.detector.stop()
    reg = _telemetry.get_registry()
    for w in ctx.windows.values():
        if reg.enabled:
            # windows still live at shutdown: whatever mass their slots
            # hold retires as "pending" (callers barrier before shutdown,
            # so on clean runs the deposits are all committed by now)
            _ledger_probe_pending(reg, w, ctx.rank)
        w.shm.close(unlink=False)
    names = list(ctx.created_names)
    ctx.windows.clear()
    ctx.shm_job.close(unlink=False)
    if ctx.statuspage is not None:
        ctx.statuspage.close(unlink=unlink)
        ctx.statuspage = None
    if ctx.serve_region is not None:
        ctx.serve_region.close(unlink=unlink)
        ctx.serve_region = None
    hostmap = os.environ.get("BLUEFOG_ISLAND_HOSTMAP")
    if hostmap:
        from bluefog_tpu_torch.native.routed_transport import parse_hostmap

        hosts = parse_hostmap(hostmap, ctx.size)
        local = [r for r in range(ctx.size) if hosts[r] == hosts[ctx.rank]]
        if ctx.rank == local[0]:
            shm_native.unlink_all(f"{ctx.job}_h{hosts[ctx.rank]}", names)
    if unlink:
        shm_native.unlink_all(ctx.job, names)
    tr = _tracing.get_tracer()
    if tr.enabled:
        tr.write_buffer()
        tr.close()
    _context = None


def initialized() -> bool:
    return _context is not None


def rank() -> int:
    return _ctx().rank


def size() -> int:
    return _ctx().size


def barrier(timeout: Optional[float] = None) -> None:
    """Explicit global barrier (init/teardown/tests; the async hot loop
    never calls this — that is the point of islands).  With ``timeout``
    (seconds) the wait is bounded: TimeoutError if the barrier does not
    complete — the arrival is retracted, so a later barrier is unharmed.
    Raises TypeError on transports without timed-barrier support."""
    if timeout is None:
        _ctx().shm_job.barrier()
    else:
        _ctx().shm_job.barrier(timeout=timeout)


def set_topology(topo: topology_util.DiGraph) -> bool:
    """Install the virtual topology.  Must be called identically on every
    rank BEFORE creating windows (windows snapshot it, as upstream [U])."""
    ctx = _ctx()
    if ctx.windows:
        raise RuntimeError("set_topology with live windows: free them first "
                           "(windows snapshot their topology, as upstream)")
    ctx.topology = topo
    return True


def load_topology() -> topology_util.DiGraph:
    return _ctx().topology


def in_neighbor_ranks() -> List[int]:
    ctx = _ctx()
    return sorted(ctx.topology.predecessors(ctx.rank))


def out_neighbor_ranks() -> List[int]:
    ctx = _ctx()
    return sorted(ctx.topology.successors(ctx.rank))


# ---------------------------------------------------------------------------
# resilience: failure detection + topology healing (docs/RESILIENCE.md)
# ---------------------------------------------------------------------------


def resilience_detector() -> FailureDetector:
    """This rank's heartbeat failure detector (started at init on
    transports with liveness support)."""
    return _ctx().detector


def dead_ranks() -> set:
    """Ranks the failure detector currently considers dead (monotone:
    once declared, a rank stays dead for this job)."""
    return _ctx().detector.dead_ranks()


def is_orphaned() -> bool:
    """Whether this rank is in the ORPHAN quiesce (lost membership
    quorum; see docs/RESILIENCE.md "Orphan quiesce")."""
    return _ctx().orphaned


def _publish_orphan_page(ctx: "_IslandContext") -> None:
    """One final status-page publish carrying the ORPHAN flag — the
    page then freezes (the quiesced rank runs no more window ops), so
    an attached ``bftpu-top`` keeps showing the verdict."""
    page = ctx.statuspage
    if page is None:
        return
    from bluefog_tpu_torch.introspect import statuspage as _statuspage

    reg = _telemetry.get_registry()
    try:
        page.publish(nranks=len(ctx.members_global), step=ctx.op_rounds,
                     epoch=ctx.epoch, op_id=ctx.op_rounds,
                     last_op="ORPHAN",
                     ledger=_ledger_totals(reg) if reg.enabled else None,
                     flags=_statuspage.FLAG_ORPHAN)
    except (OSError, ValueError):
        pass  # a reaped segment must never fail the quiesce itself


def _enter_orphan(ctx: "_IslandContext", live: int, total: int,
                  op: str) -> None:
    """The minority-side verdict: freeze instead of forking a second
    epoch lineage.  Idempotent — only the first denial transitions."""
    if ctx.orphaned:
        return
    ctx.orphaned = True
    reg = _telemetry.get_registry()
    if ctx.progress is not None:
        # park the engine exactly like an epoch switch does: the
        # in-flight op completes (or times out against the unreachable
        # side), queued ops stay queued until merge_orphan re-resolves
        # the world — no resume() until then
        try:
            ctx.progress.quiesce()
        except Exception:  # noqa: BLE001 - quiesce must not mask the verdict
            pass
    if reg.enabled:
        reg.counter("resilience.orphan_entered").inc()
        reg.journal("orphan_entered", epoch=ctx.epoch,
                    global_rank=ctx.global_rank, live=live, total=total,
                    op=op, **_ledger_totals(reg))
    tr = _tracing.get_tracer()
    if tr.enabled:
        tr.instant("orphan_entered", aux=live)
    _publish_orphan_page(ctx)


def _orphan_guard(ctx: "_IslandContext", op: str) -> None:
    """Raise the retriable :class:`OrphanedError` on any state-mutating
    window op while quiesced (reads of local state stay allowed)."""
    if ctx.orphaned:
        raise OrphanedError(
            f"{op}: this rank is ORPHANED (minority side of a "
            f"partition, membership epoch {ctx.epoch}); windows are "
            "read-only until merge_orphan() re-admits it",
            live=-1, total=len(ctx.members_global), epoch=ctx.epoch)


def _quorum_gate(ctx: "_IslandContext", dead: set, op: str) -> bool:
    """Quorum fence for heal/demote commits: True = the commit may
    proceed.  ``dead`` is the would-be local-rank dead set (this
    rank's view).  A denial enters the ORPHAN quiesce."""
    if not _quorum.quorum_enabled():
        return True
    total = len(ctx.members_global)
    live = total - len(set(ctx.dead) | set(dead))
    if _quorum.quorum_met(live, total):
        return True
    reg = _telemetry.get_registry()
    if reg.enabled:
        reg.counter("resilience.quorum_denied", op=op).inc()
        reg.journal("quorum_denied", op=op, live=live, total=total,
                    floor=_quorum.majority_floor(total), epoch=ctx.epoch)
    _enter_orphan(ctx, live, total, op)
    return False


def heal(dead=None, retiring=()):
    """Excise ``dead`` ranks (default: the detector's verdict) from the
    gossip: force-drain their mailbox slots (a writer that died
    mid-deposit committed zero mass — see DEPOSIT_COMMITS_AFTER_PAYLOAD),
    break any job mutex they held, and record them so every subsequent
    win op skips them and renormalizes its combine weights
    (mass-conserving degraded steps).  Returns the
    :class:`~bluefog_tpu_torch.resilience.healing.HealedTopology` — survivor
    topology, doubly-stochastic W, and recompiled plan — or None when
    nothing is dead.

    ``retiring`` marks local ranks in ``dead`` whose PROCESS is alive —
    an orphan's abandoned identity, excised at merge-grant time
    (:func:`admit_pending`).  They are excised and drained like any
    corpse, but WITHOUT the crash-side ledger settlement: a crashed
    rank's registry died with it (so the survivor adopts its writer
    counts and writes off deposits it will never combine), while a
    retiring rank's registry lives on — it keeps its own writer counts
    and probes its quiesced inbox as pending in
    :func:`merge_orphan`, so settling its sides here would
    double-count both legs of the conservation identity.

    Idempotent and rank-local: every survivor calls it on its own
    schedule; no collective required (there is no one left to
    coordinate with — that is the failure mode being handled).

    Quorum-fenced (``BFTPU_QUORUM``, default ``majority``): the heal
    only commits when this rank still sees a strict majority of the
    membership epoch as live.  A minority view is a partition, not a
    mass death — the rank enters the ORPHAN quiesce instead and the
    call returns None (docs/RESILIENCE.md "Orphan quiesce").
    """
    ctx = _ctx()
    reg = _telemetry.get_registry()
    t0 = time.perf_counter_ns() if reg.enabled else 0
    dead = set(ctx.detector.dead_ranks() if dead is None else dead)
    if not dead:
        return ctx.healed
    if ctx.orphaned or not _quorum_gate(ctx, dead, "heal"):
        # quorum fence (BFTPU_QUORUM): a rank that cannot account for
        # a strict majority as live is the MINORITY side of a
        # partition, not a survivor — it must not excise "corpses"
        # that are actually healthy ranks across the cut.  No state
        # was mutated; merge_orphan() is the way back.
        return None
    for r in dead:
        ctx.detector.declare_dead(r)
    new = dead - ctx.dead
    ctx.dead |= dead
    for r in sorted(new):
        # a rank that died holding a mutex must not wedge win_mutex
        breaker = getattr(ctx.shm_job, "mutex_break", None)
        if breaker is not None:
            breaker(r)
    retiring = set(retiring)
    adopted = written_off = 0
    for win in ctx.windows.values():
        if reg.enabled:
            # the corpse's registry died with it, so BOTH sides of its
            # edges must be settled from the survivor side or the global
            # conservation identity (deposits == collected + drained +
            # pending over the live registries) breaks:
            # - edges corpse->me: ADOPT its lost writer-side count — the
            #   slot version is the monotone deposit count, minus the
            #   creation seed;
            # - edges me->corpse: WRITE OFF my deposits it will never
            #   combine — they leave live circulation as pending.
            # A RETIRING identity gets neither: its live registry keeps
            # the writer counts, and merge_orphan probes its inbox.
            rv = getattr(win.shm, "read_version", None)
            for s in win.in_neighbors:
                if s in new and s not in retiring and rv is not None:
                    try:
                        v = int(rv(win.slot_of[ctx.rank][s], src=s))
                    except Exception:  # noqa: BLE001 - accounting only
                        v = win._seed_ver
                    if v > win._seed_ver:
                        adopted += v - win._seed_ver
            for r in new:
                if r in retiring:
                    win._deposited_to.pop(r, None)
                else:
                    written_off += win._deposited_to.pop(r, 0)
        drain = getattr(win.shm, "force_drain", None)
        if drain is None:
            continue
        for s in win.in_neighbors:
            if s in new:
                slot = win.slot_of[ctx.rank][s]
                if reg.enabled:
                    _ledger_retire_probe(
                        reg, win, slot, s, _telemetry.LEDGER_DRAINED)
                drain(slot, src=s)
    if reg.enabled:
        if adopted:
            reg.counter(_telemetry.LEDGER_DEPOSITS).add(adopted)
        if written_off:
            reg.counter(_telemetry.LEDGER_PENDING).add(written_off)
    ctx.healed = _healing.heal_topology(ctx.topology, sorted(ctx.dead))
    tr = _tracing.get_tracer()
    if tr.enabled and new:
        for r in sorted(new):
            tr.instant("heal", aux=r)
    if reg.enabled and new:
        dt = (time.perf_counter_ns() - t0) / 1e9
        reg.counter("resilience.heals").inc()
        reg.histogram("resilience.heal_s").observe(dt)
        reg.journal("heal", new_dead=sorted(new), dead=sorted(ctx.dead),
                    duration_s=dt, ledger_adopted=adopted,
                    ledger_written_off=written_off)
    return ctx.healed


# ---------------------------------------------------------------------------
# elastic membership: rank join + epoch switch (resilience/join.py;
# docs/RESILIENCE.md "Elastic membership")
# ---------------------------------------------------------------------------


def global_rank() -> int:
    """This rank's stable global identity.  Equal to :func:`rank` in the
    launch epoch; after membership changes :func:`rank` is the dense
    epoch-local rank while the global rank never changes (and a dead
    rank's global id is never reissued)."""
    return _ctx().global_rank


def members() -> Tuple[int, ...]:
    """Sorted global ranks of the current membership epoch."""
    return tuple(_ctx().members_global)


def membership_epoch() -> int:
    """The membership epoch this rank is currently participating in."""
    return _ctx().epoch


def _ledger_totals(reg) -> Dict[str, float]:
    return {
        "deposits": reg.counter(_telemetry.LEDGER_DEPOSITS).value,
        "collected": reg.counter(_telemetry.LEDGER_COLLECTED).value,
        "drained": reg.counter(_telemetry.LEDGER_DRAINED).value,
        "pending": reg.counter(_telemetry.LEDGER_PENDING).value,
    }


def _live_global_graph(ctx: "_IslandContext") -> topology_util.DiGraph:
    """The current topology restricted to live members, in GLOBAL rank
    labels — the graph :func:`grow_topology` splices joiners into."""
    mapping = {l: ctx.members_global[l] for l in range(ctx.size)
               if l not in ctx.dead}
    G = topology_util.DiGraph()
    G.add_nodes_from(sorted(mapping.values()))
    for u, v in ctx.topology.edges:
        if u != v and u in mapping and v in mapping:
            G.add_edge(mapping[u], mapping[v])
    return G


def _windows_meta(ctx: "_IslandContext") -> List[dict]:
    return [{"name": n,
             "shape": [int(d) for d in ctx.windows[n].shm.shape],
             "dtype": str(np.dtype(ctx.windows[n].shm.dtype))}
            for n in sorted(ctx.windows)]


def _switch_epoch(ctx: "_IslandContext", rec: dict) -> None:
    """Member side of the epoch switch: retire outstanding mailbox mass,
    journal the ledger balance AT the switch (the membership-epoch
    audit point), close the old epoch's segments, and rebind into the
    epoch-suffixed namespace with the committed topology and windows.

    Old-epoch segments are left for crashed-run hygiene to reclaim (the
    designated unlink rank of the old epoch may be exactly the corpse
    being replaced); ``unlink_all``'s job-prefix glob catches every
    epoch's segments.
    """
    reg = _telemetry.get_registry()
    tr = _tracing.get_tracer()
    t0 = time.perf_counter_ns()
    if ctx.progress is not None:
        # park the progress engine FIRST: the in-flight op completes into
        # the old epoch's segments (its mass is then probed as pending or
        # already committed below), and queued ops survive the rebind —
        # they resolve their window by NAME at execution time, so after
        # resume() they land in the new epoch's segments.  No op is lost
        # or double-executed (the progress.queue-state-machine rule).
        ctx.progress.quiesce()
    if rec.get("reweight"):
        # QUIESCE before probing: an adaptive reweight switches a fleet
        # where every member is alive and mid-gossip — a deposit landing
        # after my pending-probe but before the peer switches would
        # vanish from the ledger.  Barriering the OLD epoch first orders
        # every member's last old-epoch write before every member's
        # probe, so the switch-point ledger balances deterministically.
        # (The join/death path cannot do this: its old epoch may contain
        # a corpse that will never arrive.)
        ctx.shm_job.barrier()
    saved: Dict[str, Tuple[np.ndarray, float]] = {}
    for name, w in ctx.windows.items():
        if reg.enabled:
            # deposits still sitting in slots cross the epoch boundary as
            # "pending" — never silently: the conservation identity
            # deposits == collected + drained + pending must hold AT the
            # switch (the resilience.membership-epoch rule checks it)
            _ledger_probe_pending(reg, w, ctx.rank)
        saved[name] = (np.array(w.self_tensor, copy=True), float(w.p_self))
    if reg.enabled:
        reg.journal("epoch_switch", old_epoch=ctx.epoch,
                    new_epoch=int(rec["epoch"]),
                    global_rank=ctx.global_rank,
                    joined=list(rec.get("joined", ())),
                    demoted=list(rec.get("demoted", ())),
                    **_ledger_totals(reg))
    ctx.detector.stop()
    for w in ctx.windows.values():
        w.shm.close(unlink=False)
    ctx.shm_job.close(unlink=False)

    new_members = tuple(int(m) for m in rec["members"])
    new_local = new_members.index(ctx.global_rank)
    m = len(new_members)
    ejob = _join.epoch_job(ctx.base_job, int(rec["epoch"]))
    ctx.rank = new_local
    ctx.size = m
    ctx.job = ejob
    ctx.epoch = int(rec["epoch"])
    ctx.members_global = new_members
    ctx.topology = _join.record_graph(rec)
    ctx.dead = set()
    ctx.healed = None
    # reweight records carry the adaptive state forward; any other kind
    # (a join grant re-splices the graph) resets it — the persistent
    # edge-health machine will simply re-demote a still-slow rank
    old_demoted = set(ctx.demoted)
    ctx.demoted = set(int(g) for g in rec.get("demoted", ()))
    if ctx.adaptive is not None and rec.get("reweight"):
        # start the commit floor for every peer whose standing changed,
        # and adopt the committer's promote verdicts: a non-anchor's
        # machine was starved of observations during the demotion and
        # would otherwise re-demote on its stale SUSPECT state
        changed = (old_demoted ^ ctx.demoted) \
            | set(int(g) for g in rec.get("promoted", ()))
        ctx.adaptive.note_epoch_change(changed)
        for g in rec.get("promoted", ()):
            if int(g) != ctx.global_rank:
                ctx.adaptive.health.absolve(int(g))
    ctx.base_edges = ([(int(u), int(v)) for u, v in rec["base_edges"]]
                      if rec.get("base_edges") else None)
    ctx.windows = {}
    ctx.created_names = set()
    ctx.shm_job = shm_native.make_job(ejob, new_local, m)
    ctx.detector = FailureDetector(ctx.shm_job, new_local, m).start()
    _attach_edge_health(ctx)
    ctx.shm_job.barrier()  # every new-epoch member (joiners included)
    for wmeta in sorted(rec["windows"], key=lambda w: w["name"]):
        name = wmeta["name"]
        t, p = saved[name]
        win = _IslandWindow(name, t, ctx, zero_init=True)
        ctx.windows[name] = win
        ctx.created_names.add(name)
        if p != 1.0:
            # carry this member's push-sum mass across the epoch: the
            # fresh window exposed (t, 1.0); restore the true (t, p)
            win.p_self = p
            win.shm.expose(win.self_tensor, p)
        # re-seed my own slots with the restored (t, p) — the creation
        # contract (pre-put win_update is a no-op average); zero slots
        # would bleed into the first post-switch combines and destroy
        # the consensus value admission is supposed to preserve
        for k, s in enumerate(win.in_neighbors):
            win.shm.write(ctx.rank, k, win.self_tensor,
                          p=win.p_self, writer=s)
            win._ledger_seen[k] = 1
        win._seed_ver = 1
    ctx.shm_job.barrier()  # every (t, p) exposure restored — joiners
    ctx.shm_job.barrier()  # ... finished their onboarding reads
    if ctx.progress is not None:
        ctx.progress.resume()
    if tr.enabled:
        tr.instant("epoch_switch", aux=ctx.epoch)
    if reg.enabled:
        reg.counter("resilience.epoch_switches").inc()
        reg.histogram("resilience.epoch_switch_s").observe(
            (time.perf_counter_ns() - t0) / 1e9)


def admit_pending(timeout: Optional[float] = None):
    """Admit any pending join requests and switch the job to the next
    membership epoch.  Call at a round barrier on EVERY member (the
    natural spot is right after a combine); returns the committed epoch
    record, or None when nobody is waiting to join.

    The sponsor — the lowest live global rank — grants all pending
    requests in one atomic board commit (fresh ranks, grown topology,
    window metadata); every other member waits for the commit, then all
    members switch together (see :func:`_switch_epoch`).  If the
    sponsor dies mid-admission, the next-lowest live rank takes over —
    the board commit is idempotent, so a raced double-grant resolves to
    the first record.
    """
    ctx = _ctx()
    if ctx.orphaned:
        return None  # an orphan neither sponsors nor switches epochs
    board = _join.MembershipBoard(ctx.base_job)
    rec = None
    if shm_native.membership_epoch(ctx.base_job) > ctx.epoch:
        rec = board.epoch_record(ctx.epoch + 1)
    if rec is None:
        pend = board.pending_requests()
        if not pend:
            return None
        # a merging orphan names the identity it abandoned: excise it
        # exactly like a detector-confirmed corpse BEFORE granting —
        # its heartbeats only stopped at the merge, so the detector may
        # not have flagged it yet, and a grown view that includes it
        # would wait forever on the new-epoch barrier
        g2l = {g: l for l, g in enumerate(ctx.members_global)}
        stale = {g2l[int(r["retiring"])] for r in pend
                 if int(r.get("retiring", -1)) in g2l} - ctx.dead
        if stale:
            # retiring identities are excised WITHOUT the crash-side
            # ledger settlement (their live process settles its own
            # sides at merge — see heal's ``retiring`` contract)
            heal(set(ctx.detector.dead_ranks()) | stale, retiring=stale)
        elif ctx.detector.dead_ranks() - ctx.dead:
            heal()  # the grown view must not include a corpse
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.journal("join_requested_seen", epoch=ctx.epoch)
        deadline = time.monotonic() + (
            _degraded.op_deadline_s() if timeout is None else timeout)
        while rec is None:
            live = [ctx.members_global[l] for l in range(ctx.size)
                    if l not in ctx.dead]
            if ctx.global_rank == min(live) and board.pending_requests():
                rec = board.grant(
                    ctx.global_rank, live, _live_global_graph(ctx),
                    _windows_meta(ctx), ctx.associated_p, ctx.epoch)
                if rec is not None and reg.enabled:
                    reg.counter("resilience.joins_admitted").inc(
                        len(rec["joined"]))
                    reg.journal("join_admitted",
                                joined=list(rec["joined"]),
                                epoch=int(rec["epoch"]),
                                sponsor=ctx.global_rank)
                break
            rec = board.epoch_record(ctx.epoch + 1)
            if rec is not None:
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"epoch {ctx.epoch + 1} not committed within the "
                    "deadline (is the sponsor calling admit_pending?)")
            # the sponsor may itself be the next corpse: refresh the
            # verdict so sponsorship falls through to the next-lowest
            if ctx.detector.dead_ranks() - ctx.dead:
                heal()
            time.sleep(_join.join_poll_s())
    if rec is None:
        return None
    _switch_epoch(ctx, rec)
    return dict(rec)


def join(job: Optional[str] = None, timeout: Optional[float] = None,
         retiring: int = -1):
    """Join a LIVE island job as a brand-new rank (the elastic scale-out
    entry point; call INSTEAD of :func:`init`).  Blocks until some
    member admits this process via :func:`admit_pending`, then binds
    the new epoch's segments, receives every live window's state from
    the sponsor over the exposed-window (broadcast) path, and returns
    the :class:`~bluefog_tpu_torch.resilience.join.JoinGrant`.

    The joiner enters each window with **unit push-sum mass at the
    sponsor's debiased estimate** — Σx/Σp over the grown membership is
    the same value the survivors agreed on, so admission neither
    creates nor destroys mass (journaled per window as
    ``join_mass_admitted``; counter ``MASS_JOIN_ADMITTED``).

    ``retiring`` names a global rank this process is abandoning —
    :func:`merge_orphan` re-enters under a fresh rank while its
    quiesced old identity may still look alive to the majority; the
    request carries it so :func:`admit_pending` excises the old
    identity before granting (dead ids are never reissued).
    """
    global _context
    if _context is not None:
        raise RuntimeError("join(): this process is already a member "
                           "(join replaces init for new processes)")
    j = job if job is not None else os.environ.get("BLUEFOG_ISLAND_JOB")
    if not j:
        raise RuntimeError("join() needs the job name: pass job= or set "
                           "BLUEFOG_ISLAND_JOB")
    board = _join.MembershipBoard(j)
    req = board.post_request(retiring=retiring)
    grant = board.wait_for_grant(req, timeout)
    rec = grant.record
    reg = _telemetry.get_registry()
    if reg.enabled:
        reg.rank, reg.job = grant.rank, j
        reg.journal("join_granted", epoch=grant.epoch,
                    sponsor=grant.sponsor,
                    members=list(grant.members))
    tr = _tracing.get_tracer()
    if tr.enabled:
        tr.set_identity(grant.rank, grant.size, j)
        tr.instant("join_granted", aux=grant.epoch)
    ejob = _join.epoch_job(j, grant.epoch)
    ctx = _IslandContext(grant.local_rank, grant.size, ejob)
    ctx.topology = _join.record_graph(rec)
    ctx.base_job = j
    ctx.epoch = grant.epoch
    ctx.global_rank = grant.rank
    ctx.members_global = grant.members
    ctx.associated_p = bool(rec.get("associated_p", False))
    if ctx.statuspage is not None:
        # the context constructor keyed the page by (epoch job, local
        # rank); re-key by the stable identity bftpu-top attaches under
        from bluefog_tpu_torch.introspect import statuspage as _statuspage

        ctx.statuspage.close(unlink=True)
        try:
            ctx.statuspage = _statuspage.StatusPage(j, grant.rank)
            ctx.tracectl = _statuspage.TraceControl(j, grant.rank,
                                                   grant.size)
        except OSError:
            ctx.statuspage = None
    _context = ctx
    ctx.shm_job.barrier()  # aligns with _switch_epoch's first barrier
    sponsor_local = grant.sponsor_local
    for wmeta in sorted(rec["windows"], key=lambda w: w["name"]):
        name = wmeta["name"]
        dt = np.dtype(wmeta["dtype"])
        win = _IslandWindow(name, np.zeros(tuple(wmeta["shape"]), dt),
                            ctx, zero_init=True)
        ctx.windows[name] = win
        ctx.created_names.add(name)
    ctx.shm_job.barrier()  # members restored their true (t, p) exposures
    for name in sorted(ctx.windows):
        win = ctx.windows[name]
        # onboarding = the broadcast idiom: one one-sided read of the
        # sponsor's exposure, debiased so the joiner enters at the value
        # the survivors agree on, with unit push-sum mass of its own
        a, p, _ = win.shm.read_exposed(sponsor_local)
        x = np.asarray(a / p if (ctx.associated_p and p > 0.0) else a,
                       dtype=win.shm.dtype)
        win.self_tensor = x
        win.p_self = 1.0
        win.shm.expose(x, 1.0)
        # seed my own slots with the entry value (creation contract: a
        # pre-put combine is a no-op average, never a mix with zeros)
        for k, s in enumerate(win.in_neighbors):
            win.shm.write(ctx.rank, k, x, p=1.0, writer=s)
            win._ledger_seen[k] = 1
        win._seed_ver = 1
        if reg.enabled:
            reg.counter(_telemetry.MASS_JOIN_ADMITTED).add(1.0)
            reg.journal("join_mass_admitted", window=name, p=1.0,
                        epoch=grant.epoch)
    ctx.shm_job.barrier()  # sponsor's exposure survived until here
    if reg.enabled:
        # the joiner's switch-point ledger is trivially balanced (all
        # zeros) but journaled anyway: the membership-epoch rule audits
        # EVERY member of the new view, joiners included
        reg.journal("epoch_switch", old_epoch=None,
                    new_epoch=grant.epoch, global_rank=grant.rank,
                    joined=list(rec.get("joined", ())),
                    **_ledger_totals(reg))
    if tr.enabled:
        tr.instant("join_complete", aux=grant.epoch)
    return grant


def merge_orphan(timeout: Optional[float] = None):
    """Re-enter the fleet after an ORPHAN quiesce (call when
    connectivity has returned): tear down the quiesced context and come
    back through the standard join machinery — membership-board lease →
    sponsor grant → fresh global rank → epoch switch — **carrying this
    rank's debiased estimate** into the new epoch.

    The majority side long since healed this rank away, settling both
    ledger sides from its end; our side settles symmetrically here —
    deposits still sitting in the quiesced slots are probed as pending
    before teardown, so the conservation identity holds across
    partition → heal → merge.  The orphan re-enters each window with
    unit push-sum mass at its own debiased x̂ (the value it agreed on
    before the cut), so the merge neither creates nor destroys mass
    and gossip re-converges to the member-weighted average.

    Blocks until some majority member admits us via
    :func:`admit_pending`; returns the :class:`~bluefog_tpu_torch.resilience.
    join.JoinGrant`.  The process keeps its telemetry/trace identity;
    its global rank changes (dead ids are never reissued).
    """
    global _context
    ctx = _ctx()
    if not ctx.orphaned:
        raise RuntimeError("merge_orphan(): this rank is not orphaned "
                           "(nothing to merge; did heal() deny quorum?)")
    reg = _telemetry.get_registry()
    est: Dict[str, np.ndarray] = {}
    for name, w in ctx.windows.items():
        x = np.array(w.self_tensor, copy=True)
        if ctx.associated_p and w.p_self > 0.0 and x.dtype == _BF16:
            x = _progress.staging.host_view(
                (_bf16(x).float() / w.p_self).to(torch.bfloat16))
        elif ctx.associated_p and w.p_self > 0.0:
            x = np.asarray(x / w.p_self, dtype=x.dtype)
        est[name] = x
        if reg.enabled:
            _ledger_probe_pending(reg, w, ctx.rank)
    if reg.enabled:
        reg.counter("resilience.orphan_merged").inc()
        reg.journal("orphan_merged", epoch=ctx.epoch,
                    global_rank=ctx.global_rank,
                    windows=sorted(est), **_ledger_totals(reg))
    tr = _tracing.get_tracer()
    if tr.enabled:
        tr.instant("orphan_merge", aux=ctx.epoch)
    base_job = ctx.base_job
    old_identity = ctx.global_rank
    # teardown, mirroring _switch_epoch's close half: segments are left
    # for crashed-run hygiene (unlink_all's job glob), the frozen
    # status page is reclaimed so bftpu-top stops reporting ORPHAN
    ctx.detector.stop()
    if ctx.progress is not None:
        try:
            ctx.progress.stop()
        except Exception:  # noqa: BLE001 - a wedged worker must not block merge
            pass
    for w in ctx.windows.values():
        w.shm.close(unlink=False)
    ctx.shm_job.close(unlink=False)
    if ctx.statuspage is not None:
        ctx.statuspage.close(unlink=True)
        ctx.statuspage = None
    _context = None
    # the request names the abandoned identity so the majority excises
    # it before granting (it would never ack the new-epoch barrier)
    grant = join(base_job, timeout, retiring=old_identity)
    nctx = _ctx()
    for name, x in est.items():
        w = nctx.windows.get(name)
        if w is None:
            continue  # the window was freed on the majority side
        # overwrite the sponsor-onboarded value with the carried
        # estimate: mass stays the unit p the grant admitted, only the
        # value differs — slot seeds are version-fenced (seed_ver), so
        # no combine mixes the stale sponsor copy back in
        w.self_tensor = np.asarray(x, dtype=w.shm.dtype)
        w.shm.expose(w.self_tensor, w.p_self)
    return grant


# ---------------------------------------------------------------------------
# serving plane: fenced snapshot publication to the inference fleet
# (bluefog_tpu_torch.serve; docs/SERVING.md)
# ---------------------------------------------------------------------------


def serve_publish(name: str, payload_cap: Optional[int] = None) -> int:
    """Publish my debiased estimate of window ``name`` as one committed
    serve snapshot for the job's replica fleet (docs/SERVING.md).

    The fence, in order: an ORPHAN quiesce raises immediately, and the
    quorum gate re-checks the current live view (detector verdict) at
    the publish boundary — a minority that has not yet healed enters the
    orphan quiesce HERE instead of publishing a split-brain snapshot.
    The progress engine (when running) is quiesced around the estimate
    read so no async deposit lands mid-snapshot; the snapshot itself is
    the push-sum debiased value x̂ = x/p — what the consensus agrees
    on — stamped with the membership epoch, so the publish is fenced at
    the epoch boundary replicas can reason about.

    Returns the committed version — strictly monotone for the job, even
    across publisher death and handoff (the region persists the word).

    A bf16 window's estimate is f32 (f32(x) / f32(p)), as the JAX
    package's ml_dtypes arithmetic gives it."""
    from bluefog_tpu_torch.serve.snapshot import SnapshotRegion

    ctx = _ctx()
    _orphan_guard(ctx, "serve_publish")
    if not _quorum_gate(ctx, set(ctx.detector.dead_ranks()),
                        "serve_publish"):
        _orphan_guard(ctx, "serve_publish")  # just quiesced: raise
    win = _win(name)
    reg = _telemetry.get_registry()
    t0 = time.monotonic()
    eng = ctx.progress
    if eng is not None:
        eng.quiesce()
    try:
        x = win.self_tensor
        if x.dtype == _BF16:
            if ctx.associated_p and win.p_self > 0.0:
                est = (_bf16(x).float() / win.p_self).numpy()
            else:
                est = np.array(x, copy=True)
        elif ctx.associated_p and win.p_self > 0.0:
            est = np.asarray(x) / win.p_self
        else:
            est = np.array(x, copy=True)
    finally:
        if eng is not None:
            eng.resume()
    region = ctx.serve_region
    if region is None:
        cap = int(payload_cap) if payload_cap else max(1, est.nbytes)
        region = ctx.serve_region = SnapshotRegion(ctx.base_job, cap)
    version = region.publish(est, epoch=ctx.epoch, step=ctx.op_rounds)
    ctx.serve_version = version
    if reg.enabled:
        reg.counter("serve.published").inc()
        reg.gauge("serve.version").set(version)
        reg.histogram("serve.publish_s").observe(time.monotonic() - t0)
        reg.journal("serve_publish", win=name, version=version,
                    epoch=ctx.epoch, step=ctx.op_rounds,
                    nbytes=int(est.nbytes))
    _statuspage_tick(ctx, name, "serve_pub")
    return version


# ---------------------------------------------------------------------------
# adaptive topology: the straggler demote/promote control loop
# (resilience/adaptive.py; docs/RESILIENCE.md "Adaptive topology")
# ---------------------------------------------------------------------------


def adaptive_policy() -> Optional[_adaptive.AdaptivePolicy]:
    """This rank's adaptive edge-health policy, or None when
    ``BFTPU_ADAPTIVE`` is off."""
    return _ctx().adaptive


def demoted_ranks() -> Tuple[int, ...]:
    """Sorted global ranks currently demoted (degree-capped) by the
    adaptive topology — members, not corpses: they still gossip through
    their anchor edge."""
    return tuple(sorted(_ctx().demoted))


def _members_graph_global(ctx: "_IslandContext") -> topology_util.DiGraph:
    """The CURRENT epoch topology over ALL members (demoted included),
    in global rank labels — the base a demote caps or a promote
    restores."""
    G = topology_util.DiGraph()
    G.add_nodes_from(sorted(ctx.members_global))
    for u, v in ctx.topology.edges:
        if u != v:
            G.add_edge(_peer_global(ctx, u), _peer_global(ctx, v))
    return G


def _is_anchor(ctx: "_IslandContext", g: int) -> bool:
    """Whether this rank is ``g``'s anchor in the demoted topology —
    the ONLY member still observing g's edge, hence the only member
    whose edge-health machine can witness the recovery (everyone else
    stopped probing g when the demote dropped their edges)."""
    if g not in ctx.members_global:
        return False
    lg = ctx.members_global.index(g)
    nbrs = set(ctx.topology.successors(lg)) | set(ctx.topology.predecessors(lg))
    return ctx.rank in nbrs


def _commit_reweight(ctx: "_IslandContext", board, demote=(), promote=()):
    """Compute the deterministic reweight record and race it onto the
    board (first observer wins; the rest adopt the committed record).
    Quorum-fenced like :func:`heal`: a minority view may not commit a
    demote/promote epoch either — same split-brain, different door."""
    if ctx.orphaned or not _quorum_gate(ctx, set(), "reweight"):
        return None
    base = ctx.base_edges
    if base is None:
        G0 = _members_graph_global(ctx)
        base = sorted((int(u), int(v)) for u, v in G0.edges)
    baseG = topology_util.DiGraph()
    baseG.add_nodes_from(sorted(ctx.members_global))
    baseG.add_edges_from(base)
    new_demoted = (set(ctx.demoted) | set(demote)) - set(promote)
    if new_demoted:
        healed = _healing.demote_topology(baseG, sorted(new_demoted))
    else:
        # full restore: heal with an empty dead set re-symmetrizes and
        # MH re-weights the base graph through the same pipeline
        healed = _healing.heal_topology(baseG, [])
    reg = _telemetry.get_registry()
    rec = board.commit_reweight(
        committer=ctx.global_rank, prev_epoch=ctx.epoch,
        members=[int(m) for m in healed.to_global],
        edges=list(healed.topology.edges),
        windows=_windows_meta(ctx), associated_p=ctx.associated_p,
        demoted=sorted(new_demoted), promoted=sorted(promote),
        base_edges=base)
    if rec is not None and not rec.get("reweight"):
        return None  # a raced JOIN grant won this epoch; retry next tick
    if (rec is not None and reg.enabled
            and int(rec["sponsor"]) == ctx.global_rank):
        which = "demote" if demote else "promote"
        reg.counter(f"adaptive.{which}s_committed").inc()
        reg.journal(f"adaptive_{which}", epoch=int(rec["epoch"]),
                    demoted=list(rec.get("demoted", ())),
                    promoted=list(rec.get("promoted", ())),
                    committer=ctx.global_rank)
    return rec


def adaptive_step():
    """One tick of the adaptive-topology control loop: call at the
    round cadence on EVERY member (right after a combine is the natural
    spot).  No-op unless ``BFTPU_ADAPTIVE`` is on.

    Three things can happen, at most one per tick:

    1. a reweight epoch committed by another member is observed (cheap
       epoch-word probe) and this rank switches into it;
    2. an in-neighbor the edge-health machine holds SUSPECT is DEMOTED:
       any observer commits the deterministic degree-capped topology
       (:func:`~bluefog_tpu_torch.resilience.healing.demote_topology`,
       first-wins) and switches;
    3. a demoted rank whose machine transitioned back to ALIVE — only
       its ANCHOR still observes it — is PROMOTED: the anchor commits
       the restored base topology and switches.

    Returns the epoch record switched through, or None.  Flapping
    cannot thrash epochs: the machine's hysteresis floor
    (``BFTPU_DEMOTE_FLOOR_S``) lower-bounds the time between its own
    transitions, and demote/promote commits only fire ON a transition's
    standing state.  Demotions are additionally capped to a MINORITY of
    the membership (longest-SUSPECT first) — every straggler needs a
    healthy anchor, and no misattribution cascade can demote the fleet
    out from under itself (at np=2 the cap is zero: ABSORB alone
    bounds the rounds there).
    """
    ctx = _ctx()
    pol = ctx.adaptive
    if pol is None or ctx.orphaned:
        return None
    board = _join.MembershipBoard(ctx.base_job)
    # 1. observe: someone committed an epoch I have not switched into
    if shm_native.membership_epoch(ctx.base_job) > ctx.epoch:
        rec = board.epoch_record(ctx.epoch + 1)
        if rec is not None and rec.get("reweight"):
            _switch_epoch(ctx, rec)
            return dict(rec)
        return None  # a join grant: admit_pending's business
    # 2. demote: a live, not-yet-demoted member gone SUSPECT
    suspects = pol.health.suspects()
    if suspects:
        cand = sorted(
            g for g in suspects
            if g in ctx.members_global and g not in ctx.demoted
            and g != ctx.global_rank
            and ctx.members_global.index(g) not in ctx.dead
            and pol.epoch_floor_open(g)
            # with the tracing feed live, demotion needs gap staleness
            # AND critical-path blame (pass-through when tracing is off)
            and pol.corroborated(g))
        if cand:
            # never demote past a minority: every straggler needs a
            # healthy anchor and a majority-healthy core keeps the
            # demoted graph mixing — this is also the terminal guard
            # against a convoy misattribution walking the fleet into
            # "every member is a straggler".  Longest-SUSPECT first:
            # under contention the persistently slow rank wins the slot
            # over a transient suspect.
            room = (len(ctx.members_global) - 1) // 2 - len(ctx.demoted)
            cand.sort(key=lambda g: -pol.health.time_in_state(g))
            cand = sorted(cand[:max(0, room)])
        if cand:
            rec = _commit_reweight(ctx, board, demote=cand)
            if rec is not None:
                _switch_epoch(ctx, rec)
                return dict(rec)
            return None
    # 3. promote: an anchored straggler proved itself ALIVE again
    if ctx.demoted:
        cand = sorted(
            g for g in ctx.demoted
            if pol.health.state(g) == EDGE_ALIVE and _is_anchor(ctx, g)
            and pol.epoch_floor_open(g))
        if cand:
            rec = _commit_reweight(ctx, board, promote=cand)
            if rec is not None:
                _switch_epoch(ctx, rec)
                return dict(rec)
    return None


def adaptive_leave() -> int:
    """Leave the adaptive control loop: call on EVERY member once it has
    made its last :func:`adaptive_step`, before its teardown barrier
    (:func:`spawn`'s workers do).  No-op unless ``BFTPU_ADAPTIVE`` is on.

    Members finish their rounds at different times.  A reweight that a
    member still stepping commits after another has left would pair the
    switch's old-epoch barrier with the leaver's teardown barrier: the
    leaver shuts down, and the switchers wait in the new epoch's barrier
    for it forever.  So the leaver marks itself leaving on the membership
    board, after which no member can commit a reweight
    (:meth:`~bluefog_tpu_torch.resilience.join.MembershipBoard.mark_leaving`),
    and switches through the reweight epochs committed before its mark,
    which its peers switch through too, so every member meets the
    teardown barrier in the same epoch.  Returns the epochs switched
    through."""
    ctx = _ctx()
    if ctx.adaptive is None or ctx.orphaned:
        return 0
    board = _join.MembershipBoard(ctx.base_job)
    if board.read() is None:
        return 0  # not elastic (read-only shm dir): nothing was committed
    last = board.mark_leaving(ctx.global_rank)
    switched = 0
    while ctx.epoch < last:
        rec = board.epoch_record(ctx.epoch + 1)
        if rec is None or not rec.get("reweight"):
            break  # a join grant: admit_pending's business
        _switch_epoch(ctx, rec)
        switched += 1
    return switched


# ---------------------------------------------------------------------------
# window ops
# ---------------------------------------------------------------------------


def _win(name: str) -> _IslandWindow:
    w = _ctx().windows.get(name)
    if w is None:
        raise KeyError(f"no window named {name!r}; call win_create first")
    return w


def _check_dst(win: _IslandWindow, dst_weights: WeightDict):
    """Destination ranks for a put/accumulate, validated against MY
    out-neighbors (a deposit lands in the slot keyed by the WRITER, so a
    non-out-neighbor target has no slot for us — fail with the real reason
    rather than a confusing slot KeyError)."""
    if dst_weights is None:
        return win.out_neighbors
    unknown = set(dst_weights) - set(win.out_neighbors)
    if unknown:
        raise KeyError(
            f"dst_weights for non-out-neighbor rank(s) {sorted(unknown)}; "
            f"out-neighbors of rank {_ctx().rank} are {win.out_neighbors}"
        )
    return dst_weights


def _to_host(tensor, key: Optional[str] = None) -> np.ndarray:
    # torch.Tensor (CPU: a view of its storage; CUDA: a pinned-buffer copy
    # cached under ``key``), a staged DeviceSnapshot, or array-like → host
    # numpy (progress/staging.py)
    return _progress.staging.stage(tensor, key)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _from_host(arr: np.ndarray, device):
    """``arr`` as the kind the window was created from: numpy when
    ``device`` is None, else a torch tensor on ``device`` (a CPU tensor
    shares ``arr``'s memory when it is writable; bf16 bytes come back as
    ``torch.bfloat16``)."""
    if device is None:
        return arr
    if device.type == "cpu":
        return _progress.staging.tensor_view(
            arr if arr.flags.writeable else arr.copy())
    return _progress.staging.to_device(arr, device)


class _IslandFusionMeta:
    """Pytree (fused) window metadata — one packed buffer per tree, the
    twin of windows._FusionMeta for the island (host) runtime."""

    __slots__ = ("treedef", "shapes", "sizes")

    def __init__(self, treedef, shapes, sizes):
        self.treedef = treedef
        self.shapes = shapes
        self.sizes = sizes


def _flatten(tree):
    """(leaves, spec) of a pytree of tensors/arrays (dicts, lists, tuples;
    ``torch.utils._pytree``: dicts flatten in insertion order)."""
    return _pytree.tree_flatten(tree)


def _pack_leaves(leaves, key: str):
    """One flat buffer from the leaves: ``torch.cat`` on their device when
    they are all tensors on one device (a new tensor, so a snapshot), else
    the concatenation of their host copies."""
    if (leaves and all(_is_tensor(l) for l in leaves)
            and len({l.device for l in leaves}) == 1):
        return torch.cat([l.detach().reshape(-1) for l in leaves])
    packed = np.concatenate([_to_host(l, f"{key}#leaf#{i}").ravel()
                             for i, l in enumerate(leaves)])
    _progress.staging.release(f"{key}#leaf")  # the concatenation copied them
    return packed


def _island_fusion_split(tensor):
    """(meta, packed 1-D buffer) for a pytree; (None, tensor) for a tensor
    or array."""
    leaves, treedef = _flatten(tensor)
    if treedef.is_leaf():
        return None, tensor
    if not leaves:
        raise ValueError("win_create: empty pytree")
    if isinstance(tensor, (list, tuple)) and all(
        np.ndim(l) == 0 and not _is_tensor(l) for l in leaves
    ):
        # nested-list-of-scalars spelling of a bare array
        return None, np.asarray(tensor)
    dts = {_np_dtype(l) for l in leaves}
    if len(dts) > 1:
        raise ValueError(
            f"fused windows need a uniform leaf dtype, got "
            f"{sorted(map(str, dts))}; create one window per dtype group"
        )
    meta = _IslandFusionMeta(
        treedef,
        [tuple(l.shape) for l in leaves],
        [int(np.prod(tuple(l.shape), dtype=np.int64)) for l in leaves],
    )
    return meta, _pack_leaves(leaves, "#create")


def _np_dtype(x) -> np.dtype:
    if _is_tensor(x):
        if x.dtype == torch.bfloat16:
            return _BF16
        return np.dtype(str(x.dtype).replace("torch.", ""))
    return np.asarray(x).dtype


# A bf16 window holds the JAX package's two-byte bf16 layout (staging.BF16),
# so a mixed fleet shares its segment; its arithmetic runs on torch bf16
# CPU tensors in the order the JAX package's ml_dtypes arrays take:
#   t * w            -> f32(t) * f32(w), rounded to bf16 by the deposit;
#   the win_update   -> f64(self) * sw + sum f64(f32(slot) * f32(w)),
#   combine             rounded once to bf16 at the end;
#   x / p            -> f32(x) / f32(p), an f32 estimate.
_BF16 = _progress.staging.BF16


def _bf16(a: np.ndarray):
    return _progress.staging.tensor_view(a)


def _scaled(a: np.ndarray, wgt: float) -> np.ndarray:
    """``a * wgt`` as the deposit stores it."""
    if a.dtype == _BF16:
        return _progress.staging.host_view(_bf16(a) * wgt)
    return a * wgt


def _island_pack(name, tensor):
    """The packed buffer for a fused window's tree (a tensor, array or
    snapshot passes through).  A pack of tensors stays on their device
    (``torch.cat``); the caller stages it."""
    meta = _ctx().win_fusion.get(name)
    if meta is None:
        return tensor
    if isinstance(tensor, _progress.staging.DeviceSnapshot):
        leaves, treedef = [tensor], None
    else:
        leaves, treedef = _flatten(tensor)
    if treedef is None or treedef.is_leaf():
        # already-packed buffer (internal callers like push_sum_round work
        # on the packed buffer) — accept iff it has the packed length
        shape = tuple(tensor.shape) if hasattr(tensor, "shape") else np.shape(tensor)
        if shape == (sum(meta.sizes),):
            return tensor
        raise ValueError(
            f"window '{name}' is a fused pytree window; pass the tree "
            f"(or its packed [{sum(meta.sizes)}] buffer), got shape {shape}"
        )
    if treedef != meta.treedef:
        raise ValueError(
            f"pytree structure does not match window '{name}': {treedef} "
            f"vs {meta.treedef}"
        )
    bad = [(tuple(l.shape), tuple(exp)) for l, exp in zip(leaves, meta.shapes)
           if tuple(l.shape) != tuple(exp)]
    if bad:
        # same-size-different-shape leaves would pack without error and
        # unpack as silently corrupted data
        raise ValueError(
            f"leaf shapes do not match window '{name}': {bad[:4]}"
        )
    return _pack_leaves(leaves, name)


def _island_unpack(name, packed):
    """The window's result in the caller's kind: the tree of a fused
    window, else one tensor or array (torch on the window's device when it
    was created from a tensor)."""
    ctx = _ctx()
    out = _from_host(packed, ctx.win_device.get(name))
    meta = ctx.win_fusion.get(name)
    if meta is None:
        return out
    parts, off = [], 0
    for s, sz in zip(meta.shapes, meta.sizes):
        parts.append(out[off:off + sz].reshape(s))
        off += sz
    return _pytree.tree_unflatten(parts, meta.treedef)


def _device_of(tensor):
    """The torch device of a tensor or a tree of tensors; None for numpy."""
    leaves, _ = _flatten(tensor)
    for l in leaves:
        if _is_tensor(l):
            return l.device
    return None


def win_create(tensor, name: str, zero_init: bool = False) -> bool:
    """Collectively create a named window from THIS rank's tensor
    (reference ``bf.win_create`` [U]; collective like MPI_Win_create)."""
    ctx = _ctx()
    if name in ctx.windows:
        # already exists — e.g. this process JOINED and the window came
        # with the epoch record: adopt the caller's fusion meta so a
        # pytree window still unpacks correctly after the replayed call
        meta, _ = _island_fusion_split(tensor)
        if meta is not None and name not in ctx.win_fusion:
            ctx.win_fusion[name] = meta
        ctx.win_device.setdefault(name, _device_of(tensor))
        return False
    device = _device_of(tensor)
    meta, tensor = _island_fusion_split(tensor)
    t = _to_host(tensor, name)
    ctx.windows[name] = _IslandWindow(name, t, ctx, zero_init)
    ctx.created_names.add(name)
    ctx.win_device[name] = device
    if meta is not None:
        ctx.win_fusion[name] = meta
    _note_op("win_create", name)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window (all when ``name`` is None).  COLLECTIVE, like
    MPI_Win_free [U]: every rank must call it with the same name(s).  The
    segment is unlinked (rank 0, between two barriers) so a later
    ``win_create`` under the same name starts from a fresh segment instead
    of attaching to stale slots."""
    ctx = _ctx()
    names = [name] if name is not None else sorted(ctx.windows)
    ok = True
    reg = _telemetry.get_registry()
    if ctx.lab_probes:
        # flush + journal the convergence probe's batched tail before
        # the window goes away
        for n in names:
            pr = ctx.lab_probes.get(n)
            if pr is not None:
                pr.flush_pending()
                _drain_conv_journal(ctx, n, pr)
    eng = ctx.progress
    if eng is not None:
        # flush queued async ops into the still-live segments, then park
        # the worker: its idle prefetch must not touch a window whose
        # mapping the loop below is about to close
        for n in names:
            eng.drain(window=n, timeout=60.0)
        eng.quiesce()
        for n in names:
            eng.windows_seen.discard(n)
    try:
        ok = _win_free_inner(ctx, names, reg)
    finally:
        if eng is not None:
            eng.resume()
    return ok


def _win_free_inner(ctx: "_IslandContext", names, reg) -> bool:
    ok = True
    for n in names:
        w = ctx.windows.pop(n, None)
        if w is None:
            ok = False
            continue
        if reg.enabled:
            # ledger: account mass left in the slots as "pending" — but
            # only after every rank has entered this collective free (a
            # slower peer may still be mid-deposit), so barrier first.
            # BFTPU_TELEMETRY must be uniform across ranks (the launcher
            # forwards it), keeping the barrier schedule identical.
            ctx.shm_job.barrier()
            _ledger_probe_pending(reg, w, ctx.rank)
        w.shm.close(unlink=False)
        ctx.shm_job.barrier()  # all mappings closed
        # transport-aware designated unlink (plain shm: global rank 0;
        # hierarchical: each host group's segment-rank-0; tcp: no-op)
        w.shm.unlink_segments()
        ctx.shm_job.barrier()  # name gone everywhere before any re-create
        ctx.created_names.discard(n)
        ctx.win_fusion.pop(n, None)
        ctx.win_device.pop(n, None)
        _progress.staging.release(n)
        _note_op("win_free", n)
    return ok


def win_put(tensor, name: str, dst_weights: WeightDict = None) -> bool:
    """One-sided deposit of (optionally per-destination scaled) values into
    my slot at each out-neighbor — completes without receiver participation
    (reference ``bf.win_put`` → MPI_Put [U]).  Also refreshes my exposed
    tensor (upstream the window aliases the tensor's memory)."""
    with timeline_context("island_win_put"):
        ctx = _ctx()
        _orphan_guard(ctx, "win_put")
        win = _win(name)
        reg = _telemetry.get_registry()
        tr = _tracing.get_tracer()
        ttok = tr.begin("win_put", window=name) if tr.enabled else None
        emits = [] if ttok is not None else None
        t0 = time.perf_counter_ns() if reg.enabled else 0
        t = _to_host(_island_pack(name, tensor), name).astype(
            win.shm.dtype, copy=False)
        # alias, don't copy: upstream the window aliases the user tensor's
        # memory, and the shm exposure below is already a stable snapshot
        win.self_tensor = t
        targets = _check_dst(win, dst_weights)
        if ctx.dead:
            # degraded step: a rank that died inside a fused combine holds
            # its own slot locks forever — depositing to it would spin
            targets = [d for d in targets if d not in ctx.dead]
        scaled = _scaled_transport(win)
        dual = getattr(win.shm, "put_dual", None) if scaled else None
        exposed = False
        for d in targets:
            wgt = 1.0 if dst_weights is None else float(dst_weights[d])
            if ttok is not None:
                # stamp BEFORE the deposit: the consumer must never see a
                # committed payload without its context word
                op_id = tr.next_op_id()
                win.shm.trace_stamp(
                    d, win.slot_of[d][ctx.rank],
                    _tracing.pack_ctx(tr.round, op_id, ctx.rank))
                emits.append({"dst": d, "op_id": op_id})
            if dual is not None and not exposed:
                # v2 transport: ONE read of t feeds both the exposed slot
                # and the first destination's mailbox, chunk-interleaved
                dual(d, win.slot_of[d][ctx.rank], t, p=win.p_self * wgt,
                     accumulate=False, scale=wgt, expose_p=win.p_self)
                exposed = True
            elif scaled:
                # the scale rides inside the deposit pass — no
                # per-destination ``t * wgt`` temporary
                win.shm.write(d, win.slot_of[d][ctx.rank], t,
                              p=win.p_self * wgt, accumulate=False,
                              scale=wgt)
            else:
                payload = t if wgt == 1.0 else _scaled(t, wgt)
                win.shm.write(d, win.slot_of[d][ctx.rank], payload,
                              p=win.p_self * wgt, accumulate=False)
        if not exposed:
            win.shm.expose(t, win.p_self)
        if reg.enabled:
            for d in targets:
                _edge_deposit(reg, win, "win_put", ctx.rank, d, t.nbytes)
            _op_hist(reg, win, "win_put").observe(
                (time.perf_counter_ns() - t0) / 1e9)
        if ttok is not None:
            tr.end(ttok, emit=emits)
        _note_op("win_put", name)
    return True


def _scaled_transport(win: _IslandWindow) -> bool:
    """Whether the window's transport fuses a scale factor into the deposit
    pass (protocol-v2 shm windows, float payloads only)."""
    return (getattr(win.shm, "supports_scale", False)
            and np.issubdtype(win.shm.dtype, np.floating))


def _note_op(op: str, name: str) -> None:
    """Record an island window op through the single telemetry event path
    (``telemetry.note_op``): bumps the ``win_ops.total`` counter and fans
    out to listeners — ``windows.record_win_ops()`` traces (and the
    verifier's epoch linter) subscribe there, so island-mode programs are
    covered without a parallel bookkeeping path (and without importing
    :mod:`bluefog_tpu_torch.windows` into every island worker)."""
    _telemetry.note_op(op, name)


def _lab_probe_tick(ctx: "_IslandContext", win: "_IslandWindow",
                    name: str) -> None:
    """Feed this round's post-combine tensor to the window's convergence
    probe (:mod:`bluefog_tpu_torch.lab`) and stream the sample into telemetry.
    Off-path: when ``BFTPU_LAB_PROBE`` is unset the per-op cost is one
    attribute load and a falsy branch, same convention as tracing and
    the status page.  The enablement check is lazy (first win_update,
    not context init) so spawn() has already propagated the env.

    The probe batches its math over ``BFTPU_LAB_FLUSH`` rounds (the
    probe module's cost model: the tick runs cache-cold, so per-round
    numpy has a ~40 µs floor the < 2% gate can't afford), so the page's
    ``(conv_err, conv_round)`` pair and the journal trail advance in
    flush-sized bursts — every round's exact value still lands, each
    tagged with its own round index."""
    probes = ctx.lab_probes
    if probes is False:
        return
    if probes is None:
        from bluefog_tpu_torch.lab import probe as _lab_probe

        if not _lab_probe.probe_enabled():
            ctx.lab_probes = False
            return
        probes = ctx.lab_probes = {}
    if name not in probes:
        from bluefog_tpu_torch.lab import probe as _lab_probe

        probes[name] = _lab_probe.ConvergenceProbe(
            flush_every=_lab_probe.flush_every_env())
        probes[name]._journaled = 0  # history entries already journaled
    pr = probes[name]
    err = pr.observe(win.self_tensor,
                     win.p_self if ctx.associated_p else 1.0)
    if pr.last_round > 0:
        ctx.conv_round = pr.last_round
        ctx.conv_err = err if err == err else -1.0  # NaN first round
    _drain_conv_journal(ctx, name, pr)


def _drain_conv_journal(ctx: "_IslandContext", name: str, pr) -> None:
    """Journal the probe's newly computed (round, err) history entries.
    Called from the tick (after a flush lands a burst), from the
    ``win_conv_*`` accessors, and from win_free — so the batched tail
    (up to ``BFTPU_LAB_FLUSH - 1`` rounds) is never lost to the
    journal."""
    hist = pr.history
    done = getattr(pr, "_journaled", 0)
    if done >= len(hist):
        return
    reg = _telemetry.get_registry()
    if reg.enabled:
        for t, e in hist[done:]:
            if e == e:  # the round-1 NaN has no predecessor
                reg.gauge("lab.conv_err", win=name).set(e)
                reg.journal("conv", win=name, round=t, err=e,
                            epoch=ctx.epoch)
    pr._journaled = len(hist)


def _statuspage_tick(ctx: "_IslandContext", name: str,
                     op: str = "win_update") -> None:
    """Republish my live status page (one seqlocked mmap write, no
    locks/syscalls) and poll the trace-control word — the per-op
    heartbeat of the introspection plane (:mod:`bluefog_tpu_torch.introspect`).
    No-op when ``BFTPU_STATUSPAGE=0``."""
    page = ctx.statuspage
    if page is None:
        return
    ctx.op_rounds += 1
    pol = ctx.adaptive
    deadline = (pol.gap_deadline_s() or 0.0) if pol is not None else 0.0
    edges = []
    for l, g in enumerate(ctx.members_global):
        if g == ctx.global_rank:
            continue
        code = (_EDGE_STATE_CODE.get(pol.health.state(g), 0)
                if pol is not None else 0)
        if l in ctx.dead:
            code = 2  # dead set outranks the edge machine's view
        elif g in ctx.demoted:
            code = 3
        edges.append((g, code, deadline))
    reg = _telemetry.get_registry()
    ledger = _ledger_totals(reg) if reg.enabled else None
    eng = ctx.progress
    qdepth, inflight = -1, ""
    if eng is not None:
        st = eng.stats()
        qdepth = int(st["queue_depth"])
        inflight = st["inflight"] or ""
    try:
        page.publish(nranks=len(ctx.members_global), step=ctx.op_rounds,
                     epoch=ctx.epoch, op_id=ctx.op_rounds,
                     last_op=f"{op}:{name}", ledger=ledger, edges=edges,
                     qdepth=qdepth, inflight=inflight,
                     conv_err=ctx.conv_err, conv_round=ctx.conv_round,
                     serve_version=ctx.serve_version,
                     serve_lag=0 if ctx.serve_version >= 0 else -1)
    except (OSError, ValueError):
        pass  # a reaped segment must never fail the op itself
    if ctx.tracectl is not None:
        ctx.tracectl.poll()


# ---------------------------------------------------------------------------
# telemetry helpers: per-edge traffic counters + the mailbox mass ledger.
# Every helper is called behind a ``reg.enabled`` guard, so the disabled
# path costs one attribute load and a falsy branch per op.
# ---------------------------------------------------------------------------


def _tel_table(reg, win: _IslandWindow) -> dict:
    """The window's memoized metric-handle table for ``reg``.  A labeled
    handle lookup (``reg.counter(name, **labels)``) costs ~2µs in label-key
    construction; an op touches several handles, which is visible next to a
    ~ms mailbox deposit.  Handles are stable objects, so the hot paths cache
    them per window, invalidating if telemetry is reset to a new registry."""
    cache = win._tel_cache
    if cache is None or cache[0] is not reg:
        win._tel_cache = cache = (reg, {})
    return cache[1]


def _edge_deposit(reg, win: _IslandWindow, op: str, src: int, dst: int,
                  nbytes: int) -> None:
    """Writer-side accounting for ONE mailbox deposit on edge src->dst."""
    tbl = _tel_table(reg, win)
    h = tbl.get(("e", op, src, dst))
    if h is None:
        h = tbl[("e", op, src, dst)] = (
            reg.counter("win.edge_ops", op=op, src=src, dst=dst),
            reg.counter("win.edge_bytes", op=op, src=src, dst=dst),
            reg.counter(_telemetry.LEDGER_DEPOSITS),
        )
    h[0].inc()
    h[1].add(int(nbytes))
    h[2].inc()
    win._deposited_to[dst] = win._deposited_to.get(dst, 0) + 1


def _op_hist(reg, win: _IslandWindow, op: str):
    """Memoized ``win.op_s`` latency histogram handle for ``op``."""
    tbl = _tel_table(reg, win)
    h = tbl.get(("h", op))
    if h is None:
        h = tbl[("h", op)] = reg.histogram("win.op_s", op=op)
    return h


def _ledger_retire(reg, win: _IslandWindow, slot: int, ver: int,
                   what: str) -> None:
    """Retire slot versions up to ``ver`` into ledger counter ``what``.
    Versions are monotone deposit counts, so retirement telescopes: the
    total ever retired equals the last version probed, regardless of how
    individual deposits were classified under concurrent writers."""
    seen = win._ledger_seen.get(slot, 0)
    if ver > seen:
        tbl = _tel_table(reg, win)
        c = tbl.get(("lc", what))
        if c is None:
            c = tbl[("lc", what)] = reg.counter(what)
        c.add(int(ver - seen))
        win._ledger_seen[slot] = int(ver)


def _ledger_retire_probe(reg, win: _IslandWindow, slot: int, src: int,
                         what: str) -> None:
    rv = getattr(win.shm, "read_version", None)
    if rv is None:
        return
    try:
        ver = rv(slot, src=src)
    except Exception:  # noqa: BLE001 - accounting must never break the op
        return
    _ledger_retire(reg, win, slot, int(ver), what)


def _ledger_probe_pending(reg, win: _IslandWindow, rank_: int) -> None:
    """Retire whatever each slot still holds as "pending" (window free /
    job shutdown: mass deposited but never combined)."""
    for s in win.in_neighbors:
        _ledger_retire_probe(reg, win, win.slot_of[rank_][s], s,
                             _telemetry.LEDGER_PENDING)


def win_accumulate(tensor, name: str, dst_weights: WeightDict = None) -> bool:
    """Like win_put but atomically ADDS into the destination slot (reference
    ``bf.win_accumulate`` → MPI_Accumulate [U]).  With associated-p enabled
    the scalar mass rides along, so Σ(x, p) over all slots + exposed tensors
    is invariant — the push-sum conservation law."""
    with timeline_context("island_win_accumulate"):
        ctx = _ctx()
        _orphan_guard(ctx, "win_accumulate")
        win = _win(name)
        reg = _telemetry.get_registry()
        tr = _tracing.get_tracer()
        ttok = tr.begin("win_accumulate", window=name) if tr.enabled else None
        emits = [] if ttok is not None else None
        t0 = time.perf_counter_ns() if reg.enabled else 0
        # a pinned staging buffer of its own: win.self_tensor may alias
        # the put buffer
        t = _to_host(_island_pack(name, tensor), name + "#acc").astype(
            win.shm.dtype, copy=False)
        targets = _check_dst(win, dst_weights)
        if ctx.dead:
            targets = [d for d in targets if d not in ctx.dead]
        scaled = _scaled_transport(win)
        for d in targets:
            wgt = 1.0 if dst_weights is None else float(dst_weights[d])
            if ttok is not None:
                # accumulating deposits overwrite the slot's word: the
                # flow records the LAST contributor (the sidecar word is
                # advisory, not a full contributor list)
                op_id = tr.next_op_id()
                win.shm.trace_stamp(
                    d, win.slot_of[d][ctx.rank],
                    _tracing.pack_ctx(tr.round, op_id, ctx.rank))
                emits.append({"dst": d, "op_id": op_id})
            if scaled:
                win.shm.write(d, win.slot_of[d][ctx.rank], t,
                              p=win.p_self * wgt, accumulate=True,
                              scale=wgt)
            else:
                payload = t if wgt == 1.0 else _scaled(t, wgt)
                win.shm.write(d, win.slot_of[d][ctx.rank], payload,
                              p=win.p_self * wgt, accumulate=True)
        if reg.enabled:
            for d in targets:
                _edge_deposit(reg, win, "win_accumulate", ctx.rank, d, t.nbytes)
            _op_hist(reg, win, "win_accumulate").observe(
                (time.perf_counter_ns() - t0) / 1e9)
        if ttok is not None:
            tr.end(ttok, emit=emits)
        _note_op("win_accumulate", name)
    return True


class _ProgressBackend:
    """Engine→transport adapter (the ``backend`` duck type in
    :mod:`bluefog_tpu_torch.progress.engine`).  Ops re-enter the PUBLIC
    synchronous win ops, so telemetry, tracing, the mass ledger, and the
    degraded-mode dead-rank filtering apply identically on the async
    path; windows are resolved by NAME at execution time, which is what
    makes queued ops survive a membership-epoch rebind."""

    def execute(self, kind, window, payload, weights, kwargs):
        if kind == "put":
            return win_put(payload, window, dst_weights=weights)
        if kind == "accumulate":
            return win_accumulate(payload, window, dst_weights=weights)
        return win_update(window, **kwargs)

    def fuse(self, kind, window, payloads):
        # put deposits overwrite the slot: executing only the LAST of a
        # coalesced run is indistinguishable from executing all of them.
        # accumulate deposits add: the run deposits its (packed) sum
        # once — w·Σtᵢ == Σ(w·tᵢ), and the engine only fuses ops with
        # identical weights.
        if kind == "put":
            return payloads[-1]
        acc = np.array(_to_host(_island_pack(window, payloads[0]),
                                window + "#acc"), copy=True)
        for t in payloads[1:]:
            acc += _to_host(_island_pack(window, t), window + "#acc")
        return acc

    def epoch(self) -> int:
        return _context.epoch if _context is not None else -1

    def prefetch(self, names) -> int:
        """Idle-time mailbox warming: one ``read_version`` word per
        in-edge, and a read-only bracketed copy into a persistent warm
        buffer for slots whose deposit count moved.  No collect, no
        mass movement, no semantic effect — the caller's next combine
        just runs over cache-warm pages."""
        ctx = _context
        if ctx is None:
            return 0
        n = 0
        for name in names:
            win = ctx.windows.get(name)
            if win is None:
                continue
            pairs = [(win.slot_of[ctx.rank][s], s)
                     for s in win.in_neighbors if s not in ctx.dead]
            for slot, src, ver in shm_native.poll_versions(
                    win.shm, pairs, win._warm_ver):
                buf = win._warm.get(slot)
                if (buf is None or buf.shape != win.shm.shape
                        or buf.dtype != win.shm.dtype):
                    buf = win._warm[slot] = np.empty(
                        win.shm.shape, dtype=win.shm.dtype)
                try:
                    win.shm.read(slot, collect=False, src=src, out=buf)
                except TypeError:  # transport without out= support
                    win.shm.read(slot, collect=False, src=src)
                win._warm_ver[slot] = ver
                n += 1
        return n


def progress_engine() -> Optional[_progress.ProgressEngine]:
    """This rank's background progress engine, creating it on first use.
    None when the engine is disabled (``BFTPU_PROGRESS=0``) — the async
    ops then run synchronously at the call site."""
    ctx = _ctx()
    if not _progress.enabled():
        return None
    eng = ctx.progress
    if eng is None or eng.stopped:
        eng = ctx.progress = _progress.ProgressEngine(
            _ProgressBackend(), name=f"{ctx.base_job}:{ctx.global_rank}")
    return eng


def _payload_nbytes(win: _IslandWindow) -> int:
    # deposits must match the window shape, so the fusion-budget estimate
    # never needs to stage the (possibly still-computing) payload
    return int(np.prod(win.shm.shape, dtype=np.int64)
               * np.dtype(win.shm.dtype).itemsize)


def _async_payload(name: str, tensor):
    """What an async op hands the worker: a snapshot taken NOW, on the
    caller's stream.  A fused tree is packed (``torch.cat`` on its device,
    a new tensor); a lone CUDA tensor is cloned on the device; either gets
    an event the worker's copy waits on (progress/staging.py).  A thunk or
    a CPU tensor passes as it is: it must not change until the handle
    resolves."""
    if callable(tensor):
        return tensor
    if name in _ctx().win_fusion and not isinstance(
            tensor, (np.ndarray, _progress.staging.DeviceSnapshot)):
        packed = _island_pack(name, tensor)
        return _progress.staging.snapshot(packed, fresh=_is_tensor(packed))
    return _progress.staging.snapshot(tensor)


def win_put_async(tensor, name: str, dst_weights: WeightDict = None):
    """:func:`win_put` off the critical path: enqueue the deposit on the
    progress engine and return a
    :class:`~bluefog_tpu_torch.progress.handles.WinHandle` immediately — the
    worker thread stages, fuses, and lands it while the caller's next
    train step computes.  A CUDA payload is snapshotted at submit (see
    :func:`_async_payload`), so the caller may update it in place at
    once; a CPU tensor or array must not change until the handle
    resolves.  ``tensor`` may also be a zero-arg callable, materialized
    on the worker."""
    win = _win(name)  # surface unknown-window errors at the call site
    _orphan_guard(_ctx(), "win_put_async")
    eng = progress_engine()
    if eng is None:
        t = tensor() if callable(tensor) else tensor
        return _progress.completed(win_put(t, name, dst_weights))
    return eng.submit("put", name, payload=_async_payload(name, tensor),
                      weights=dst_weights, nbytes=_payload_nbytes(win))


def win_accumulate_async(tensor, name: str,
                         dst_weights: WeightDict = None):
    """:func:`win_accumulate` through the progress engine — see
    :func:`win_put_async`.  Fused runs deposit their sum once; the mass
    ledger balance is unchanged because accumulation is additive."""
    win = _win(name)
    _orphan_guard(_ctx(), "win_accumulate_async")
    eng = progress_engine()
    if eng is None:
        t = tensor() if callable(tensor) else tensor
        return _progress.completed(win_accumulate(t, name, dst_weights))
    return eng.submit("accumulate", name,
                      payload=_async_payload(name, tensor),
                      weights=dst_weights, nbytes=_payload_nbytes(win))


def win_update_async(name: str, self_weight: Optional[float] = None,
                     neighbor_weights: WeightDict = None,
                     reset: bool = False):
    """:func:`win_update` through the progress engine; the handle's
    ``result()`` is the combined tensor (or pytree).  The combine runs
    on the worker in submission order after any queued deposits to the
    same window — the per-window FIFO the verifier family checks.  The
    result is always an independent copy (``clone`` semantics): it must
    stay valid while later queued ops keep mutating the window."""
    _win(name)
    _orphan_guard(_ctx(), "win_update_async")
    eng = progress_engine()
    if eng is None:
        return _progress.completed(win_update(
            name, self_weight=self_weight,
            neighbor_weights=neighbor_weights, reset=reset, clone=True))
    return eng.submit("update", name, self_weight=self_weight,
                      neighbor_weights=neighbor_weights, reset=reset,
                      clone=True)


def win_get(name: str, src_weights: WeightDict = None) -> bool:
    """One-sided pull of in-neighbors' exposed tensors into my mailbox
    slots, optionally receiver-scaled (reference ``bf.win_get`` →
    MPI_Get [U])."""
    with timeline_context("island_win_get"):
        ctx = _ctx()
        _orphan_guard(ctx, "win_get")
        win = _win(name)
        reg = _telemetry.get_registry()
        t0 = time.perf_counter_ns() if reg.enabled else 0
        if src_weights is not None:
            unknown = set(src_weights) - set(win.in_neighbors)
            if unknown:
                raise KeyError(
                    f"src_weights for non-in-neighbor rank(s) {sorted(unknown)}; "
                    f"in-neighbors of rank {ctx.rank} are {win.in_neighbors}"
                )
        sources = win.in_neighbors if src_weights is None else src_weights
        if ctx.dead:
            sources = [s for s in sources if s not in ctx.dead]
        scaled = _scaled_transport(win)
        tr = _tracing.get_tracer()
        ttok = tr.begin("win_get", window=name) if tr.enabled else None
        emits = [] if ttok is not None else None
        for s in sources:
            wgt = 1.0 if src_weights is None else float(src_weights[s])
            a, p, _ = win.shm.read_exposed(s)
            if ttok is not None:
                # the pull deposits into MY slot: this rank is both the
                # emitting and (later, at win_update) the consuming side,
                # so origin is self — the edge s->me is recorded in args
                op_id = tr.next_op_id()
                win.shm.trace_stamp(
                    ctx.rank, win.slot_of[ctx.rank][s],
                    _tracing.pack_ctx(tr.round, op_id, ctx.rank),
                    writer=s)
                emits.append({"dst": ctx.rank, "op_id": op_id, "src": s})
            # writer-of-record is s: deposit and later read must agree on
            # which transport leg holds the slot (hierarchical routing)
            if scaled:
                win.shm.write(ctx.rank, win.slot_of[ctx.rank][s], a,
                              p=p * wgt, accumulate=False, writer=s,
                              scale=wgt)
            else:
                win.shm.write(ctx.rank, win.slot_of[ctx.rank][s],
                              _scaled(a, wgt),
                              p=p * wgt, accumulate=False, writer=s)
            if reg.enabled:
                # the pull deposits into MY slot on edge s->me; this rank
                # performed the write, so this rank counts the deposit
                _edge_deposit(reg, win, "win_get", s, ctx.rank, a.nbytes)
        if reg.enabled:
            _op_hist(reg, win, "win_get").observe(
                (time.perf_counter_ns() - t0) / 1e9)
        if ttok is not None:
            tr.end(ttok, emit=emits)
        _note_op("win_get", name)
    return True


def _adaptive_probe(ctx: "_IslandContext", win: _IslandWindow,
                    nbrs: Sequence[int]) -> Tuple[int, ...]:
    """Probe each in-edge's slot version (a monotone deposit count) and
    feed the edge-health policy: a changed version is a fresh deposit
    (clean observation + a gap sample for the pooled baseline), an
    unchanged one past the edge deadline is a miss.  Returns the local
    ranks whose edges missed — the combine absorbs them for this round.

    One ``read_version`` word per edge per combine; transports without
    the surface opt out (no probe, no misses)."""
    pol = ctx.adaptive
    rv = getattr(win.shm, "read_version", None)
    if rv is None:
        return ()
    now = time.monotonic()
    seen = win._edge_seen
    stale: List[int] = []
    for s in nbrs:
        slot = win.slot_of[ctx.rank][s]
        try:
            ver = int(rv(slot, src=s))
        except Exception:  # noqa: BLE001 - health probing must never break the op
            continue
        prev = seen.get(slot)
        if prev is None or ver != prev[0]:
            if prev is not None:
                # the completed gap is the observation unit: clean only
                # if it made the deadline (a missed gap already counted
                # its one miss mid-gap — prev[2])
                pol.note_fresh(_peer_global(ctx, s), now - prev[1],
                               clean=not prev[2])
            seen[slot] = (ver, now, False)
        else:
            d = pol.gap_deadline_s()
            age = now - prev[1]
            if d is None or age <= d:
                continue
            if not prev[2]:
                # ONE miss per stale gap, never one per poll: a
                # synchronous caller polling at ms cadence would turn a
                # single marginal gap into a full SUSPECT streak, and
                # the convoy behind a straggler (blocked ranks stop
                # depositing too) would demote innocents.  A persistent
                # straggler misses on EVERY gap and still builds the
                # streak; a rank silent forever is the heartbeat
                # detector's jurisdiction — ABSORB keeps the round
                # bounded meanwhile.
                pol.note_stale(_peer_global(ctx, s), age)
                seen[slot] = (prev[0], prev[1], True)
            stale.append(s)
    return tuple(stale)


def _resolve_update_weights(win: _IslandWindow, self_weight, neighbor_weights):
    nbrs = win.in_neighbors
    if neighbor_weights is not None:
        unknown = set(neighbor_weights) - set(nbrs)
        if unknown:
            raise KeyError(
                f"neighbor_weights for non-in-neighbor rank(s) {sorted(unknown)}; "
                f"in-neighbors of rank {_ctx().rank} are {nbrs}"
            )
        nw = {s: float(neighbor_weights.get(s, 0.0)) for s in nbrs}
        sw = (1.0 - sum(nw.values())) if self_weight is None else float(self_weight)
        dead = _ctx().dead
        if dead and not dead.isdisjoint(nw):
            # degraded combine, self-weight renormalization: drop dead
            # neighbors and let self absorb their weight — the row total
            # is unchanged, so a convex row stays convex and push-sum
            # collect rows (all-ones) keep their unit slot weights
            dropped = sum(w for s, w in nw.items() if s in dead)
            nw = {s: w for s, w in nw.items() if s not in dead}
            sw += dropped
            reg = _telemetry.get_registry()
            if reg.enabled and dropped:
                reg.counter("resilience.weight_absorbed").add(dropped)
    else:
        dead = _ctx().dead
        live = [s for s in nbrs if s not in dead] if dead else nbrs
        u = 1.0 / (len(live) + 1)
        nw = {s: u for s in live}
        sw = u if self_weight is None else float(self_weight)
    return sw, nw


def win_update(
    name: str,
    self_weight: Optional[float] = None,
    neighbor_weights: WeightDict = None,
    reset: bool = False,
    clone: bool = False,
):  # -> np.ndarray, or the window's pytree for fused windows
    """Local weighted combine of my exposed tensor with my mailbox slots
    (reference ``bf.win_update`` [U]; default uniform 1/(in_degree+1)).
    ``reset=True`` drains the slots atomically (collect) so in-flight
    deposits are never lost — the accumulate idiom."""
    with timeline_context("island_win_update"):
        ctx = _ctx()
        _orphan_guard(ctx, "win_update")
        win = _win(name)
        reg = _telemetry.get_registry()
        tr = _tracing.get_tracer()
        ttok = tr.begin("win_update", window=name) if tr.enabled else None
        t0 = time.perf_counter_ns() if reg.enabled else 0
        sw, nw = _resolve_update_weights(win, self_weight, neighbor_weights)
        # after healing, dead in-neighbors are absent from nw: their slots
        # were force-drained and must not be combined (or even locked)
        nbrs = [s for s in win.in_neighbors if s in nw]
        win._last_absorbed = ()
        if ctx.adaptive is not None:
            # the corroboration gate follows the tracer's LIVE state (it
            # can flip at runtime via bftpu-top): while tracing, demotion
            # additionally needs critical-path blame — see corroborated()
            ctx.adaptive.set_live_feed(tr.enabled)
        if ctx.adaptive is not None and nbrs:
            # round-local ABSORB on deadline-missed edges: a stale edge
            # is dropped from THIS combine only — its slot keeps its
            # mass (pending; collected once the straggler deposits), and
            # for a convex row the dropped weight moves to self so the
            # row total is unchanged.  Push-sum collect rows (all-ones)
            # are not convex: there the plain drop is the conserving
            # move (doubling the self share would mint mass).
            stale = _adaptive_probe(ctx, win, nbrs)
            if stale:
                convex = abs(sw + sum(nw.values()) - 1.0) <= 1e-6
                dropped = 0.0
                for s in stale:
                    dropped += nw.pop(s)
                if convex:
                    sw += dropped
                nbrs = [s for s in nbrs if s in nw]
                win._last_absorbed = tuple(
                    sorted(_peer_global(ctx, s) for s in stale))
                if tr.enabled:
                    # live critical-path attribution: a deadline-missed
                    # in-edge is by construction the op this round
                    # waited on — the rank-local form of the merged
                    # trace's rounds-lengthened-by-rank
                    for s in stale:
                        ctx.adaptive.note_round_blame(_peer_global(ctx, s))
                if reg.enabled:
                    reg.counter("adaptive.weight_absorbed").add(
                        dropped if convex else float(len(stale)))
        consumes = None
        if ttok is not None:
            # peek BEFORE the combine: collect (reset) may recycle the
            # slot to a new deposit under a racing writer.  An unchanged
            # word means no NEW deposit was consumed on that edge since
            # the last combine — skip it, or every later round would
            # re-draw the same flow arrow.
            consumes = []
            for s in nbrs:
                slot = win.slot_of[ctx.rank][s]
                word = win.shm.trace_peek(slot, src=s)
                if word and word != win._trace_seen.get(slot):
                    win._trace_seen[slot] = word
                    rnd, op_id, origin = _tracing.unpack_ctx(word)
                    consumes.append({"src": s, "origin": origin,
                                     "op_id": op_id, "round": rnd})
        wdt = (win.shm.dtype if np.issubdtype(win.shm.dtype, np.inexact)
               else np.float64)
        fused = (getattr(win.shm, "update_fused", None)
                 if wdt == win.shm.dtype else None)
        if fused is not None:
            # v2 transport: the entire update — self-scale, every weighted
            # neighbor combine, the atomic drain, AND the expose republish
            # — is one native chunked sweep; the per-chunk partial stays
            # cache-resident across sub-passes, so the round does ~one
            # traversal per payload instead of four.
            self_data = np.ascontiguousarray(win.self_tensor, dtype=wdt)
            slots = [win.slot_of[ctx.rank][s] for s in nbrs]
            wts = [nw[s] for s in nbrs]
            view_fn = getattr(win.shm, "exposed_view", None)
            if view_fn is not None:
                # in-place form: the combine's destination IS the exposed
                # payload (reference windows alias tensor memory — bf's
                # win_update writes the buffer neighbors read), so the
                # republish copy disappears entirely.  The returned tensor
                # is a view over an independent mapping of those pages and
                # stays readable after win_free unmaps the window.
                p_acc = fused(
                    slots, wts, self_data, sw, win.p_self, None,
                    collect=reset, expose=2 if ctx.associated_p else 1,
                )
                win.self_tensor = view_fn()
            else:
                if (win._scratch is None or win._scratch.dtype != wdt
                        or win._scratch.shape != win.self_tensor.shape):
                    win._scratch = np.empty(win.self_tensor.shape, dtype=wdt)
                out_buf = win._scratch
                p_acc = fused(
                    slots, wts, self_data, sw, win.p_self, out_buf,
                    collect=reset, expose=2 if ctx.associated_p else 1,
                )
                # the buffer IS the new window tensor; a subsequent
                # win_update reads it back as self_data, which the native
                # sweep handles alias-safely
                win.self_tensor = out_buf
            if ctx.associated_p:
                win.p_self = float(p_acc)
            if reg.enabled:
                if reset:
                    # the fused sweep drained the slots; the post-drain
                    # version probe retires exactly what it collected
                    for s in nbrs:
                        _ledger_retire_probe(
                            reg, win, win.slot_of[ctx.rank][s], s,
                            _telemetry.LEDGER_COLLECTED)
                _op_hist(reg, win, "win_update").observe(
                    (time.perf_counter_ns() - t0) / 1e9)
            if ttok is not None:
                tr.end(ttok, consume=consumes)
                tr.advance_round()
            _note_op("win_update", name)
            _lab_probe_tick(ctx, win, name)
            _statuspage_tick(ctx, name)
            out = win.self_tensor
            out = np.array(out, copy=True) if clone else out
            return _island_unpack(name, out)
        bf16 = win.shm.dtype == _BF16
        if bf16:
            acc = _bf16(win.self_tensor).double() * sw
        else:
            acc = np.multiply(win.self_tensor, sw, dtype=wdt)
        p_acc = sw * win.p_self
        combine = (getattr(win.shm, "combine", None)
                   if wdt == win.shm.dtype else None)
        if combine is not None:
            # v2 shm transport: the weighted combine is fused into ONE
            # native pass per neighbor under the slot lock — the slot
            # payload is never materialized on the Python side, and
            # collect (reset) happens in the same critical section.
            for s in nbrs:
                slot = win.slot_of[ctx.rank][s]
                p, ver = combine(slot, acc, nw[s], collect=reset, src=s)
                if reset and reg.enabled:
                    _ledger_retire(reg, win, slot, int(ver),
                                   _telemetry.LEDGER_COLLECTED)
                p_acc = p_acc + nw[s] * p
        else:
            # preallocated-scratch combine for the other transports: the
            # naive expression ``acc + w * a.astype(wdt)`` allocates three
            # payload-sized temporaries per neighbor (astype ALWAYS
            # copies), which dominates the gossip round on a 1-core host.
            # One fused multiply into a persistent scratch buffer + an
            # in-place add keeps it to two passes with zero allocations
            # after the first call.
            if not bf16 and (win._scratch is None
                             or win._scratch.shape != acc.shape
                             or win._scratch.dtype != acc.dtype):
                win._scratch = np.empty_like(acc)
            scratch = win._scratch
            for s in nbrs:
                slot = win.slot_of[ctx.rank][s]
                a, p, ver = win.shm.read(slot, collect=reset, src=s)
                if reset and reg.enabled:
                    _ledger_retire(reg, win, slot, int(ver),
                                   _telemetry.LEDGER_COLLECTED)
                if bf16:
                    acc += (_bf16(a).float() * nw[s]).double()
                else:
                    np.multiply(a, nw[s], out=scratch, casting="unsafe")
                    np.add(acc, scratch, out=acc)
                p_acc = p_acc + nw[s] * p
        if bf16:
            win.self_tensor = _progress.staging.host_view(
                acc.to(torch.bfloat16))
        else:
            win.self_tensor = acc.astype(win.shm.dtype, copy=False)
        if ctx.associated_p:
            win.p_self = float(p_acc)
        win.shm.expose(win.self_tensor, win.p_self)
        if reg.enabled:
            _op_hist(reg, win, "win_update").observe(
                (time.perf_counter_ns() - t0) / 1e9)
        if ttok is not None:
            tr.end(ttok, consume=consumes)
            tr.advance_round()
        _note_op("win_update", name)
        _lab_probe_tick(ctx, win, name)
        _statuspage_tick(ctx, name)
        out = win.self_tensor
        out = np.array(out, copy=True) if clone else out
        return _island_unpack(name, out)


def win_update_then_collect(name: str, require_mutex: bool = False):
    # -> np.ndarray, or the window's pytree for fused windows
    """Self weight 1, every neighbor slot weight 1, atomic drain — the
    push-sum accumulate-and-drain idiom (reference
    ``bf.win_update_then_collect`` [U]).  ``require_mutex`` is honored with
    the REAL shared-memory mutex (unlike the bulk-synchronous shim)."""
    win = _win(name)
    ones = {s: 1.0 for s in win.in_neighbors if s not in _ctx().dead}
    cm = win_mutex(name, for_self=True) if require_mutex else contextlib.nullcontext()
    with cm:
        return win_update(name, self_weight=1.0, neighbor_weights=ones,
                          reset=True)


def win_absorbed(name: str) -> Tuple[int, ...]:
    """GLOBAL ranks whose edges the most recent :func:`win_update` on
    ``name`` dropped via the round-local ABSORB (deadline-missed
    in-edges).  A synchronous caller waiting for every in-edge to turn
    fresh treats an absorbed edge as handled for the round — that is
    exactly the bound the adaptive deadline buys."""
    return _win(name)._last_absorbed


def win_sync(name: str):
    """My current tensor (or pytree, for fused windows) without combining
    (reference ``bf.win_sync``-style read of the window copy [U])."""
    return _island_unpack(name, _win(name).self_tensor)


@contextlib.contextmanager
def win_mutex(name: str, for_self: bool = False,
              ranks: Optional[Sequence[int]] = None):
    """REAL cross-process mutual exclusion over shared-memory locks
    (reference ``bf.win_mutex`` — MPI lock-based [U]).  Default locks my
    out-neighbors (the ranks whose windows I am about to touch); always
    acquired in ascending rank order to prevent deadlock."""
    del name
    ctx = _ctx()
    targets = set(ranks) if ranks is not None else set(out_neighbor_ranks())
    targets -= ctx.dead  # a dead rank's window needs no exclusion
    if for_self:
        targets.add(ctx.rank)
    ordered = sorted(targets)
    acquired = []
    try:
        for r in ordered:
            _mutex_acquire_deadline(ctx, r)
            acquired.append(r)
        yield
    finally:
        for r in reversed(acquired):
            ctx.shm_job.mutex_release(r)


def _mutex_acquire_deadline(ctx: "_IslandContext", r: int) -> None:
    """Acquire rank ``r``'s job mutex under the op deadline.  A holder
    that died mid-critical-section wedges a plain acquire forever; the
    timed path re-consults the failure detector between attempts and
    heals (which breaks dead holders' mutexes) so the retry succeeds.
    Transports without timed acquire keep the unbounded wait."""

    def on_timeout():
        if ctx.detector.dead_ranks() - ctx.dead:
            heal()

    pol = ctx.adaptive
    t0 = time.monotonic() if pol is not None else 0.0
    try:
        _degraded.with_deadline(
            lambda budget: ctx.shm_job.mutex_acquire(r, timeout=budget),
            f"win_mutex acquire of rank {r}",
            on_timeout=on_timeout)
    except TypeError:
        ctx.shm_job.mutex_acquire(r)
    if pol is not None:
        # the convoy signal: a straggler asleep INSIDE its critical
        # section stalls this acquire long past the healthy-cadence
        # baseline (acquires are never CLEAN evidence — see adaptive.py).
        # Blame the rank that actually HELD the lock during the wait
        # (the transport's holder word) when available; the window
        # owner is the fallback attribution.
        blame = r
        h = getattr(ctx.shm_job, "last_wait_holder", None)
        if h is not None and 0 <= h < ctx.size:
            blame = h
        if blame != ctx.rank and blame not in ctx.dead:
            pol.note_acquire(_peer_global(ctx, blame),
                             time.monotonic() - t0)


def win_associated_p(name: str) -> float:
    return _win(name).p_self


def win_set_exposed(name: str, tensor, associated_p: Optional[float] = None) -> None:
    """Overwrite my exposed tensor (and optionally p) without a put — the
    push-sum debias-and-restart idiom (see windows.win_set_exposed)."""
    win = _win(name)
    t = _to_host(_island_pack(name, tensor), name + "#exposed").astype(
        win.shm.dtype, copy=False)
    if t.shape != win.shm.shape:
        raise ValueError(f"shape {t.shape} != window shape {win.shm.shape}")
    win.self_tensor = t  # alias (reference windows alias the tensor [U])
    if associated_p is not None:
        win.p_self = float(associated_p)
    win.shm.expose(t, win.p_self)


def win_conv_error(name: str) -> Tuple[int, float]:
    """``(round, err)`` from the window's convergence probe
    (:mod:`bluefog_tpu_torch.lab`): the round counter and the latest debiased
    consensus-error sample.  ``(-1, nan)`` when ``BFTPU_LAB_PROBE`` is
    off or no win_update has run yet; ``err`` is NaN on the first
    probed round (a successive difference needs a predecessor)."""
    ctx = _ctx()
    _win(name)  # raise KeyError on unknown windows, like the other accessors
    probes = ctx.lab_probes
    if not probes or name not in probes:
        return (-1, float("nan"))
    pr = probes[name]
    pr.flush_pending()  # reads want the batched stragglers computed
    _drain_conv_journal(ctx, name, pr)
    return (pr.rounds, pr.last_err)


def win_conv_history(name: str) -> List[Tuple[int, float]]:
    """The window's full probe history, ``[(round, err), ...]`` oldest
    first (empty when the probe is off) — what the lab sweep driver
    fits a contraction rate to."""
    ctx = _ctx()
    _win(name)
    probes = ctx.lab_probes
    if not probes or name not in probes:
        return []
    pr = probes[name]
    pr.flush_pending()
    _drain_conv_journal(ctx, name, pr)
    return list(pr.history)


def get_win_version(name: str) -> Dict[int, int]:
    """{in_neighbor: deposit_count} for MY slots (reference
    ``bf.get_win_version`` [U], rank-local view)."""
    ctx = _ctx()
    win = _win(name)
    return {
        s: win.shm.read_version(win.slot_of[ctx.rank][s], src=s)
        for s in win.in_neighbors
    }


def push_sum_round(name: str, dst_weights: WeightDict = None):
    # -> np.ndarray, or the window's pytree for fused windows
    """One mass-conserving asynchronous push-sum round (Kempe et al.; the
    algorithm the reference's ``win_accumulate`` + associated-p machinery
    exists for — ``examples/pytorch_optimization.py`` push-sum loops [U]).

    Splits my (x, p) mass into equal shares over {self} ∪ out-neighbors
    (or per ``dst_weights``, which must sum with the kept share to 1),
    deposits the neighbor shares atomically, keeps my share, then drains my
    mailbox.  Ordering matters: the deposit must read (x, p) BEFORE the kept
    share is written back, else the ride-along p is double-scaled.  Under
    any interleaving Σx and Σp over all ranks' (exposed + slots) are
    invariant, so ``win_sync(name) / win_associated_p(name)`` converges to
    the exact global average with NO synchronization.

    Requires associated-p mode; enables it if off.
    """
    ctx = _ctx()
    if not ctx.associated_p:
        ctx.associated_p = True
    win = _win(name)
    cur = win.self_tensor
    p = win.p_self
    live_out = [d for d in win.out_neighbors if d not in ctx.dead]
    if dst_weights is None:
        share = 1.0 / (len(live_out) + 1)
        dst_weights = {d: share for d in live_out}
        keep = share
    else:
        # shares aimed at dead ranks would be silently skipped by the
        # degraded win_accumulate — keep them instead (mass conservation)
        keep = 1.0 - sum(w for d, w in dst_weights.items()
                         if d not in ctx.dead)
    win_accumulate(cur, name, dst_weights=dst_weights)
    win_set_exposed(name, cur * keep, p * keep)
    return win_update_then_collect(name)


def turn_on_win_ops_with_associated_p() -> None:
    _ctx().associated_p = True


def turn_off_win_ops_with_associated_p() -> None:
    _ctx().associated_p = False


def broadcast(tensor, root: int = 0, name: Optional[str] = None):
    """Collective broadcast via the exposed-tensor region: ``win_create``
    already exposes every rank's tensor (and ends with a barrier), so the
    body is just a one-sided read of root's exposure (reference
    ``bf.broadcast`` [U]; the islands use-case is the consistent-start
    idiom).  All ranks must call it in the same order.  A tensor comes
    back as a tensor on its own device; an array as an array."""
    ctx = _ctx()
    device = _device_of(tensor)
    if name is None:
        n = getattr(ctx, "_bcast_counter", 0)
        ctx._bcast_counter = n + 1
        name = f"_bcast_auto{n}"  # same order on all ranks -> same name
    t = _to_host(tensor, name)
    if not win_create(t, name, zero_init=True):
        raise ValueError(
            f"broadcast window name {name!r} collides with a live window"
        )
    try:
        out, _, _ = _win(name).shm.read_exposed(root)
        # every rank reads BEFORE anyone tears the window down (the TCP
        # store vanishes at close)
        barrier()
    finally:
        win_free(name)
    return _from_host(out, device)


def broadcast_parameters(params, root: int = 0):
    """Broadcast parameters from ``root`` — the consistent initialization
    idiom (reference ``bf.broadcast_parameters`` [U]).  ``params`` is a
    dict of tensors (an ``nn.Module``'s ``state_dict``, say) or any pytree
    of tensors and arrays.  Leaves are packed into ONE flat buffer per
    dtype, groups in ``str(dtype)`` order and leaves in tree order (the
    reference's layout), so the coordination cost is a couple of window
    lifecycles regardless of leaf count.  Returns the same structure with
    every leaf replaced by root's value, each leaf keeping its kind
    (tensor on its device, or array) and dtype."""
    flat, treedef = _flatten(params)
    by_dtype: Dict = {}
    for i, leaf in enumerate(flat):
        by_dtype.setdefault(_np_dtype(leaf), []).append(i)
    for dt, idxs in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        packed = np.concatenate(
            [_to_host(flat[i], f"#bcast#{j}").astype(dt, copy=False).ravel()
             for j, i in enumerate(idxs)]
        )
        got = broadcast(packed, root=root)
        off = 0
        for i in idxs:
            leaf = flat[i]
            shape = tuple(leaf.shape) if _is_tensor(leaf) else np.shape(leaf)
            size = int(np.prod(shape, dtype=np.int64))
            arr = got[off:off + size].reshape(shape)
            if _is_tensor(leaf):
                flat[i] = _from_host(np.array(arr), leaf.device).to(leaf.dtype)
            else:
                flat[i] = arr.astype(np.asarray(leaf).dtype, copy=False)
            off += size
    _progress.staging.release("#bcast")
    return _pytree.tree_unflatten(flat, treedef)


# ---------------------------------------------------------------------------
# asynchronous WinPut optimizer (the reference's flagship async training API)
# ---------------------------------------------------------------------------


class DistributedWinPutOptimizer:
    """Asynchronous decentralized optimizer over island windows — the
    reference's ``bf.DistributedWinPutOptimizer`` [U] with TRUE async
    semantics: after each local update the parameters are deposited into
    out-neighbors' windows (one-sided) and combined with whatever the
    in-neighbors have deposited so far — no barrier, ranks step at their
    own pace.

    Wraps a ``torch.optim.Optimizer`` in the idiom of
    :class:`bluefog_tpu_torch.optim.DistributedWinPutOptimizer`: call
    :meth:`step` after ``backward()``.  The parameters are packed into one
    window per dtype (groups in ``str(dtype)`` order, leaves in parameter
    order: the reference's layout), so a round is two window ops per group.
    ``num_steps_per_communication`` is the local-SGD cadence.  Creating the
    optimizer is collective (it creates the windows).

    ``overlap=True`` runs the host side of each gossip round (device→host
    staging, deposits, combine) on the rank's progress engine while the
    caller computes the next gradients; the combine lands one step later,
    at the start of the next :meth:`step` (AD-PSGD-style staleness — the
    reference's background-thread semantics).  CONTRACT (the torch form of
    the reference's "do not donate" rule): the round is handed a SNAPSHOT
    of the parameters — their ``torch.cat`` pack, a new tensor — so the
    next in-place ``optimizer.step()`` cannot race the staging copy; on
    the card an event recorded after the pack orders the copy behind it.

    Usage (inside an island process)::

        opt = islands.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.1))
        loss.backward()
        opt.step()          # local update, then async gossip
        ...
        opt.finish()        # apply the in-flight combine (overlap)
        opt.settle(rounds)  # barriered gossip rounds (all ranks)
        opt.free()          # collective: release the windows
    """

    def __init__(self, base, window_prefix: str = "island_winput",
                 num_steps_per_communication: int = 1,
                 overlap: bool = False):
        self.base = base
        self.prefix = window_prefix
        self.k = int(num_steps_per_communication)
        self.overlap = bool(overlap)
        self._step_count = 0
        self.params = [p for g in base.param_groups for p in g["params"]]
        # in-flight gossip round: [(put_handle, update_handle)] per group,
        # resolved by the rank's progress engine
        self._pending = None
        by_dtype: Dict = {}
        for i, p in enumerate(self.params):
            by_dtype.setdefault(_np_dtype(p), []).append(i)
        self._groups = []  # [(leaf_indices, np_dtype)]
        for g, (dt, idxs) in enumerate(
            sorted(by_dtype.items(), key=lambda kv: str(kv[0]))
        ):
            if not win_create(self._pack(idxs), f"{self.prefix}.{g}"):
                raise RuntimeError(
                    f"window '{self.prefix}.{g}' already exists — two "
                    "optimizers share window_prefix (pass a distinct "
                    "prefix) or a previous instance was not freed"
                )
            self._groups.append((idxs, dt))

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def _pack(self, idxs):
        """The group's parameters as one flat tensor on their device (a
        new tensor: a snapshot the next in-place update cannot touch)."""
        with torch.no_grad():
            return torch.cat([self.params[i].detach().reshape(-1) for i in idxs])

    def _unpack_into(self, combined, idxs) -> None:
        """Copy a combined window buffer back into the parameters."""
        off = 0
        with torch.no_grad():
            for i in idxs:
                p = self.params[i]
                n = p.numel()
                p.copy_(combined[off:off + n].view_as(p))
                off += n

    def _submit_gossip_round(self):
        """Enqueue one gossip round on the progress engine: the pack is
        made here, on the caller's stream, and handed over as a snapshot;
        with the engine disabled the round runs inline and the handles
        come back already resolved (same one-step-stale apply)."""
        pairs = []
        for g, (idxs, _) in enumerate(self._groups):
            name = f"{self.prefix}.{g}"
            ph = win_put_async(
                _progress.staging.snapshot(self._pack(idxs), fresh=True), name)
            pairs.append((ph, win_update_async(name)))
        return pairs

    def _apply_pending(self) -> None:
        """Wait for the in-flight gossip round (if any) and copy its
        combined values into the parameters — the one-step-stale combine
        of AD-PSGD-style overlap."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        for g, (idxs, _) in enumerate(self._groups):
            put_h, upd_h = pending[g]
            put_h.result()  # surface deposit failures, not just combine's
            self._unpack_into(upd_h.result(), idxs)

    def finish(self) -> None:
        """Drain the overlap pipeline: apply any in-flight combine, then
        release the overlap machinery (``close``).  Call after the
        training loop (before settle/evaluation/checkpoint)."""
        self._apply_pending()
        self.close()

    def close(self) -> None:
        """Release the overlap machinery (idempotent): drain and discard
        any in-flight round so repeated optimizer init/teardown leaks
        neither threads nor queued ops.  The progress engine itself is
        rank-global and stays up for other callers."""
        pending, self._pending = self._pending, None
        for put_h, upd_h in pending or ():
            for h in (put_h, upd_h):
                try:
                    h.result(timeout=60.0)
                except Exception:  # noqa: BLE001 - draining, not applying
                    pass

    def step(self) -> None:
        # fail BEFORE the local update: an orphaned rank's step must be
        # retriable as a unit once merge_orphan() re-admits it
        _orphan_guard(_ctx(), "DistributedWinPutOptimizer.step")
        if self.overlap:
            # combine-then-adapt on the freshest gossip: the in-flight
            # round deposited LAST step's params while the caller computed
            # the gradients (at those same params) — apply it first so the
            # local update lands on the combined point
            self._apply_pending()
        self.base.step()
        self._step_count += 1
        reg = _telemetry.get_registry()
        if reg.enabled:
            reg.counter("optim.steps", optimizer="island_winput").inc()
        if self._step_count % self.k != 0:
            return
        if reg.enabled:
            reg.counter("optim.gossip_rounds",
                        optimizer="island_winput").inc()
        if self.overlap:
            self._pending = self._submit_gossip_round()
            return
        for g, (idxs, _) in enumerate(self._groups):
            name = f"{self.prefix}.{g}"
            win_put(self._pack(idxs), name)
            self._unpack_into(win_update(name), idxs)

    def settle(self, rounds: int = 1) -> None:
        """Barriered pure-gossip rounds: deposit, barrier, combine, barrier
        — every combine sees THIS round's deposits from all neighbors, so
        stragglers align deterministically.  Call after the async training
        loop (all ranks, same ``rounds``)."""
        self._apply_pending()  # drain the overlap pipeline
        for _ in range(rounds):
            for g, (idxs, _) in enumerate(self._groups):
                win_put(self._pack(idxs), f"{self.prefix}.{g}")
            barrier()
            for g, (idxs, _) in enumerate(self._groups):
                self._unpack_into(win_update(f"{self.prefix}.{g}"), idxs)
            barrier()

    def free(self) -> None:
        """Collective: release the optimizer's windows (drains the overlap
        pipeline first — a deposit must not race the teardown barrier; a
        failed round must not skip the collective win_free, or siblings
        would block forever in its barrier)."""
        self.close()
        for g in range(len(self._groups or [])):
            win_free(f"{self.prefix}.{g}")


# ---------------------------------------------------------------------------
# process spawner (used by bftpu-run --islands and the tests)
# ---------------------------------------------------------------------------


def _spawn_worker(fn, r, nranks, job, args, q, tolerant=False):
    # spawn() signals SIGUSR1 before it gives up on a rank that never
    # reported: every thread's stack goes to stderr, so a hang shows where
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    try:
        init(r, nranks, job)
        out = fn(r, nranks, *args)
    except Exception as e:  # noqa: BLE001 - report to parent
        import traceback

        tr = _tracing.get_tracer()
        if tr.enabled:
            # flight dump BEFORE reporting: the parent may reap siblings
            # (and us) as soon as the failure lands on the queue
            tr.dump_flight(f"fatal:{type(e).__name__}")
            tr.write_buffer()
        q.put((r, False, f"{e}\n{traceback.format_exc()}"))
        return
    # report BEFORE the teardown barrier: if a sibling died, the barrier
    # never completes and the parent reaps us after collecting results
    q.put((r, True, out))
    if tolerant:
        # chaos runs: a sibling may have been killed, so the teardown
        # barrier can never complete — bound it and proceed to shutdown
        try:
            barrier(timeout=_degraded.op_deadline_s())
        except TypeError:
            barrier()  # transport without timed barriers
        except TimeoutError:
            pass
    else:
        adaptive_leave()  # the teardown barrier meets no reweight switch
        barrier()
    shutdown(unlink=(r == 0))


def _dump_stacks(procs, reported) -> None:
    """Have each live rank that has not reported print its threads' stacks
    to stderr (``faulthandler`` on SIGUSR1, armed by ``_spawn_worker``)."""
    waiting = [(r, p) for r, p in enumerate(procs) if r not in reported and p.is_alive()]
    for r, p in waiting:
        print(f"island spawn: rank {r} (pid {p.pid}) never reported; its stacks:",
              file=sys.stderr, flush=True)
        with contextlib.suppress(ProcessLookupError):
            os.kill(p.pid, signal.SIGUSR1)
        time.sleep(0.5)  # one rank's dump before the next rank's
    if waiting:
        time.sleep(1.0)  # the dumps are written by the ranks themselves


# distinguishes concurrent spawn() calls from one parent: pid alone is not
# enough (same fn name + nranks would collide on shm job/barrier segments)
_spawn_counter = itertools.count()


def spawn(fn, nranks: int, job: Optional[str] = None, timeout: float = 120.0,
          args: Tuple = (), method: str = "spawn",
          allow_failures: bool = False) -> List:
    """Run ``fn(rank, size, *args)`` in ``nranks`` processes, each
    auto-``init``-ed; returns the per-rank return values in rank order.  The
    miniature in-process ``bfrun``: tests and notebooks use this, production
    uses ``bftpu-run --islands`` (one process per host).

    ``method`` is the multiprocessing start method: the default "spawn" is
    required once the parent has touched CUDA (CUDA cannot be forked; a
    fresh interpreter per island is the semantics anyway); "fork" is
    faster for parents that never touched the card.  The default job name
    starts with ``tspawn`` so this package's segments never collide with
    the reference's ``spawn`` jobs in ``/dev/shm``.  Under "spawn", ``fn`` must be a picklable
    top-level function.  Raises on any child failure.

    ``allow_failures=True`` is the chaos-test mode: ranks that die (or
    never report) yield ``None`` in the result list instead of raising,
    and workers bound their teardown barrier so survivors exit cleanly
    when a sibling was killed.
    """
    import multiprocessing as mp

    job = job or (
        f"tspawn{os.getpid()}_{next(_spawn_counter)}_"
        f"{getattr(fn, '__name__', 'fn')[:32]}"
    )
    mp_ctx = mp.get_context(method)
    q = mp_ctx.Queue()
    procs = [
        mp_ctx.Process(target=_spawn_worker,
                       args=(fn, r, nranks, job, args, q, allow_failures))
        for r in range(nranks)
    ]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    failures = []
    deadline = time.monotonic() + timeout
    while len(results) + len(failures) < nranks:
        try:
            r, ok, out = q.get(timeout=min(
                0.25,
                max(0.05, deadline - time.monotonic())))
        except Exception:
            if time.monotonic() < deadline:
                if allow_failures and not any(p.is_alive() for p in procs):
                    break  # killed ranks never report; everyone has exited
                if not allow_failures:
                    # a child that died before reporting (its interpreter
                    # failed to start, or it was killed) never will
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        failures.extend(f"rank {r}: exited with code {c} before "
                                        "reporting" for r, c in dead)
                        break
                continue
            if not allow_failures:
                failures.append("timeout waiting for island results")
                _dump_stacks(procs, results)
            break
        if ok:
            results[r] = out
        else:
            failures.append(f"rank {r}: {out}")
    if failures or (allow_failures and len(results) < nranks):
        # siblings of a failed rank may be stuck at the teardown barrier
        for p in procs:
            if p.is_alive():
                p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            failures.append("child did not exit")
    # reclaim segments on EVERY path (spawn's children are on this host by
    # definition): rank 0's collective unlink normally already ran, but a
    # child terminated mid-teardown — e.g. under heavy machine load the
    # 10s join expired — must not leave /dev/shm litter behind
    shm_native.unlink_all(job, [])
    if (failures or len(results) < nranks) and _tracing.tracing_dir():
        # post-mortem: SIGKILLed ranks never ran their own dump — convert
        # their mmap flight rings (page cache survives the process) to JSON
        _tracing.convert_flight_rings(job)
    if failures:
        raise RuntimeError("island spawn failed:\n" + "\n".join(failures))
    # under allow_failures, killed ranks never reported: yield None
    return [results.get(r) for r in range(nranks)]
