"""Rule family 4: seeded-bug fixture corpus.

Every rule family must be shown to FIRE, not just to pass — a verifier
that has never caught anything proves nothing.  Each fixture here is a
deliberately-broken artifact (a mutated plan, a tampered mixing weight,
a gossip program with an injected all-gather, a protocol variant with a
dropped fence, an ill-ordered window trace) paired with the rule set
that must flag it.  ``run_fixture`` returns the findings; the CLI's
``--fixture``/``--self-test`` modes and tests/test_analysis.py both
demand a non-empty result for every name in :data:`FIXTURES`.

Fixtures are built by *mutating real seed artifacts* (``compile_plan``
output, the corpus topologies) rather than hand-writing broken objects,
so a representation change that silently disarms a rule breaks the
fixture too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.core.plan import compile_plan, plan_from_neighbor_lists

from bluefog_tpu_torch.resilience.healing import demote_topology, heal_topology

from bluefog_tpu_torch.analysis import (
    adaptive_rules,
    collective_rules,
    epoch_rules,
    introspect_rules,
    plan_rules,
    progress_rules,
    resilience_rules,
    seqlock_model,
    telemetry_rules,
    trace_rules,
    wire_rules,
)
from bluefog_tpu_torch.analysis.engine import Finding

__all__ = ["FIXTURES", "run_fixture"]


def _seed_plan(size: int = 8):
    topo = tu.ExponentialTwoGraph(size)
    return topo, compile_plan(topo)


# ---------------------------------------------------------------------------
# plan fixtures: mutate a freshly compiled exp2@8 plan
# ---------------------------------------------------------------------------


def _plan_duplicate_destination() -> List[Finding]:
    """Two class edges aimed at the same destination rank — not a
    permutation, so one ppermute cannot realize the class."""
    topo, plan = _seed_plan()
    cls = plan.classes[0]
    (s0, d0), (s1, d1) = cls.perm[0], cls.perm[1]
    bad = dataclasses.replace(cls, perm=((s0, d0), (s1, d0)) + cls.perm[2:])
    mutated = dataclasses.replace(plan, classes=(bad,) + plan.classes[1:])
    return plan_rules.check_classes_are_permutations(mutated, "exp2@8[dup-dst]")


def _plan_dropped_edge() -> List[Finding]:
    """One scheduled edge removed: that neighbor never transfers and the
    class cover no longer matches the topology."""
    topo, plan = _seed_plan()
    cls = plan.classes[0]
    bad = dataclasses.replace(cls, perm=cls.perm[1:])
    mutated = dataclasses.replace(plan, classes=(bad,) + plan.classes[1:])
    return plan_rules.check_edge_cover(mutated, topo, "exp2@8[dropped-edge]")


def _plan_tampered_weights() -> List[Finding]:
    """One receive weight doubled: W rows stop summing to 1."""
    topo, plan = _seed_plan()
    cls = plan.classes[0]
    rw = list(cls.recv_weights)
    idx = next(i for i, w in enumerate(rw) if w != 0.0)
    rw[idx] *= 2.0
    bad = dataclasses.replace(cls, recv_weights=tuple(rw))
    mutated = dataclasses.replace(plan, classes=(bad,) + plan.classes[1:])
    return plan_rules.check_mixing_stochastic(mutated, "exp2@8[tampered-w]")


def _plan_inconsistent_slots() -> List[Finding]:
    """slot_index pointed at the wrong in-neighbor position: allgather
    output placement would scramble."""
    topo, plan = _seed_plan()
    cls = plan.classes[0]
    si = list(cls.slot_index)
    recv = next(r for r in range(plan.size) if cls.recv_mask[r])
    si[recv] = (si[recv] + 1) % max(plan.in_degrees[recv], 1) \
        if plan.in_degrees[recv] > 1 else -1
    bad = dataclasses.replace(cls, slot_index=tuple(si))
    mutated = dataclasses.replace(plan, classes=(bad,) + plan.classes[1:])
    return plan_rules.check_slot_consistency(mutated, "exp2@8[bad-slot]")


def _plan_disconnected() -> List[Finding]:
    """Two disjoint 4-cliques spelled as one 8-rank plan: W is block
    diagonal, the second eigenvalue is 1, the spectral gap is zero."""
    src_ranks = [[s for s in range((r // 4) * 4, (r // 4) * 4 + 4) if s != r]
                 for r in range(8)]
    plan = plan_from_neighbor_lists(8, src_ranks)
    findings, _gap = plan_rules.check_spectral_gap(plan, "two-cliques@8")
    return findings


# ---------------------------------------------------------------------------
# collective fixtures: a real program with an injected violation
# ---------------------------------------------------------------------------


def _injected_all_gather_inventory():
    """A gossip step whose contract is "collective-permute only", run under
    the collective inventory on ``meta`` tensors (shapes only) at the
    reference fixture's sizes: every rank holds f32[4096,4096].  The
    injected bug broadcasts the whole rank-major tensor to every rank (a
    per-rank f32[8,4096,4096], the full 8-way axis, 536.9 MB), keeps its
    own slice, and adds one ring permute."""
    import torch

    from bluefog_tpu_torch.common.collective_inspect import CollectiveInventory

    x = torch.empty((8, 4096, 4096), dtype=torch.float32, device="meta")
    src = torch.empty((8,), dtype=torch.long, device="meta")
    with CollectiveInventory(8) as inv:
        gathered = x.unsqueeze(0).expand((8,) + tuple(x.shape))
        own = gathered[:, 0]
        own + own.index_select(0, src)
    return inv


def _collective_injected_all_gather() -> List[Finding]:
    rules = [
        collective_rules.CollectiveBudget(
            {"collective-permute": 1}, subject="gossip_step[injected-ag]"),
        collective_rules.NoFullAxisAllGather(
            axis_size=8, subject="gossip_step[injected-ag]"),
    ]
    return collective_rules.check_program(_injected_all_gather_inventory(),
                                          rules)


def _collective_replicated_large_buffer() -> List[Finding]:
    rules = [collective_rules.NoReplicatedLargeBuffer(
        max_bytes=64 * 2 ** 20, subject="gossip_step[512MB-gather]")]
    return collective_rules.check_program(_injected_all_gather_inventory(),
                                          rules)


# ---------------------------------------------------------------------------
# resilience fixtures: botched healings + broken drain protocols
# ---------------------------------------------------------------------------


def _healed_dead_not_excised() -> List[Finding]:
    """A healing that declares rank 2 dead but forgot to excise it: the
    survivor set (and hence the plan) still schedules the corpse."""
    healed = heal_topology(tu.ExponentialTwoGraph(8), dead=[3])
    lied = dataclasses.replace(healed, dead=(2,))
    return resilience_rules.check_dead_excised(lied, "exp2@8[corpse-kept]")


def _healed_not_doubly_stochastic() -> List[Finding]:
    """A healed plan whose Metropolis–Hastings re-weighting was skipped
    for one edge (weight doubled): the survivor W stops being
    stochastic, so degraded gossip drifts off the survivor average."""
    healed = heal_topology(tu.ExponentialTwoGraph(8), dead=[3])
    cls = healed.plan.classes[0]
    rw = list(cls.recv_weights)
    idx = next(i for i, w in enumerate(rw) if w != 0.0)
    rw[idx] *= 2.0
    bad = dataclasses.replace(cls, recv_weights=tuple(rw))
    mutated = dataclasses.replace(healed.plan,
                                  classes=(bad,) + healed.plan.classes[1:])
    return plan_rules.check_mixing_stochastic(
        mutated, "exp2@8-dead[3][skipped-mh]", expect_column=True)


def _grown_reuses_dead_rank() -> List[Finding]:
    """A grown membership view that handed a joiner the CORPSE's global
    rank: stale deposits addressed to the dead rank would be consumed by
    the new member — double-counted mass."""
    from bluefog_tpu_torch.resilience.healing import grow_topology

    healed = heal_topology(tu.ExponentialTwoGraph(8), dead=[3])
    G = tu.relabel_nodes(healed.topology,
                         dict(enumerate(healed.to_global)), copy=True)
    grown = grow_topology(G, [8])
    # lie: the view claims rank 8 (a mapped member) is ALSO dead — the
    # reissued-corpse signature check_grown exists to catch
    lied = dataclasses.replace(grown, dead=(8,))
    return resilience_rules.check_grown(
        lied, "exp2@8[joiner-reuses-corpse]").findings


def _grown_not_doubly_stochastic() -> List[Finding]:
    """A grown plan whose Metropolis–Hastings re-weighting skipped one
    spliced-in edge (weight doubled): the grown W stops being doubly
    stochastic, so post-admission gossip drifts off the consensus the
    joiner was onboarded at."""
    from bluefog_tpu_torch.resilience.healing import grow_topology

    grown = grow_topology(tu.ExponentialTwoGraph(8), [8, 9])
    cls = grown.plan.classes[0]
    rw = list(cls.recv_weights)
    idx = next(i for i, w in enumerate(rw) if w != 0.0)
    rw[idx] *= 2.0
    bad = dataclasses.replace(cls, recv_weights=tuple(rw))
    mutated = dataclasses.replace(grown.plan,
                                  classes=(bad,) + grown.plan.classes[1:])
    return plan_rules.check_mixing_stochastic(
        mutated, "exp2@8+join[8,9][skipped-mh]", expect_column=True)


def _epoch_switch_unbalanced_ledger() -> List[Finding]:
    """An epoch_switch journal where one member's switch-point counters
    lost a deposit (retired neither collected, drained, nor pending):
    mass crossed the membership barrier unaccounted."""
    events = resilience_rules._synthetic_epoch_journal()
    ev = next(e for e in events if e["new_epoch"] == 1
              and e["old_epoch"] is not None)
    ev["pending"] -= 2  # two deposits vanish at the cut
    return resilience_rules.check_membership_epochs(
        events, "fixture[unbalanced-switch]")


# ---------------------------------------------------------------------------
# adaptive fixtures: botched demotions + a flapping schedule under the floor
# ---------------------------------------------------------------------------


def _demoted_straggler_excised() -> List[Finding]:
    """A demotion that dropped the straggler from the member set — the
    death-by-another-name bug: its pending slot mass has nowhere to
    drain and every neighbor averages in a vanished rank."""
    demoted = demote_topology(tu.ExponentialTwoGraph(8), [3])
    lied = dataclasses.replace(
        demoted, survivors=tuple(r for r in demoted.survivors if r != 3))
    return adaptive_rules.check_straggler_member(
        lied, "exp2@8-slow[3][straggler-excised]")


def _demoted_degree_cap_violated() -> List[Finding]:
    """A demotion that forgot to cut one of the straggler's edges: the
    straggler keeps two neighbors, so it still sits on a second rank's
    critical path and the convoy persists."""
    demoted = demote_topology(tu.ExponentialTwoGraph(8), [3])
    H = demoted.topology.copy()
    v = demoted.to_local[3]
    extra = next(u for u in H.nodes
                 if u != v and not H.has_edge(v, u))
    H.add_edge(v, extra)
    H.add_edge(extra, v)
    lied = dataclasses.replace(demoted, topology=H)
    return adaptive_rules.check_straggler_capped(
        lied, "exp2@8-slow[3][degree-2]")


def _demoted_not_doubly_stochastic() -> List[Finding]:
    """A demoted plan whose Metropolis–Hastings re-weighting was skipped
    for one edge (weight doubled): the adaptively produced W stops being
    doubly stochastic, so gossip under it drifts off the average."""
    demoted = demote_topology(tu.ExponentialTwoGraph(8), [3])
    cls = demoted.plan.classes[0]
    rw = list(cls.recv_weights)
    idx = next(i for i, w in enumerate(rw) if w != 0.0)
    rw[idx] *= 2.0
    bad = dataclasses.replace(cls, recv_weights=tuple(rw))
    mutated = dataclasses.replace(
        demoted.plan, classes=(bad,) + demoted.plan.classes[1:])
    return plan_rules.check_mixing_stochastic(
        mutated, "exp2@8-slow[3][skipped-mh]", expect_column=True)


def _adaptive_flap_below_floor() -> List[Finding]:
    """A transition log where one peer demotes and promotes 0.2 s apart
    under a 1 s hysteresis floor — the epoch-thrash signature the floor
    exists to forbid."""
    log = [
        {"t": 0.0, "peer": 3, "frm": "alive", "to": "suspect"},
        {"t": 0.2, "peer": 3, "frm": "suspect", "to": "alive"},
        {"t": 1.5, "peer": 3, "frm": "alive", "to": "suspect"},
    ]
    return adaptive_rules.check_hysteresis(
        log, floor_s=1.0, label="fixture[flap-0.2s]")


# ---------------------------------------------------------------------------
# protocol fixtures: broken seqlock/collect/barrier variants + bad traces
# ---------------------------------------------------------------------------


def _model_fixture(model) -> List[Finding]:
    return seqlock_model.check_model(model).findings


# ---------------------------------------------------------------------------
# telemetry fixtures: mutate real in-memory Registry snapshots
# ---------------------------------------------------------------------------


def _telemetry_counter_regression() -> List[Finding]:
    """A snapshot sequence where a counter value goes BACKWARD (the bug a
    raced read-modify-write or an accidental reset would produce)."""
    from bluefog_tpu_torch.telemetry.registry import Registry as TReg

    reg = TReg(out_dir=None, rank=0, job="fixture")
    reg.counter("tcp.round_trips").add(10)
    first = reg.snapshot()
    second = reg.snapshot()
    for c in second["counters"]:
        if c["name"] == "tcp.round_trips":
            c["value"] = 3.0  # regressed
    return telemetry_rules.check_counters_monotone(
        [first, second], label="fixture[regressed-counter]")


def _telemetry_snapshot_bad_schema() -> List[Finding]:
    """A real snapshot with its schema tag clobbered and a histogram
    counts array truncated (missing the overflow bucket)."""
    from bluefog_tpu_torch.telemetry.registry import Registry as TReg

    reg = TReg(out_dir=None, rank=0, job="fixture")
    reg.histogram("win.op_s", op="win_put").observe(1e-4)
    snap = reg.snapshot()
    snap["schema"] = "bftpu-telemetry-snapshot/999"
    snap["histograms"][0]["counts"] = snap["histograms"][0]["counts"][:-1]
    return telemetry_rules.check_snapshot_schema(
        snap, label="fixture[bad-schema]")


def _telemetry_conservation_broken() -> List[Finding]:
    """A 2-rank corpus where one deposit was never retired into any sink
    — the lost-mass signature the ledger identity exists to catch."""
    from bluefog_tpu_torch.telemetry.registry import (
        LEDGER_COLLECTED, LEDGER_DEPOSITS, Registry as TReg)

    snaps = []
    for r in range(2):
        reg = TReg(out_dir=None, rank=r, job="fixture")
        reg.counter(LEDGER_DEPOSITS).add(4)
        reg.counter(LEDGER_COLLECTED).add(3 if r else 4)  # rank 1 lost one
        snaps.append(reg.snapshot())
    return telemetry_rules.check_conservation(
        snaps, label="fixture[lost-deposit]")


def _envlint_undocumented_var() -> List[Finding]:
    """A referenced env knob that appears in no doc — the lint must name
    the var and the files using it."""
    # name assembled at runtime so the env lint's source scan (which
    # reads THIS file) never sees the seeded knob as a real reference
    var = "BFTPU_" + "SEEDED_UNDOCUMENTED_KNOB"
    return telemetry_rules.check_env_documented(
        {var: ["bluefog_tpu_torch/fake.py"]},
        documented=set(), label="fixture[undocumented-var]")


def _trace_fixture_corpus() -> List[dict]:
    """The trace family's healthy synthetic corpus, re-used by mutation
    (same rationale as the plan fixtures: break the REAL shape so a
    schema change that disarms a rule breaks the fixture too)."""
    return trace_rules._synthetic_traces()


def _trace_unbalanced_nesting() -> List[Finding]:
    """A buffer where one span's end crossed another's — the signature
    of a dropped/reused begin token (two timing contexts raced)."""
    t = _trace_fixture_corpus()[0]
    # stretch the first win_put so it ends INSIDE the following
    # win_update: partial overlap, neither nested nor disjoint
    put = next(s for s in t["spans"] if s["name"] == "win_put")
    upd = next(s for s in t["spans"] if s["name"] == "win_update")
    put["t1"] = (upd["t0"] + upd["t1"]) // 2
    return trace_rules.check_span_nesting(
        t, label="fixture[crossed-spans]")


def _trace_dangling_flow() -> List[Finding]:
    """A consume whose flow identity no present buffer ever emitted —
    the corrupted-context-word signature (origin rank IS in the corpus,
    so this must be an error, not a missing-buffer warning)."""
    corpus = _trace_fixture_corpus()
    for s in corpus[1]["spans"]:
        for c in s.get("consume", ()):
            c["op_id"] += 1000  # no such emit anywhere
    return [f for f in trace_rules.check_flow_endpoints(
        corpus, label="fixture[dangling-flow]")
        if f.severity == "error"]


def _trace_clock_skew() -> List[Finding]:
    """A buffer whose applied clock offset is far outside what its own
    estimator state allows: flows complete before their producers by
    much more than the combined error bound."""
    corpus = _trace_fixture_corpus()
    # claim a huge NEGATIVE offset with a tiny rtt: rank 1's spans slide
    # 5 ms earlier while the error bound stays at rtt/2 = 4 µs
    corpus[1]["clock"] = {"offset_s": -5e-3, "err_s": 4e-6,
                          "best_rtt_s": 8e-6, "samples": 3}
    return trace_rules.check_clock_offsets(
        corpus, label="fixture[clock-skew]")


# ---------------------------------------------------------------------------
# introspect fixtures: a real status page / holder board / blame feed,
# each broken the way its failure mode would break it
# ---------------------------------------------------------------------------


def _introspect_torn_page() -> List[Finding]:
    """A REAL published status page decoded, then presented the way a
    reader racing a stuck writer would see it: odd seq, clobbered
    version, and a balance that stopped matching its own totals."""
    import tempfile

    from bluefog_tpu_torch.introspect import statuspage as sp
    from bluefog_tpu_torch.native import shm_native

    with tempfile.TemporaryDirectory(prefix="bftpu_fixture_") as td:
        saved = shm_native._FALLBACK_DIR
        shm_native._FALLBACK_DIR = td
        try:
            page = sp.StatusPage("fixture", 0)
            try:
                page.publish(nranks=2, step=7, epoch=0, op_id=7,
                             last_op="win_update:g",
                             ledger={"deposits": 4.0, "collected": 3.0,
                                     "drained": 1.0, "pending": 0.0},
                             edges=[(1, 0, 0.2)])
                decoded = sp.read_status_page(sp.status_page_path(
                    "fixture", 0))
            finally:
                page.close(unlink=True)
        finally:
            shm_native._FALLBACK_DIR = saved
    decoded["seq"] = 7                  # accepted mid-write
    decoded["version"] = 99             # foreign layout
    decoded["ledger"]["balance"] = 3.5  # 4 - 3 - 1 == 0, not 3.5
    return introspect_rules.check_status_page(decoded, "fixture[torn-page]")


def _introspect_ghost_holder() -> List[Finding]:
    """A real holder board where the holding rank died and the heal path
    never ran mutex_break: the word keeps blaming a ghost."""
    import tempfile

    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.native.shm_native import HolderBoard

    with tempfile.TemporaryDirectory(prefix="bftpu_fixture_") as td:
        saved = shm_native._FALLBACK_DIR
        shm_native._FALLBACK_DIR = td
        try:
            board = HolderBoard("fixture-hb", 4)
            try:
                board.set_holder(1, 3)  # rank 3 acquires, then dies
                snap = board.snapshot()
            finally:
                board.close(unlink=True)
        finally:
            shm_native._FALLBACK_DIR = saved
    return introspect_rules.check_holder_words(
        snap, members={0, 1, 2}, dead={3}, label="fixture[ghost-holder]")


def _introspect_blame_regression() -> List[Finding]:
    """A real AdaptivePolicy blame feed reset mid-run (the bug a raced
    re-init or an epoch switch dropping the dict would produce): the
    snapshot sequence goes backward."""
    from bluefog_tpu_torch.resilience.adaptive import AdaptivePolicy

    pol = AdaptivePolicy()
    pol.note_round_blame(3)
    pol.note_round_blame(3)
    first = dict(pol._cp_blame)
    pol._cp_blame.clear()  # seeded bug: feed reset mid-run
    pol.note_round_blame(3)
    second = dict(pol._cp_blame)
    return introspect_rules.check_blame_monotone(
        [first, second], "fixture[blame-regression]")


# ---------------------------------------------------------------------------
# progress fixtures: a broken engine variant + seeded bad traces
# ---------------------------------------------------------------------------


def _progress_queue_drops_on_quiesce() -> List[Finding]:
    """A quiesce that clears the queue instead of parking it (the
    classic shutdown/epoch-switch confusion): the parked op's handle
    never resolves after resume + drain, and the state-machine check
    on the REAL engine class must notice the loss."""
    from bluefog_tpu_torch.progress import ProgressEngine

    class Droppy(ProgressEngine):
        def quiesce(self, timeout: float = 60.0) -> int:
            with self._cv:
                self._q.clear()
            return super().quiesce(timeout)

    return progress_rules.check_schedule(
        [("put", "w"), "quiesce", "resume", "step"],
        subject="fixture[queue-drops-on-quiesce]", engine_cls=Droppy)


def _progress_handle_double_complete() -> List[Finding]:
    """A worker that resolves the same handle on the requeue path AND
    the success path — the exactly-once lifecycle lint must flag the
    second resolution."""
    return progress_rules.check_handle_events(
        [("h0", "create"), ("h0", "complete"), ("h0", "complete"),
         ("h0", "result")],
        subject="fixture[handle-double-complete]")


def _progress_fusion_reorders() -> List[Finding]:
    """A fuser that coalesced two same-window puts ACROSS an interleaved
    other-window put: the combined deposit stream no longer replays in
    submission order."""
    subs = [(0, "put", "a", None, 8), (1, "put", "b", None, 8),
            (2, "put", "a", None, 8)]
    batches = [("put", "a", (0, 2)), ("put", "b", (1,))]
    return progress_rules.check_batches(
        subs, batches, budget=1 << 20,
        subject="fixture[fusion-reorders]")


def _sim_mass_leak() -> List[Finding]:
    """A full campaign with a seeded 1e-3 multiplicative leak in the
    combine path: the continuous mass audit must flag it (and nothing
    else can — the leak never touches the count ledger)."""
    from bluefog_tpu_torch.analysis import sim_rules
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    cfg = SimConfig(ranks=16, rounds=20, seed=3, quiesce_rounds=10,
                    debug_bugs=("mass_leak",))
    res = run_campaign(cfg)
    return sim_rules.campaign_findings(res, "fixture[sim-mass-leak]")


def _sim_cap_bypass() -> List[Finding]:
    """A campaign whose adaptive step ignores the minority-demotion
    cap, on a hand-written schedule slowing 5 of 8 ranks: with the cap
    bypassed the fleet demotes a majority, which the standing
    invariant must flag (the same schedule without the seeded bug runs
    clean — the cap is what protects it)."""
    from bluefog_tpu_torch.analysis import sim_rules
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    cfg = SimConfig(ranks=8, rounds=40, seed=5, quiesce_rounds=20,
                    faults=("slow",), debug_bugs=("cap_bypass",))
    sched = FaultSchedule(
        [Fault(kind="slow", step=3 + i, rank=i, duration_s=1.0, stop=35)
         for i in range(5)], seed=5)
    res = run_campaign(cfg, sched)
    return sim_rules.campaign_findings(res, "fixture[sim-cap-bypass]")


def _sim_split_brain() -> List[Finding]:
    """A partition campaign with the quorum fence seeded out
    (``split_brain``): both sides of the cut heal the other out and
    commit under diverged membership, which the single-lineage
    standing invariant must flag (the identical campaign WITH the
    fence runs clean — partition_rules pins that side)."""
    from bluefog_tpu_torch.analysis import partition_rules, sim_rules

    _cfg, _sched, res = partition_rules.partition_campaign(
        16, 30, 3, (6, 11), debug_bugs=("split_brain",))
    return sim_rules.campaign_findings(res, "fixture[sim-split-brain]")


def _serve_version_reset() -> List[Finding]:
    """A serve campaign whose publisher handoff forgets the region
    header's persisted version word and restarts at 1
    (``serve_version_reset``): the serve-monotone standing invariant
    must flag it at the publisher."""
    from bluefog_tpu_torch.analysis import serve_rules, sim_rules

    _cfg, _sched, res = serve_rules.serve_campaign(
        16, 24, 3, debug_bugs=("serve_version_reset",))
    return sim_rules.campaign_findings(res,
                                       "fixture[serve-version-reset]")


def _serve_torn_swap() -> List[Finding]:
    """A serve campaign whose replica swap mixes old and new buffer
    bytes instead of flipping one whole generation (``serve_torn``):
    the serve-committed standing invariant must flag bytes that match
    no committed snapshot."""
    from bluefog_tpu_torch.analysis import serve_rules, sim_rules

    _cfg, _sched, res = serve_rules.serve_campaign(
        16, 24, 3, debug_bugs=("serve_torn",))
    return sim_rules.campaign_findings(res, "fixture[serve-torn-swap]")


def _serve_torn_read_model() -> List[Finding]:
    """The double-buffer interleaving model with both seqlocks dropped:
    a reader racing the buffer-reuse publish completes with a torn mix
    of two generations, which the model must surface."""
    from bluefog_tpu_torch.analysis import serve_rules

    res = serve_rules.torn_read_model(buffer_seqlock=False,
                                      header_seqlock=False)
    return [Finding("serve.torn-read-model",
                    "fixture[serve-no-seqlock]", msg)
            for msg in res["findings"]]


# ---------------------------------------------------------------------------
# distrib fixtures: seeded distribution-plane bugs the standing
# invariants (and the delta-completeness audit) must catch
# ---------------------------------------------------------------------------


def _distrib_degree_overflow() -> List[Finding]:
    """A distribution campaign whose tree repair ignores the fan-out
    cap (``distrib_degree_overflow``): a relay death dumps every
    orphan onto the shallowest relay, and the tree-validity standing
    invariant must flag the overloaded node."""
    from bluefog_tpu_torch.analysis import distrib_rules, sim_rules
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    _cfg, _sched, res = distrib_rules.distrib_campaign(
        16, 24, 3, serve_replicas=13, distrib_fanout=3, distrib_slo=0,
        schedule=FaultSchedule([Fault(kind="serve_kill", step=2,
                                      rank=1)]),
        debug_bugs=("distrib_degree_overflow",))
    return sim_rules.campaign_findings(
        res, "fixture[distrib-degree-overflow]")


def _distrib_stalled_subtree() -> List[Finding]:
    """A distribution campaign where a dead relay's children never
    re-parent (``distrib_stall``): the orphaned subtree stops adopting
    versions while the publisher keeps committing, and the
    staleness-SLO standing invariant must flag the growing lag."""
    from bluefog_tpu_torch.analysis import distrib_rules, sim_rules
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    _cfg, _sched, res = distrib_rules.distrib_campaign(
        16, 40, 3, distrib_slo=4,
        schedule=FaultSchedule([Fault(kind="serve_kill", step=2,
                                      rank=0)]),
        debug_bugs=("distrib_stall",))
    return sim_rules.campaign_findings(
        res, "fixture[distrib-stalled-subtree]")


def _distrib_version_regress() -> List[Finding]:
    """A distribution campaign whose publisher handoff restarts the
    version word at 1 (``serve_version_reset`` with the tree armed):
    the serve-monotone standing invariant must flag the regression
    before it propagates down the tree."""
    from bluefog_tpu_torch.analysis import distrib_rules, sim_rules

    _cfg, _sched, res = distrib_rules.distrib_campaign(
        16, 24, 3, debug_bugs=("serve_version_reset",))
    return sim_rules.campaign_findings(
        res, "fixture[distrib-version-regress]")


def _distrib_stale_delta() -> List[Finding]:
    """A feed that silently drops a dirty chunk from its delta: the
    delta-completeness audit (CRC gate bypassed, so the audit itself
    must notice) flags bytes that no longer compose to the full
    canonical snapshot."""
    from bluefog_tpu_torch.analysis import distrib_rules

    return distrib_rules.stale_delta_findings()


# ---------------------------------------------------------------------------
# lab fixtures: mutate the REAL frozen sweep artifact (same rationale as
# the plan fixtures — a schema change that disarms a rule breaks these)
# ---------------------------------------------------------------------------


def _lab_artifact() -> dict:
    import copy

    from bluefog_tpu_torch.lab.recommend import load_artifact

    return copy.deepcopy(load_artifact())


def _lab_corrupted_fit() -> List[Finding]:
    """A scaling law whose exponent was clobbered to claim contraction
    rates GROWING with fleet size — physically impossible for every
    corpus topology (gaps are non-increasing in n) and no longer the
    law the measured cells refit to."""
    from bluefog_tpu_torch.analysis import lab_rules

    art = _lab_artifact()
    topo = sorted(art["fits"])[0]
    art["fits"][topo]["b"] = 0.5  # rates grow ~ n^0.5: impossible
    return lab_rules.check_fit_monotonicity(
        art, f"LAB[{topo}-growing-law]")


def _lab_tampered_rate() -> List[Finding]:
    """A cell's headline rate hand-edited away from what its own stored
    series refits to — the tampered-number signature the raw-data-in-
    artifact design exists to catch."""
    from bluefog_tpu_torch.analysis import lab_rules

    art = _lab_artifact()
    cell = art["cells"][0]
    cell["rate"] = min(1.0, float(cell["rate"]) * 0.5 + 0.25)
    return lab_rules.check_cell_refit(art, "LAB[tampered-rate]")


def _lab_recommendation_contradicts_corpus() -> List[Finding]:
    """A stored recommendation swapped to a topology the measured
    corpus does not pick — recomputing ``lab.recommend`` over the same
    artifact must contradict it (the determinism contract behind
    BFTPU_LAB_AUTO_TOPOLOGY)."""
    from bluefog_tpu_torch.analysis import lab_rules
    from bluefog_tpu_torch.lab.recommend import TOPOLOGIES

    art = _lab_artifact()
    key = sorted(art["recommended"])[0]
    stored = art["recommended"][key]
    stored["topology"] = next(t for t in sorted(TOPOLOGIES)
                              if t != stored["topology"])
    return lab_rules.check_recommendation_consistency(
        art, "LAB[swapped-recommendation]")


def _conformance_out_of_order_commit() -> List[Finding]:
    """A transport that buffers deposits and commits them LIFO: the
    ascending-commit contract breaks and the differential harness must
    shrink the divergence to its minimal repro."""
    from bluefog_tpu_torch.analysis import conformance

    return conformance.mutant_out_of_order_findings()


def _conformance_capability_overclaim() -> List[Finding]:
    """A transport whose CAPS record claims a fused scale (and a future
    device-resident tier) its ``write`` cannot deliver: the capability
    honesty lint must refuse the declaration."""
    from bluefog_tpu_torch.analysis import conformance

    return conformance.mutant_overclaim_findings()


def _conformance_drain_loses_mass() -> List[Finding]:
    """A force-drain that wipes committed mass without crediting any
    ledger bin: the reference mass identity must break."""
    from bluefog_tpu_torch.analysis import conformance

    return conformance.mutant_lossy_drain_findings()


def _conformance_epoch_reseed_skipped() -> List[Finding]:
    """An epoch switch that retires the ledger but carries the old
    epoch's slot state into the new one: the differential against the
    reference re-seed must diverge on the first version observation."""
    from bluefog_tpu_torch.analysis import conformance

    return conformance.mutant_reseed_findings()


def _slo_silent_violation() -> List[Finding]:
    """A traffic campaign whose replica drain only runs every third
    poll (``slo_silent_violation``): requests queue past the latency
    SLO with no fault window to blame, and the request-SLO standing
    invariant must flag the silent stall."""
    from bluefog_tpu_torch.analysis import sim_rules, slo_rules

    _cfg, _sched, res = slo_rules.slo_campaign(
        16, 24, 3, debug_bugs=("slo_silent_violation",))
    return sim_rules.campaign_findings(
        res, "fixture[slo-silent-violation]")


def _omission_biased_loadgen() -> List[Finding]:
    """A traffic campaign whose drain re-anchors each request's send
    time to the drain instant (``loadgen_omission``): queueing delay
    vanishes from the measurement — coordinated omission — and the
    open-loop standing invariant must flag it."""
    from bluefog_tpu_torch.analysis import sim_rules, slo_rules

    _cfg, _sched, res = slo_rules.slo_campaign(
        16, 24, 3, debug_bugs=("loadgen_omission",))
    return sim_rules.campaign_findings(
        res, "fixture[omission-biased-loadgen]")


def _monitor_silent_alert() -> List[Finding]:
    """A monitored mass-leak campaign whose monitor scrapes but never
    feeds its alert engine (``mon_silent``): the leak runs to quiesce
    with no alert fired, and the alert-completeness audit must flag
    the silence."""
    from bluefog_tpu_torch.analysis import monitor_rules

    _cfg, _sched, res = monitor_rules.monitored_campaign(
        16, 20, 3, debug_bugs=("mass_leak", "mon_silent"))
    return monitor_rules.monitor_findings(
        res, "fixture[monitor-silent-alert]",
        expect=("mass_imbalance",))


def _monitor_flapping_alert() -> List[Finding]:
    """A monitored mass-leak campaign whose engine gap-close is set to
    a hundredth of the sample cadence (``mon_flap``): one sustained
    breach opens a fresh window at every sample, and the
    window-coalescing audit must flag the flapping."""
    from bluefog_tpu_torch.analysis import monitor_rules

    _cfg, _sched, res = monitor_rules.monitored_campaign(
        16, 20, 3, debug_bugs=("mass_leak", "mon_flap"))
    return monitor_rules.monitor_findings(
        res, "fixture[monitor-flapping-alert]",
        expect=("mass_imbalance",))


def _monitor_false_alarm() -> List[Finding]:
    """A CLEAN campaign watched by a naive fork detector that alarms
    on ANY membership-view divergence (``mon_naive_fork``): the normal
    kill/heal adoption transient raises a spurious ``epoch_fork``,
    which the false-alarm-free audit must flag."""
    from bluefog_tpu_torch.analysis import monitor_rules

    _cfg, _sched, res = monitor_rules.monitored_campaign(
        16, 20, 3, debug_bugs=("mon_naive_fork",))
    return monitor_rules.monitor_findings(
        res, "fixture[monitor-false-alarm]", expect=())


FIXTURES: Dict[str, Callable[[], List[Finding]]] = {
    # plan family
    "plan-duplicate-destination": _plan_duplicate_destination,
    "plan-dropped-edge": _plan_dropped_edge,
    "plan-tampered-weights": _plan_tampered_weights,
    "plan-inconsistent-slots": _plan_inconsistent_slots,
    "plan-disconnected-zero-gap": _plan_disconnected,
    # collective family (the reference's hlo family)
    "collective-injected-all-gather": _collective_injected_all_gather,
    "collective-replicated-large-buffer": _collective_replicated_large_buffer,
    # protocol family: each drops one ingredient of the real protocol
    "seqlock-skip-odd-phase": lambda: _model_fixture(
        seqlock_model.seqlock_model(1, 2, odd_phase=False)),
    "seqlock-publish-before-payload": lambda: _model_fixture(
        seqlock_model.seqlock_model(1, 2, early_publish=True)),
    "seqlock-no-writer-lock": lambda: _model_fixture(
        seqlock_model.seqlock_model(2, 1, use_lock=False)),
    "collect-split-critical-section": lambda: _model_fixture(
        seqlock_model.collect_model(2, atomic_collect=False)),
    "barrier-release-before-reset": lambda: _model_fixture(
        seqlock_model.barrier_model(2, 2, reset_before_release=False)),
    # protocol v2 (chunk-ring) family: each drops one ingredient of
    # slot_deposit / the drained-marker drain
    "chunk-ring-missing-commit-fence": lambda: _model_fixture(
        seqlock_model.chunk_ring_model(2, 2, commit_fence=False)),
    "chunk-ring-reordered-commit": lambda: _model_fixture(
        seqlock_model.chunk_ring_model(2, 1, words=1,
                                       in_order_commit=False,
                                       frontier_reader=True)),
    "chunk-drained-split-collect": lambda: _model_fixture(
        seqlock_model.drained_collect_model(2, atomic_collect=False)),
    # resilience family: botched healings + broken dead-writer drains
    "healed-dead-rank-not-excised": _healed_dead_not_excised,
    "healed-not-doubly-stochastic": _healed_not_doubly_stochastic,
    "grown-reuses-dead-rank": _grown_reuses_dead_rank,
    "grown-not-doubly-stochastic": _grown_not_doubly_stochastic,
    "epoch-switch-unbalanced-ledger": _epoch_switch_unbalanced_ledger,
    # adaptive family: botched demotions + a sub-floor flapping schedule
    "adaptive-straggler-excised": _demoted_straggler_excised,
    "adaptive-degree-cap-violated": _demoted_degree_cap_violated,
    "adaptive-demoted-not-doubly-stochastic": _demoted_not_doubly_stochastic,
    "adaptive-flap-below-floor": _adaptive_flap_below_floor,
    "dead-writer-lost-mass-drain": lambda: _model_fixture(
        seqlock_model.dead_writer_drain_model(deposits=2,
                                              account_wiped=False)),
    "dead-writer-early-commit": lambda: _model_fixture(
        seqlock_model.dead_writer_drain_model(deposits=2,
                                              commits_after_payload=False)),
    # wire family: the one wire protocol with one ingredient dropped
    "wire-reordered-chunk-stream": lambda: _model_fixture(
        wire_rules.chunk_stream_model(nchunks=3, writer_in_order=False,
                                      enforce_order=False)),
    "wire-credit-window-deadlock": lambda: _model_fixture(
        wire_rules.credit_window_model(nchunks=3, window=1,
                                       ack_per_chunk=False)),
    "wire-residual-dropped-on-demote": lambda: _model_fixture(
        wire_rules.residual_feedback_model(rounds=3, drop_on_demote=True)),
    "wire-commit-at-stream-open": lambda: _model_fixture(
        wire_rules.stream_death_model(nchunks=2,
                                      commits_after_payload=False)),
    "wire-drain-strands-reader": lambda: _model_fixture(
        wire_rules.stream_death_model(nchunks=2, drain_evenizes=False)),
    # telemetry family: broken snapshots, regressed counters, lost mass
    "telemetry-counter-regression": _telemetry_counter_regression,
    "telemetry-snapshot-bad-schema": _telemetry_snapshot_bad_schema,
    "telemetry-conservation-broken": _telemetry_conservation_broken,
    "envlint-undocumented-var": _envlint_undocumented_var,
    # introspect family: torn/foreign page, ghost holder, reset feed
    "introspect-torn-page": _introspect_torn_page,
    "introspect-ghost-holder": _introspect_ghost_holder,
    "introspect-blame-regression": _introspect_blame_regression,
    # sim family: seeded invariant bugs a full campaign must catch
    "sim-mass-leak": _sim_mass_leak,
    "sim-cap-bypass": _sim_cap_bypass,
    "sim-split-brain": _sim_split_brain,
    # serve family: a forgetful publisher handoff, a torn replica
    # swap, and the double-buffer model with its seqlocks dropped
    "serve-version-reset": _serve_version_reset,
    "serve-torn-swap": _serve_torn_swap,
    "serve-torn-read-model": _serve_torn_read_model,
    # slo family: a drain that skips polls (silent SLO hole) and a
    # drain that re-anchors send times (coordinated omission)
    "slo-silent-violation": _slo_silent_violation,
    "omission-biased-loadgen": _omission_biased_loadgen,
    # monitor family: a silent monitor, a flapping monitor, and a
    # false-alarming fork detector
    "monitor-silent-alert": _monitor_silent_alert,
    "monitor-flapping-alert": _monitor_flapping_alert,
    "monitor-false-alarm": _monitor_false_alarm,
    # distrib family: an uncapped tree repair, a stalled orphan
    # subtree, a regressing publisher handoff, a dirty chunk dropped
    # from a delta
    "distrib-degree-overflow": _distrib_degree_overflow,
    "distrib-stalled-subtree": _distrib_stalled_subtree,
    "distrib-version-regress": _distrib_version_regress,
    "distrib-stale-delta": _distrib_stale_delta,
    # lab family: tampered sweep artifacts the observatory must reject
    "lab-corrupted-fit": _lab_corrupted_fit,
    "lab-tampered-rate": _lab_tampered_rate,
    "lab-recommendation-contradicts-corpus":
        _lab_recommendation_contradicts_corpus,
    # trace family: crossed spans, corrupted flow identity, clock skew
    "trace-unbalanced-nesting": _trace_unbalanced_nesting,
    "trace-dangling-flow": _trace_dangling_flow,
    "trace-clock-skew": _trace_clock_skew,
    # progress family: dropped queue, double resolution, reordered fuse
    "progress-queue-drops-on-quiesce": _progress_queue_drops_on_quiesce,
    "progress-handle-double-complete": _progress_handle_double_complete,
    "progress-fusion-reorders": _progress_fusion_reorders,
    # epoch family: ill-ordered window traces
    "epoch-use-after-free": lambda: epoch_rules.check_trace(
        [("win_create", "w"), ("win_put", "w"), ("win_free", "w"),
         ("win_update", "w")], subject="use-after-free"),
    "epoch-get-clobbers-put": lambda: epoch_rules.check_trace(
        [("win_create", "w"), ("win_put", "w"), ("win_get", "w"),
         ("win_update", "w")], subject="get-clobbers-put"),
    # conformance family: transport mutants the differential harness,
    # the mass ledger, and the capability lint must each catch
    "conformance-out-of-order-commit": _conformance_out_of_order_commit,
    "conformance-capability-overclaim": _conformance_capability_overclaim,
    "conformance-drain-loses-mass": _conformance_drain_loses_mass,
    "conformance-epoch-reseed-skipped": _conformance_epoch_reseed_skipped,
}


def run_fixture(name: str) -> List[Finding]:
    """Build and lint one seeded-bug fixture; MUST return >= 1 finding."""
    return FIXTURES[name]()
