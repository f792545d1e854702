"""Rule family: the serving plane as a verifier.

The serving fleet (:mod:`bluefog_tpu_torch.serve`) argues three properties
hold under arbitrary publisher/replica death:

1. the committed snapshot **version is strictly monotone** — the
   region header persists it, so a successor publisher continues past
   the highest committed version instead of restarting at 1, and a
   replica hot-swap never flips backward;
2. publication is **quorum-fenced** — ``islands.serve_publish`` runs
   the same strict-majority gate as membership commits, so an ORPHAN
   minority can never publish weights the majority lineage diverged
   from;
3. the double-buffer seqlock makes **torn reads impossible** — a
   reader either observes a whole committed snapshot or retries;
   served bytes always equal SOME committed version.

These rules turn the argument into checks on the sim-campaign plan of
:mod:`.partition_rules` plus one exhaustive interleaving model:

- **version-monotone** — pinned serve campaigns (clean, replica kill
  mid-swap + respawn, publisher kill mid-payload and mid-flip) finish
  with zero violations and non-vacuously: versions in the event log
  strictly increase across the publisher handoff, replicas converge
  to the committed head, the kill paths actually fired;
- **fence-requires-quorum** — the publish gate is pinned against the
  production :func:`~bluefog_tpu_torch.resilience.quorum.quorum_met`
  arithmetic, and a partition campaign that cuts the publisher into
  the minority shows it FENCED (``serve_fenced``), never publishing
  while orphaned, with the majority's successor continuing monotone;
- **torn-read-model** — an exhaustive interleaving model of the
  double-buffer protocol (two publishes racing one reader, every
  atomic-step placement): a completed read only ever returns a
  committed ``(version, payload)`` pair; dropping the seqlocks or the
  reader's re-read bracket produces the torn accepts the fixture
  corpus pins.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

__all__ = [
    "serve_campaign",
    "torn_read_model",
    "selftest_serve_campaigns",
    "SERVE_PINS",
]

#: ``--self-test`` pinned serve campaigns: (ranks, rounds, seed,
#: fault kind or None) — chaos under serving at a modest acceptance
#: size (the np=4 process-level e2e lives in tests/).
SERVE_PINS: Tuple[Tuple[int, int, int, object], ...] = (
    (32, 40, 7, None),
    (32, 40, 7, "serve_kill"),
    (32, 40, 11, "serve_pub_kill"),
)


def serve_campaign(ranks: int, rounds: int, seed: int,
                   schedule=None, **kw):
    """One serve-enabled campaign: publisher analog every 4 rounds,
    two hot-swap replicas, default no rank faults."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    kw.setdefault("quiesce_rounds", max(10, rounds // 2))
    kw.setdefault("serve_every", 4)
    kw.setdefault("serve_replicas", 2)
    cfg = SimConfig(ranks=ranks, rounds=rounds, seed=seed, **kw)
    sched = schedule if schedule is not None else FaultSchedule()
    return cfg, sched, run_campaign(cfg, sched)


def _publish_versions(res) -> List[int]:
    return [dict(e[3])["version"] for e in res.event_log
            if e[1] == "serve_publish"]


def _serve_path_findings(res, label: str,
                         expect_publishes: int = 3) -> List[Finding]:
    """Non-vacuity + monotonicity over the campaign's event log."""
    out: List[Finding] = []
    vers = _publish_versions(res)
    if len(vers) < expect_publishes:
        out.append(Finding(
            "serve.version-monotone", label,
            f"only {len(vers)} snapshot(s) published, expected >= "
            f"{expect_publishes} — the publisher path is not running"))
    if any(b <= a for a, b in zip(vers, vers[1:])):
        out.append(Finding(
            "serve.version-monotone", label,
            f"published versions not strictly increasing: {vers}"))
    sv = res.final.get("serve") or {}
    reps = sv.get("replicas") or {}
    if not reps:
        out.append(Finding(
            "serve.version-monotone", label,
            "no replica state in the campaign result — replicas never "
            "ran"))
    for i, rep in sorted(reps.items()):
        if rep.get("killed"):
            continue  # killed without a respawn round scheduled
        if rep.get("version") != sv.get("published"):
            out.append(Finding(
                "serve.version-monotone", label,
                f"replica {i} quiesced at version {rep.get('version')}"
                f", committed head is {sv.get('published')} — the "
                "hot-swap loop stalled"))
        if not rep.get("steps"):
            out.append(Finding(
                "serve.version-monotone", label,
                f"replica {i} served zero steps"))
    return out


@registry.rule("serve.version-monotone", "serve",
               "pinned serve campaigns — clean, replica killed "
               "mid-swap and respawned, publisher killed mid-payload "
               "and mid-flip — publish strictly increasing versions, "
               "replicas converge to the committed head, and the "
               "standing serve invariants stay silent")
def _run_version_monotone(report: Report) -> None:
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    cases = [
        ("clean", None, ()),
        ("replica-kill",
         FaultSchedule([Fault(kind="serve_kill", step=2, rank=0,
                              stop=16)]),
         ("serve_replica_kill", "serve_replica_join")),
        ("pub-kill-payload",
         FaultSchedule([Fault(kind="serve_pub_kill", step=2, rank=-1,
                              group="payload")]),
         ("serve_pub_kill",)),
        ("pub-kill-flip",
         FaultSchedule([Fault(kind="serve_pub_kill", step=2, rank=-1,
                              group="flip")]),
         ("serve_pub_kill",)),
    ]
    for name, sched, need_events in cases:
        label = f"serve[n=16,seed=3,{name}]"
        report.subjects_checked += 1
        _cfg, _sched, res = serve_campaign(16, 24, 3, schedule=sched)
        report.extend(campaign_findings(res, label))
        report.extend(_serve_path_findings(res, label))
        kinds = {e[1] for e in res.event_log}
        for ev in need_events:
            if ev not in kinds:
                report.add(Finding(
                    "serve.version-monotone", label,
                    f"scheduled fault never fired: no {ev!r} event — "
                    "the chaos path passed vacuously"))
        if name == "pub-kill-payload":
            # mid-payload death must NOT commit: one publish ordinal
            # is swallowed, yet versions stay gap-free and monotone
            # (the torn standby buffer is simply overwritten)
            vers = _publish_versions(res)
            if vers != sorted(set(vers)) or (
                    vers and vers != list(range(1, len(vers) + 1))):
                report.add(Finding(
                    "serve.version-monotone", label,
                    f"versions after a mid-payload publisher death "
                    f"are {vers} — expected a gap-free monotone "
                    "sequence (nothing committed at the torn ordinal)"))
        report.metrics[f"serve.publishes/{label}"] = float(
            len(_publish_versions(res)))


@registry.rule("serve.fence-requires-quorum", "serve",
               "the publish gate matches the production quorum_met "
               "arithmetic, and a partition that cuts the publisher "
               "into the minority fences it (serve_fenced, no publish "
               "while orphaned) while the majority successor "
               "continues strictly monotone")
def _run_fence_requires_quorum(report: Report) -> None:
    from bluefog_tpu_torch.resilience.quorum import majority_floor, quorum_met
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    # the arithmetic pin: serve_publish commits iff quorum_met — a
    # fence that admitted one member below the strict-majority floor
    # would let an orphaned minority publish diverged weights
    report.subjects_checked += 1
    for total in (1, 2, 3, 4, 5, 8, 9, 64):
        floor = majority_floor(total)
        if not quorum_met(floor, total) or quorum_met(floor - 1, total):
            report.add(Finding(
                "serve.fence-requires-quorum", f"total={total}",
                f"quorum_met is not a strict threshold at the floor "
                f"({floor} of {total}) — the publish fence inherits "
                "the defect"))

    # the campaign pin: ranks 0..2 (the publisher among them) cut from
    # a 5-strong majority; serve_every=1 so the denial round publishes
    label = "serve[n=8,seed=3,publisher-orphaned]"
    report.subjects_checked += 1
    sched = FaultSchedule([Fault.partition([(0, 1, 2)], 5, 14)], seed=3)
    _cfg, _sched, res = serve_campaign(
        8, 24, 3, schedule=sched, serve_every=1, serve_replicas=1,
        quiesce_rounds=30)
    report.extend(campaign_findings(res, label))
    fenced = [e for e in res.event_log if e[1] == "serve_fenced"]
    if not fenced:
        report.add(Finding(
            "serve.fence-requires-quorum", label,
            "the orphaned publisher was never fenced (no serve_fenced "
            "event) — the quorum gate did not engage"))
    orphan_t = {e[2]: e[0] for e in res.event_log if e[1] == "orphan"}
    for e in res.event_log:
        if e[1] == "serve_publish" and e[2] in orphan_t \
                and e[0] >= orphan_t[e[2]]:
            report.add(Finding(
                "serve.fence-requires-quorum", label,
                f"rank {e[2]} published at t={e[0]} AFTER entering "
                f"ORPHAN at t={orphan_t[e[2]]} — a minority published "
                "weights the majority lineage diverged from"))
    vers = _publish_versions(res)
    if any(b <= a for a, b in zip(vers, vers[1:])):
        report.add(Finding(
            "serve.fence-requires-quorum", label,
            f"versions not monotone across the publisher handoff: "
            f"{vers}"))
    pubs_by_rank = sorted({e[2] for e in res.event_log
                           if e[1] == "serve_publish"})
    if len(pubs_by_rank) < 2:
        report.add(Finding(
            "serve.fence-requires-quorum", label,
            f"publisher never handed off (publishing ranks: "
            f"{pubs_by_rank}) — the fence path passed vacuously"))


# ---------------------------------------------------------------------------
# the double-buffer torn-read model
# ---------------------------------------------------------------------------

#: canonical payload per version: version v serves (10v, 10v + 1)
_PAYLOAD = {v: (10 * v, 10 * v + 1) for v in (1, 2, 3)}


def _writer_ops(version: int, buf: int, *, buffer_seqlock: bool,
                header_seqlock: bool) -> List:
    """One publish as a list of atomic mutations of the region state
    (mirrors ``SnapshotRegion.publish``: standby buffer under its own
    seqlock, then the header flip under the head seqlock)."""
    w0, w1 = _PAYLOAD[version]
    ops = []
    if buffer_seqlock:
        ops.append(lambda st: st["bufs"][buf].__setitem__(
            "seq", st["bufs"][buf]["seq"] + 1))
    ops.append(lambda st: st["bufs"][buf].__setitem__("w0", w0))
    ops.append(lambda st: st["bufs"][buf].__setitem__("w1", w1))
    ops.append(lambda st: st["bufs"][buf].__setitem__("ver", version))
    if buffer_seqlock:
        ops.append(lambda st: st["bufs"][buf].__setitem__(
            "seq", st["bufs"][buf]["seq"] + 1))
    if header_seqlock:
        ops.append(lambda st: st["head"].__setitem__(
            "seq", st["head"]["seq"] + 1))

    def flip(st):
        st["head"]["active"] = buf
        st["head"]["version"] = version
        st["committed"] = version
    ops.append(flip)
    if header_seqlock:
        ops.append(lambda st: st["head"].__setitem__(
            "seq", st["head"]["seq"] + 1))
    return ops


def torn_read_model(*, buffer_seqlock: bool = True,
                    header_seqlock: bool = True,
                    reader_rechecks: bool = True) -> Dict:
    """Exhaustively interleave one reader attempt against two
    publishes (v2 into the standby buffer, then v3 overwriting v1's
    old buffer — the reuse that makes tearing possible at all).

    Every atomic-step placement of the reader is explored, including
    "writer died here" (all remaining reader steps run against the
    frozen state).  A completed read must return a ``(version,
    payload)`` pair where the version was committed at accept time and
    the payload is that version's canonical bytes.  The knobs produce
    the seeded-bug variants: ``buffer_seqlock=False`` +
    ``header_seqlock=False`` drops the seqlocks, ``reader_rechecks=
    False`` drops the reader's re-read bracket.
    """
    base = {
        "bufs": [{"seq": 0, "ver": 1,
                  "w0": _PAYLOAD[1][0], "w1": _PAYLOAD[1][1]},
                 {"seq": 0, "ver": 0, "w0": 0, "w1": 0}],
        "head": {"seq": 0, "active": 0, "version": 1},
        "committed": 1,
    }
    wops = (_writer_ops(2, 1, buffer_seqlock=buffer_seqlock,
                        header_seqlock=header_seqlock)
            + _writer_ops(3, 0, buffer_seqlock=buffer_seqlock,
                          header_seqlock=header_seqlock))

    def state_at(wpos: int) -> dict:
        import copy

        st = copy.deepcopy(base)
        for op in wops[:wpos]:
            op(st)
        return st

    states = [state_at(k) for k in range(len(wops) + 1)]

    # reader attempt as a PC machine over registers; each step reads
    # the writer-state at its own placement position.  Returns None
    # (retry/abort) or the accepted (version, payload, committed-at).
    def step(pc: int, regs: tuple, wpos: int):
        st = states[wpos]
        h, b = st["head"], st["bufs"]
        if pc == 0:
            if h["seq"] & 1:
                return None
            return (regs + (h["seq"],), 1)            # h1
        if pc == 1:
            return (regs + (h["active"], h["version"]), 2)  # a, hv
        if pc == 2:
            s = b[regs[1]]["seq"]
            if s & 1:
                return None
            return (regs + (s,), 3)                   # b1
        if pc == 3:
            return (regs + (b[regs[1]]["w0"],), 4)    # r0
        if pc == 4:
            return (regs + (b[regs[1]]["w1"],), 5)    # r1
        if pc == 5:
            if b[regs[1]]["ver"] != regs[2]:
                return None
            if not reader_rechecks:
                return (regs, 8)
            return (regs, 6)
        if pc == 6:
            if b[regs[1]]["seq"] != regs[3]:
                return None
            return (regs, 7)
        if pc == 7:
            if h["seq"] != regs[0]:
                return None
            return (regs, 8)
        raise AssertionError(pc)

    findings: List[str] = []
    accepts = 0
    seen = set()
    stack = [(0, (), 0)]
    while stack:
        pc, regs, wpos = stack.pop()
        key = (pc, regs, wpos)
        if key in seen:
            continue
        seen.add(key)
        if pc == 8:
            accepts += 1
            _h1, _a, hv, _b1, r0, r1 = regs[:6]
            committed_now = states[wpos]["committed"]
            want = _PAYLOAD.get(hv)
            if hv > committed_now or (r0, r1) != want:
                if len(findings) < 8:
                    findings.append(
                        f"torn accept at writer step {wpos}: version "
                        f"{hv} payload ({r0}, {r1}) — committed head "
                        f"is {committed_now}, canonical payload "
                        f"{want}")
            continue
        # advance the writer first (or let it die here: the reader
        # step at the same wpos covers the frozen-state case)
        if wpos < len(wops):
            stack.append((pc, regs, wpos + 1))
        nxt = step(pc, regs, wpos)
        if nxt is not None:
            stack.append((nxt[1], nxt[0], wpos))
    if accepts == 0:
        findings.append("the model never completed a read — the "
                        "protocol model is vacuous")
    return {"name": "serve-double-buffer", "accepts": accepts,
            "states": len(seen), "findings": findings}


@registry.rule("serve.torn-read-model", "serve",
               "exhaustive interleavings of one reader against two "
               "publishes (with buffer reuse and writer death at "
               "every step): a completed read only ever returns a "
               "committed version's canonical bytes")
def _run_torn_read_model(report: Report) -> None:
    report.subjects_checked += 1
    res = torn_read_model()
    for msg in res["findings"]:
        report.add(Finding("serve.torn-read-model",
                           "double-buffer[2 publishes]", msg))
    report.metrics["serve.model-states"] = float(res["states"])
    # the knobs must matter: a model that stays clean with the
    # seqlocks dropped is not actually checking the bracket
    broken = torn_read_model(buffer_seqlock=False, header_seqlock=False)
    if not broken["findings"]:
        report.add(Finding(
            "serve.torn-read-model", "double-buffer[no-seqlock]",
            "dropping both seqlocks produced NO torn accept — the "
            "model is not sensitive to the protection it verifies"))


def selftest_serve_campaigns():
    """The ``--self-test`` arm: acceptance-size serve campaigns under
    chaos, clean + non-vacuous + bit-identical on a second run.
    Returns ``(label, result, findings)`` triples."""
    from bluefog_tpu_torch.sim.campaign import run_campaign
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    out = []
    for ranks, rounds, seed, kind in SERVE_PINS:
        if kind == "serve_kill":
            sched = FaultSchedule([Fault(kind="serve_kill", step=3,
                                         rank=1, stop=rounds - 10)],
                                  seed=seed)
        elif kind == "serve_pub_kill":
            sched = FaultSchedule([Fault(kind="serve_pub_kill", step=2,
                                         rank=-1, group="payload")],
                                  seed=seed)
        else:
            sched = FaultSchedule(seed=seed)
        cfg, sched, res = serve_campaign(ranks, rounds, seed,
                                         schedule=sched)
        label = f"serve[n={ranks},seed={seed},{kind or 'clean'}]"
        findings = campaign_findings(res, label)
        findings.extend(_serve_path_findings(res, label))
        again = run_campaign(cfg, sched)
        if again.digest != res.digest:
            findings.append(Finding(
                "serve.version-monotone", label,
                f"same-seed serve campaign diverged: "
                f"{res.digest[:16]} != {again.digest[:16]}"))
        out.append((label, res, findings))
    return out
