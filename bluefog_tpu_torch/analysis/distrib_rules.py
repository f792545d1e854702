"""Rule family: the snapshot distribution plane as a verifier.

The distribution plane (:mod:`bluefog_tpu_torch.serve.distrib`) argues three
properties hold under arbitrary relay death and subscriber churn:

1. the fan-out **tree stays a tree** — connected, acyclic, and
   degree-capped at ``BFTPU_DISTRIB_FANOUT`` — across any sequence of
   relay deaths and greedy re-parents (the publisher is the root of
   last resort, allowed to run hot);
2. **delta application is complete** — the dirty map composed with
   delta-apply reproduces the full canonical snapshot bit for bit, for
   every codec (f32 | bf16 | int8), every lag inside the horizon, and
   degrades to a full resync beyond it; the commit CRC makes an
   incomplete delta un-installable;
3. the distributed **version is monotone under relay death** — a
   re-parented subtree converges back to the committed head without
   ever serving a version it already moved past.

The rules run the REAL code three ways: exhaustive kill/re-parent
sequences against the production tree math
(:mod:`bluefog_tpu_torch.serve.distrib.tree` — the same functions the feed
coordinator calls), the real ``DeltaEncoder``/``ChunkStore`` pair over
seeded update streams, and pinned distribution-tree sim campaigns
(relay kills + a join storm mid-rollout at acceptance size) audited by
the standing invariants after every event.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.sim_rules import campaign_findings

__all__ = [
    "distrib_campaign",
    "stale_delta_findings",
    "selftest_distrib_campaigns",
    "DISTRIB_PINS",
]

#: ``--self-test`` pinned distribution campaigns: (ranks, rounds, seed,
#: scenario).  ``relay-storm`` is the acceptance campaign: >= 64 ranks,
#: two relay kills plus a join storm mid-rollout, every standing
#: invariant (tree-validity, staleness SLO, serve monotone/committed)
#: audited after every event.
DISTRIB_PINS: Tuple[Tuple[int, int, int, str], ...] = (
    (32, 40, 7, "clean"),
    (32, 40, 13, "relay-kill"),
    (64, 40, 11, "relay-storm"),
)


def distrib_campaign(ranks: int, rounds: int, seed: int,
                     schedule=None, **kw):
    """One distribution-tree campaign: publisher analog every 4
    rounds, 8 tree-fed replicas at fanout 4, staleness SLO armed."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign
    from bluefog_tpu_torch.sim.schedule import FaultSchedule

    kw.setdefault("quiesce_rounds", max(10, rounds // 2))
    kw.setdefault("serve_every", 4)
    kw.setdefault("serve_replicas", 8)
    kw.setdefault("distrib_fanout", 4)
    kw.setdefault("distrib_slo", 6)
    cfg = SimConfig(ranks=ranks, rounds=rounds, seed=seed, **kw)
    sched = schedule if schedule is not None else FaultSchedule()
    return cfg, sched, run_campaign(cfg, sched)


def _storm_schedule(rounds: int, seed: int):
    """Two relay kills (the interior relay, then a post-storm parent)
    with one respawn — the mid-rollout chaos the acceptance criteria
    name."""
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    return FaultSchedule([
        # replica 0 is the interior relay of the heap placement
        # (feeds 4..7); step here is the swap ordinal, ~serve_every
        # rounds apiece, so ordinal 2 lands mid-rollout
        Fault(kind="serve_kill", step=2, rank=0, stop=rounds - 10),
        # replica 1 picks up join-storm leaves, then dies under them
        Fault(kind="serve_kill", step=4, rank=1),
    ], seed=seed)


def _depth_bound(replicas: int, fanout: int) -> int:
    """The acceptance depth bound: ``floor(log_fanout R) + 1`` (+1 of
    slack under churn — greedy repair is near- but not exactly
    optimal)."""
    return int(math.floor(math.log(max(2, replicas), max(2, fanout)))) + 2


def _distrib_path_findings(res, label: str,
                           expect_reparents: int = 0,
                           expect_joins: int = 0) -> List[Finding]:
    """Non-vacuity + convergence + final-tree audit over a campaign."""
    from bluefog_tpu_torch.serve.distrib import tree as _tree

    out: List[Finding] = []
    sv = res.final.get("serve") or {}
    dv = sv.get("distrib") or {}
    if not dv:
        out.append(Finding(
            "distrib.version-monotone", label,
            "no distribution-tree state in the campaign result — the "
            "tree model never armed"))
        return out
    parents, fanout = dv["parents"], dv["fanout"]
    err = _tree.tree_valid(parents, fanout)
    if err:
        out.append(Finding(
            "distrib.tree-validity", label,
            f"final parent map is not a valid tree: {err}"))
    bound = _depth_bound(len(parents), fanout)
    if dv["depth"] > bound:
        out.append(Finding(
            "distrib.tree-validity", label,
            f"final tree depth {dv['depth']} exceeds the "
            f"log_{fanout}(R)+1 bound ({bound}) for {len(parents)} "
            "replicas — repair is not keeping the tree shallow"))
    if dv["reparents"] < expect_reparents:
        out.append(Finding(
            "distrib.version-monotone", label,
            f"only {dv['reparents']} re-parent(s), expected >= "
            f"{expect_reparents} — the relay-death path passed "
            "vacuously"))
    joins = len([e for e in res.event_log if e[1] == "distrib_join"])
    if joins < expect_joins:
        out.append(Finding(
            "distrib.version-monotone", label,
            f"only {joins} distrib_join event(s), expected >= "
            f"{expect_joins} — the join storm never landed"))
    for i, rep in sorted((sv.get("replicas") or {}).items()):
        if rep.get("killed"):
            continue
        if rep.get("version") != sv.get("published"):
            out.append(Finding(
                "distrib.version-monotone", label,
                f"replica {i} quiesced at version {rep.get('version')}"
                f", committed head is {sv.get('published')} — its feed "
                "path never converged"))
    return out


# ---------------------------------------------------------------------------
# rule 1: tree validity under exhaustive kill/re-parent sequences
# ---------------------------------------------------------------------------


@registry.rule("distrib.tree-validity", "distrib",
               "exhaustive kill/re-parent sequences over the "
               "production tree math (every 1- and 2-node death order "
               "at several sizes): the repaired map stays connected, "
               "acyclic, and degree-capped, at logarithmic depth — "
               "and dropping the degree cap is caught")
def _run_tree_validity(report: Report) -> None:
    from bluefog_tpu_torch.serve.distrib import tree as _tree

    # canonical placement: valid, capped, logarithmic at every size
    report.subjects_checked += 1
    for fanout in (2, 3, 4):
        for n in (1, 2, 5, 16, 33, 64):
            parents = {k: _tree.parent_of(k, fanout) for k in range(n)}
            err = _tree.tree_valid(parents, fanout,
                                   root_cap=fanout)
            if err:
                report.add(Finding(
                    "distrib.tree-validity", f"heap[n={n},f={fanout}]",
                    f"canonical placement invalid: {err}"))
            depth = _tree.tree_depth(parents)
            bound = _depth_bound(n, fanout) - 1  # no churn: exact bound
            if depth > bound:
                report.add(Finding(
                    "distrib.tree-validity", f"heap[n={n},f={fanout}]",
                    f"canonical depth {depth} > log_{fanout}({n})+1 "
                    f"= {bound}"))

    # exhaust every ordered death pair (and every single death) at
    # n=13/f=3 and n=9/f=2; after each reassign the map must still be
    # a valid tree and every survivor must keep a path to the publisher
    for n, fanout in ((13, 3), (9, 2)):
        report.subjects_checked += 1
        base = {k: _tree.parent_of(k, fanout) for k in range(n)}
        checked = 0
        for seq in itertools.chain(
                ((k,) for k in range(n)),
                itertools.permutations(range(n), 2)):
            parents = dict(base)
            for dead in seq:
                if dead not in parents:
                    continue  # died as a leaf of an earlier death
                parents = _tree.reassign(parents, dead, fanout)
                err = _tree.tree_valid(parents, fanout)
                checked += 1
                if err:
                    report.add(Finding(
                        "distrib.tree-validity",
                        f"kill-seq[n={n},f={fanout},seq={seq}]",
                        f"after killing {dead}: {err}"))
                    break
        report.metrics[f"distrib.kill-states/n={n}"] = float(checked)

    # sensitivity: the degree_cap=False knob (the seeded bug) must
    # produce an overload the validator catches, or the cap check is
    # vacuous
    report.subjects_checked += 1
    base = {k: _tree.parent_of(k, 3) for k in range(13)}
    broken = _tree.reassign(base, 1, 3, degree_cap=False)
    if _tree.tree_valid(broken, 3) is None:
        report.add(Finding(
            "distrib.tree-validity", "kill-seq[no-degree-cap]",
            "re-parenting with the degree cap dropped produced a tree "
            "the validator accepts — the fan-out bound is not actually "
            "checked"))


# ---------------------------------------------------------------------------
# rule 2: delta completeness (dirty map ∘ delta-apply ≡ full snapshot)
# ---------------------------------------------------------------------------


class _ChunkDroppingStore:
    """The seeded-bug wrapper: a feed whose delta silently drops one
    dirty chunk (the bug the commit CRC exists to catch)."""

    def __init__(self, store):
        self._store = store

    def delta_since(self, have: int, horizon: Optional[int] = None):
        full, items, meta = self._store.delta_since(have, horizon)
        if not full and len(items) > 1:
            items = items[1:]
        return full, items, meta


def _env_patched(**kv):
    """Context manager: patch env keys, restore on exit."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        saved = {k: os.environ.get(k) for k in kv}
        try:
            for k, v in kv.items():
                os.environ[k] = str(v)
            yield
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
    return cm()


def _update_stream(rng: np.random.RandomState, shape, versions: int,
                   nchunks: int, per: int):
    """Seeded sparse update stream: each version dirties a small
    random subset of chunks (the steady-state a delta plane exists
    for)."""
    arrs = []
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(versions):
        dirty = rng.choice(nchunks, size=max(1, nchunks // 4),
                           replace=False)
        x = x.copy()
        flat = x.reshape(-1)
        for i in dirty:
            seg = flat[i * per:(i + 1) * per]
            seg += rng.standard_normal(seg.shape).astype(
                np.float32) * 0.01
        arrs.append(x)
    return arrs


def _dropped_chunk_stream():
    """Publisher + lag-2 subscriber with a chunk-dropping feed between
    them: v2 dirties chunks {0,1}, v3 dirties {2,3}, the feed drops
    one of the four dirty chunks from the delta."""
    from bluefog_tpu_torch.serve.distrib.delta import ChunkStore, DeltaEncoder

    per = 1024 // 4  # 1 KiB chunks of f32
    nchunks = 6
    enc = DeltaEncoder()
    sub = ChunkStore()
    x = np.arange(nchunks * per, dtype=np.float32)
    enc.publish(1, 0, 1, x)
    full, items, meta = enc.store.delta_since(0)
    sub.install(meta, dict(items), full=full)
    for v, dirty in ((2, (0, 1)), (3, (2, 3))):
        x = x.copy()
        for i in dirty:
            x[i * per:(i + 1) * per] += float(v)
        enc.publish(v, 0, v, x)
    bad = _ChunkDroppingStore(enc.store)
    return enc, sub, bad


def stale_delta_findings() -> List[Finding]:
    """The seeded-bug probe (shared with the fixture corpus): a feed
    that silently drops a dirty chunk from its delta.  The
    completeness audit applies the delta with the runtime CRC gate
    bypassed, so the audit itself must notice the divergent bytes —
    dirty-map ∘ delta-apply no longer equals the full snapshot."""
    out: List[Finding] = []
    with _env_patched(BFTPU_WIRE_DTYPE="bf16", BFTPU_DISTRIB_CHUNK_KB=1):
        enc, sub, bad = _dropped_chunk_stream()
        full, items, meta = bad.delta_since(sub.version)
        got = sub.install(meta, dict(items), full=full, verify=False)
        _, want = enc.store.decode()
        if not np.array_equal(got, want):
            out.append(Finding(
                "distrib.delta-completeness", "fixture[dropped-chunk]",
                f"a delta missing a dirty chunk installed bytes "
                f"differing from the canonical v{meta.version} "
                "snapshot — the dirty map and the applied delta do "
                "not compose to the full snapshot"))
    return out


@registry.rule("distrib.delta-completeness", "distrib",
               "dirty-map deltas composed over seeded update streams "
               "reproduce the full canonical snapshot bit for bit at "
               "every codec (f32/bf16/int8) and every lag; beyond the "
               "horizon the feed degrades to a full resync; a delta "
               "missing a dirty chunk is un-installable (commit CRC)")
def _run_delta_completeness(report: Report) -> None:
    from bluefog_tpu_torch.serve.distrib.delta import ChunkStore, DeltaEncoder

    horizon = 4
    nchunks = 6
    per = 1024 // 4
    for wire in ("f32", "bf16", "int8"):
        report.subjects_checked += 1
        label = f"delta[{wire},chunks={nchunks}]"
        with _env_patched(BFTPU_WIRE_DTYPE=wire,
                          BFTPU_DISTRIB_CHUNK_KB=1):
            rng = np.random.RandomState(11)
            enc = DeltaEncoder()
            arrs = _update_stream(rng, (nchunks * per,), 10, nchunks,
                                  per)
            # subscribers at lag 1 / lag 3 / past-horizon, all
            # applying deltas (or resyncs) against their own stores
            subs = {1: ChunkStore(), 3: ChunkStore(), 99: ChunkStore()}
            delta_chunks = 0
            fulls = {k: 0 for k in subs}
            for v, arr in enumerate(arrs, start=1):
                enc.publish(v, 0, v, arr)
                for lag, sub in subs.items():
                    if lag == 99:
                        # installs v1, then sleeps far past the
                        # horizon and wakes at the head
                        if v not in (1, len(arrs)):
                            continue
                    elif v % lag:
                        continue  # this subscriber polls every `lag`
                    full, items, meta = enc.store.delta_since(
                        sub.version, horizon)
                    fulls[lag] += bool(full)
                    if not full:
                        delta_chunks += len(items)
                    got = sub.install(meta, dict(items), full=full)
                    _, want = enc.store.decode()
                    if not np.array_equal(got, want):
                        report.add(Finding(
                            "distrib.delta-completeness", label,
                            f"subscriber at lag {lag} applied "
                            f"{'a full resync' if full else 'a delta'}"
                            f" to v{v} and holds bytes differing from "
                            "the canonical snapshot"))
            if fulls[99] != 2:
                report.add(Finding(
                    "distrib.delta-completeness", label,
                    f"a subscriber {len(arrs) - 1} versions behind "
                    f"took {fulls[99]} full resync(s), expected "
                    "exactly 2 (the bootstrap plus one past-horizon "
                    "degrade) — the horizon path is broken"))
            if fulls[1] > 1 or delta_chunks == 0:
                report.add(Finding(
                    "distrib.delta-completeness", label,
                    f"steady-state subscribers took {fulls[1]} extra "
                    f"full resync(s) and {delta_chunks} delta chunks "
                    "— the dirty map is not producing deltas"))

    # the exhaustive window: EVERY pair of dirty subsets over a
    # 3-chunk buffer (two publishes after the seed generation); the
    # lag-1 delta must reproduce the full snapshot in all 49 cases
    report.subjects_checked += 1
    with _env_patched(BFTPU_WIRE_DTYPE="f32", BFTPU_DISTRIB_CHUNK_KB=1):
        n3, cases = 3, 0
        for s1 in _subsets(n3):
            for s2 in _subsets(n3):
                enc = DeltaEncoder()
                sub = ChunkStore()
                base = np.arange(n3 * per, dtype=np.float32)
                enc.publish(1, 0, 1, base)
                full, items, meta = enc.store.delta_since(0)
                sub.install(meta, dict(items), full=full)
                x = base
                for v, dirty in ((2, s1), (3, s2)):
                    x = x.copy()
                    for i in dirty:
                        x[i * per:(i + 1) * per] += float(v)
                    enc.publish(v, 0, v, x)
                    full, items, meta = enc.store.delta_since(
                        sub.version, horizon)
                    got = sub.install(meta, dict(items), full=full)
                    if full or not np.array_equal(got, x):
                        report.add(Finding(
                            "distrib.delta-completeness",
                            f"exhaustive[s1={s1},s2={s2}]",
                            f"lag-1 delta at v{v} "
                            f"{'degraded to a full resync' if full else 'produced wrong bytes'}"))
                    want_sent = {i for i, _c in items}
                    if not set(dirty) <= want_sent:
                        report.add(Finding(
                            "distrib.delta-completeness",
                            f"exhaustive[s1={s1},s2={s2}]",
                            f"delta at v{v} omitted dirty chunk(s) "
                            f"{sorted(set(dirty) - want_sent)}"))
                cases += 1
        report.metrics["distrib.exhaustive-delta-cases"] = float(cases)

    # sensitivity: the chunk-dropping feed must (a) be visible to the
    # bypassed-CRC audit and (b) be REFUSED by the runtime CRC gate —
    # a gate that admits the torn generation is the finding here
    report.subjects_checked += 1
    if not stale_delta_findings():
        report.add(Finding(
            "distrib.delta-completeness", "delta[dropped-chunk]",
            "a delta with a dirty chunk dropped produced NO byte "
            "divergence — the completeness audit is not sensitive to "
            "the bug it exists to catch"))
    with _env_patched(BFTPU_WIRE_DTYPE="bf16", BFTPU_DISTRIB_CHUNK_KB=1):
        _enc, sub, bad = _dropped_chunk_stream()
        full, items, meta = bad.delta_since(sub.version)
        try:
            sub.install(meta, dict(items), full=full)
        except ValueError:
            pass  # the commit CRC refused the flip, as designed
        else:
            report.add(Finding(
                "distrib.delta-completeness", "delta[dropped-chunk]",
                "the staged-install CRC gate ADMITTED a delta missing "
                "a dirty chunk — a subscriber would serve bytes that "
                "match no committed snapshot"))


def _subsets(n: int):
    for r in range(n + 1):
        yield from itertools.combinations(range(n), r)


# ---------------------------------------------------------------------------
# rule 3: version monotone under relay death (pinned campaigns)
# ---------------------------------------------------------------------------


@registry.rule("distrib.version-monotone", "distrib",
               "pinned distribution-tree campaigns — clean, interior "
               "relay killed mid-fan-out and respawned, join storm "
               "mid-rollout — keep every standing invariant silent "
               "(tree-validity, staleness SLO, serve monotone and "
               "committed) while the subtree re-parents and converges "
               "back to the committed head")
def _run_version_monotone(report: Report) -> None:
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    cases = [
        ("clean", None, 0, 0, {}),
        ("relay-kill",
         FaultSchedule([Fault(kind="serve_kill", step=2, rank=0,
                              stop=16)]),
         3, 1, {}),
        ("join-storm", None, 0, 4,
         {"distrib_join_round": 8, "distrib_join_n": 4}),
    ]
    for name, sched, want_rep, want_join, extra in cases:
        label = f"distrib[n=16,seed=3,{name}]"
        report.subjects_checked += 1
        _cfg, _sched, res = distrib_campaign(16, 24, 3, schedule=sched,
                                             **extra)
        report.extend(campaign_findings(res, label))
        report.extend(_distrib_path_findings(
            res, label, expect_reparents=want_rep,
            expect_joins=want_join))
        report.metrics[f"distrib.reparents/{label}"] = float(
            (res.final["serve"].get("distrib") or {}).get(
                "reparents", -1))


def selftest_distrib_campaigns():
    """The ``--self-test`` arm: acceptance-size distribution campaigns
    under relay chaos, clean + non-vacuous + bit-identical on a second
    run.  Returns ``(label, result, findings)`` triples."""
    from bluefog_tpu_torch.sim.campaign import run_campaign
    from bluefog_tpu_torch.sim.schedule import Fault, FaultSchedule

    out = []
    for ranks, rounds, seed, kind in DISTRIB_PINS:
        extra = {}
        if kind == "relay-kill":
            sched = FaultSchedule([Fault(kind="serve_kill", step=2,
                                         rank=0, stop=rounds - 10)],
                                  seed=seed)
            want_rep, want_join = 3, 1
        elif kind == "relay-storm":
            sched = _storm_schedule(rounds, seed)
            extra = {"distrib_join_round": 8, "distrib_join_n": 4}
            want_rep, want_join = 4, 4
        else:
            sched = FaultSchedule(seed=seed)
            want_rep, want_join = 0, 0
        cfg, sched, res = distrib_campaign(ranks, rounds, seed,
                                           schedule=sched, **extra)
        label = f"distrib[n={ranks},seed={seed},{kind}]"
        findings = campaign_findings(res, label)
        findings.extend(_distrib_path_findings(
            res, label, expect_reparents=want_rep,
            expect_joins=want_join))
        again = run_campaign(cfg, sched)
        if again.digest != res.digest:
            findings.append(Finding(
                "distrib.version-monotone", label,
                f"same-seed distribution campaign diverged: "
                f"{res.digest[:16]} != {again.digest[:16]}"))
        out.append((label, res, findings))
    return out
