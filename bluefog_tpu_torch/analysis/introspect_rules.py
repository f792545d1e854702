"""Rule family: the live introspection plane (status pages, holder words,
critical-path feed).

Three invariants the ``bftpu-top`` plane leans on, checked the same way
the adaptive family checks demotions — by DRIVING the real artifacts
(a real :class:`~bluefog_tpu_torch.introspect.statuspage.StatusPage` writer,
a real :class:`~bluefog_tpu_torch.resilience.adaptive.AdaptivePolicy`) and
linting what comes out:

- **status-page** — every page an external reader accepts must be
  schema/version-exact, settled (even seq), self-consistent (rank in
  range, edge records legal, ledger balance arithmetic intact).  A page
  that fails here would make ``bftpu-top`` lie about a running job.
- **holder-word** — a mutex holder word must name a live member: a rank
  outside the membership (or in the dead set) holding a word means the
  clear-on-release / clear-on-break path was skipped, and every future
  mutex wait would be blamed on a ghost.
- **critical-path-feed** — the blame counters feeding
  :meth:`AdaptivePolicy.corroborated` are cumulative: a snapshot
  sequence where any rank's count decreases means the feed was reset or
  raced, silently re-arming demotion for ranks the trace had cleared.

Pure ``check_*`` helpers (artifact in, findings out) so the fixture
corpus and the CLI share one implementation.
"""

from __future__ import annotations

import tempfile
from typing import Dict, List, Mapping, Sequence, Set

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry

_RULE_PAGE = "introspect.status-page"
_RULE_HOLDER = "introspect.holder-word"
_RULE_FEED = "introspect.critical-path-feed"


# ---------------------------------------------------------------------------
# status pages
# ---------------------------------------------------------------------------


def check_status_page(page: Mapping[str, object],
                      label: str) -> List[Finding]:
    """Structural lint of one decoded status page (the dict shape
    ``read_status_page`` returns and ``bftpu-top --json`` re-emits)."""
    from bluefog_tpu_torch.introspect.statuspage import (
        EDGE_STATE_NAMES, MAX_EDGES, STATUS_SCHEMA, STATUS_VERSION)

    out: List[Finding] = []

    def bad(msg: str) -> None:
        out.append(Finding(_RULE_PAGE, label, msg))

    if page.get("schema") != STATUS_SCHEMA:
        bad(f"schema {page.get('schema')!r} != {STATUS_SCHEMA!r}")
    if page.get("version") != STATUS_VERSION:
        bad(f"version {page.get('version')!r} != {STATUS_VERSION}")
    seq = page.get("seq")
    if not isinstance(seq, int) or seq % 2 != 0:
        bad(f"seq {seq!r} is not even: the page was accepted mid-write")

    rank, nranks = page.get("rank"), page.get("nranks")
    if not (isinstance(rank, int) and isinstance(nranks, int)
            and 0 <= rank < max(nranks, 1)):
        bad(f"rank {rank!r} outside [0, nranks={nranks!r})")

    edges = page.get("edges") or []
    if len(edges) > MAX_EDGES:
        bad(f"{len(edges)} edge records exceed MAX_EDGES={MAX_EDGES}")
    legal_states = set(EDGE_STATE_NAMES.values())
    for e in edges:
        peer, state = e.get("peer"), e.get("state")
        if state not in legal_states:
            bad(f"edge peer={peer!r} has unknown state {state!r}")
        if not (isinstance(peer, int) and 0 <= peer) or peer == rank:
            bad(f"edge peer {peer!r} is not a valid remote rank")
        if not (float(e.get("deadline_s", 0.0)) >= 0.0):
            bad(f"edge peer={peer!r} deadline "
                f"{e.get('deadline_s')!r} is negative")

    led = page.get("ledger") or {}
    for k in ("deposits", "collected", "drained", "pending"):
        if float(led.get(k, 0.0)) < 0.0:
            bad(f"ledger {k} {led.get(k)!r} is negative")
    want = (float(led.get("deposits", 0.0)) - float(led.get("collected", 0.0))
            - float(led.get("drained", 0.0)))
    if abs(float(led.get("balance", 0.0)) - want) > 1e-9:
        bad(f"ledger balance {led.get('balance')!r} != "
            f"deposits - collected - drained = {want}")
    return out


def check_page_sequence(pages: Sequence[Mapping[str, object]],
                        label: str) -> List[Finding]:
    """Republishes from one rank: step, op_id, and epoch never go
    backward (each publish overwrites the whole page in place)."""
    out: List[Finding] = []
    for field in ("step", "op_id", "epoch"):
        prev = None
        for p in pages:
            cur = p.get(field)
            if prev is not None and isinstance(cur, int) and cur < prev:
                out.append(Finding(
                    _RULE_PAGE, label,
                    f"{field} went backward across republishes: "
                    f"{prev} -> {cur}"))
            if isinstance(cur, int):
                prev = cur
    return out


@registry.rule(
    _RULE_PAGE, "introspect",
    "Drive a real StatusPage writer through publish/read cycles (edges, "
    "ledger, epoch bump, in-place republish) and lint every page an "
    "external reader would accept: schema/version exact, seq even, rank "
    "and edge records in range, ledger balance arithmetic intact, "
    "step/op_id/epoch monotone.")
def _run_status_pages(report: Report) -> None:
    from bluefog_tpu_torch.introspect import statuspage as sp
    from bluefog_tpu_torch.native import shm_native

    with tempfile.TemporaryDirectory(prefix="bftpu_introspect_") as td:
        saved = shm_native._FALLBACK_DIR
        shm_native._FALLBACK_DIR = td
        try:
            job = "analysis-sp"
            for rank in range(2):
                page = sp.StatusPage(job, rank)
                seen: List[Dict[str, object]] = []
                try:
                    for step in range(1, 4):
                        epoch = 1 if step == 3 else 0
                        page.publish(
                            nranks=2, step=step, epoch=epoch, op_id=step,
                            last_op=f"win_update:g{step}",
                            ledger={"deposits": 4.0 * step,
                                    "collected": 3.0 * step,
                                    "drained": 0.5 * step,
                                    "pending": 0.5 * step},
                            edges=[(1 - rank, 1 if step == 2 else 0, 0.2)])
                        decoded = sp.read_status_page(
                            sp.status_page_path(job, rank))
                        seen.append(decoded)
                        report.subjects_checked += 1
                        report.extend(check_status_page(
                            decoded, f"{job}/r{rank}@step{step}"))
                finally:
                    page.close(unlink=True)
                report.extend(check_page_sequence(seen, f"{job}/r{rank}"))
            report.metric("introspect.pages_checked", 6)
        finally:
            shm_native._FALLBACK_DIR = saved


# ---------------------------------------------------------------------------
# holder words
# ---------------------------------------------------------------------------


def check_holder_words(holders: Mapping[int, int],
                       members: Set[int], dead: Set[int],
                       label: str) -> List[Finding]:
    """Every holder word must name a live member.  ``holders`` maps
    mutex rank -> holder rank (the decoded, 0-based view a
    ``HolderBoard.snapshot``/``collect`` exposes)."""
    out: List[Finding] = []
    for mutex_rank, holder in sorted(holders.items()):
        if holder in dead:
            out.append(Finding(
                _RULE_HOLDER, label,
                f"mutex {mutex_rank} held by DEAD rank {holder}: the "
                f"break/heal path must clear the word so waits stop "
                f"blaming a ghost"))
        elif holder not in members:
            out.append(Finding(
                _RULE_HOLDER, label,
                f"mutex {mutex_rank} held by rank {holder} outside the "
                f"membership {sorted(members)}: stale word survived a "
                f"release or epoch switch"))
    return out


@registry.rule(
    _RULE_HOLDER, "introspect",
    "Drive a real HolderBoard through the acquire/release/break "
    "lifecycle and audit the words after each step: a set word names "
    "the acquirer, release clears it, mutex_break (the heal path for a "
    "dead holder) clears it — no ghost holders at any point.")
def _run_holder_lifecycle(report: Report) -> None:
    from bluefog_tpu_torch.native.shm_native import HolderBoard

    with tempfile.TemporaryDirectory(prefix="bftpu_introspect_") as td:
        from bluefog_tpu_torch.native import shm_native
        saved = shm_native._FALLBACK_DIR
        shm_native._FALLBACK_DIR = td
        try:
            members = {0, 1, 2, 3}
            board = HolderBoard("analysis-hb", 4)
            try:
                report.subjects_checked += 1
                # acquire: rank 2 takes rank 0's window mutex
                board.set_holder(0, 2)
                snap = board.snapshot()
                report.extend(check_holder_words(
                    snap, members, set(), "analysis-hb[held]"))
                if snap.get(0) != 2:
                    report.add(Finding(
                        _RULE_HOLDER, "analysis-hb[held]",
                        f"acquire did not publish the holder: {snap}"))
                # conditional release by the right rank clears the word
                board.clear(0, 2)
                if 0 in board.snapshot():
                    report.add(Finding(
                        _RULE_HOLDER, "analysis-hb[released]",
                        "release by the holder left the word set"))
                # a raced conditional clear by a NON-holder is a no-op
                board.set_holder(1, 3)
                board.clear(1, 0)
                if board.snapshot().get(1) != 3:
                    report.add(Finding(
                        _RULE_HOLDER, "analysis-hb[raced-clear]",
                        "conditional clear by a non-holder clobbered "
                        "another rank's word"))
                # heal: rank 3 died holding mutex 1; break clears
                # unconditionally, after which the audit must be clean
                report.extend(check_holder_words(
                    board.snapshot(), members, set(), "analysis-hb[pre]"))
                board.clear(1)
                report.extend(check_holder_words(
                    board.snapshot(), members - {3}, {3},
                    "analysis-hb[healed]"))
            finally:
                board.close(unlink=True)
        finally:
            shm_native._FALLBACK_DIR = saved


# ---------------------------------------------------------------------------
# critical-path feed
# ---------------------------------------------------------------------------


def check_blame_monotone(snapshots: Sequence[Mapping[int, int]],
                         label: str) -> List[Finding]:
    """The per-rank critical-path blame counts are cumulative: across a
    snapshot sequence every rank's count must be non-negative and
    non-decreasing."""
    out: List[Finding] = []
    prev: Dict[int, int] = {}
    for i, snap in enumerate(snapshots):
        for rank, n in sorted(snap.items()):
            if n < 0:
                out.append(Finding(
                    _RULE_FEED, label,
                    f"snapshot {i}: rank {rank} blame count {n} < 0"))
            if n < prev.get(rank, 0):
                out.append(Finding(
                    _RULE_FEED, label,
                    f"rank {rank} blame count went backward "
                    f"({prev[rank]} -> {n} at snapshot {i}): the feed "
                    f"was reset mid-run and corroboration is unsound"))
        for rank, n in snap.items():
            prev[rank] = max(prev.get(rank, 0), int(n))
    return out


@registry.rule(
    _RULE_FEED, "introspect",
    "Drive a real AdaptivePolicy's critical-path feed (note_round_blame "
    "increments, feed_critical_path max-merges) and check the contract "
    "corroborated() relies on: counts only ever grow, the gate is open "
    "when no live trace feed exists and closed for unblamed peers when "
    "one does.")
def _run_critical_path_feed(report: Report) -> None:
    from bluefog_tpu_torch.resilience.adaptive import AdaptivePolicy

    pol = AdaptivePolicy()
    report.subjects_checked += 1

    snaps: List[Dict[int, int]] = [dict(pol._cp_blame)]
    pol.note_round_blame(3)
    snaps.append(dict(pol._cp_blame))
    pol.note_round_blame(3)
    pol.note_round_blame(1)
    snaps.append(dict(pol._cp_blame))
    # a merge reporting LOWER totals than already observed must not
    # roll the counters back (max-merge)
    pol.feed_critical_path({3: 1, 2: 5})
    snaps.append(dict(pol._cp_blame))
    report.extend(check_blame_monotone(snaps, "adaptive-policy@4"))

    # gate semantics: without a live feed every peer is corroborated;
    # with one, only blamed peers are
    if not pol.corroborated(0):
        report.add(Finding(
            _RULE_FEED, "adaptive-policy@4",
            "corroborated() closed with no live trace feed: demotion "
            "would deadlock whenever tracing is off"))
    pol.set_live_feed(True)
    if pol.corroborated(0):
        report.add(Finding(
            _RULE_FEED, "adaptive-policy@4",
            "corroborated() open for a peer the live critical path "
            "never blamed"))
    if not (pol.corroborated(3) and pol.corroborated(2)):
        report.add(Finding(
            _RULE_FEED, "adaptive-policy@4",
            "corroborated() closed for a blamed peer: the feed is not "
            "reaching the gate"))
    report.metric("introspect.blame_snapshots", len(snaps))
