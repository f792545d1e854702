"""Elastic membership: the rank-join protocol for island jobs.

Healing taught the fleet to SHRINK (heal_topology excises the dead); this
module is the GROW side: a brand-new process rendezvouses with a live
job, is granted a **fresh global rank** (the monotone-dead-set contract
— a restarted rank never reuses its old identity), and the whole
membership moves together to a new **epoch**.

The coordination medium is a **membership board**: one JSON document in
the shm dir (``bf_<job>_membership``), updated read-modify-write under
an ``lockf`` sidecar lock and published by atomic rename, plus the
8-byte **membership-epoch word** (``shm_native.membership_epoch``) as
the cheap has-anything-changed probe.  On the pure-TCP transport the
coordinator serves the same rendezvous primitives as wire ops
(``_OP_JOIN_RANK`` / ``_OP_EPOCH`` in native/tcp_transport.py) for the
multi-host deployment where joiner and members share no filesystem.

Protocol (see docs/RESILIENCE.md, "Elastic membership"):

1. the joiner **posts a request** on the board and polls for a grant;
2. every member calls :func:`bluefog_tpu_torch.islands.admit_pending` at a
   round barrier; the **sponsor** (lowest live global rank) grants all
   pending requests: it assigns fresh global ranks off the board's
   monotone ``next_rank`` counter, computes the grown topology
   (:func:`~bluefog_tpu_torch.resilience.healing.grow_topology` over the live
   member graph), and commits an **epoch record** — members, dense
   edge list, window metadata, sponsor — in one atomic board write;
3. every member (and the joiner) observes the record and performs the
   **epoch switch**: drain + retire outstanding mailbox deposits into
   the mass ledger, close the old epoch's segments, bind the
   epoch-suffixed job namespace (``<job>_e<N>``, segments sized for the
   new member count), recreate the windows, and barrier;
4. the joiner onboards by reading the sponsor's exposed window state
   (the ``broadcast`` window path) and enters with **unit mass at the
   sponsor's debiased estimate**, so Σx/Σp is preserved at consensus —
   the admitted mass is journaled (``MASS_JOIN_ADMITTED``) and the
   ledger balance at the switch barrier is journaled per rank
   (``epoch_switch``), which is what the analysis
   ``resilience.membership-epoch`` rule audits.

Env knobs:

- ``BFTPU_JOIN_TIMEOUT_S`` (default 60) — joiner-side wait for a grant
  (members admit at their own round cadence);
- ``BFTPU_JOIN_POLL_S`` (default 0.05) — board poll period.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple


from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import healing as _healing
from bluefog_tpu_torch.sim.clock import resolve_clock as _resolve_clock

__all__ = [
    "BOARD_SCHEMA",
    "MembershipBoard",
    "JoinGrant",
    "epoch_job",
    "join_timeout_s",
    "join_poll_s",
]

BOARD_SCHEMA = "bftpu-membership/1"


def join_timeout_s() -> float:
    try:
        return float(os.environ.get("BFTPU_JOIN_TIMEOUT_S", "60"))
    except ValueError:
        return 60.0


def join_poll_s() -> float:
    try:
        return float(os.environ.get("BFTPU_JOIN_POLL_S", "0.05"))
    except ValueError:
        return 0.05


def epoch_job(job: str, epoch: int) -> str:
    """The shm namespace for a membership epoch.  Epoch 0 is the launch
    namespace unchanged (pre-elastic jobs never see a suffix); later
    epochs get ``_e<N>``, which still matches the ``bf_<job>_*`` cleanup
    glob so crashed-run hygiene reclaims every epoch's segments."""
    return job if int(epoch) == 0 else f"{job}_e{int(epoch)}"


@dataclasses.dataclass(frozen=True)
class JoinGrant:
    """One admitted joiner's view of an epoch record."""

    rank: int                     # fresh global rank
    epoch: int
    members: Tuple[int, ...]      # sorted global ranks of the new epoch
    sponsor: int                  # sponsor's global rank
    record: dict                  # the full epoch record

    @property
    def local_rank(self) -> int:
        return self.members.index(self.rank)

    @property
    def sponsor_local(self) -> int:
        return self.members.index(self.sponsor)

    @property
    def size(self) -> int:
        return len(self.members)


def record_graph(record: dict) -> topology_util.DiGraph:
    """Rebuild the epoch's dense MH-weighted topology from the record's
    edge list — every member and the joiner derive the SAME graph from
    the SAME committed record (consensus by construction, not by
    re-derivation)."""
    G = topology_util.DiGraph()
    G.add_nodes_from(range(len(record["members"])))
    G.add_edges_from((int(u), int(v)) for u, v in record["edges"])
    topology_util.MetropolisHastingsWeights(G)
    G.graph["grown_from"] = tuple(int(j) for j in record.get("joined", ()))
    if record.get("reweight"):
        # adaptive reweight records tag the graph like demote_topology
        # does, so the analysis rules see the same artifact either way
        G.graph["demoted_from"] = tuple(
            int(g) for g in record.get("demoted", ()))
    return G


class MembershipBoard:
    """The job's membership document: requests in, epoch records out.

    All mutation is read-modify-write under an exclusive ``lockf`` on a
    sidecar lock file (the lock file is never replaced, so the lock is
    on a stable inode), and the document itself is published by atomic
    rename — readers never see a torn JSON.
    """

    def __init__(self, job: str, clock=None):
        self.job = job
        # injectable clock (sim/clock.py seam) for the grant-poll loop;
        # ``None`` is wall time — production behavior unchanged
        self._clock = _resolve_clock(clock)
        base = shm_native.seg_name(job, "membership")[1:]
        self.path = os.path.join(shm_native._FALLBACK_DIR, base)
        self.lock_path = self.path + ".lock"

    # -- document I/O -----------------------------------------------------

    def read(self) -> Optional[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _publish(self, doc: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def _locked(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def cm():
            fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                fcntl.lockf(fd, fcntl.LOCK_EX)
                yield
            finally:
                fcntl.lockf(fd, fcntl.LOCK_UN)
                os.close(fd)

        return cm()

    def _publish_epoch_word(self, epoch: int) -> None:
        """Publish the 8-byte membership-epoch word — the cheap
        has-anything-changed probe members poll at round barriers.
        Separated out so a transport that keeps its epoch word
        somewhere other than the shm segment (the simulator's
        in-memory board) can override just this."""
        shm_native.publish_membership_epoch(self.job, int(epoch))

    # -- lifecycle --------------------------------------------------------

    def ensure(self, nranks: int) -> dict:
        """Idempotently create the epoch-0 document (any member may call
        this; first writer wins)."""
        with self._locked():
            doc = self.read()
            if doc is not None:
                return doc
            doc = {
                "schema": BOARD_SCHEMA,
                "job": self.job,
                "epoch": 0,
                "next_rank": int(nranks),
                "members": list(range(int(nranks))),
                "requests": [],
                "epochs": [],
            }
            self._publish(doc)
            return doc

    # -- joiner side ------------------------------------------------------

    def post_request(self, retiring: int = -1) -> str:
        """Publish a join request; returns the request id to poll on.

        ``retiring`` names a global rank this joiner is abandoning — a
        merging orphan re-enters under a fresh rank while its quiesced
        old identity still looks alive (heartbeats only stopped at the
        merge).  Members MUST excise it before granting: the grown
        view's new-epoch barrier would otherwise wait forever on an
        identity that never switches (``islands.admit_pending`` treats
        it exactly like a detector-confirmed corpse).
        """
        req_id = f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        with self._locked():
            doc = self.read()
            if doc is None:
                raise RuntimeError(
                    f"no membership board for job {self.job!r} — is the "
                    "job running (islands.init publishes the board)?")
            req = {"req": req_id, "pid": os.getpid(),
                   "host": socket.gethostname(), "t": time.time()}
            if int(retiring) >= 0:
                req["retiring"] = int(retiring)
            doc["requests"].append(req)
            self._publish(doc)
        return req_id

    def wait_for_grant(self, req_id: str,
                       timeout: Optional[float] = None) -> JoinGrant:
        """Poll until some epoch record grants ``req_id`` a rank."""
        deadline = self._clock.deadline(join_timeout_s()
                                        if timeout is None else timeout)
        poll = join_poll_s()
        while True:
            doc = self.read()
            if doc is not None:
                for rec in reversed(doc["epochs"]):
                    granted = rec.get("granted", {})
                    if req_id in granted:
                        return JoinGrant(
                            rank=int(granted[req_id]),
                            epoch=int(rec["epoch"]),
                            members=tuple(int(m) for m in rec["members"]),
                            sponsor=int(rec["sponsor"]),
                            record=rec,
                        )
            if self._clock.expired(deadline):
                raise TimeoutError(
                    f"join request {req_id} not granted within timeout "
                    f"(job {self.job!r}; is any member calling "
                    "islands.admit_pending()?)")
            self._clock.sleep(poll)

    # -- sponsor side -----------------------------------------------------

    def pending_requests(self) -> List[dict]:
        doc = self.read()
        return list(doc["requests"]) if doc else []

    def epoch_record(self, epoch: int) -> Optional[dict]:
        doc = self.read()
        if doc is None:
            return None
        for rec in doc["epochs"]:
            if int(rec["epoch"]) == int(epoch):
                return rec
        return None

    def grant(self, sponsor: int, live_members: Sequence[int],
              live_graph: topology_util.DiGraph, windows: List[dict],
              associated_p: bool, prev_epoch: int) -> Optional[dict]:
        """Commit the next epoch record admitting every pending request.

        Deterministic from the board state + the sponsor's live view:
        fresh ranks come off the monotone ``next_rank`` counter, the
        grown topology comes from :func:`grow_topology` over the live
        member graph (global labels), and the dense edge list of the
        result is what gets committed — so a raced second sponsor (a
        momentary disagreement about who is lowest-alive) finds the
        record already present and returns it unchanged.

        Returns the committed record, or None if there was nothing to
        grant.
        """
        with self._locked():
            doc = self.read()
            if doc is None:
                raise RuntimeError(f"membership board vanished for "
                                   f"{self.job!r}")
            new_epoch = int(prev_epoch) + 1
            for rec in doc["epochs"]:
                if int(rec["epoch"]) == new_epoch:
                    return rec  # already committed by a raced sponsor
            reqs = list(doc["requests"])
            if not reqs:
                return None
            fresh = list(range(int(doc["next_rank"]),
                               int(doc["next_rank"]) + len(reqs)))
            grown = _healing.grow_topology(live_graph, fresh)
            rec = {
                "epoch": new_epoch,
                "members": [int(m) for m in grown.to_global],
                "joined": fresh,
                "removed": sorted(set(doc["members"])
                                  - set(int(m) for m in live_members)),
                "granted": {r["req"]: rank
                            for r, rank in zip(reqs, fresh)},
                "sponsor": int(sponsor),
                "edges": [[int(u), int(v)]
                          for u, v in grown.topology.edges],
                "windows": windows,
                "associated_p": bool(associated_p),
            }
            doc["epochs"].append(rec)
            doc["epoch"] = new_epoch
            doc["members"] = rec["members"]
            doc["next_rank"] = int(doc["next_rank"]) + len(reqs)
            doc["requests"] = []
            self._publish(doc)
        # the cheap probe members poll at round barriers
        self._publish_epoch_word(new_epoch)
        return rec

    # -- adaptive-topology side (resilience/adaptive.py) ------------------

    def commit_reweight(self, committer: int, prev_epoch: int,
                        members: Sequence[int], edges: Sequence,
                        windows: List[dict], associated_p: bool,
                        demoted: Sequence[int], promoted: Sequence[int],
                        base_edges: Sequence) -> Optional[dict]:
        """Commit a **reweight** epoch record: same member set, new
        topology — the adaptive demote/promote switch (straggler degree
        capped, or restored).  The record carries ``reweight: True`` so
        the switch points can tell it from a join grant, plus the
        demoted set and the base (pre-demotion) edge list any member
        needs to compute the NEXT demote or the promote restore.

        First-wins and idempotent like :meth:`grant`: raced observers
        of the same straggler find epoch ``prev_epoch + 1`` already
        committed and get that record back (the caller checks its
        ``reweight`` flag — a raced JOIN grant wins the epoch and the
        demote retries next tick).  Returns the committed-or-existing
        record, or None once a member has marked itself leaving
        (:meth:`mark_leaving`).
        """
        with self._locked():
            doc = self.read()
            if doc is None:
                raise RuntimeError(f"membership board vanished for "
                                   f"{self.job!r}")
            new_epoch = int(prev_epoch) + 1
            for rec in doc["epochs"]:
                if int(rec["epoch"]) == new_epoch:
                    return rec  # first observer (or a join) won the epoch
            if doc.get("leaving"):
                return None  # a member has left its rounds: see mark_leaving
            rec = {
                "epoch": new_epoch,
                "members": [int(m) for m in members],
                "joined": [],
                "removed": [],
                "granted": {},
                "sponsor": int(committer),
                "edges": [[int(u), int(v)] for u, v in edges],
                "windows": windows,
                "associated_p": bool(associated_p),
                "reweight": True,
                "demoted": [int(g) for g in demoted],
                "promoted": [int(g) for g in promoted],
                "base_edges": [[int(u), int(v)] for u, v in base_edges],
            }
            doc["epochs"].append(rec)
            doc["epoch"] = new_epoch
            self._publish(doc)
        self._publish_epoch_word(new_epoch)
        return rec

    def mark_leaving(self, member: int) -> int:
        """Record that global rank ``member`` has left its round loop and
        return the board's epoch at that moment.  From then on
        :meth:`commit_reweight` refuses: a reweight switch needs every
        member at its barriers, and a member that left would meet them
        with its teardown barrier instead.  The reweight epochs committed
        before the mark are the ones the leaver still switches through
        (``islands.adaptive_leave``)."""
        with self._locked():
            doc = self.read()
            if doc is None:
                raise RuntimeError(f"membership board vanished for "
                                   f"{self.job!r}")
            doc["leaving"] = sorted(set(doc.get("leaving", ())) | {int(member)})
            self._publish(doc)
            return int(doc["epoch"])
