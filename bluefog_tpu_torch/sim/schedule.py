"""One fault-schedule format for chaos e2e tests and sim campaigns.

A schedule is an ordered tuple of :class:`Fault` records — ``(kind,
step, rank, duration_s, stop)`` — where ``step`` counts protocol
rounds on the victim's own cadence, exactly like
:func:`bluefog_tpu_torch.resilience.chaos.checkpoint` counts its
instrumented steps.  The same four kinds exist on both sides:

====== ==========================================================
kind   semantics (chaos env keys / sim campaign)
====== ==========================================================
kill   SIGKILL at step (``BFTPU_CHAOS_KILL_RANK`` and
       ``BFTPU_CHAOS_KILL_STEP``) / rank dies, mass seized,
       in-flight drops on dead
suspend SIGSTOP for ``duration_s`` then SIGCONT
       (``BFTPU_CHAOS_SUSPEND_RANK``, ``BFTPU_CHAOS_SUSPEND_STEP``,
       ``BFTPU_CHAOS_SUSPEND_S``) / heartbeats stop, rounds stall
slow   main-thread sleep per step from ``step`` until ``stop``
       (``BFTPU_CHAOS_SLOW_RANK``, ``BFTPU_CHAOS_SLOW_STEP``,
       ``BFTPU_CHAOS_SLOW_S``, ``BFTPU_CHAOS_SLOW_STOP``) / round
       cadence stretched by ``duration_s`` — the gray failure
       adaptive demotion catches
join   a joiner posts on the membership board at step
       (``BFTPU_CHAOS_JOIN_RANK``, ``BFTPU_CHAOS_JOIN_STEP``) / a
       fresh SimRank rendezvouses
partition network partition from ``step`` until ``stop``: cross-group
       traffic drops, liveness words and the membership-epoch word go
       stale across the cut (``BFTPU_CHAOS_PARTITION_GROUP``,
       ``BFTPU_CHAOS_PARTITION_STEP``, ``BFTPU_CHAOS_PARTITION_STOP``)
       / the quorum-fenced minority ORPHANs and merges back on heal
serve_kill replica ``rank`` SIGKILLs mid-swap at its ``step``-th
       hot-swap, respawning at round ``stop``
       (``BFTPU_CHAOS_SERVE_KILL_REPLICA``,
       ``BFTPU_CHAOS_SERVE_KILL_SWAP``,
       ``BFTPU_CHAOS_SERVE_KILL_STOP``) / the sim replica dies between
       read and flip, its served version stays monotone across rejoin
serve_pub_kill the publisher SIGKILLs during its ``step``-th publish;
       ``group`` carries the phase — ``payload`` (standby buffer torn)
       or ``flip`` (payload whole, header not flipped)
       (``BFTPU_CHAOS_SERVE_PUB_KILL_PUBLISH``,
       ``BFTPU_CHAOS_SERVE_PUB_KILL_PHASE``) / survivors keep serving
       the previous committed snapshot, the successor continues the
       version sequence
====== ==========================================================

A partition's sides ride in ``group``: a pipe-separated list of
comma-separated global ranks (``"3"`` = rank 3 vs everyone else;
``"0,1|6,7"`` = two explicit islands plus the implicit rest).  Ranks
not named in any group form one extra implicit group, so the compact
one-sided spelling shrinks well under ddmin.

``to_json``/``from_json`` round-trip losslessly.  ``to_env`` projects
onto the chaos env keys — which hold at most ONE schedule per kind
(that is the chaos format's capacity, not this one's); projecting a
multi-fault campaign keeps the earliest fault of each kind and
reports what it dropped.  ``from_env`` lifts a chaos env schedule
into a one-fault-per-kind ``FaultSchedule``, so a flaky wall-clock
e2e can be replayed as a deterministic campaign.

Determinism: :meth:`FaultSchedule.generate` derives everything from a
seeded ``random.Random`` — same ``(seed, ranks, rounds, kinds)``,
same schedule, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bluefog_tpu_torch.resilience import chaos as _chaos

__all__ = ["Fault", "FaultSchedule", "SCHEDULE_SCHEMA", "FAULT_KINDS",
           "GENERATE_KINDS"]

SCHEDULE_SCHEMA = "bftpu-fault-schedule/1"
FAULT_KINDS = ("kill", "suspend", "slow", "join", "partition",
               "serve_kill", "serve_pub_kill")
#: the kinds :meth:`FaultSchedule.generate` draws from by default — the
#: classic fleet faults.  The serve kinds are opt-in (pass them in
#: ``kinds`` explicitly): keeping the default draw set frozen keeps
#: every previously pinned ``generate(seed, ...)`` schedule, and hence
#: every pinned campaign event digest, bit-identical.
GENERATE_KINDS = ("kill", "suspend", "slow", "join", "partition")


@dataclasses.dataclass(frozen=True, order=True)
class Fault:
    """One scheduled fault.  Ordering is ``(step, kind, rank)`` so a
    sorted schedule is canonical — two schedules with the same fault
    set serialize identically.  ``group`` is the partition-side spec
    (empty for every other kind) and rides LAST so pre-partition
    schedules order, construct, and serialize exactly as before."""

    step: int
    kind: str
    rank: int
    duration_s: float = 0.0
    stop: Optional[int] = None
    group: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.kind == "partition" and not self.group:
            raise ValueError("partition fault needs a group spec "
                             "(e.g. '3' or '0,1|6,7')")
        if self.kind == "serve_pub_kill" and self.group not in (
                "", "payload", "flip"):
            raise ValueError(
                f"serve_pub_kill phase {self.group!r} (the group field "
                "carries the phase: 'payload' or 'flip')")

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "step": int(self.step),
             "rank": int(self.rank)}
        if self.duration_s:
            d["duration_s"] = float(self.duration_s)
        if self.stop is not None:
            d["stop"] = int(self.stop)
        if self.group:
            d["group"] = str(self.group)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(kind=str(d["kind"]), step=int(d["step"]),
                   rank=int(d["rank"]),
                   duration_s=float(d.get("duration_s", 0.0)),
                   stop=(None if d.get("stop") is None
                         else int(d["stop"])),
                   group=str(d.get("group", "")))

    @classmethod
    def partition(cls, groups, start: int, stop: int) -> "Fault":
        """The ``partition(groups, t0, t1)`` constructor: cross-group
        traffic drops from round ``start`` until round ``stop``.
        ``groups`` is an iterable of rank iterables; ranks named in no
        group form one implicit extra side."""
        spec = "|".join(",".join(str(int(r)) for r in sorted(grp))
                        for grp in groups)
        return cls(kind="partition", step=int(start), rank=-1,
                   stop=int(stop), group=spec)

    def groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Parse the ``group`` spec into explicit rank tuples (the
        implicit "rest" side is the fleet's to derive — it knows who is
        alive when the cut lands)."""
        return tuple(
            tuple(sorted(int(x) for x in part.split(",") if x.strip()))
            for part in self.group.split("|") if part.strip())


class FaultSchedule:
    """An immutable, canonically-ordered tuple of faults + the seed
    that generated it (None for hand-written schedules)."""

    def __init__(self, faults: Iterable[Fault] = (),
                 seed: Optional[int] = None):
        self.faults: Tuple[Fault, ...] = tuple(sorted(faults))
        self.seed = seed

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultSchedule)
                and self.faults == other.faults)

    def __repr__(self) -> str:
        return (f"FaultSchedule(seed={self.seed}, "
                f"faults={[f.to_dict() for f in self.faults]})")

    def subset(self, faults: Sequence[Fault]) -> "FaultSchedule":
        """A schedule holding exactly ``faults`` (the shrinker's
        building block); the seed tags along for provenance."""
        return FaultSchedule(faults, seed=self.seed)

    # -- JSON round-trip ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "schema": SCHEDULE_SCHEMA,
            "seed": self.seed,
            "faults": [f.to_dict() for f in self.faults],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "FaultSchedule":
        doc = json.loads(payload)
        schema = doc.get("schema")
        if schema != SCHEDULE_SCHEMA:
            raise ValueError(f"not a fault schedule (schema={schema!r}, "
                             f"want {SCHEDULE_SCHEMA!r})")
        return cls((Fault.from_dict(d) for d in doc.get("faults", ())),
                   seed=doc.get("seed"))

    # -- chaos env interop -------------------------------------------------

    def to_env(self, env: Optional[dict] = None) -> dict:
        """Project onto the chaos env keys.  The chaos format holds at
        most ONE schedule per kind, so the earliest fault of each kind
        wins — a lossy projection for multi-fault campaigns (the JSON
        form is the lossless one)."""
        env = {} if env is None else env
        first: Dict[str, Fault] = {}
        for f in self.faults:
            if f.kind not in first:
                first[f.kind] = f
        for kind, f in first.items():
            if kind == "kill":
                _chaos.schedule_kill(env, f.rank, f.step,
                                     delay_s=f.duration_s)
            elif kind == "suspend":
                _chaos.schedule_suspend(
                    env, f.rank, f.step,
                    duration_s=f.duration_s or 2.5)
            elif kind == "slow":
                _chaos.schedule_slow(env, f.rank, f.step,
                                     delay_s=f.duration_s or 0.5,
                                     stop=f.stop)
            elif kind == "join":
                _chaos.schedule_join(env, f.rank, f.step)
            elif kind == "partition":
                _chaos.schedule_partition(env, f.group, f.step,
                                          stop=f.stop)
            elif kind == "serve_kill":
                _chaos.schedule_serve_kill(env, f.rank, f.step,
                                           stop=f.stop)
            elif kind == "serve_pub_kill":
                _chaos.schedule_serve_pub_kill(
                    env, f.step, phase=f.group or "payload")
        return env

    @classmethod
    def from_env(cls, env) -> "FaultSchedule":
        """Lift a chaos env schedule (at most one fault per kind) into
        the shared format."""
        faults: List[Fault] = []
        if _chaos._KILL_RANK in env:
            faults.append(Fault(
                kind="kill", rank=int(env[_chaos._KILL_RANK]),
                step=int(env.get(_chaos._KILL_STEP, "1")),
                duration_s=float(env.get(_chaos._DELAY_S, "0"))))
        if _chaos._SUSPEND_RANK in env:
            faults.append(Fault(
                kind="suspend", rank=int(env[_chaos._SUSPEND_RANK]),
                step=int(env.get(_chaos._SUSPEND_STEP, "1")),
                duration_s=float(env.get(_chaos._SUSPEND_S, "2.5"))))
        if _chaos._SLOW_RANK in env:
            stop = env.get(_chaos._SLOW_STOP)
            faults.append(Fault(
                kind="slow", rank=int(env[_chaos._SLOW_RANK]),
                step=int(env.get(_chaos._SLOW_STEP, "1")),
                duration_s=float(env.get(_chaos._SLOW_S, "0.5")),
                stop=None if stop is None else int(stop)))
        if _chaos._JOIN_RANK in env:
            faults.append(Fault(
                kind="join", rank=int(env[_chaos._JOIN_RANK]),
                step=int(env.get(_chaos._JOIN_STEP, "1"))))
        if _chaos._PARTITION_GROUP in env:
            stop = env.get(_chaos._PARTITION_STOP)
            faults.append(Fault(
                kind="partition", rank=-1,
                step=int(env.get(_chaos._PARTITION_STEP, "1")),
                stop=None if stop is None else int(stop),
                group=str(env[_chaos._PARTITION_GROUP])))
        if _chaos._SERVE_KILL_REPLICA in env:
            stop = env.get(_chaos._SERVE_KILL_STOP)
            faults.append(Fault(
                kind="serve_kill",
                rank=int(env[_chaos._SERVE_KILL_REPLICA]),
                step=int(env.get(_chaos._SERVE_KILL_SWAP, "1")),
                stop=None if stop is None else int(stop)))
        if _chaos._SERVE_PUB_KILL_PUBLISH in env:
            faults.append(Fault(
                kind="serve_pub_kill", rank=-1,
                step=int(env[_chaos._SERVE_PUB_KILL_PUBLISH]),
                group=str(env.get(_chaos._SERVE_PUB_KILL_PHASE,
                                  "payload"))))
        return cls(faults)

    # -- seeded generation -------------------------------------------------

    @classmethod
    def generate(cls, seed: int, ranks: int, rounds: int,
                 kinds: Sequence[str] = GENERATE_KINDS,
                 n_faults: Optional[int] = None,
                 max_kills_frac: float = 0.25) -> "FaultSchedule":
        """Deterministically derive a campaign schedule from a seed.

        Kills are capped at ``max_kills_frac`` of the fleet (the
        healing rules assume a surviving majority), fault steps land
        in the first ~2/3 of the campaign so the quiesce window can
        actually quiesce, and every choice comes off one seeded
        ``random.Random`` — the same seed replays the same schedule.
        """
        rng = random.Random(int(seed))
        kinds = (tuple(k for k in kinds if k in FAULT_KINDS)
                 or GENERATE_KINDS)
        if n_faults is None:
            n_faults = max(1, min(8, ranks // 8, rounds // 4))
        max_kills = max(1, int(ranks * max_kills_frac))
        horizon = max(2, (2 * rounds) // 3)
        faults: List[Fault] = []
        kills = 0
        victims = set()
        partitions = 0
        for _ in range(int(n_faults)):
            kind = rng.choice(kinds)
            if kind == "kill" and kills >= max_kills:
                kind = "slow" if "slow" in kinds else "join"
            step = rng.randrange(1, horizon + 1)
            if kind == "serve_kill":
                # rank names the replica ordinal, not a fleet victim
                faults.append(Fault(
                    kind="serve_kill", step=max(1, step // 4),
                    rank=rng.randrange(0, 2),
                    stop=min(rounds, step + rng.randrange(3, 8))))
                continue
            if kind == "serve_pub_kill":
                faults.append(Fault(
                    kind="serve_pub_kill", step=max(1, step // 4),
                    rank=-1, group=rng.choice(("payload", "flip"))))
                continue
            if kind == "partition":
                # one window at a time (the fleet runs one cut), the
                # named side strictly sub-majority so the implicit rest
                # keeps quorum and can sponsor the merge-back
                if partitions >= 1:
                    continue
                partitions += 1
                size = rng.randrange(1, max(2, min(ranks // 4,
                                                   (ranks - 1) // 2) + 1))
                side = sorted(rng.sample(range(ranks), size))
                stop = min(rounds, step + rng.randrange(4, 10))
                faults.append(Fault.partition([side], step, stop))
                continue
            # victims are distinct (two faults on one rank is a valid
            # scenario but shrinks poorly: keep campaigns orthogonal)
            pool = [r for r in range(ranks) if r not in victims]
            if not pool:
                break
            rank = rng.choice(pool)
            if kind == "kill":
                kills += 1
                victims.add(rank)
                faults.append(Fault(kind="kill", step=step, rank=rank))
            elif kind == "suspend":
                victims.add(rank)
                faults.append(Fault(kind="suspend", step=step, rank=rank,
                                    duration_s=rng.uniform(2.5, 4.0)))
            elif kind == "slow":
                victims.add(rank)
                # long enough that the stale window (gap minus the
                # adaptive deadline) spans several observer polls —
                # a shorter slow is a legitimate fault the machine
                # correctly rides out without demoting
                dur = rng.uniform(0.5, 1.5)
                stop = min(rounds, step + rng.randrange(5, 15))
                faults.append(Fault(kind="slow", step=step, rank=rank,
                                    duration_s=dur, stop=stop))
            else:  # join — rank names the joiner ordinal, not a victim
                faults.append(Fault(kind="join", step=step,
                                    rank=ranks + len(faults)))
        return cls(faults, seed=int(seed))
