"""Recovery benchmark: SIGKILL-to-first-healed-gossip-round latency.

The resilience headline (docs/RESILIENCE.md): with ``nprocs`` island
ranks gossiping over exp2 through the shm mailbox, the parent SIGKILLs
one rank and each survivor independently detects the death (heartbeat
stamp ages past ``BFTPU_FAILURE_TIMEOUT_S``), heals the topology
(force-drain + Metropolis–Hastings re-weighting over the survivors),
and completes one full degraded gossip round.  ``value`` is the median
survivor's kill-to-first-healed-round wall time in ms — dominated by
the failure timeout by construction, so the interesting part is the
margin above it (drain + replan + one round).

``time.monotonic`` is CLOCK_MONOTONIC, system-wide on Linux, so the
parent's kill stamp and the survivors' healed stamps share a clock.

Counterpart of the JAX package's ``benchmarks/recovery.py``: the same four
runs (``measure_recovery``, ``measure_join``, ``measure_partition``,
``measure_straggler``), with rank 0's window a torch tensor on ``device``
(the card by default) and the others' on the CPU.  ``measure_recovery``
also holds every survivor's healed mixing matrix to
:func:`bluefog_tpu_torch.resilience.healing.heal_topology`'s.

Run: ``python -m bluefog_tpu_torch.benchmarks.recovery [--device cpu]``
(one JSON line).
"""

import os
import signal
import sys
import time
from typing import Optional


_FAILURE_TIMEOUT_S = 0.5


def _window(rank: int, device: str, n: int = 4):
    """Rank ``rank``'s window tensor: on ``device`` for rank 0, else on
    the CPU."""
    import torch

    return torch.full((n,), float(rank), dtype=torch.float64,
                      device=device if rank == 0 else "cpu")


def _mean(x) -> float:
    import torch

    return float(torch.as_tensor(x).double().mean())


def _worker(rank, size, job, q, device="cuda"):
    from bluefog_tpu_torch import islands, topology_util
    from bluefog_tpu_torch.resilience.healing import healed_weight_matrix

    islands.init(rank, size, job)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(_window(rank, device), "rec")
    islands.barrier()
    q.put(("up", rank, os.getpid(), time.monotonic()))
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and not islands.dead_ranks():
        islands.win_put(islands.win_sync("rec"), "rec")
        islands.win_update("rec")
        time.sleep(0.002)
    healed = islands.heal()
    if healed is not None:
        # first full gossip round on the healed topology
        islands.win_put(islands.win_sync("rec"), "rec")
        islands.win_update("rec")
        q.put(("healed", rank, (tuple(healed.dead), healed.survivors,
                                healed_weight_matrix(healed).tolist()),
               time.monotonic()))
    islands.shutdown(unlink=False)


def measure_recovery(nprocs: int = 4, victim: int = 1,
                     failure_timeout_s: float = _FAILURE_TIMEOUT_S,
                     device: str = "cuda") -> dict:
    """Kill one of ``nprocs`` gossiping island ranks; return the metric
    dict with ``value`` = median survivor kill-to-first-healed-round ms
    (bench.py rides this in the headline's ``recovery_ms`` key)."""
    import multiprocessing as mp

    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.resilience.healing import (heal_topology,
                                                      healed_weight_matrix)

    want = heal_topology(topology_util.ExponentialTwoGraph(nprocs), [victim])
    want_w = healed_weight_matrix(want).tolist()
    job = f"recov{os.getpid()}"
    saved = os.environ.get("BFTPU_FAILURE_TIMEOUT_S")
    os.environ["BFTPU_FAILURE_TIMEOUT_S"] = str(failure_timeout_s)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, nprocs, job, q, device))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        pids = {}
        for _ in range(nprocs):
            tag, r, pid, _t = q.get(timeout=300)
            assert tag == "up"
            pids[r] = pid
        time.sleep(0.3)  # steady-state gossip before the fault
        t_kill = time.monotonic()
        os.kill(pids[victim], signal.SIGKILL)
        lat_ms = []
        for _ in range(nprocs - 1):
            tag, r, (dead, survivors, w), t_healed = q.get(
                timeout=60 + 10 * failure_timeout_s)
            assert tag == "healed" and victim in dead, (tag, r, dead)
            # the healed topology is heal_topology's, on every survivor
            assert survivors == want.survivors and w == want_w, (
                r, survivors, w, want_w)
            lat_ms.append((t_healed - t_kill) * 1000.0)
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job, ["rec"])
        if saved is None:
            os.environ.pop("BFTPU_FAILURE_TIMEOUT_S", None)
        else:
            os.environ["BFTPU_FAILURE_TIMEOUT_S"] = saved
    lat_ms.sort()
    median = lat_ms[len(lat_ms) // 2]
    return {
        "metric": f"rank-kill to first healed gossip round "
                  f"(exp2, {nprocs} procs, shm mailbox)",
        "value": round(median, 1),
        "unit": "ms",
        # the detector floor: value - this = drain + replan + one round
        "failure_timeout_ms": round(failure_timeout_s * 1000.0, 1),
        "survivor_range_ms": [round(lat_ms[0], 1), round(lat_ms[-1], 1)],
        "survivors": nprocs - 1,
        "healed_topology": "heal_topology",
    }


def _elastic_worker(rank, size, job, q, device="cuda"):
    from bluefog_tpu_torch import islands, topology_util

    islands.init(rank, size, job)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(_window(rank, device), "rec")
    islands.barrier()
    q.put(("up", rank, os.getpid(), time.monotonic()))
    deadline = time.monotonic() + 60.0
    rec = None
    while time.monotonic() < deadline and rec is None:
        islands.win_put(islands.win_sync("rec"), "rec")
        islands.win_update("rec")
        # the admission probe rides the gossip cadence: one cheap
        # epoch-word stat per round until a joiner shows up
        rec = islands.admit_pending(timeout=30)
    if rec is not None:
        # first full gossip round on the grown membership
        islands.win_put(islands.win_sync("rec"), "rec")
        islands.win_update("rec")
        islands.barrier()
        q.put(("grown", islands.global_rank(), islands.size(),
               time.monotonic()))
        islands.barrier()
    islands.shutdown(unlink=False)


def _join_worker(job, q):
    from bluefog_tpu_torch import islands

    q.put(("posted", -1, os.getpid(), time.monotonic()))
    islands.join(job=job, timeout=60)
    islands.win_put(islands.win_sync("rec"), "rec")
    islands.win_update("rec")
    islands.barrier()
    q.put(("joined", islands.global_rank(), islands.size(),
           time.monotonic()))
    islands.barrier()
    islands.shutdown(unlink=False)


def measure_join(nprocs: int = 4, device: str = "cuda") -> dict:
    """Scale ``nprocs`` gossiping island ranks to ``nprocs + 1``: return
    the metric dict with ``value`` = rendezvous-to-first-gossip-round
    latency of the joiner in ms (bench.py's ``join_ms`` headline).  Like
    ``recovery_ms`` is dominated by the detector floor, this is
    dominated by the members' admission cadence (they probe the board
    once per gossip round) — the interesting part is the margin above
    it: grant + epoch switch + state transfer + one round."""
    import multiprocessing as mp

    from bluefog_tpu_torch.native import shm_native

    job = f"join{os.getpid()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_elastic_worker,
                         args=(r, nprocs, job, q, device))
             for r in range(nprocs)]
    joiner = ctx.Process(target=_join_worker, args=(job, q))
    try:
        for p in procs:
            p.start()
        for _ in range(nprocs):
            tag, r, pid, _t = q.get(timeout=300)
            assert tag == "up"
        time.sleep(0.3)  # steady-state gossip before the scale-out
        joiner.start()
        t_post = None
        t_joined = None
        member_ms = []
        while t_joined is None or len(member_ms) < nprocs:
            tag, r, extra, t = q.get(timeout=90)
            if tag == "posted":
                t_post = t
            elif tag == "joined":
                assert extra == nprocs + 1, (tag, r, extra)
                t_joined = t
            elif tag == "grown":
                assert extra == nprocs + 1, (tag, r, extra)
                member_ms.append(t)
        join_ms = (t_joined - t_post) * 1000.0
        member_lat = sorted((t - t_post) * 1000.0 for t in member_ms)
    finally:
        for p in procs + [joiner]:
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job, ["rec"])
    return {
        "metric": f"join rendezvous to first gossip round including the "
                  f"new rank (exp2, {nprocs}+1 procs, shm mailbox)",
        "value": round(join_ms, 1),
        "unit": "ms",
        "member_switch_range_ms": [round(member_lat[0], 1),
                                   round(member_lat[-1], 1)],
        "members": nprocs,
    }


def _partition_worker(rank, size, job, victim, cut_ev, q, device="cuda"):
    from bluefog_tpu_torch import islands, topology_util

    islands.init(rank, size, job)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(_window(rank, device), "pm")
    islands.barrier()
    q.put(("up", rank, os.getpid(), time.monotonic()))
    deadline = time.monotonic() + 90.0

    if rank == victim:
        # steady-state gossip until the parent cuts the link
        while not cut_ev.is_set() and time.monotonic() < deadline:
            islands.win_put(islands.win_sync("pm"), "pm")
            islands.win_update("pm")
            time.sleep(0.002)
        # the minority-side view across the cut: every majority rank
        # looks dead.  The quorum fence must DENY the heal (1 of 4 is
        # no majority) and park this rank as an ORPHAN instead.
        t_cut = time.monotonic()
        healed = islands.heal(dead=set(range(size)) - {victim})
        assert healed is None and islands.is_orphaned(), healed
        try:
            islands.win_put(islands.win_sync("pm"), "pm")
            raise AssertionError("orphan win_put did not raise")
        except islands.OrphanedError:
            pass
        q.put(("orphan", rank, None, t_cut))
        # the link heals: merge back through the join machinery,
        # carrying the pre-cut estimate
        islands.merge_orphan(timeout=60)
        islands.win_put(islands.win_sync("pm"), "pm")
        islands.win_update("pm")
        q.put(("merged", islands.global_rank(), islands.size(),
               time.monotonic()))
    else:
        # majority side: keep stepping (quorum holds), admit the
        # orphan when it posts, and heal its abandoned old identity
        # once the detector times it out
        grown = None
        while time.monotonic() < deadline and grown is None:
            islands.win_put(islands.win_sync("pm"), "pm")
            islands.win_update("pm")
            grown = islands.admit_pending(timeout=30)
        islands.win_put(islands.win_sync("pm"), "pm")
        islands.win_update("pm")
        q.put(("grown", islands.global_rank(), islands.size(),
               time.monotonic()))

    # re-merged fleet: heal the orphan's retired identity when the
    # detector flags it, then gossip to consensus and report
    settle = time.monotonic() + 2.0
    while time.monotonic() < settle:
        if islands.dead_ranks() - islands._ctx().dead:
            islands.heal()
        islands.win_put(islands.win_sync("pm"), "pm")
        islands.win_update("pm")
        time.sleep(0.002)
    q.put(("est", islands.global_rank(),
           _mean(islands.win_sync("pm")), time.monotonic()))
    islands.barrier()
    islands.shutdown(unlink=False)


def measure_partition(nprocs: int = 4, victim: Optional[int] = None,
                      failure_timeout_s: float = _FAILURE_TIMEOUT_S,
                      device: str = "cuda") -> dict:
    """Partition ``nprocs`` gossiping island ranks 3/1 (the minority is
    ``victim``'s view of the cut): the minority's heal is quorum-DENIED
    and it ORPHANs; on reconnect it merges back through the join
    machinery carrying its estimate, the majority heals the retired
    identity, and gossip re-converges.  Returns the metric dict with
    ``value`` = cut-to-first-gossip-round-as-readmitted-rank ms
    (bench.py's ``partition_merge_ms`` headline).  Because the join
    request NAMES the retired identity, the majority excises it at the
    grant instead of waiting out its heartbeats — so the merge beats
    the ``failure_timeout_ms`` detector floor that a crash-recovery
    heal pays; the value is board post + grant + excision + epoch
    switch + state transfer + one round."""
    import multiprocessing as mp

    from bluefog_tpu_torch.native import shm_native

    if victim is None:
        victim = nprocs - 1
    job = f"part{os.getpid()}"
    saved = {k: os.environ.get(k)
             for k in ("BFTPU_FAILURE_TIMEOUT_S", "BFTPU_QUORUM")}
    os.environ["BFTPU_FAILURE_TIMEOUT_S"] = str(failure_timeout_s)
    os.environ["BFTPU_QUORUM"] = "majority"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    cut_ev = ctx.Event()
    procs = [ctx.Process(target=_partition_worker,
                         args=(r, nprocs, job, victim, cut_ev, q, device))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        for _ in range(nprocs):
            tag, r, _pid, _t = q.get(timeout=300)
            assert tag == "up"
        time.sleep(0.3)  # steady-state gossip before the cut
        cut_ev.set()
        t_cut = None
        t_merged = None
        grown_ms = []
        ests = {}
        while len(ests) < nprocs:
            tag, r, extra, t = q.get(timeout=120)
            if tag == "orphan":
                t_cut = t
            elif tag == "merged":
                # the retired identity is excised at the grant, so the
                # re-merged membership is back to nprocs (3 + the
                # orphan's fresh rank), not nprocs + 1
                assert extra == nprocs, (tag, r, extra)
                t_merged = t
            elif tag == "grown":
                assert extra == nprocs, (tag, r, extra)
                grown_ms.append((t - t_cut) * 1000.0)
            elif tag == "est":
                ests[r] = extra
        vals = sorted(ests.values())
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job, ["pm"])
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {
        "metric": f"partition cut to first gossip round as the "
                  f"re-admitted rank ({nprocs - 1}/1 split, exp2, "
                  f"shm mailbox, quorum=majority)",
        "value": round((t_merged - t_cut) * 1000.0, 1),
        "unit": "ms",
        # the crash-recovery detector floor the merge BEATS: the join
        # request names the retired identity, so the majority excises
        # it at the grant instead of waiting out its heartbeats
        "failure_timeout_ms": round(failure_timeout_s * 1000.0, 1),
        "majority_grown_range_ms": [round(min(grown_ms), 1),
                                    round(max(grown_ms), 1)],
        "consensus_spread": round(vals[-1] - vals[0], 6),
        "survivors": nprocs - 1,
    }


def _straggler_worker(rank, size, steps, device="cuda"):
    """One synchronous-gossip rank for :func:`measure_straggler` — runs
    under ``islands.spawn`` (auto-init'ed).  Per step: deposit, then
    wait for a fresh deposit on every in-edge, counting an ABSORBED
    edge (adaptive mode) as handled — the contract a synchronous
    training step has with the gossip layer.  The chaos schedule slows
    the last rank at its checkpoint, so in adaptive-off mode every
    neighbor eats the straggler's nap (up to the 2 s hard cap); in
    adaptive-on mode the ABSORB deadline and then the demotion bound
    the wait.  Returns ``(rank, post-warmup step durations in s)``."""
    from bluefog_tpu_torch import islands, topology_util
    from bluefog_tpu_torch.resilience import chaos

    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(_window(rank, device), "st")
    islands.barrier()
    durs = []
    for step in range(steps):
        chaos.checkpoint(rank, "stbench")       # the straggler naps here
        before = islands.get_win_version("st")
        islands.win_put(islands.win_sync("st"), "st")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.0:      # the no-adaptive hard cap
            islands.win_update("st")
            now_v = islands.get_win_version("st")
            if set(now_v) != set(before):
                break  # epoch switched mid-wait: edge set changed
            absorbed = set(islands.win_absorbed("st"))
            members = islands._ctx().members_global
            if not {s for s, v in now_v.items()
                    if v <= before.get(s, 0)
                    and members[s] not in absorbed}:
                break
            time.sleep(0.002)
        if step >= 5:  # warmup: cold pools, first chaos window edge
            durs.append(time.monotonic() - t0)
        islands.adaptive_step()
        time.sleep(0.003)
    return (rank, durs)


def _pooled_p99_ms(durs) -> float:
    durs = sorted(durs)
    return durs[min(len(durs) - 1, int(round(0.99 * (len(durs) - 1))))] \
        * 1000.0


def _run_straggler_once(nprocs, steps, delay_s, adaptive_on,
                        device="cuda") -> float:
    from bluefog_tpu_torch import islands
    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.resilience import chaos

    job = f"strag{os.getpid()}{'a' if adaptive_on else 'o'}"
    keys = ("BFTPU_ADAPTIVE", "BFTPU_EDGE_DEADLINE_S")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["BFTPU_ADAPTIVE"] = "1" if adaptive_on else "0"
    os.environ["BFTPU_EDGE_DEADLINE_S"] = "0.2"
    chaos.schedule_slow(os.environ, rank=nprocs - 1, step=5,
                        delay_s=delay_s)
    try:
        res = islands.spawn(_straggler_worker, nprocs, job=job,
                            timeout=300.0, args=(steps, device))
    finally:
        chaos.clear_schedule()
        shm_native.unlink_all(job, ["st"])
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    healthy = [d for rank, ds in res if rank != nprocs - 1 for d in ds]
    return _pooled_p99_ms(healthy)


def measure_straggler(nprocs: int = 4, steps: int = 30,
                      delay_s: float = 0.6, device: str = "cuda") -> dict:
    """One rank sleeps ``delay_s`` per round (gray failure: heartbeats
    keep flowing) while the others run synchronous gossip steps; return
    the metric dict with ``value`` = pooled healthy-rank step p99 in ms
    with the adaptive control loop ON (bench.py's ``straggler_p99_ms``
    headline), plus the adaptive-OFF p99 for the contrast.  ON is
    bounded by the edge deadline (ABSORB) and then by the demotion that
    drops the straggler's edges; OFF eats the nap every round."""
    on_ms = _run_straggler_once(nprocs, steps, delay_s, adaptive_on=True,
                                device=device)
    off_ms = _run_straggler_once(nprocs, steps, delay_s, adaptive_on=False,
                                 device=device)
    return {
        "metric": f"healthy-rank synchronous gossip step p99 with one "
                  f"{delay_s * 1000:.0f} ms straggler "
                  f"(exp2, {nprocs} procs, shm mailbox, adaptive on)",
        "value": round(on_ms, 1),
        "unit": "ms",
        "adaptive_off_p99_ms": round(off_ms, 1),
        "straggler_delay_ms": round(delay_s * 1000.0, 1),
        "steps": steps,
        "ranks_pooled": nprocs - 1,
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="rank 0's window device (default: the card)")
    dev = ap.parse_args().device
    print(json.dumps({"recovery": measure_recovery(device=dev),
                      "join": measure_join(device=dev),
                      "partition": measure_partition(device=dev),
                      "straggler": measure_straggler(device=dev)}))
