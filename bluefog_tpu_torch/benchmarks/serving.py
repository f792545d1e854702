"""Serving benchmark: publish-to-hot-swap latency and steady serve rate.

The serving headline (docs/SERVING.md): a publisher commits versioned
weight snapshots into the job's double-buffered seqlock'd region
(``bluefog_tpu_torch.serve.snapshot``) while a replica process subscribes and
hot-swaps.  ``value`` is the median publish-complete to swap-complete
wall time in ms (bench.py's ``publish_swap_ms`` headline) — dominated
by the replica's poll cadence by construction, so the interesting part
is the margin above it (region read + crc + the reference flip).  The
replica keeps calling ``serve_step`` between swaps, so a run with
``served == 0`` (or any failed step) would falsify the zero-downtime
contract, not just slow the number down.

``time.monotonic`` is CLOCK_MONOTONIC, system-wide on Linux, so the
publisher's commit stamp and the replica's swap stamps share a clock
(the recovery benchmark's protocol).

Counterpart of the JAX package's ``benchmarks/serving.py``: the same four
arms, with the replicas' snapshots on ``device`` (the card by default)
and the publisher's payload a torch tensor there too (a card tensor is
staged to the host by the region's publish).  ``payload_model=
"resnet50"`` sizes the payload from ``models.resnet.ResNet50(
num_classes=1000)``'s own parameters (their flat f32 vector, built from a
seed) in place of ``payload_kb``.

Run: ``python -m bluefog_tpu_torch.benchmarks.serving [distrib | load]
[--device cpu] [--payload-model resnet50]`` (one JSON line).
"""

import os
import time

import numpy as np
import torch

_POLL_S = 0.0005


def _payload(payload_kb: int, payload_model, device, dtype=torch.float64):
    """(payload tensor on ``device``, label): the model's parameters, or
    ``payload_kb`` KB of ``dtype``."""
    if payload_model:
        from bluefog_tpu_torch.examples.serve_islands import flat_params

        t = flat_params(payload_model, 0).to(device)
        return t, f"{payload_model} ({t.numel() * 4 / 1e6:.1f} MB f32)"
    n = payload_kb * 1024 // torch.empty((), dtype=dtype).element_size()
    return torch.empty(n, dtype=dtype, device=device), f"{payload_kb} KB"


def _replica_worker(job, n_versions, q, device="cuda"):
    # tight subscribe cadence: the benchmark measures the swap path, not
    # the default production backoff
    os.environ["BFTPU_SERVE_BACKOFF_S"] = "0.001"
    from bluefog_tpu_torch.serve import Replica
    from bluefog_tpu_torch.serve.snapshot import SnapshotUnavailable

    rep = Replica(job, 0, publish_page=False, device=device)
    q.put(("up", os.getpid(), time.monotonic()))
    deadline = time.monotonic() + 120.0
    served = 0
    while rep.version < n_versions and time.monotonic() < deadline:
        try:
            if rep.poll_swap():
                q.put(("swap", rep.version, time.monotonic()))
        except SnapshotUnavailable:
            pass  # publisher not up yet: keep polling
        if rep.version:
            # zero-downtime evidence: the serve path keeps answering
            # between (and during) swaps, against whatever is installed
            rep.serve_step()
            served += 1
        time.sleep(_POLL_S)
    q.put(("installs", rep.installs, time.monotonic()))
    q.put(("done", served, time.monotonic()))


def measure_publish_swap(versions: int = 12, payload_kb: int = 64,
                         device: str = "cuda", payload_model=None) -> dict:
    """Publish ``versions`` snapshots while one replica process
    subscribes; return the metric dict with ``value`` = median
    publish-complete to hot-swap-complete ms (bench.py rides this in
    the headline's ``publish_swap_ms`` key), plus the replica's install
    split (region read + crc, host-to-device) and the publish call's
    own ms."""
    import multiprocessing as mp

    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.serve.snapshot import SnapshotRegion, region_path

    job = f"svb{os.getpid()}"
    payload, label = _payload(payload_kb, payload_model, device)
    nbytes = payload.numel() * payload.element_size()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_replica_worker,
                       args=(job, versions, q, device))
    region = SnapshotRegion(job, nbytes)
    lat_ms, pub_ms, installs = [], [], []
    shm_bytes = None
    served = None
    try:
        proc.start()
        tag, _pid, _t = q.get(timeout=300)
        assert tag == "up"
        for v in range(1, versions + 1):
            payload.fill_(float(v))
            t0 = time.monotonic()
            region.publish(payload, epoch=v, step=v)
            t_pub = time.monotonic()
            pub_ms.append((t_pub - t0) * 1000.0)
            tag, ver, t_swap = q.get(timeout=60)
            assert tag == "swap" and ver == v, (tag, ver, v)
            lat_ms.append(max(0.0, (t_swap - t_pub) * 1000.0))
        # the region's mapped size: both buffers of the payload
        shm_bytes = os.path.getsize(region_path(job))
        tag, installs, _t = q.get(timeout=60)
        assert tag == "installs", tag
        tag, served, _t = q.get(timeout=60)
        assert tag == "done" and served > 0, (tag, served)
    finally:
        proc.join(timeout=15)
        if proc.is_alive():
            proc.terminate()
        region.close()
        shm_native.unlink_all(job)
    lat_ms.sort()
    median = lat_ms[len(lat_ms) // 2]
    read_ms = sorted(i[1] for i in installs)
    h2d_ms = sorted(i[2] for i in installs)
    return {
        "metric": f"snapshot publish to replica hot-swap "
                  f"({label} payload, shm region, 1 replica on {device})",
        "value": median,
        "unit": "ms",
        # the subscribe floor: value - this = region read + crc + flip
        "replica_poll_ms": _POLL_S * 1000.0,
        "swap_range_ms": [lat_ms[0], lat_ms[-1]],
        "publish_ms_median": sorted(pub_ms)[len(pub_ms) // 2],
        "install_read_crc_ms_median": read_ms[len(read_ms) // 2],
        "install_h2d_ms_median": h2d_ms[len(h2d_ms) // 2],
        "payload_bytes": nbytes,
        "peak_shm_bytes": shm_bytes,
        "versions": versions,
        "served_steps_during": served,
    }


def measure_serve_rate(steps: int = 20000, payload_kb: int = 64,
                       device: str = "cuda", payload_model=None) -> dict:
    """Steady-state serve rate: one replica answering ``serve_step``
    against an installed snapshot (swap and serve are decoupled, so
    this is the pure serve-path cost — no region reads).  Each step is
    the snapshot-vector product on ``device``; the rate is read after
    the device has finished every step."""
    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.serve import Replica
    from bluefog_tpu_torch.serve.snapshot import SnapshotRegion

    job = f"svr{os.getpid()}"
    payload, label = _payload(payload_kb, payload_model, device)
    payload.fill_(1.0)
    region = SnapshotRegion(job, payload.numel() * payload.element_size())
    try:
        region.publish(payload)
        rep = Replica(job, 0, publish_page=False, device=device)
        assert rep.poll_swap()
        x = torch.ones_like(payload)
        for _ in range(50):  # warmup: cold caches, first matvec
            rep.serve_step(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            _, y = rep.serve_step(x)
        _sync(device)
        dt = time.perf_counter() - t0
        assert float(y) == float(payload.numel()), (float(y), payload.numel())
        rep.close()
    finally:
        region.close()
        shm_native.unlink_all(job)
    return {
        "metric": f"steady-state replica serve rate "
                  f"({label} snapshot matvec on {device}, no region reads)",
        "value": steps / dt,
        "unit": "steps/s",
        "steps": steps,
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_load(replica_counts=(4, 8), rate_hz: float = 200.0,
                 idle_s: float = 1.2, publish_period_s: float = 1.5,
                 publishes: int = 2, payload_kb: int = 64,
                 device: str = "cuda") -> dict:
    """Open-loop load arm (docs/SERVING.md "Measuring serve latency
    under churn"): Poisson arrivals at ``rate_hz`` per replica against
    K in-process replicas, once idle and once while the publisher
    commits on a ``publish_period_s`` cadence with a poller hot-swapping
    every replica between requests.

    Latency is charged from the SCHEDULED send instant
    (:mod:`bluefog_tpu_torch.serve.loadgen`), so a swap stall shows up as
    queueing delay on every overdue request instead of silently
    vanishing (coordinated omission).  ``value`` is the churn-phase
    p99 at the largest fleet (bench.py's
    ``serve_p99_during_publish_ms`` rides the per-fleet dict).
    """
    import threading

    from bluefog_tpu_torch.native import shm_native
    from bluefog_tpu_torch.serve import LoadGenerator, Replica
    from bluefog_tpu_torch.serve.snapshot import SnapshotRegion

    job = f"svl{os.getpid()}"
    payload = np.ones(payload_kb * 1024 // 8, np.float64)
    p99_idle, p99_pub, qps, p50_idle, p50_pub = {}, {}, {}, {}, {}
    region = SnapshotRegion(job, payload.nbytes)
    version = 0
    try:
        for k in replica_counts:
            version += 1
            payload.fill(float(version))
            region.publish(payload, epoch=version, step=version)
            reps = [Replica(job, i, publish_page=False, device=device)
                    for i in range(k)]
            try:
                for r in reps:
                    r.poll_swap()
                    assert r.version, "bootstrap install failed"
                idle = LoadGenerator(reps, rate_hz=rate_hz,
                                     schedule="poisson",
                                     duration_s=idle_s, seed=7).run()
                stop = threading.Event()

                def _publisher():
                    nonlocal version
                    for _ in range(publishes):
                        if stop.wait(publish_period_s):
                            return
                        version += 1
                        payload.fill(float(version))
                        region.publish(payload, epoch=version,
                                       step=version)

                def _poller():
                    while not stop.is_set():
                        for r in reps:
                            r.poll_swap()
                        time.sleep(0.001)

                churn_s = publishes * publish_period_s + 0.5
                gen = LoadGenerator(reps, rate_hz=rate_hz,
                                    schedule="poisson",
                                    duration_s=churn_s, seed=11)
                aux = [threading.Thread(target=t, daemon=True)
                       for t in (_publisher, _poller)]
                for t in aux:
                    t.start()
                churn = gen.run()
                stop.set()
                for t in aux:
                    t.join(timeout=10)
                # every request answered, none errored: the churn
                # phase would falsify zero-downtime with a single
                # failed serve_step, not just slow the tail down
                assert idle.requests and churn.requests, (k, idle, churn)
                bad = {o: n for o, n in churn.outcomes.items()
                       if o != "ok"}
                assert not bad, (k, bad)
                kk = str(k)
                p50_idle[kk] = round(idle.p50_ms, 3)
                p99_idle[kk] = round(idle.p99_ms, 3)
                p50_pub[kk] = round(churn.p50_ms, 3)
                p99_pub[kk] = round(churn.p99_ms, 3)
                qps[kk] = round(churn.qps, 1)
            finally:
                for r in reps:
                    r.close()
    finally:
        region.close()
        shm_native.unlink_all(job)
    top = str(replica_counts[-1])
    return {
        "metric": f"open-loop serve p99 under publish churn "
                  f"({payload_kb} KB snapshot, poisson "
                  f"{rate_hz:g} Hz/replica, {publish_period_s:g} s "
                  f"publish cadence, at {top} replicas on {device})",
        "value": p99_pub[top],
        "unit": "ms",
        "rate_hz": rate_hz,
        "publish_period_s": publish_period_s,
        "replica_counts": list(replica_counts),
        "p50_idle_by_fleet_ms": p50_idle,
        "p99_idle_by_fleet_ms": p99_idle,
        "p50_publish_by_fleet_ms": p50_pub,
        "p99_publish_by_fleet_ms": p99_pub,
        "qps_by_fleet": qps,
    }


def measure_distrib(replicas=(4, 8, 16), versions: int = 8,
                    payload_kb: int = 1024, device: str = "cuda") -> dict:
    """Distribution-plane arm (docs/SERVING.md "Cross-host
    distribution"): one publisher feeds K loopback ``TcpSource``
    replicas through the bounded-degree delta fan-out tree, for
    K in ``replicas``.

    ``value`` is the median publish-complete to ALL-replicas-swapped
    wall time in ms at the middle fleet size (bench.py's
    ``distrib_all_swap_ms``).  ``delta_ratio_bf16`` is the steady-state
    wire bytes a one-version-behind replica pulls divided by the raw
    f32 snapshot bytes — the < 0.6 acceptance gate, measured at the
    WORST case (every publish perturbs the whole buffer, so every
    chunk is dirty and the win is the bf16 wire codec alone; frame
    headers are charged against the delta, the wire-compression
    headline's policy).  ``sparse_delta_ratio_f32`` shows the dirty
    map's own multiplier, measured at f32 where chunk bytes are exact:
    a publish touching a quarter of the buffer ships a quarter of the
    raw bytes.  (At bf16 the error-feedback residual keeps evolving
    untouched chunks' canonical bytes — sigma-delta style — so the
    codec's 0.5x is the honest steady-state bf16 figure.)

    Tree-shape evidence is asserted, not just reported: depth stays
    within floor(log_fanout(K)) + 1 and the publisher holds at most
    ``fanout`` persistent feed sockets at every fleet size.

    Each ``TcpSource`` feeds a :class:`~bluefog_tpu_torch.serve.Replica`
    on ``device``, so a swap counts once the snapshot is installed there.
    """
    import math

    from bluefog_tpu_torch.native.tcp_transport import _HDR
    from bluefog_tpu_torch.serve import Replica
    from bluefog_tpu_torch.serve.distrib import tree as dtree
    from bluefog_tpu_torch.serve.distrib.feed import DistribPublisher
    from bluefog_tpu_torch.serve.distrib.sub import TcpSource

    fanout = 4
    saved = {k: os.environ.get(k)
             for k in ("BFTPU_WIRE_DTYPE", "BFTPU_DISTRIB_FANOUT")}
    os.environ["BFTPU_WIRE_DTYPE"] = "bf16"
    os.environ["BFTPU_DISTRIB_FANOUT"] = str(fanout)
    rng = np.random.default_rng(7)
    base = rng.standard_normal(payload_kb * 1024 // 4).astype(np.float32)
    all_swap, depth, feeds = {}, {}, {}
    ratio = sparse_ratio = delta_mb = None
    try:
        for k in replicas:
            pub = DistribPublisher(f"dsb{os.getpid()}k{k}", fanout=fanout)
            subs, reps = [], {}
            try:
                pub.publish(1, 0, 0, base)
                # join in replica order: slots (and so the tree shape)
                # are deterministic; the first poll is the bootstrap
                # full resync
                subs = [TcpSource(pub.addr_str, replica_id=i)
                        for i in range(k)]
                for i, s in enumerate(subs):
                    reps[s] = Replica(f"dsb{os.getpid()}k{k}", i, source=s,
                                      publish_page=False, device=device)
                    assert reps[s].poll_swap()
                lat = []
                for v in range(2, versions + 2):
                    arr = base + 0.01 * rng.standard_normal(
                        base.size).astype(np.float32)
                    pub.publish(v, 0, v, arr)
                    t0 = time.perf_counter()
                    # slot order: parents commit before their children
                    # poll, so one pass normally converges the fleet
                    for _ in range(5):
                        for s in sorted(subs, key=lambda s: s.slot):
                            reps[s].poll_swap()
                        if all(r.version == v for r in reps.values()):
                            break
                    assert all(s.store.version == v for s in subs)
                    assert all(r.version == v for r in reps.values())
                    lat.append((time.perf_counter() - t0) * 1000.0)
                lat.sort()
                all_swap[str(k)] = round(lat[len(lat) // 2], 2)
                d = dtree.tree_depth(pub.server.parents)
                bound = int(math.floor(math.log(k, fanout))) + 1
                assert d <= bound, (k, d, bound)
                depth[str(k)] = d
                # O(fanout) publisher sockets no matter the fleet size
                assert pub.server.live_feeds <= fanout, k
                feeds[str(k)] = pub.server.live_feeds
                # steady state rode the delta path: the bootstrap was
                # the only full resync anywhere in the tree
                assert all(s.resyncs == 1 for s in subs)
                if ratio is None:
                    head = pub.store.version
                    full, items, _ = pub.store.delta_since(head - 1)
                    assert not full
                    delta_b = sum(len(c[2]) + _HDR.size
                                  for _, c in items)
                    ratio = delta_b / base.nbytes
                    delta_mb = delta_b / 2 ** 20
            finally:
                for r in reps.values():
                    r.close()
                for s in subs:
                    s.close()
                pub.close()
        # dirty-map multiplier, f32 wire (exact chunk bytes, no
        # residual churn): touch a quarter of the buffer, ship a
        # quarter of the raw bytes
        from bluefog_tpu_torch.serve.distrib.delta import DeltaEncoder

        os.environ["BFTPU_WIRE_DTYPE"] = "f32"
        enc = DeltaEncoder()
        enc.publish(1, 0, 0, base)
        sparse = base.copy()
        sparse[:sparse.size // 4] += 0.5
        enc.publish(2, 0, 0, sparse)
        _, sitems, _ = enc.store.delta_since(1)
        sparse_ratio = sum(len(c[2]) + _HDR.size
                           for _, c in sitems) / base.nbytes
    finally:
        for kk, vv in saved.items():
            if vv is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = vv
    mid = str(replicas[len(replicas) // 2])
    return {
        "metric": f"distrib publish to all-replicas-swapped "
                  f"({payload_kb} KB snapshot, bf16 wire, fanout "
                  f"{fanout}, loopback tree, median at "
                  f"{mid} replicas on {device})",
        "value": all_swap[mid],
        "unit": "ms",
        "all_swap_ms": all_swap,
        "replicas": list(replicas),
        "fanout": fanout,
        "versions": versions,
        # the acceptance gate: one-behind delta wire bytes / raw f32
        # snapshot bytes, all chunks dirty (headers charged)
        "delta_ratio_bf16": round(ratio, 4),
        "delta_wire_mb": round(delta_mb, 3),
        "raw_full_mb": round(base.nbytes / 2 ** 20, 3),
        "sparse_delta_ratio_f32": round(sparse_ratio, 4),
        "tree_depth": depth,
        "publisher_feeds": feeds,
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arm", nargs="?", choices=("distrib", "load"),
                    help="run one arm only (default: all four)")
    ap.add_argument("--device", default="cuda",
                    help="the replicas' device (default: the card)")
    ap.add_argument("--payload-model", default=None, choices=("resnet50",),
                    help="size publish_swap / serve_rate's payload from "
                    "this model's parameters")
    a = ap.parse_args()
    if a.arm == "distrib":
        print(json.dumps({"distrib": measure_distrib(device=a.device)}))
    elif a.arm == "load":
        print(json.dumps({"load": measure_load(device=a.device)}))
    else:
        kw = dict(device=a.device, payload_model=a.payload_model)
        print(json.dumps({"publish_swap": measure_publish_swap(**kw),
                          "serve_rate": measure_serve_rate(**kw),
                          "distrib": measure_distrib(device=a.device),
                          "load": measure_load(device=a.device)}))
