"""Benchmark headline: ResNet-50 decentralized-SGD throughput, img/s/chip.

Counterpart of the repo root's ``bench.py``: decentralized SGD by ATC
``neighbor_allreduce`` on ``ExponentialTwoGraph`` against the framework's
own gradient ``allreduce`` on the same hardware; ``vs_baseline`` is that
ratio.  Both phases and a bare forward + backward (the session ceiling)
are timed by the paired-slope estimator in interleaved passes, adaptively
until the two smallest times of each phase agree within 3%.  Then the
optional phases run, in the reference's order and with its arguments, each
through its port twin while the wall-clock budget lasts: the win_put
bandwidths, the observability overheads, the resilience and serving
headlines, the wire.

One card holds all ``BENCH_RANKS`` virtual ranks side by side (rank-major
tensors), where the reference ran one rank a chip; so ``value`` is
``ranks x batch / step seconds``, every image the card trained in a second,
and the session ceiling is the bare forward + backward of all the ranks'
models.  With every rank on one card, ``vs_baseline`` weighs the combine
(one gather a shift class) against the allreduce's mean, not a wire.

Environment knobs, the reference's, with its two sets of defaults (the
card's / the CPU's): ``BENCH_BATCH`` (128 / 2 a rank), ``BENCH_STEPS``
(20 / 3), ``BENCH_WARMUP`` (2 / 1), ``BENCH_STEPS_PER_CALL`` (1),
``BENCH_BUDGET_S`` (480), ``BENCH_MAX_PASSES`` (10); and ``BENCH_RANKS``
(4 / 8), the port's counterpart of the reference's device count.  On the
card the model is ResNet-50 at 224 x 224 with 1000 classes; on the CPU
ResNet-18 at 16 x 16 with 8 filters and 10 classes.  Weights come from a
seeded ``torch.Generator``, images and labels from
``np.random.default_rng(0)``, as the reference's.

Run:  python -m bluefog_tpu_torch.bench [--device cpu]
      python -m bluefog_tpu_torch.bench --trend [--dir D ...]

Prints ONE line of JSON on stdout (schema ``bftpu-bench/1``); everything
else goes to stderr.  ``--trend`` is the regression gate over frozen
``BENCH_r*.json`` records in the ``--dir`` directories.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.benchmarks import gossip_bandwidth, island_overlap, recovery, serving
from bluefog_tpu_torch.models import ResNet18, ResNet50
from bluefog_tpu_torch.optim import CommunicationType
from bluefog_tpu_torch.profiling import (
    measure_rtt,
    paired_slope,
    robust_min,
    throughput_range,
)
from bluefog_tpu_torch.training import (
    make_classifier_apply_fn,
    make_decentralized_train_step,
    replicate_for_mesh,
    softmax_cross_entropy,
)


def build(comm_type: CommunicationType, model: torch.nn.Module, plan,
          params: Dict[str, torch.Tensor], batch_stats: Dict[str, torch.Tensor],
          steps_per_call: int = 1) -> Tuple[Callable, Callable]:
    """``(step_fn, reset)``: the train step (momentum SGD, lr 0.1, 0.9, with
    batch statistics) over the phase's own copies of the rank-major
    ``params`` and ``batch_stats``, which it never writes; ``reset()`` puts
    those copies back to them and clears the momentum, so every pass of
    every phase starts from the same state."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    stats = {k: v.detach().clone() for k, v in batch_stats.items()}
    opt = torch.optim.SGD(list(leaves.values()), lr=0.1, momentum=0.9)
    step_fn = make_decentralized_train_step(
        make_classifier_apply_fn(model), leaves, opt, communication_type=comm_type,
        plan=plan, batch_stats=stats, steps_per_call=steps_per_call)

    @torch.no_grad()
    def reset():
        for k, v in leaves.items():
            v.copy_(params[k])
            v.grad = None
        for k, v in stats.items():
            v.copy_(batch_stats[k])
        opt.state.clear()

    return step_fn, reset


def _sync(loss: torch.Tensor) -> float:
    """Wait for the card, fetch the losses' sum and check it is finite."""
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    v = float(loss.float().sum())
    assert math.isfinite(v)
    return v


def time_steps(step_fn: Callable, reset: Callable, batch, labels, warmup: int,
               iters: int) -> Tuple[float, bool]:
    """Seconds a call (``steps_per_call`` steps) by the paired-slope
    estimator, from the phase's initial state; ``(per_call,
    used_fallback)``."""
    reset()
    loss = None
    for _ in range(warmup):
        loss, _ = step_fn(batch, labels)
    _sync(loss)

    def region(k):
        nonlocal loss
        t0 = time.perf_counter()
        for _ in range(k):
            loss, _ = step_fn(batch, labels)
        _sync(loss)
        return time.perf_counter() - t0

    return paired_slope(region, iters, "resnet", lambda: measure_rtt(loss))


def _min2_spread(ts: Sequence[float]) -> float:
    """Top-2 agreement of the minimum in percent; 0.0 for one pass (an
    ``inf`` would print a non-RFC ``Infinity``)."""
    s = sorted(ts)
    return (s[1] - s[0]) / s[0] * 100 if len(s) > 1 else 0.0


def _bare_step_fn(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                  batch_stats: Dict[str, torch.Tensor], x, y) -> Callable:
    """Every rank's forward and backward as the train step runs them, on
    copies of the initial state: no optimizer, no combine, no metrics."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    stats = {k: v.detach().clone() for k, v in batch_stats.items()}
    apply_fn = make_classifier_apply_fn(model)

    def bare_step():
        losses = []
        for p in leaves.values():
            p.grad = None
        for r in range(x.shape[0]):
            state = {k: v[r] for k, v in leaves.items()}
            state.update((k, b[r]) for k, b in stats.items())
            loss = softmax_cross_entropy(apply_fn(state, x[r]), y[r])
            loss.backward()
            losses.append(loss.detach())
        return torch.stack(losses)

    return bare_step


def headline_passes(on_card: bool, n: int, per_rank_batch: int, iters: int, warmup: int,
                    spc: int, budget_s: float, t_start: float, max_passes: int) -> Dict:
    """The ResNet phases: gossip, allreduce and the session ceiling in
    interleaved passes; their times, the spreads and the fallbacks."""
    img = 224 if on_card else 16
    nclass = 1000 if on_card else 10
    dev = bf.device()
    plan = bf.context().plan
    if on_card:
        # cuDNN picks its algorithms by measurement, inside the warm-up
        torch.backends.cudnn.benchmark = True
    gen = torch.Generator().manual_seed(0)
    if on_card:
        model = ResNet50(num_classes=nclass, device="cpu", generator=gen)
    else:
        model = ResNet18(num_classes=nclass, num_filters=8, small_images=True, device="cpu",
                         generator=gen)
    model = model.to(dev)
    params = replicate_for_mesh(dict(model.named_parameters()), n, requires_grad=False)
    batch_stats = replicate_for_mesh(dict(model.named_buffers()), n, requires_grad=False)
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(
        rng.normal(size=(n, per_rank_batch, img, img, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, nclass, size=(n, per_rank_batch))).to(dev)
    if spc > 1:
        # leading sub-step axis: the same synthetic batch each sub-step
        batch = batch[None].expand((spc,) + tuple(batch.shape))
        labels = labels[None].expand((spc,) + tuple(labels.shape))

    fallback_passes = 0

    def timed_pass(step, warm):
        nonlocal fallback_passes
        t, used_fallback = time_steps(step[0], step[1], batch, labels, warm, iters)
        fallback_passes += int(used_fallback)
        return t

    # decentralized (the metric), then the global-allreduce baseline
    step_dec = build(CommunicationType.neighbor_allreduce, model, plan, params, batch_stats,
                     steps_per_call=spc)
    dec_times = [timed_pass(step_dec, warmup)]
    step_ar = build(CommunicationType.allreduce, model, None, params, batch_stats,
                    steps_per_call=spc)
    ar_times = [timed_pass(step_ar, warmup)]

    # session ceiling: the bare forward + backward of every rank, timed by
    # the same estimator in the same interleaved passes
    bare_times: List[float] = []
    bare_pass = None
    try:
        bare_step = _bare_step_fn(model, params, batch_stats,
                                  batch[0] if spc > 1 else batch,
                                  labels[0] if spc > 1 else labels)
        loss0 = bare_step()
        _sync(loss0)

        def bare_region(k):
            t0 = time.perf_counter()
            ls = None
            for _ in range(k):
                ls = bare_step()
            _sync(ls)
            return time.perf_counter() - t0

        def bare_pass():
            nonlocal fallback_passes
            t, used_fb = paired_slope(bare_region, iters, "bare", lambda: measure_rtt(loss0))
            fallback_passes += int(used_fb)
            return t

        bare_times.append(bare_pass())
    except Exception as e:  # noqa: BLE001 -- the ceiling must not cost the headline
        bare_pass = None
        print(f"session-ceiling phase failed: {e!r}", file=sys.stderr)

    # adaptive interleaved passes: until the minimum of each phase is
    # reproduced within 3% by its second smallest, or the cap or budget ends
    for _ in range(max_passes - 1):
        enough = (len(dec_times) >= 4 and _min2_spread(dec_times) < 3.0
                  and _min2_spread(ar_times) < 3.0)
        if enough or time.perf_counter() - t_start > budget_s:
            break
        print(f"bench: pass {len(dec_times)} done at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr)
        dec_times.append(timed_pass(step_dec, 1))
        ar_times.append(timed_pass(step_ar, 1))
        if bare_pass is not None:
            try:
                bare_times.append(bare_pass())
            except Exception as e:  # noqa: BLE001
                bare_pass = None
                print(f"session-ceiling pass failed: {e!r}", file=sys.stderr)
    return {"dec_times": dec_times, "ar_times": ar_times, "bare_times": bare_times,
            "fallback_passes": fallback_passes}


def optional_phases(device: str, on_card: bool, n: int) -> List[Tuple[str, List]]:
    """``[(label, [(result name, thunk), ...]), ...]``: the reference's
    budget-guarded phases in its order and with its arguments, each through
    its port twin on ``device`` where the twin takes one; the rank-major
    win_put bandwidth stands where the SPMD one stood.  The thunks of one
    label run in one guard, as the reference's serving phase does."""
    gb, rv, sv = gossip_bandwidth, recovery, serving
    return [
        ("spmd bandwidth", [("bw_spmd", lambda: gb.measure_rank_major(
            n, 256.0 if on_card else 4.0, 60 if on_card else 10, 2, "exp2", device))]),
        ("island bandwidth", [("bw_isl", lambda: gb.measure_islands(
            nprocs=2, mb=16.0, iters=10, warmup=2))]),
        ("island protocol", [("bw_proto", lambda: gb.measure_island_protocol(
            mb=16.0, iters=40))]),
        ("telemetry overhead", [("tel", lambda: gb.measure_telemetry_overhead(nprocs=2))]),
        ("tracing overhead", [("trc", lambda: gb.measure_tracing_overhead(nprocs=2))]),
        ("statuspage overhead", [("spg", lambda: gb.measure_statuspage_overhead(nprocs=2))]),
        ("lab probe overhead", [("lab", lambda: gb.measure_lab_probe_overhead(
            device=device))]),
        ("monitor overhead", [("mon", lambda: gb.measure_monitor_overhead(device=device))]),
        ("recovery", [("rec", lambda: rv.measure_recovery(nprocs=4, device=device))]),
        ("join", [("jn", lambda: rv.measure_join(nprocs=4, device=device))]),
        ("partition", [("part", lambda: rv.measure_partition(nprocs=4, device=device))]),
        ("straggler", [("strag", lambda: rv.measure_straggler(nprocs=4, device=device))]),
        ("overlap-hidden", [("ovh", lambda: island_overlap.measure_overlap_hidden(
            nprocs=2, rounds=10, mb=16.0, inner=8, device=device))]),
        ("tcp chunked-framing", [("tcpf", lambda: gb.measure_tcp_chunked(mb=4.0, iters=40))]),
        ("serving", [("sps", lambda: sv.measure_publish_swap(device=device)),
                     ("srate", lambda: sv.measure_serve_rate(device=device))]),
        ("serve load", [("lod", lambda: sv.measure_load(device=device))]),
        ("distrib", [("dst", lambda: sv.measure_distrib(device=device))]),
        ("wire compression", [("wcr", lambda: gb.measure_wire_compression(
            nprocs=2, wire_dtype="bf16"))]),
    ]


#: (phase result, ((headline key, the result's field), ...)), in the order
#: the reference writes them
HEADLINE_FIELDS = (
    ("bw_spmd", (("win_put_gossip_bandwidth_gbs", "value"),
                 ("win_put_bandwidth_metric", "metric"),
                 ("win_put_vs_neighbor_allreduce", "vs_baseline"))),
    ("bw_isl", (("island_win_put_gbs_per_rank", "value"),
                ("island_win_put_metric", "metric"),
                ("island_win_put_vs_raw_memcpy", "vs_raw_memcpy"),
                ("island_chunk_bytes", "chunk_bytes"),
                ("island_pipeline_depth", "pipeline_depth"))),
    ("bw_proto", (("island_protocol_ceiling_gbs", "value"),
                  ("island_protocol_vs_raw_memcpy", "vs_raw_memcpy"))),
    ("tel", (("telemetry_overhead_pct", "value"), ("telemetry_overhead_metric", "metric"))),
    ("trc", (("tracing_overhead_pct", "value"), ("tracing_overhead_metric", "metric"))),
    ("spg", (("statuspage_overhead_pct", "value"), ("statuspage_overhead_metric", "metric"))),
    ("lab", (("lab_probe_overhead_pct", "value"), ("lab_probe_overhead_metric", "metric"))),
    ("mon", (("monitor_overhead_pct", "value"), ("monitor_overhead_metric", "metric"))),
    ("rec", (("recovery_ms", "value"), ("recovery_metric", "metric"),
             ("recovery_failure_timeout_ms", "failure_timeout_ms"))),
    ("jn", (("join_ms", "value"), ("join_metric", "metric"),
            ("join_member_switch_range_ms", "member_switch_range_ms"))),
    ("part", (("partition_merge_ms", "value"), ("partition_metric", "metric"),
              ("partition_failure_timeout_ms", "failure_timeout_ms"),
              ("partition_consensus_spread", "consensus_spread"))),
    ("strag", (("straggler_p99_ms", "value"), ("straggler_metric", "metric"),
               ("straggler_p99_off_ms", "adaptive_off_p99_ms"))),
    ("ovh", (("overlap_hidden_pct", "value"), ("overlap_hidden_metric", "metric"),
             ("overlap_staging_bytes_saved", "staging_bytes_saved"),
             ("overlap_sync_op_ms", "sync_op_ms"),
             ("overlap_async_blocked_ms", "async_blocked_ms"))),
    ("tcpf", (("tcp_chunked_gbps", "value"), ("tcp_chunked_metric", "metric"),
              ("tcp_legacy_gbps", "legacy_gbs"))),
    ("sps", (("publish_swap_ms", "value"), ("publish_swap_metric", "metric"),
             ("publish_swap_poll_ms", "replica_poll_ms"))),
    ("srate", (("serve_rate_steps_s", "value"), ("serve_rate_metric", "metric"))),
    ("lod", (("serve_p99_idle_ms", "p99_idle_by_fleet_ms"),
             ("serve_p99_during_publish_ms", "p99_publish_by_fleet_ms"),
             ("serve_qps_sustained", "qps_by_fleet"), ("serve_load_metric", "metric"))),
    ("dst", (("distrib_all_swap_ms", "value"), ("distrib_metric", "metric"),
             ("distrib_delta_ratio", "delta_ratio_bf16"),
             ("distrib_all_swap_by_fleet_ms", "all_swap_ms"),
             ("distrib_tree_depth", "tree_depth"),
             ("distrib_publisher_feeds", "publisher_feeds"))),
    ("wcr", (("wire_compression_ratio", "value"), ("wire_compression_metric", "metric"),
             ("wire_raw_mb", "raw_mb"), ("wire_wire_mb", "wire_mb"))),
)


@contextlib.contextmanager
def _stdout_to_stderr():
    """Send file descriptor 1 to stderr for the block, children included:
    stdout carries the one headline line and nothing else."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m bluefog_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap


def run(device: str) -> Dict:
    """The headline dict (everything but the printing)."""
    on_card = torch.device(device).type == "cuda"
    n = int(os.environ.get("BENCH_RANKS", 4 if on_card else 8))
    per_rank_batch = int(os.environ.get("BENCH_BATCH", 128 if on_card else 2))
    iters = int(os.environ.get("BENCH_STEPS", 20 if on_card else 3))
    warmup = int(os.environ.get("BENCH_WARMUP", 2 if on_card else 1))
    # k steps a call; the paired slope reads k=1 and k=2 alike, so 1
    spc = max(int(os.environ.get("BENCH_STEPS_PER_CALL", 1)), 1)
    iters = max(iters // spc, 3)
    # wall-clock guard over the optional phases and the extra passes
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 480))
    max_passes = int(os.environ.get("BENCH_MAX_PASSES", 10))
    t_start = time.perf_counter()

    bf.init(topology_util.ExponentialTwoGraph(n), size=n, device=device)
    try:
        p = headline_passes(on_card, n, per_rank_batch, iters, warmup, spc, budget_s,
                            t_start, max_passes)
    finally:
        bf.shutdown()
    if on_card:
        torch.cuda.empty_cache()  # the models' memory, before the optional phases
    dec_times, ar_times, bare_times = p["dec_times"], p["ar_times"], p["bare_times"]
    t_dec = robust_min(dec_times, "dec")
    t_ar = robust_min(ar_times, "allreduce")
    # spread_pct: reproducibility of the min (top-2 agreement, what the
    # adaptive loop drives < 3); spread_all_pct: the full range
    spread_pct = max(_min2_spread(dec_times), _min2_spread(ar_times))
    spread_all_pct = max(
        (max(dec_times) - min(dec_times)) / min(dec_times),
        (max(ar_times) - min(ar_times)) / min(ar_times),
    ) * 100
    images = n * per_rank_batch  # every rank's batch, all on this chip
    imgs_per_sec_chip = images * spc / t_dec
    ceiling_img_s = ratio_to_ceiling = None
    if bare_times:
        ceiling_img_s = images / robust_min(bare_times, "bare")
        ratio_to_ceiling = imgs_per_sec_chip / ceiling_img_s
    ratio = t_ar / t_dec  # > 1: the gossip step is faster than allreduce

    print(f"bench: resnet passes done at {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    results: Dict[str, Dict] = {}
    for label, thunks in optional_phases(device, on_card, n):
        if time.perf_counter() - t_start >= budget_s:
            print(f"bench: {label} phase skipped: the budget of {budget_s:g} s is spent",
                  file=sys.stderr)
            continue
        t_phase = time.perf_counter()
        try:
            for name, thunk in thunks:
                results[name] = thunk()
                print(json.dumps(results[name]), file=sys.stderr)
        except Exception as e:  # noqa: BLE001 -- a phase must not cost the headline
            print(f"{label} phase failed: {e!r}", file=sys.stderr)
        print(f"bench: {label} phase {time.perf_counter() - t_phase:.1f} s", file=sys.stderr)

    try:
        from bluefog_tpu_torch.lab.sweep import provenance
        prov = provenance()
    except Exception:  # noqa: BLE001 -- the stamp must never cost the run
        prov = None
    where = "one GPU" if on_card else "the CPU"
    headline = {
        "schema": "bftpu-bench/1",
        "provenance": prov,
        "metric": (f"ResNet-50 images/sec/chip (neighbor_allreduce exp2, {n} virtual ranks "
                   f"on {where})" if on_card else
                   f"ResNet-18-tiny images/sec/chip (neighbor_allreduce exp2, {n} virtual "
                   f"ranks on {where})"),
        "value": round(imgs_per_sec_chip, 2),
        "unit": "img/s/chip",
        "vs_baseline": round(ratio, 4),
        "estimator": "paired-slope",
        "estimator_fallbacks": p["fallback_passes"],
        "spread_pct": round(spread_pct, 2),
        "spread_all_pct": round(spread_all_pct, 2),
        "passes": len(dec_times),
        "range": throughput_range(dec_times, images * spc),
        "vs_baseline_note": (f"one chip holds all {n} ranks: the ratio weighs the combine "
                             "(one gather a shift class) against the allreduce's mean, "
                             "not a wire"),
    }
    if ceiling_img_s is not None:
        headline["session_ceiling_img_s"] = round(ceiling_img_s, 2)
        headline["ratio_to_session_ceiling"] = round(ratio_to_ceiling, 4)
    for name, fields in HEADLINE_FIELDS:
        if name in results:
            for key, field in fields:
                headline[key] = results[name][field]
    return headline


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    with _stdout_to_stderr():
        headline = run(args.device)
    print(json.dumps(headline), flush=True)
    return 0


# ---------------------------------------------------------------------------
# --trend: regression gate over frozen BENCH_r*.json records
# ---------------------------------------------------------------------------

#: headline keys where bigger is better (gate: the newest record must hold
#: >= TREND_DROP x the best of the last <= 3 priors carrying the key)
TREND_HIGHER = (
    "value",
    "win_put_gossip_bandwidth_gbs",
    "island_win_put_gbs_per_rank",
    "tcp_chunked_gbps",
    "serve_rate_steps_s",
)
#: latency keys where smaller is better (gate: <= TREND_RISE x the best --
#: minimum -- of the last <= 3 priors carrying the key)
TREND_LOWER = (
    "recovery_ms",
    "join_ms",
    "partition_merge_ms",
    "publish_swap_ms",
    "distrib_all_swap_ms",
)
TREND_DROP = 0.8    # > 20% throughput loss vs the recent best fails
TREND_RISE = 1.2    # > 20% latency growth vs the recent best fails


def _trend_values(doc: dict) -> dict:
    """Flatten one frozen record to ``{headline_key: number}``.  Two shapes:
    the bench JSON line wrapped under "parsed", or per-headline dicts with
    a "value"."""
    out = {}
    for k, v in doc.items():
        if k in ("round", "n", "rc"):
            continue
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v)
        elif isinstance(v, dict) and isinstance(v.get("value"), (int, float)):
            out[k] = float(v["value"])
    parsed = doc.get("parsed")
    if isinstance(parsed, dict):
        for k, v in parsed.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = float(v)
    return out


def load_trend_corpus(dirs: Optional[Sequence[str]] = None) -> list:
    """The records ``BENCH_r<round>.json`` in ``dirs`` as ``(round, path,
    values)`` sorted by round.  Without ``dirs`` none: the repo's own
    records are the TPU's frozen rounds, no prior of this port."""
    import glob
    import re

    recs = []
    for d in dirs or ():
        for path in glob.glob(os.path.join(d, "BENCH_r*.json")):
            m = re.fullmatch(r"BENCH_r(\d+)\.json", os.path.basename(path))
            if not m:
                continue
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                print(f"trend: skipping unreadable {path}: {e}", file=sys.stderr)
                continue
            recs.append((int(m.group(1)), path, _trend_values(doc)))
    recs.sort(key=lambda r: r[0])
    return recs


def trend_main(argv: Optional[Sequence[str]] = None) -> int:
    """``--trend``: exit 1 when a gated headline of the NEWEST record
    regressed > 20% against the best of the last <= 3 prior records that
    carry the key.  Keys a record lacks are skipped."""
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.bench --trend",
        description="regression gate over frozen BENCH_r*.json records")
    ap.add_argument("--dir", action="append", default=None,
                    help="corpus directory (repeatable; default: none)")
    args = ap.parse_args(argv)

    recs = load_trend_corpus(args.dir)
    if len(recs) < 2:
        print(f"trend: {len(recs)} frozen record(s) — nothing to gate")
        return 0
    cur_round, cur_path, cur = recs[-1]
    priors = recs[:-1]
    print(f"trend: r{cur_round} ({os.path.basename(cur_path)}) vs "
          f"{len(priors)} prior record(s)")
    failures = []
    for key, higher in ([(k, True) for k in TREND_HIGHER]
                        + [(k, False) for k in TREND_LOWER]):
        if key not in cur:
            continue
        hist = [(rno, vals[key]) for rno, _p, vals in priors if key in vals][-3:]
        if not hist:
            print(f"  {key:<34s} {cur[key]:>12g}  (no prior — baseline)")
            continue
        ref = (max if higher else min)(v for _r, v in hist)
        bound = ref * (TREND_DROP if higher else TREND_RISE)
        ok = cur[key] >= bound if higher else cur[key] <= bound
        arrow = ">=" if higher else "<="
        print(f"  {key:<34s} {cur[key]:>12g}  {arrow} {bound:g} "
              f"(best {ref:g} over r{hist[0][0]}..r{hist[-1][0]})"
              f"  {'ok' if ok else 'REGRESSED'}")
        if not ok:
            failures.append(key)
    if failures:
        print(f"trend: FAIL — {len(failures)} gated headline(s) "
              f"regressed > 20%: {failures}")
        return 1
    print("trend: OK — no gated headline regressed > 20%")
    return 0


if __name__ == "__main__":
    if "--trend" in sys.argv[1:]:
        sys.exit(trend_main([a for a in sys.argv[1:] if a != "--trend"]))
    sys.exit(main())
