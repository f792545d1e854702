"""Slope timing and the shared slope estimators.

Counterpart of ``bluefog_tpu/profiling.py`` (``slope_time``,
``slope_time_fused``, ``segment_times``) together with a copy of the
estimators that ``bench.py`` shares between the JAX package's benchmarks
(``paired_slope``, ``conservative_delta``, ``subtract_rtt``, ``robust_min``,
``throughput_range``, ``measure_rtt``), with the same rules and the same
``(seconds, used_fallback)`` contract.

Where the timed work runs on a CUDA tensor, each timed run is bracketed by
two ``torch.cuda.Event``s on the current stream and ends in
``torch.cuda.synchronize()`` (the counterpart of ``device_sync``); the
events read the card's own clock, so the host's sync round trip is not in
the reading.  On the CPU the clock is ``time.perf_counter``; such a time
says how fast the host ran and is never a device number.

:func:`device_profile` reads a ``torch.profiler`` trace of one step: device
time by kernel name, and the device's busy time and idle share on the
trace's own timeline (:func:`device_timeline`).

Not ported: ``cost_summary`` and ``cost_delta`` read XLA's compiled cost
analysis (flops and bytes of a jitted program).  PyTorch runs eagerly and
has no compiled program whose costs it reports, so there is nothing to port.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["slope_time", "slope_time_fused", "segment_times", "timed_region",
           "graph_seconds", "paired_slope", "conservative_delta", "subtract_rtt",
           "robust_min", "throughput_range", "measure_rtt", "device_profile",
           "device_timeline"]


def _on_cuda(obj) -> bool:
    """True if ``obj`` is, or holds, a CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (list, tuple)):
        return any(_on_cuda(x) for x in obj)
    if isinstance(obj, dict):
        return any(_on_cuda(x) for x in obj.values())
    return False


def timed_region(run: Callable[[], object], cuda: bool) -> float:
    """Seconds that ``run()`` takes: between two CUDA events on the current
    stream, synchronized after, when ``cuda``; else on the host clock."""
    if not cuda:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e-3


def graph_seconds(fn: Callable[[], object], calls: int = 50, repeats: int = 3) -> float:
    """Device seconds a call of ``fn()`` (work on the card) takes with no
    host work between calls: ``calls`` calls captured in one CUDA graph,
    the graph replayed between two events, the least of ``repeats``
    replays over ``calls``.  For a kernel shorter than its wrapper's host
    time, where events around eager calls time the host."""
    fn()  # warm up (builds, attribute calls) outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return min(timed_region(graph.replay, cuda=True) for _ in range(repeats)) / calls


def _check_span(lo: int, hi: int, names: Tuple[str, str]) -> None:
    if hi <= lo:
        raise ValueError(f"{names[1]} ({hi}) must exceed {names[0]} ({lo})")


def slope_time(fn: Callable, args: Sequence = (), *, iters_lo: int = 3,
               iters_hi: int = 13, repeats: int = 2) -> float:
    """Per-call seconds of ``fn(*args)`` as the slope
    ``(T(iters_hi) - T(iters_lo)) / (iters_hi - iters_lo)``, each T the
    best of ``repeats`` timed runs of back-to-back calls.

    What cancels: the per-run cost (events, the final synchronize).  What
    does not: each call's host-side launch cost, wherever the card waits
    for the host, since the events then span the host's gaps too.  That is
    the honest number for a step-level segment.  The first call, outside
    the timed runs, decides the clock: the card's if the output holds a
    CUDA tensor or any argument is one."""
    _check_span(iters_lo, iters_hi, ("iters_lo", "iters_hi"))
    out = fn(*args)  # warm-up: builds, caches and allocator settle here
    cuda = _on_cuda(out) or _on_cuda(args)
    if cuda:
        torch.cuda.synchronize()

    def run(k):
        for _ in range(k):
            fn(*args)

    def timed(k: int) -> float:
        return min(timed_region(lambda: run(k), cuda) for _ in range(repeats))

    return (timed(iters_hi) - timed(iters_lo)) / (iters_hi - iters_lo)


def slope_time_fused(body: Callable, x, *, iters_lo: int = 4,
                     iters_hi: int = 24, repeats: int = 2) -> float:
    """Per-iteration seconds of ``x -> body(x)``, iterated: ``k`` bodies
    are queued back to back between two events with no host sync inside,
    each fed the previous one's output (what one jitted ``fori_loop``
    buys on the TPU).  ``body`` must return what it takes."""
    _check_span(iters_lo, iters_hi, ("iters_lo", "iters_hi"))
    cuda = _on_cuda(x)
    body(x)  # warm-up
    if cuda:
        torch.cuda.synchronize()

    def run(k):
        y = x
        for _ in range(k):
            y = body(y)

    def timed(k: int) -> float:
        return min(timed_region(lambda: run(k), cuda) for _ in range(repeats))

    return (timed(iters_hi) - timed(iters_lo)) / (iters_hi - iters_lo)


def segment_times(segments: Mapping[str, Tuple[Callable, Sequence]],
                  **slope_kwargs) -> Dict[str, float]:
    """Slope-time every named segment; returns ``{name: seconds}``.  Pass
    e.g. ``{"fwd": (fwd, a), "fwd_bwd": (grad, a), "step": (step, b)}``
    and read the differences (optimizer + gossip = step - fwd_bwd)."""
    return {name: slope_time(fn, args, **slope_kwargs)
            for name, (fn, args) in segments.items()}


# --------------------------------------------------------------------------
# The shared estimators (copied from bench.py; same rules)
# --------------------------------------------------------------------------


def paired_slope(region: Callable[[int], float], iters: int, label: str,
                 fallback_rt: Callable[[], float],
                 repeats: int = 1) -> Tuple[float, bool]:
    """Paired-slope per-call estimator.

    ``region(k)`` runs k back-to-back calls and one sync and returns their
    seconds.  Two regions (``iters // 2`` then ``iters`` calls) are timed;
    per call = ``(T_big - T_small) / (iters - iters // 2)``, which cancels
    the constant per-region cost exactly.  If the slope drowns in noise
    (non-positive in every round), it falls back to the guarded RTT
    subtraction of the best big region; ``fallback_rt`` is a zero-argument
    callable so the round trip is measured only on that path.

    With ``repeats`` > 1 the rounds go through :func:`conservative_delta`,
    which reports the larger (conservative) of its two statistics.

    Returns ``(per_call_seconds, used_fallback)``."""
    small = max(iters // 2, 1)
    if iters <= small:
        return subtract_rtt(region(iters), fallback_rt(), iters, label), True
    t_smalls, t_bigs = [], []
    for _ in range(repeats):
        t_smalls.append(region(small))
        t_bigs.append(region(iters))
    delta = conservative_delta(t_smalls, t_bigs)
    if delta is not None:
        return delta / (iters - small), False
    print(
        f"{label}: paired slope non-positive in all {repeats} round(s) "
        f"(deltas {[round((b - s) * 1e3, 1) for s, b in zip(t_smalls, t_bigs)]}"
        " ms) -- falling back to the guarded RTT-subtracted best big "
        "region; raise iters for a trustworthy slope",
        file=sys.stderr,
    )
    return subtract_rtt(min(t_bigs), fallback_rt(), iters, label), True


def conservative_delta(t_smalls, t_bigs) -> Optional[float]:
    """``max(min positive paired delta, min(t_bigs) - min(t_smalls))``, or
    None when both are non-positive (the caller decides the fallback).

    The min positive paired delta is deflated by a stall in a round's
    small region; the difference of minima can pair floors from different
    windows.  Each failure deflates the per-call time, so the larger of
    the two guards both."""
    cands = [d for d in (
        min((b - s for s, b in zip(t_smalls, t_bigs) if b - s > 0),
            default=-1.0),
        min(t_bigs) - min(t_smalls),
    ) if d > 0]
    return max(cands) if cands else None


def subtract_rtt(total: float, rt: float, iters: int, label: str = "") -> float:
    """Per-iteration time with the round trip ``rt`` subtracted, guarded:
    when the region does not dominate the round trip the subtraction is
    jitter, so warn and return the unsubtracted (conservative) figure."""
    if total < 2.0 * rt:
        print(
            f"rtt-subtraction skipped{' (' + label + ')' if label else ''}: "
            f"timed region {total * 1e3:.1f} ms < 2x RTT {rt * 1e3:.1f} ms "
            "-- raise iters for a trustworthy number (reported figure is "
            "conservative, RTT included)",
            file=sys.stderr,
        )
        return total / iters
    return (total - rt) / iters


def robust_min(ts: Sequence[float], label: str = "") -> float:
    """The throughput-defining minimum, guarded on the low side: a stall in
    a pass's small region deflates that pass's paired-slope time, and a
    plain ``min`` would pick it.  Where the second smallest does not
    reproduce the smallest within 3%, the second smallest is reported."""
    s = sorted(ts)
    if len(s) >= 2 and (s[1] - s[0]) / s[0] > 0.03:
        print(
            f"robust-min{' (' + label + ')' if label else ''}: smallest "
            f"pass {s[0] * 1e3:.1f} ms not reproduced by 2nd "
            f"{s[1] * 1e3:.1f} ms within 3% -- reporting the 2nd "
            "(guards stall-deflated slopes)",
            file=sys.stderr,
        )
        return s[1]
    return s[0]


def throughput_range(times: Sequence[float], scale: float) -> list:
    """``[lo, hi]`` throughput (``scale`` / seconds) over the passes."""
    return [round(scale / max(times), 2), round(scale / min(times), 2)]


def measure_rtt(x: torch.Tensor, n: int = 3) -> float:
    """Seconds of one synchronization round trip on the materialized tensor
    ``x``, the mean of ``n``: ``torch.cuda.synchronize()`` and a scalar
    fetch of ``x`` on the card, the scalar fetch alone (host clock, no
    device) on the CPU.  The fallback of :func:`paired_slope`."""
    t0 = time.perf_counter()
    for _ in range(n):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        x.reshape(-1)[0].item()
    return (time.perf_counter() - t0) / n


def device_timeline(prof) -> Dict:
    """Busy time and span of the device in the traced step, from the trace's
    own timeline: the union of kernel, memcpy and memset intervals, over the
    time from the first device operation's start to the last one's end."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, spans[0][0] if spans else 0.0
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    span_us = end - spans[0][0] if spans else 0.0
    return {"device_ops": len(spans), "device_union_busy_ms": busy_us / 1e3,
            "device_span_ms": span_us / 1e3,
            "idle_share": 1.0 - busy_us / span_us if span_us else None}


def device_profile(prof, wall_ms: float, top: int = 15) -> Dict:
    """Device time by kernel name from a torch.profiler trace of one step,
    and the device's idle share on the trace's own timeline.

    ``flash_ms_launches`` sums each flash kernel over its head dims and its
    bf16 and f32 instances (a step runs one of the two; its dtype says
    which).  ``gemm_ms_launches`` sums the GEMM kernels by name: ``ffma``
    those on the f32 FFMA route (``sgemm``, ``ffma``), ``other`` the rest
    (the tensor-core GEMMs)."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        # user annotations (e.g. "Optimizer.step#AdamW.step") span kernels
        # already counted under their own names
        if (e.device_type.name == "CUDA" and dev_us > 0
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    # the flash kernels by name, whether or not they make the top rows
    flash = {k: [0.0, 0] for k in ("fwd", "dkv", "dq")}
    gemm = {k: [0.0, 0] for k in ("ffma", "other")}
    for name, ms, n in rows:
        found = re.search(r"\b(fwd|dkv|dq)(?:_f32)?_kernel<", name)
        if found:
            flash[found.group(1)][0] += ms
            flash[found.group(1)][1] += n
        elif re.search(r"gemm|nvjet", name, re.IGNORECASE):
            kind = "ffma" if re.search(r"sgemm|ffma", name) else "other"
            gemm[kind][0] += ms
            gemm[kind][1] += n
    return {"wall_ms": wall_ms, **device_timeline(prof),
            "flash_ms_launches": flash, "gemm_ms_launches": gemm,
            "top": [[name[:90], ms, n] for name, ms, n in rows[:top]]}
