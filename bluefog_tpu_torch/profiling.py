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

:func:`cost_summary` and :func:`cost_delta` count the work of one eager
call the way XLA's ``HloCostAnalysis`` counts a compiled program: a
``TorchDispatchMode`` sees every aten op that the call runs and applies
XLA's rules to it (the rules and what they cover are in
:func:`cost_summary`).  As in the reference, ``bytes accessed`` is the
unfused operand-plus-result count: valid for deltas between programs, not
as the traffic a program puts on the memory.  Neither package counts a
hand-written kernel's own work: the reference's Pallas calls carry no
``cost_estimate``, and a kernel the port launches through ctypes (the
flash kernels inside ``_FlashCore``) runs no aten op the mode could see.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["slope_time", "slope_time_fused", "segment_times", "timed_region",
           "graph_seconds", "paired_slope", "conservative_delta", "subtract_rtt",
           "robust_min", "throughput_range", "measure_rtt", "device_profile",
           "device_timeline", "cost_summary", "cost_delta"]


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

    ``flash_ms_launches`` sums each flash kernel over its head dims (the
    wide kernels above 256 too) and its bf16, f16 and f32 instances (a step
    runs one dtype; it says which).
    ``gemm_ms_launches`` sums the GEMM kernels by name: ``ffma``
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
        found = re.search(r"\b(fwd|dkv|dq)(?:_wide)?(?:_f32)?_kernel[<(]", name)
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


# --------------------------------------------------------------------------
# Cost summaries: XLA's HloCostAnalysis rules over the eager aten ops
# --------------------------------------------------------------------------

# Each rule is XLA's count of the reference's HLO ops for the same function,
# each op counted once: a producer that XLA's fusion pass duplicates into
# several consumer fusions (and so counts in each) is counted once here.

# one flop per output element (XLA's elementwise ops, compares and selects)
_ELEMENTWISE = frozenset((
    "abs", "add", "ceil", "clamp", "clamp_max", "clamp_min", "div", "eq", "floor",
    "fmod", "ge", "gt", "le", "logical_and", "logical_not", "logical_or", "lt", "maximum",
    "minimum", "mul", "ne", "neg", "reciprocal", "relu", "remainder", "round", "rsub",
    "sign", "sub", "trunc", "where"))
# (flops, transcendentals) per output element
_PER_ELEMENT = {
    "acos": (0, 1), "asin": (0, 1), "atan": (0, 1), "atan2": (0, 1), "cos": (0, 1),
    "erf": (0, 1), "erfc": (0, 1), "erfinv": (0, 1), "exp": (0, 1), "exp2": (0, 1),
    "expm1": (0, 1), "log": (0, 1), "log10": (0, 1), "log1p": (0, 1), "log2": (0, 1),
    "rsqrt": (0, 1), "sin": (0, 1), "sqrt": (0, 1), "tan": (0, 1), "tanh": (0, 1),
    # XLA's CPU pipeline expands the logistic into neg, exp, add, divide
    "sigmoid": (3, 1), "silu": (4, 1),
    # a + w * (b - a)
    "lerp": (3, 0),
    # backward ops as XLA counts jax's derivatives: tanh's (g + g * y) * (1 - y),
    # the logistic's g * y * (1 - y), ReLU's compare and select, silu's product
    # rule over the forward's logistic
    "tanh_backward": (4, 0), "sigmoid_backward": (3, 0), "threshold_backward": (2, 0),
    "silu_backward": (6, 0)}
# input elements - output elements (a reduce), plus one divide an output for mean
_REDUCTIONS = frozenset(("all", "amax", "amin", "any", "max", "mean", "min", "nansum", "prod",
                         "sum"))
# no data is read or written: views, aliases, allocation and metadata
_NO_WORK = frozenset((
    "_local_scalar_dense", "_reshape_alias", "_unsafe_view", "alias", "detach", "empty",
    "empty_like", "empty_strided", "lift_fresh", "new_empty", "new_empty_strided",
    "resize_", "set_"))
# ops whose first argument is written without being read
_WRITE_ONLY_SELF = frozenset((
    "bernoulli_", "copy_", "exponential_", "fill_", "normal_", "random_", "uniform_",
    "zero_"))
_BATCH_NORM = frozenset((
    "native_batch_norm", "_native_batch_norm_legit", "_native_batch_norm_legit_no_training",
    "_batch_norm_with_update", "_batch_norm_no_update", "cudnn_batch_norm"))
_BATCH_NORM_BACKWARD = frozenset((
    "native_batch_norm_backward", "batch_norm_backward", "cudnn_batch_norm_backward"))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _arg(func, args, kwargs, name: str, default=None):
    """Argument ``name`` of an aten call, by its place in the schema."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            if a.name in kwargs:
                return kwargs[a.name]
            return args[i] if i < len(args) else default
    return default


def _valid_taps(size: int, out: int, kernel: int, stride: int, pad: int,
                dilation: int, real: Tuple[int, int]) -> int:
    """Window taps, summed over the output positions of one spatial dim,
    that land on a real input element: not on the convolution's own
    padding ``pad`` nor on the ``real = (lo, hi)`` zeros that a separate pad
    op put around the input of extent ``size`` (XLA's convolution count)."""
    lo, hi = real[0], size - real[1]
    return sum(1 for o in range(out) for t in range(kernel)
               if lo <= o * stride + t * dilation - pad < hi)


class _CostCounter(TorchDispatchMode):
    """Adds up ``flops``, ``transcendentals`` and ``bytes accessed`` of every
    aten op run inside it (the rules are in :func:`cost_summary`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        # id -> (tensor, zero padding a constant_pad_nd put around it by
        # spatial dim from the last): a convolution of that tensor, or its
        # backward, skips those taps.  The tensor is held so that its id
        # stays its own for the call.
        self._padded: Dict[int, Tuple[torch.Tensor, list]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_WORK:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        read = ins[1:] if name in _WRITE_ONLY_SELF and ins else ins
        self.bytes += sum(t.numel() * t.element_size() for t in read + outs)
        self._count(func, name, args, kwargs, ins, outs)
        return out

    def _count(self, func, name, args, kwargs, ins, outs) -> None:
        base = name.rstrip("_")
        n_out = outs[0].numel() if outs else 0
        if base in _ELEMENTWISE or (base in ("max", "min") and len(ins) == 2):
            self.flops += n_out
        elif base in ("addcmul", "addcdiv"):
            # a + value * b * c (or / c): the scale is a multiply unless it is 1
            self.flops += n_out * (2 + (_arg(func, args, kwargs, "value", 1) != 1))
        elif base in _PER_ELEMENT:
            f, t = _PER_ELEMENT[base]
            self.flops += f * n_out
            self.transcendentals += t * n_out
        elif base == "pow":
            e = _arg(func, args, kwargs, "exponent")
            if isinstance(e, (int, float)) and float(e).is_integer():
                # an integer power is multiplies (and a divide if negative)
                self.flops += n_out * (max(abs(int(e)) - 1, 0) + (e < 0))
            else:
                self.transcendentals += n_out
        elif base in ("_to_copy", "copy"):
            # a convert is one flop an element, a plain copy none
            if ins and outs and ins[-1].dtype != outs[0].dtype:
                self.flops += n_out
        elif base in _REDUCTIONS:
            self.flops += ins[0].numel() - n_out + (n_out if base == "mean" else 0)
        elif base == "mm":
            (m, k), n = ins[0].shape, ins[1].shape[1]
            self.flops += 2 * m * k * n
        elif base in ("addmm", "baddbmm", "addmv"):
            a, b = ins[1], ins[2]
            self.flops += 2 * a.numel() * (b.shape[-1] if b.dim() > 1 else 1) + n_out
        elif base == "bmm":
            (bs, m, k), n = ins[0].shape, ins[1].shape[2]
            self.flops += 2 * bs * m * k * n
        elif base in ("mv", "dot", "vdot"):
            self.flops += 2 * ins[0].numel()
        elif base == "constant_pad_nd":
            pad = list(_arg(func, args, kwargs, "pad"))
            if _arg(func, args, kwargs, "value", 0) == 0 and all(p >= 0 for p in pad):
                prior = self._padded.get(id(ins[0]), (None, ()))[1]
                pairs = [(pad[i], pad[i + 1]) for i in range(0, len(pad), 2)]
                pairs += [(0, 0)] * (len(prior) - len(pairs))
                for i, (lo, hi) in enumerate(prior):
                    pairs[i] = (pairs[i][0] + lo, pairs[i][1] + hi)
                self._padded[id(outs[0])] = (outs[0], pairs)
        elif base == "convolution":
            self.flops += self._conv_flops(func, args, kwargs, ins[0], ins[1], outs[0])
            if _arg(func, args, kwargs, "bias") is not None:
                self.flops += n_out
        elif base == "convolution_backward":
            grad, x, w = ins[0], ins[1], ins[2]
            mask = _arg(func, args, kwargs, "output_mask")
            fwd = self._conv_flops(func, args, kwargs, x, w, grad)
            # the bias gradient is a reduce over all but the channel dim
            bias = grad.numel() - grad.shape[1] if mask[2] else 0
            self.flops += fwd * (int(mask[0]) + int(mask[1])) + bias
        elif base in _BATCH_NORM:
            x, c = ins[0], ins[0].shape[1]
            training = (base not in ("_native_batch_norm_legit_no_training",
                                     "_batch_norm_no_update")
                        and _arg(func, args, kwargs, "training", True))
            # XLA's count of flax's BatchNorm: training 6 flops an element and
            # 5 a channel (mean, variance, normalize, scale, shift), eval 3
            # and 2; one rsqrt a channel either way
            self.flops += (6 * x.numel() + 5 * c) if training else (3 * x.numel() + 2 * c)
            self.transcendentals += c
        elif base in _BATCH_NORM_BACKWARD:
            n, c = ins[1].numel(), ins[1].shape[1]
            # cudnn's backward is only ever the training one
            training = (base == "cudnn_batch_norm_backward"
                        or _arg(func, args, kwargs, "train", _arg(func, args, kwargs, "update")))
            # XLA's count of jax's derivative of flax's BatchNorm, each HLO
            # op once (the forward's rsqrt reused): training 8 flops an
            # element and 15 a channel, eval 4 an element less one a channel
            self.flops += 8 * n + 15 * c if training else 4 * n - c
        elif base == "native_layer_norm":
            x = ins[0]
            rows = x.numel() // max(math.prod(_arg(func, args, kwargs, "normalized_shape")), 1)
            # XLA's count of flax's LayerNorm: 7 flops an element, 4 and one
            # rsqrt a row
            self.flops += 7 * x.numel() + 4 * rows
            self.transcendentals += rows
        elif base in ("max_pool2d_with_indices", "max_pool2d", "avg_pool2d"):
            k = _arg(func, args, kwargs, "kernel_size")
            window = k[0] * (k[1] if len(k) > 1 else k[0])
            self.flops += n_out * (window if base == "avg_pool2d" else window - 1)
        elif base == "max_pool2d_with_indices_backward":
            k = _arg(func, args, kwargs, "kernel_size")
            window = k[0] * (k[1] if len(k) > 1 else k[0])
            # XLA's select-and-scatter: window^2 an output element
            self.flops += ins[0].numel() * window * window
        elif base in ("_softmax", "_log_softmax"):
            x = ins[0]
            rows = x.numel() // x.shape[_arg(func, args, kwargs, "dim")] if x.dim() else 1
            # max and sum reduces, subtract, then divide (softmax) or
            # subtract the log a row (log_softmax); one exp an element
            self.flops += 2 * (x.numel() - rows) + 2 * x.numel()
            self.transcendentals += x.numel() + (rows if base == "_log_softmax" else 0)

    def _conv_flops(self, func, args, kwargs, x, w, y) -> int:
        """2 x (output positions x window taps on real input) x input
        features a group x output features, over the batch."""
        stride = _arg(func, args, kwargs, "stride")
        padding = _arg(func, args, kwargs, "padding")
        dilation = _arg(func, args, kwargs, "dilation")
        groups = _arg(func, args, kwargs, "groups", 1)
        if _arg(func, args, kwargs, "transposed", False):
            # every input element is scattered over the window of each of
            # its group's output features (weight [in, out / groups, ...])
            return 2 * x.numel() * math.prod(w.shape[2:]) * w.shape[1]
        spatial = x.dim() - 2
        real = list(self._padded.get(id(x), (None, ()))[1])
        real = (real + [(0, 0)] * spatial)[:spatial][::-1]  # pads from the last dim
        taps = 1
        for d in range(spatial):
            taps *= _valid_taps(x.shape[2 + d], y.shape[2 + d], w.shape[2 + d],
                                stride[d] if len(stride) > d else stride[0],
                                padding[d] if len(padding) > d else padding[0],
                                dilation[d] if len(dilation) > d else dilation[0], real[d])
        return 2 * x.shape[0] * taps * w.shape[1] * w.shape[0]


def cost_summary(fn: Callable, args: Sequence = ()) -> Dict[str, float]:
    """``{"flops", "transcendentals", "bytes accessed"}`` of one eager call
    of ``fn(*args)``, counted as XLA's ``HloCostAnalysis`` counts the
    reference's compiled program on the CPU (the key names are XLA's),
    each op once: where XLA's fusion pass duplicates a producer into
    several consumers (batch norm's normalized input, a residual block's
    add) and counts it in each, the reference reads more (~1% on a ResNet
    forward, ~5% on its train step).

    ``fn`` runs once, for real, under a ``TorchDispatchMode``; include a
    ``backward()`` in it to count the gradient.  The rules, op by op:

    - a matrix product (``mm``, ``bmm``, ``addmm``'s product, and so
      ``linear`` and ``matmul``) is 2·M·N·K flops; ``addmm``'s bias add one
      an output element;
    - a convolution is 2 x output positions x window taps x input features a
      group x output features, counting only the taps that land on real
      input: not those on the convolution's padding, nor on the zeros a
      ``constant_pad_nd`` put around its input (flax's asymmetric "SAME");
      its backward counts that once for each of the input and weight
      gradients;
    - an elementwise arithmetic op, compare or select is one flop an output
      element, a dtype convert too; a reduce is input minus output elements,
      ``mean`` one divide more an output;
    - ``exp``, ``log``, ``tanh``, ``erf``, ``rsqrt``, ``sqrt``, a
      non-integer ``pow`` and the like are one transcendental an element and
      no flops; an integer ``pow`` is its multiplies; ``sigmoid`` is one
      transcendental and 3 flops (XLA's CPU pipeline expands the logistic);
    - batch norm, layer norm, max pooling and softmax count as XLA counts
      flax's decomposition of them (batch norm in training: 6 flops an
      element and 5 and one rsqrt a channel, whether the op is
      ``native_batch_norm`` or ``cudnn_batch_norm``);
    - a backward op counts as XLA counts jax's derivative of the forward
      (``tanh_backward`` 4 flops an element, ReLU's 2, batch norm's in
      training 8 an element and 15 a channel);
    - ``bytes accessed`` is the bytes of every op's tensor operands plus its
      results, unfused (an op that only writes its first argument does not
      read it; an op that XLA writes as two, such as ``baddbmm``'s product
      and add or ``avg_pool2d``'s sum and divide, counts its own operands
      and results only);
    - views, aliases, allocations and metadata ops count nothing.

    An op with no rule here counts its bytes only.  Work that runs no aten
    op (a kernel launched through ctypes) is not seen."""
    with _CostCounter() as counter:
        fn(*args)
    return {"flops": float(counter.flops), "transcendentals": float(counter.transcendentals),
            "bytes accessed": float(counter.bytes)}


def cost_delta(fn_a: Callable, fn_b: Callable, args_a: Sequence = (),
               args_b: Sequence = ()) -> Dict[str, float]:
    """``cost_summary(fn_b) - cost_summary(fn_a)`` per key: what a change
    adds (a layer, a gossip edge, an optimizer), where the unfused byte
    overcount cancels to first order."""
    a = cost_summary(fn_a, args_a)
    b = cost_summary(fn_b, args_b)
    return {k: b.get(k, 0.0) - a.get(k, 0.0) for k in sorted(set(a) | set(b))}
