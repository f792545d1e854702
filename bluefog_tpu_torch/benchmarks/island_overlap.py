"""Gossip/compute overlap of the island win-put optimizer.

Counterpart of ``benchmarks/island_overlap.py``.  The island twin of the
reference's background communication thread is
``islands.DistributedWinPutOptimizer(overlap=True)``: the rank's progress
engine runs the whole host side of a gossip round (device→host staging
through a pinned buffer, shm deposits, mailbox combine) while the card
computes the next gradients.

Rank 0 steps a compute-heavy model on the card (``tanh(y @ x)`` for
``inner`` steps at dim 2048, a plain ``torch.matmul``), rank 1 is a CPU
neighbor; both loop with overlap OFF then ON in one session and report the
per-step wall time, plus the device→host staging time per round for the
window payload.  ``--hidden`` runs the interleaved sync/async arms instead:
what fraction of the win-op latency the progress engine hides from the
caller (``hidden_pct``).

Run:  python -m bluefog_tpu_torch.benchmarks.island_overlap [--steps 30]
          [--mb 16] [--inner 200] [--hidden] [--device cuda|cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _rank_device(rank: int, device: str) -> torch.device:
    # neighbor ranks stay off the card (one card, one owner) and on two
    # host threads, so they do not crowd rank 0's host side
    if rank != 0:
        torch.set_num_threads(2)
    return torch.device(device if rank == 0 else "cpu")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _burn(x: torch.Tensor, inner: int) -> torch.Tensor:
    y = x
    for _ in range(inner):
        y = torch.tanh(y @ x)
    return y


def _worker(rank, size, steps, mb, inner, device):
    from bluefog_tpu_torch import islands, topology_util
    from bluefog_tpu_torch.progress import staging

    dev = _rank_device(rank, device)
    islands.set_topology(topology_util.RingGraph(size))
    elems = max(int(mb * 1e6 / 4), 1)
    dim = 2048
    w = torch.zeros(elems, dtype=torch.float32, device=dev, requires_grad=True)
    x = torch.full((dim, dim), 1e-3, dtype=torch.float32, device=dev)
    # rank 0 burns real device FLOPs per step; neighbors do a token amount
    my_inner = inner if rank == 0 else 1

    def compute():
        y = _burn(x, my_inner)
        # the gradient DEPENDS on the compute, so it cannot be skipped
        w.grad = w.detach() * 1e-4 + y[0, 0]

    out = {}
    for overlap in (False, True):
        opt = islands.DistributedWinPutOptimizer(
            torch.optim.SGD([w], lr=1e-2), window_prefix=f"ovl{int(overlap)}",
            overlap=overlap)
        compute()
        _sync(dev)
        islands.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            compute()
            opt.step()
        opt.finish()
        _sync(dev)
        out[f"step_ms_overlap_{'on' if overlap else 'off'}"] = (
            (time.perf_counter() - t0) / steps * 1e3)
        islands.barrier()
        opt.free()
    # device->host staging cost of the window payload (what the background
    # thread pays per round): the pinned-buffer path of progress/staging
    d2h = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        host = staging.stage(w, "d2h_probe")
        d2h.append((time.perf_counter() - t0) * 1e3)
    staging.release("d2h_probe")
    out["d2h_ms_per_round"] = float(np.median(d2h))
    out["payload_mb"] = host.nbytes / 1e6
    out["platform"] = dev.type
    out["device_name"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                          else "cpu")
    return out


def _worker_hidden(rank, size, rounds, mb, inner, device):
    """Interleaved sync/async arms for ``hidden_pct``.  Per round the sync
    arm times the blocking ``win_put`` + ``win_update`` pair; the async arm
    times only the caller-visible slice of the same pair through the
    engine — the submit calls plus the post-step handle wait — with the
    train step between them (the card computes while the worker drains).
    The arms alternate within one session, so drift cancels."""
    from bluefog_tpu_torch import islands, topology_util
    from bluefog_tpu_torch.telemetry import registry as _telemetry

    dev = _rank_device(rank, device)
    islands.set_topology(topology_util.RingGraph(size))
    elems = max(int(mb * 1e6 / 4), 1)
    w = torch.zeros(elems, dtype=torch.float32, device=dev)
    dim = 1024
    x = torch.full((dim, dim), 1e-3, dtype=torch.float32, device=dev)
    my_inner = inner if rank == 0 else 1

    def train_step(w):
        y = _burn(x, my_inner)
        return w + y[0, 0] * 1e-6

    islands.win_create(torch.zeros(elems, dtype=torch.float32, device=dev), "hid")
    w = train_step(w)
    _sync(dev)
    islands.win_put(w, "hid")
    islands.win_update("hid")
    islands.barrier()

    sync_s, blocked_s, step_s = [], [], []
    for _ in range(rounds):
        # sync arm: the full blocking op pair
        w = train_step(w)
        _sync(dev)
        t0 = time.perf_counter()
        islands.win_put(w, "hid")
        islands.win_update("hid")
        sync_s.append(time.perf_counter() - t0)
        # async arm: submit, step, then wait out whatever is left
        t0 = time.perf_counter()
        hp = islands.win_put_async(w, "hid")
        hu = islands.win_update_async("hid")
        submit = time.perf_counter() - t0
        t0 = time.perf_counter()
        w2 = train_step(w)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        hp.wait(60)
        hu.wait(60)
        blocked_s.append(submit + time.perf_counter() - t0)
        w = w2
    islands.barrier()
    eng = islands.progress_engine()
    stats = eng.stats() if eng is not None else {}
    reg = _telemetry.get_registry()
    saved = (int(reg.counter("progress.staging_bytes_saved").value)
             if reg.enabled else -1)
    d2h = (int(reg.counter("progress.staging_d2h_bytes").value)
           if reg.enabled else -1)
    islands.win_free("hid")
    sync = float(np.median(sync_s))
    blocked = float(np.median(blocked_s))
    return {
        "sync_op_ms": sync * 1e3,
        "async_blocked_ms": blocked * 1e3,
        "step_ms": float(np.median(step_s)) * 1e3,
        "hidden_pct": (1.0 - blocked / sync) * 100.0 if sync > 0 else 0.0,
        "params_m": elems / 1e6,
        "staging_bytes_saved": saved,
        "staging_d2h_bytes": d2h,
        "engine": stats,
        "platform": dev.type,
    }


def measure_overlap_hidden(nprocs=2, rounds=12, mb=16.0, inner=60,
                           device="cuda") -> dict:
    """``hidden_pct`` of rank 0 (the card's island), with telemetry on so
    the staging counters are part of the result."""
    from bluefog_tpu_torch import islands

    prev = os.environ.get("BFTPU_TELEMETRY")
    os.environ["BFTPU_TELEMETRY"] = "1"  # children inherit
    try:
        res = islands.spawn(_worker_hidden, nprocs,
                            args=(rounds, mb, inner, device), timeout=900.0)
    finally:
        if prev is None:
            os.environ.pop("BFTPU_TELEMETRY", None)
        else:
            os.environ["BFTPU_TELEMETRY"] = prev
    r0 = res[0]
    return {
        "metric": "win-op latency hidden by the progress engine "
                  "(rank0, caller-visible blocked time vs sync op)",
        "value": r0["hidden_pct"],
        "unit": "%",
        "hidden_pct": r0["hidden_pct"],
        "sync_op_ms": r0["sync_op_ms"],
        "async_blocked_ms": r0["async_blocked_ms"],
        "step_ms": r0["step_ms"],
        "payload_params_m": r0["params_m"],
        "staging_bytes_saved": r0["staging_bytes_saved"],
        "staging_d2h_bytes": r0["staging_d2h_bytes"],
        "fused_batches": r0["engine"].get("fused_batches", 0),
        "rounds": rounds,
        "rank0_platform": r0["platform"],
    }


def measure_overlap(steps=30, mb=16.0, inner=200, device="cuda") -> dict:
    """Rank 0's step time with overlap off and on, and the device→host
    staging time per round."""
    from bluefog_tpu_torch import islands
    from bluefog_tpu_torch.native import shm_native

    res = islands.spawn(_worker, 2, args=(steps, mb, inner, device), timeout=900.0)
    r0 = res[0]
    off, on = r0["step_ms_overlap_off"], r0["step_ms_overlap_on"]
    return {
        "metric": "island gossip/compute overlap (rank0 step time)",
        "step_ms_overlap_off": off,
        "step_ms_overlap_on": on,
        "overlap_gain_pct": (off - on) / off * 100 if off else 0.0,
        "d2h_ms_per_round": r0["d2h_ms_per_round"],
        "payload_mb": r0["payload_mb"],
        "rank0_platform": r0["platform"],
        "rank0_device": r0["device_name"],
        "transport": shm_native.island_transport(),
        "transport_kind": shm_native.transport_kind(),
        "chunk_bytes": shm_native.chunk_bytes(),
        "pipeline_depth": shm_native.pipeline_depth(),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mb", type=float, default=16.0)
    ap.add_argument("--inner", type=int, default=200,
                    help="matmul iterations per step on rank 0")
    ap.add_argument("--hidden", action="store_true",
                    help="run the hidden_pct arms instead of the optimizer "
                    "step-time comparison")
    ap.add_argument("--device", default="cuda", help="rank 0's device")
    args = ap.parse_args(argv)
    if args.hidden:
        out = measure_overlap_hidden(2, rounds=max(args.steps // 2, 4), mb=args.mb,
                                     inner=args.inner, device=args.device)
    else:
        out = measure_overlap(args.steps, args.mb, args.inner, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
