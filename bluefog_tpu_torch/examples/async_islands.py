"""Asynchronous islands demo: true one-sided gossip across processes.

Counterpart of ``examples/jax_async_islands.py`` on the island runtime
(:mod:`bluefog_tpu_torch.islands`): every rank is a separate OS process with
its own torch runtime, stepping at its OWN pace — no barrier anywhere in the
hot loops.  Deposits travel through the native shared-memory mailbox
(seqlock slots + atomic collect); the tensors live on the card (every
island on ``cuda:0``) unless ``--device cpu``.

Two phases:
  1. **Asynchronous push-sum consensus** — mass-conserving (x, p) splitting;
     converges to the EXACT global average despite random per-rank delays.
  2. **Asynchronous gossip SGD** — decentralized logistic regression: each
     island fits its local data shard with SGD steps and gossips parameters
     via ``win_put`` + ``win_update`` every few steps (the island
     ``DistributedWinPutOptimizer``); ranks finish at different times.

Run:
  python -m bluefog_tpu_torch.examples.async_islands            # 4 islands, card
  python -m bluefog_tpu_torch.examples.async_islands --device cpu
Prints one line per rank, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bluefog_tpu_torch import islands, topology_util

#: the reference example's acceptance bounds
CONSENSUS_TOL = 1e-5
MIN_ACC = 0.8
#: barriered push-sum rounds that close phase 1.  The reference example
#: drains with 6 ``push_sum_round`` + ``barrier`` rounds, in which a rank
#: may collect before a neighbor's deposit of the same round has landed;
#: on a loaded host they can leave more than CONSENSUS_TOL.  Here each
#: drain round deposits, barriers, then collects, so it applies the mixing
#: matrix exactly and contracts the spread 3x on ExponentialTwoGraph(4):
#: 20 rounds bound the error below 1e-6 whatever the asynchronous rounds
#: left.
DRAIN_ROUNDS = 20


def make_shard(rank: int, size: int, n_per: int = 200, dim: int = 8):
    """Synthetic logistic-regression shard; every rank can reconstruct the
    full dataset (for the reference loss) deterministically."""
    rng = np.random.default_rng(1234)
    w_true = rng.normal(size=(dim,))
    X = rng.normal(size=(size * n_per, dim))
    y = (X @ w_true + 0.3 * rng.normal(size=(size * n_per,)) > 0).astype(np.float64)
    lo, hi = rank * n_per, (rank + 1) * n_per
    return X, y, X[lo:hi], y[lo:hi]


def _full_loss(X_full, y_full, w: np.ndarray):
    z = X_full @ w
    loss = float(np.mean(np.logaddexp(0.0, z) - y_full * z))
    acc = float((((z > 0).astype(np.float64)) == y_full).mean())
    return loss, acc


def _barriered_push_sum_round(name: str) -> None:
    """``islands.push_sum_round`` with a barrier between the deposits and
    the collect: every share lands before its receiver collects."""
    x = islands.win_sync(name)
    p = islands.win_associated_p(name)
    outs = islands.out_neighbor_ranks()
    share = 1.0 / (len(outs) + 1)
    islands.win_accumulate(x, name, dst_weights={d: share for d in outs})
    islands.win_set_exposed(name, x * share, p * share)
    islands.barrier()
    islands.win_update_then_collect(name)
    islands.barrier()


def worker(rank: int, size: int, iters: int, seed_sleep: float, device: str):
    """One island: returns ``(consensus err, full-data loss at the start,
    full-data loss at the end, accuracy)``."""
    dev = torch.device(device)
    rng = np.random.default_rng(rank)
    islands.set_topology(topology_util.ExponentialTwoGraph(size))

    # --- phase 1: asynchronous push-sum consensus --------------------------
    x0 = torch.full((16,), 100.0 * rank, dtype=torch.float64, device=dev)
    islands.turn_on_win_ops_with_associated_p()
    islands.win_create(x0, "consensus", zero_init=True)
    for _ in range(iters):
        islands.push_sum_round("consensus")
        time.sleep(float(rng.random()) * seed_sleep)  # genuine desync
    islands.barrier()
    for _ in range(DRAIN_ROUNDS):  # drain in-flight mass
        _barriered_push_sum_round("consensus")
    avg = islands.win_sync("consensus") / islands.win_associated_p("consensus")
    assert avg.device.type == dev.type, (avg.device, dev)
    exact = 100.0 * (size - 1) / 2.0
    err1 = float((avg - exact).abs().max())
    islands.win_free("consensus")
    islands.turn_off_win_ops_with_associated_p()

    # --- phase 2: asynchronous gossip SGD via the WinPut optimizer ---------
    X_full, y_full, X, y = make_shard(rank, size)
    Xt = torch.tensor(X, dtype=torch.float32, device=dev)
    yt = torch.tensor(y, dtype=torch.float32, device=dev)
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=dev, requires_grad=True)
    loss0, _ = _full_loss(X_full, y_full, w.detach().cpu().numpy().astype(np.float64))
    # local adapt, then one-sided deposit + combine — nobody waits for anybody
    opt = islands.DistributedWinPutOptimizer(
        torch.optim.SGD([w], lr=0.5), num_steps_per_communication=4)
    for _ in range(iters):
        opt.zero_grad()
        z = Xt @ w
        loss = (torch.logaddexp(torch.zeros_like(z), z) - yt * z).mean() + 1e-3 * (w * w).sum()
        loss.backward()
        opt.step()
        time.sleep(float(rng.random()) * seed_sleep)
    # settle: barriered pure-gossip rounds align stragglers
    islands.barrier()
    opt.settle(rounds=8)
    loss1, acc = _full_loss(X_full, y_full, w.detach().cpu().numpy().astype(np.float64))
    opt.free()
    return err1, loss0, loss1, acc


def run(nranks: int = 4, iters: int = 80, sleep: float = 0.002,
        device: str = "cuda", timeout: float = 300.0) -> dict:
    """Spawn ``nranks`` islands; returns the per-rank results and the
    verdict against the reference example's bounds."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    t0 = time.time()
    res = islands.spawn(worker, nranks, args=(iters, sleep, device),
                        timeout=timeout)
    errs = [r[0] for r in res]
    out = {
        "nranks": nranks,
        "device": device,
        "wall_s": time.time() - t0,
        "consensus_err": errs,
        "loss_start": [r[1] for r in res],
        "loss_end": [r[2] for r in res],
        "acc": [r[3] for r in res],
    }
    out["ok"] = bool(max(errs) < CONSENSUS_TOL and min(out["acc"]) > MIN_ACC
                     and all(np.isfinite(out["loss_end"]))
                     and all(b < a for a, b in zip(out["loss_start"], out["loss_end"])))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--sleep", type=float, default=0.002)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true",
                    help="run as one island (under the launcher's --islands; "
                    "implied by BLUEFOG_ISLAND_RANK); default self-spawns "
                    "--nranks island processes")
    args = ap.parse_args(argv)
    if args.worker or "BLUEFOG_ISLAND_RANK" in os.environ:
        return _launched_worker(args)
    out = run(args.nranks, args.iters, args.sleep, args.device)
    for r in range(args.nranks):
        print(f"rank {r}: consensus err {out['consensus_err'][r]:.2e}  "
              f"full-data loss {out['loss_start'][r]:.4f} -> {out['loss_end'][r]:.4f}  "
              f"acc {out['acc'][r]:.3f}")
    print(json.dumps(out))
    if not out["ok"]:
        raise SystemExit(1)
    return out


def _launched_worker(args) -> dict:
    """One island of a launcher-started fleet: prints its own line and one
    JSON line, and exits non-zero when it misses the reference's bounds."""
    islands.init()
    rank = islands.rank()
    err1, loss0, loss1, acc = worker(rank, islands.size(), args.iters,
                                     args.sleep, args.device)
    print(f"[rank {rank}] consensus err {err1:.2e}  full-data loss "
          f"{loss0:.4f} -> {loss1:.4f}  acc {acc:.3f}")
    ok = bool(err1 < CONSENSUS_TOL and acc > MIN_ACC and loss1 < loss0)
    out = {"rank": rank, "consensus_err": err1, "loss_start": loss0,
           "loss_end": loss1, "acc": acc, "ok": ok}
    print(json.dumps(out))
    islands.barrier()
    islands.shutdown(unlink=(rank == 0))
    if not ok:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
