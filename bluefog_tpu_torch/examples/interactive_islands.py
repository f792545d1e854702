"""Interactive island session demo — the ``ibfrun`` twin as a script.

Counterpart of ``examples/jax_interactive_islands.py``.  What a notebook
would do across cells, here as sequential ``run`` calls against the SAME
live workers: create a window in "cell" 1, gossip in "cell" 2 (the window
is still alive — the property persistent daemons exist for), read the
consensus and free the window in "cell" 3.  Rank 0's window lives on
``--device`` (default ``cuda:0``, the card); the other ranks' on the host.

Run:
  python -m bluefog_tpu_torch.examples.interactive_islands             # rank 0 on the card
  python -m bluefog_tpu_torch.examples.interactive_islands --device cpu
Prints one line per cell, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np

from bluefog_tpu_torch.run.interactive_islands import IslandSession

ROUNDS = 12
SPREAD_TOL = 0.02


def cell_create(rank, size, device="cpu"):
    import torch

    from bluefog_tpu_torch import islands, topology_util

    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    x = torch.full((8,), float(rank), dtype=torch.float32,
                   device=device if rank == 0 else "cpu")
    islands.win_create(x, "demo")
    islands.win_put(x, "demo")
    islands.barrier()
    return float(x.mean())


def cell_gossip(rank, size, rounds):
    from bluefog_tpu_torch import islands

    # the synchronous schedule (cf. islands.settle / the gossip tests):
    # deposit, barrier, combine, barrier — everyone's round-k deposit
    # lands BEFORE anyone combines, so the values are deterministic at
    # any rank count
    cur = islands.win_sync("demo")
    for _ in range(rounds):
        islands.win_put(cur, "demo")
        islands.barrier()
        cur = islands.win_update("demo")
        islands.barrier()
    return float(cur.mean())


def cell_device(rank, size):
    from bluefog_tpu_torch import islands

    return str(islands.win_sync("demo").device)


def cell_cleanup(rank, size):
    from bluefog_tpu_torch import islands

    islands.win_free("demo")
    return True


def expected_means(n: int, rounds: int) -> List[float]:
    """The per-rank means the synchronous schedule must give: rank r starts
    at r and each round applies the ExponentialTwoGraph(n) mixing matrix,
    ``W^rounds x`` in float64."""
    from bluefog_tpu_torch import topology_util

    w = topology_util.GetWeightMatrix(topology_util.ExponentialTwoGraph(n))
    x = np.arange(n, dtype=np.float64)
    for _ in range(rounds):
        x = w @ x
    return [float(v) for v in x]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda:0",
                    help="the device of rank 0's window (default: the card)")
    args = ap.parse_args(argv)
    n = args.ranks
    with IslandSession(n, timeout=300.0) as sess:
        starts = sess.run(cell_create, args.device)
        print(f"cell 1 (create+put): per-rank values {starts}")
        vals = sess.run(cell_gossip, ROUNDS)
        print(f"cell 2 ({ROUNDS} gossip rounds on the LIVE window): {vals}")
        devices = sess.run(cell_device)
        spread = max(vals) - min(vals)
        assert spread < SPREAD_TOL, vals
        assert sess.run(cell_cleanup) == [True] * n
        print(f"cell 3: consensus spread {spread:.2e} — "
              "interactive islands demo OK")
    want = expected_means(n, ROUNDS)
    err = max(abs(a - b) for a, b in zip(vals, want))
    out = {"ok": bool(err < 1e-5), "ranks": n, "starts": starts, "means": vals,
           "expected_means": want, "max_abs_err": err, "spread": spread,
           "window_devices": devices}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
