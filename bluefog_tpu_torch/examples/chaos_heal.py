"""A rank killed mid-gossip, the survivors heal: the launcher worker behind
the fleet monitor's kill run.

Each rank is an island process started by the launcher; rank 0's window
(``NUMEL`` values) is a torch tensor on ``--device`` (the card by
default), the others' on the CPU.  Every round each rank passes the
chaos checkpoint (``resilience.chaos.checkpoint(rank, "gossip")``: a
``BFTPU_CHAOS_KILL_RANK`` / ``BFTPU_CHAOS_KILL_STEP`` schedule SIGKILLs
its victim there), then runs one barriered gossip round (``win_put`` +
``win_update``, barriers bounded by ``BARRIER_TIMEOUT_S``).  The
survivors leave the loop once the failure detector declares the death,
heal around the corpse, run ``DEGRADED_ROUNDS`` asynchronous rounds on
the healed topology and hold for ``HOLD_S`` seconds, so an attached
monitor sees the healed fleet before it exits.  Each survivor prints one
JSON line: its rank, the dead set, the healed size, the healed plan's
row / column stochasticity errors and its estimate's mean.

Run under the launcher (a kill with no respawn fails the run's exit
code; the grace period, ``BFTPU_LAUNCH_GRACE_S``, lets the survivors
finish):
  BFTPU_CHAOS_KILL_RANK=2 BFTPU_CHAOS_KILL_STEP=100 BFTPU_FAILURE_TIMEOUT_S=1 \\
  BFTPU_LAUNCH_GRACE_S=30 \\
  python -m bluefog_tpu_torch.run.launcher --islands 4 --monitor --job J -- \\
      python -m bluefog_tpu_torch.examples.chaos_heal --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.resilience import chaos

WINDOW = "heal"
NUMEL = 1 << 20
MAX_ROUNDS = 400  # barriered rounds before the kill must have landed
ROUND_SLEEP_S = 0.02
BARRIER_TIMEOUT_S = 3.0
DEGRADED_ROUNDS = 100
HOLD_S = 3.0  # a survivor's page shows the dead edge until it exits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="rank 0's window device (default: the card)")
    args = ap.parse_args(argv)

    islands.init()
    rank, size = islands.rank(), islands.size()
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    x = torch.full((NUMEL,), float(10 * rank), dtype=torch.float32)
    islands.win_create(x.to(args.device if rank == 0 else "cpu"), WINDOW)
    islands.barrier()
    rounds = 0
    for _ in range(MAX_ROUNDS):
        chaos.checkpoint(rank, "gossip")  # the victim dies here
        islands.win_put(islands.win_sync(WINDOW), WINDOW)
        try:
            islands.barrier(timeout=BARRIER_TIMEOUT_S)
            islands.win_update(WINDOW)
            islands.barrier(timeout=BARRIER_TIMEOUT_S)
        except TimeoutError:
            break  # a sibling stopped arriving
        rounds += 1
        if islands.dead_ranks():
            break
        time.sleep(ROUND_SLEEP_S)
    deadline = time.monotonic() + 60.0
    while not islands.dead_ranks() and time.monotonic() < deadline:
        time.sleep(0.05)
    dead = sorted(islands.dead_ranks())
    healed = islands.heal() if dead else None
    out = {"rank": rank, "rounds": rounds, "dead": dead,
           "device": str(islands.win_sync(WINDOW).device)}
    if healed is not None:
        row_err, col_err = healed.plan.stochasticity_error()
        for _ in range(DEGRADED_ROUNDS):
            islands.win_put(islands.win_sync(WINDOW), WINDOW)
            islands.win_update(WINDOW)
            time.sleep(0.002)
        out.update(healed=True, healed_size=healed.size,
                   row_err=float(row_err), col_err=float(col_err))
    else:
        out["healed"] = False
    time.sleep(HOLD_S)
    out["mean"] = float(islands.win_sync(WINDOW).double().mean())
    print(json.dumps(out), flush=True)
    # no collective free: the corpse never arrives at its barrier (the
    # launcher reclaims the job's segments at exit)
    islands.shutdown(unlink=False)
    return 0 if out["healed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
