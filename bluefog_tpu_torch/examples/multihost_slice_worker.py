"""Worker of the simulated-multislice check: 2 processes x 4 ranks with
``BLUEFOG_SIMULATE_SLICES=4`` (twin of the reference's
``tests/multihost_slice_worker.py``, with its assertions in its order).

The 8 ranks form 4 machines of 2, finer than the 2 processes: machine_size
4, local_size 2, each process holding two whole machines, and the
hierarchical op mixes the machine rows across the process boundary.
Exits nonzero on any mismatch and prints ``multislice worker process K
OK`` at the end.

Run:  bftpu-torch-run -np 2 -- python -m bluefog_tpu_torch.examples.multihost_slice_worker
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.core import basics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the machine grid reads it at init: 4 simulated slices of 2 ranks
    os.environ["BLUEFOG_SIMULATE_SLICES"] = "4"
    bf.init(size=8, distributed=True, device=args.device)
    import torch.distributed as dist

    assert dist.get_world_size() == 2, dist.get_world_size()
    assert bf.size() == 8
    # machine axis == the simulated slice boundary (4 slices of 2), finer
    # than the 2-process boundary
    assert bf.machine_size() == 4, bf.machine_size()
    assert bf.local_size() == 2, bf.local_size()
    pid = dist.get_rank()

    # grouping contract: rank // local_size == machine index; this
    # process's 4 ranks span TWO machines
    r0 = pid * 4
    assert basics.local_ranks() == list(range(r0, r0 + 4))
    machines = {r // bf.local_size() for r in basics.local_ranks()}
    assert machines == {pid * 2, pid * 2 + 1}, machines

    # --- hierarchical neighbor_allreduce rides the slice axis -------------
    bf.set_machine_topology(tu.RingGraph(4))
    mine = np.arange(r0, r0 + 4, dtype=np.float32)
    x_local = np.repeat(mine[:, None], 3, axis=1)  # [4, 3]
    hout = bf.hierarchical_neighbor_allreduce(basics.to_rank_major_global(x_local))
    # per-machine means [0.5, 2.5, 4.5, 6.5], mixed on the ring of 4
    means = np.array([0.5, 2.5, 4.5, 6.5])
    W = tu.GetWeightMatrix(tu.RingGraph(4))
    mixed = W @ means
    # every rank of machine m holds mixed[m]; this process spans machines
    # {2*pid, 2*pid+1} with 2 ranks each
    expected = np.repeat(mixed[2 * pid: 2 * pid + 2], 2)
    got = basics.local_slice(hout).double().numpy()
    np.testing.assert_allclose(got[:, 0], expected, rtol=1e-5)

    # --- machine-axis neighbor ops see 4 machines --------------------------
    assert len(basics.in_neighbor_machine_ranks()) > 0
    print(f"multislice worker process {pid} OK", flush=True)
    bf.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
