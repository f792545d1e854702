"""Worker of the multi-process check: launched by ``bftpu-torch-run -np 2``,
one process a "host", each holding 4 of 8 ranks (twin of the reference's
``tests/multihost_worker.py``, with its assertions in its order).

Per process: distributed ``init``, the process-boundary machine grouping,
``neighbor_allreduce`` from process-local rows, ``allreduce_nonblocking``
and ``barrier`` across processes, ``local_slice`` of a replicated value,
hierarchical ``neighbor_allreduce`` across the process axis, the window
ops from process-local rows (fused trees too), and 6 ATC steps with a
decreasing loss.  Exits nonzero (assert) on any mismatch and prints
``multihost worker process K OK`` at the end.

``--parity DIR`` then writes this process's results of the same ops on
inputs drawn by numpy from a seed to ``DIR/parity-K.npz`` (the tests hold
them against the JAX package's single-process results).

Run:  bftpu-torch-run -np 2 -- python -m bluefog_tpu_torch.examples.multihost_worker
      bftpu-torch-run -np 2 -- python -m bluefog_tpu_torch.examples.multihost_worker --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.core import basics

SIZE = 8
PARITY_SEED = 21


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parity", default=None, metavar="DIR",
                    help="write this process's seeded parity results to DIR")
    return ap


def _np(t) -> np.ndarray:
    return basics.local_slice(t).double().numpy()


def atc_losses(size: int, steps: int = 6):
    """The reference worker's ATC run: ``xb @ w`` on a ring, SGD 0.05,
    cross-entropy; every step's losses of this process's ranks."""
    from bluefog_tpu_torch.optim import CommunicationType
    from bluefog_tpu_torch.training import make_decentralized_train_step, replicate_for_mesh

    def apply_fn(params, xb):
        return xb @ params["w"]

    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    params = basics.to_rank_major_global(replicate_for_mesh({"w": torch.from_numpy(w0)}, size))
    opt = torch.optim.SGD(list(params.values()), lr=0.05)
    step_fn = make_decentralized_train_step(
        apply_fn, params, opt, communication_type=CommunicationType.neighbor_allreduce,
        plan=basics.context().plan)
    xb = basics.to_rank_major_global(rng.normal(size=(size, 16, 5)).astype(np.float32))
    yb = basics.to_rank_major_global(rng.integers(0, 3, size=(size, 16)).astype(np.int64))
    return [_np(step_fn(xb, yb)[0]) for _ in range(steps)]


def parity(path: str, pid: int) -> None:
    """Seeded inputs through the ops the tests compare with the JAX
    package: neighbor_allreduce on exp2 and on a ring, hierarchical with
    machines = processes, one window round, the ATC losses."""
    rng = np.random.default_rng(PARITY_SEED)
    x = rng.standard_normal((SIZE, 3, 2)).astype(np.float32)
    out = {}
    for name, topo in (("exp2", tu.ExponentialTwoGraph(SIZE)), ("ring", tu.RingGraph(SIZE))):
        bf.set_topology(topo)
        out[f"nar_{name}"] = _np(bf.neighbor_allreduce(basics.to_rank_major_global(x)))
    bf.set_machine_topology(tu.RingGraph(bf.machine_size()))
    out["hier"] = _np(bf.hierarchical_neighbor_allreduce(x))
    bf.set_topology(tu.RingGraph(SIZE))
    bf.win_create(x, "parity")
    bf.win_put(x * 2.0, "parity")
    out["win"] = _np(bf.win_update("parity"))
    bf.win_free("parity")
    out["atc"] = np.stack(atc_losses(SIZE))
    np.savez(os.path.join(path, f"parity-{pid}.npz"), **out)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    bf.init(size=SIZE, distributed=True, device=args.device)
    import torch.distributed as dist

    assert dist.get_world_size() == 2, dist.get_world_size()
    size = bf.size()
    assert size == 8, size
    # the machine axis maps to the process boundary
    assert bf.machine_size() == 2, bf.machine_size()
    assert bf.local_size() == 4, bf.local_size()
    pid = dist.get_rank()
    assert bf.rank() == pid * 4, (bf.rank(), pid)
    assert basics.local_ranks() == list(range(pid * 4, pid * 4 + 4))
    assert bf.device().type == torch.device(args.device).type

    # --- neighbor_allreduce from process-local rows -----------------------
    topo = tu.RingGraph(size)
    bf.set_topology(topo)
    mine = np.arange(pid * 4, pid * 4 + 4, dtype=np.float32)
    x_local = np.repeat(mine[:, None], 3, axis=1)  # [4, 3], row r == rank r
    out = bf.neighbor_allreduce(basics.to_rank_major_global(x_local))
    W = tu.GetWeightMatrix(topo)
    expected = (W @ np.arange(size, dtype=np.float64))[pid * 4: pid * 4 + 4]
    got = _np(out)
    np.testing.assert_allclose(got[:, 0], expected, rtol=1e-5)

    # --- allreduce + barrier + handle sync across processes ---------------
    h = bf.allreduce_nonblocking(x_local, average=True)
    ar = _np(bf.wait(h))
    np.testing.assert_allclose(ar[:, 0], (size - 1) / 2.0, rtol=1e-6)
    bf.barrier()

    # --- local_slice on a replicated value must NOT duplicate -------------
    repl = torch.arange(3.0, device=bf.device())
    sl = basics.local_slice(repl)
    assert tuple(sl.shape) == (3,), sl.shape
    np.testing.assert_array_equal(sl.numpy(), [0.0, 1.0, 2.0])

    # --- hierarchical: machine axis == process boundary -------------------
    bf.set_machine_topology(tu.RingGraph(2))
    hout = bf.hierarchical_neighbor_allreduce(x_local)
    # local (per-process) means: proc0 ranks {0..3} -> 1.5, proc1 -> 5.5;
    # the machine ring of size 2 averages them -> 3.5 everywhere
    np.testing.assert_allclose(_np(hout)[:, 0], 3.5, rtol=1e-5)

    # --- window ops across processes (eager mailbox emulation) ------------
    bf.win_create(x_local, "mh_win")
    bf.win_put(x_local, "mh_win")
    wout = bf.win_update("mh_win")
    np.testing.assert_allclose(_np(wout)[:, 0], expected, rtol=1e-5)
    # fused pytree window from process-local rows
    tree = {"a": torch.from_numpy(x_local), "b": torch.from_numpy(x_local[:, :2].copy())}
    bf.win_create(tree, "mh_tree")
    bf.win_put(tree, "mh_tree")
    tout = bf.win_update("mh_tree")
    np.testing.assert_allclose(_np(tout["b"])[:, 0], expected, rtol=1e-5)
    # the optimizer hot path (fused put+update) and accumulate/set_exposed
    # take process-local rows too
    pout = bf.win_put_update(tree, "mh_tree")
    assert tuple(basics.local_slice(pout["a"]).shape) == (4, 3)
    bf.win_set_exposed("mh_tree", tree)
    bf.win_accumulate(tree, "mh_tree")
    aout = bf.win_update("mh_tree", reset=True)
    assert np.isfinite(_np(aout["a"])).all()
    bf.win_free("mh_win")
    bf.win_free("mh_tree")

    # --- 6 ATC train steps over this process's rows ------------------------
    losses = atc_losses(size)
    l0, l1 = float(np.mean(losses[0])), float(np.mean(losses[-1]))
    assert np.isfinite(l0) and np.isfinite(l1), (l0, l1)
    assert l1 < l0, f"ATC loss did not decrease: {l0} -> {l1}"

    if args.parity:
        parity(args.parity, pid)
    print(f"multihost worker process {pid} OK", flush=True)
    bf.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
