"""Members leave the adaptive control loop without a hang.

Island ranks finish their rounds at different times.  A reweight epoch
(an adaptive demote or promote) committed by a member still stepping
after another member has left used to pair the switch's old-epoch
barrier with the leaver's teardown barrier in ``islands.spawn``: the
leaver shut down, and the switchers waited in the new epoch's barrier
for it until the spawn timed out (``measure_straggler``'s adaptive arm,
where the healthy ranks finish long before the straggler).  The repair:
a leaver marks itself on the membership board, which ends reweight
commits, and switches through the epochs committed before its mark
(``islands.adaptive_leave``, run by every spawn worker before its
teardown barrier).  These tests pin both orders of the race, then run
the straggler benchmark's adaptive arm as it is.
"""

import math
import os
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.benchmarks import recovery
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.resilience import join as _join


def _wait_for(cond, what, timeout=60.0):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise TimeoutError(f"waited {timeout} s for {what}")
        time.sleep(0.01)


def _setup(rank, size):
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.win_create(np.full(3, float(rank), np.float64), "lv")
    islands.barrier()
    ctx = islands._ctx()
    return ctx, _join.MembershipBoard(ctx.base_job)


def _worker_commit_then_leave(rank, size):
    """Rank 0 demotes rank 3 and switches; the others see the epoch word
    move and leave their rounds without another adaptive tick, so only
    their teardown can switch them."""
    ctx, board = _setup(rank, size)
    if rank == 0:
        rec = islands._commit_reweight(ctx, board, demote=[3])
        assert rec is not None and rec.get("reweight"), rec
        islands._switch_epoch(ctx, rec)
        return (rank, islands.membership_epoch(), sorted(islands.demoted_ranks()))
    _wait_for(lambda: shm_native.membership_epoch(ctx.base_job) >= 1,
              "rank 0's reweight commit")
    return (rank, islands.membership_epoch(), sorted(islands.demoted_ranks()))


def _worker_leave_then_commit(rank, size):
    """Rank 2 leaves at once; once the board shows it leaving, rank 0's
    demote commit is refused and nobody switches."""
    ctx, board = _setup(rank, size)
    if rank == 2:
        return (rank, None)
    _wait_for(lambda: 2 in (board.read() or {}).get("leaving", ()),
              "rank 2's leaving mark")
    if rank == 0:
        return (rank, islands._commit_reweight(ctx, board, demote=[3]))
    return (rank, None)


def _spawn(monkeypatch, fn, tag):
    monkeypatch.setenv("BFTPU_ADAPTIVE", "1")
    job = f"leave{tag}{os.getpid()}"
    try:
        return islands.spawn(fn, 4, job=job, timeout=120.0)
    finally:
        shm_native.unlink_all(job, ["lv"])


def test_leaver_switches_through_a_reweight_committed_before_it_left(monkeypatch):
    res = _spawn(monkeypatch, _worker_commit_then_leave, "c")
    # rank 0 switched inside its rounds; the others left at epoch 0 and
    # completed the teardown beside it (before the repair: a spawn timeout)
    assert res[0] == (0, 1, [3]), res
    assert [r[1] for r in res[1:]] == [0, 0, 0], res


def test_no_reweight_commits_after_a_member_left(monkeypatch):
    res = _spawn(monkeypatch, _worker_leave_then_commit, "r")
    assert res[0] == (0, None), res


_CARD = pytest.mark.cuda


def _arms():
    """Three arms with rank 0's window on the CPU, twelve on the card."""
    return ([pytest.param("cpu", run, id=str(run)) for run in range(3)]
            + [pytest.param("cuda", run, id=f"cuda-{run}", marks=_CARD) for run in range(12)])


@pytest.mark.parametrize("device,run", _arms())
def test_straggler_adaptive_arm_completes(device, run):
    """``measure_straggler``'s adaptive arm as the benchmark runs it: the
    spawn returns every rank's step times within its timeout (no wall-time
    bound is held: the CPU's timing says nothing of the card's).  The card's
    cases stage rank 0's window through a CUDA tensor, as the hang's runs did."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (rank 0's window on the card)")
    p99 = recovery._run_straggler_once(4, 30, 0.6, adaptive_on=True, device=device)
    assert math.isfinite(p99) and p99 > 0.0
