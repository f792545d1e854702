"""IslandSession of the port (``bluefog_tpu_torch/run/interactive_islands``):
the reference's four cases (``tests/test_interactive_islands.py``) run with
cloudpickle unimportable in the driving process and in every worker, plus the
standard-library shipping rules (by reference, as source with closure cells
and globals, a clear error for what cannot be shipped) and the example
against ``examples/jax_interactive_islands.py``."""

import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from bluefog_tpu_torch.run import interactive_islands as ii
from bluefog_tpu_torch.run.interactive_islands import IslandSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cloudpickle(tmp_path, monkeypatch):
    """cloudpickle cannot be imported here, nor in the spawned workers
    (they inherit ``sys.path``, whose first entry holds a stub that
    raises)."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "cloudpickle.py").write_text(
        "raise ImportError('cloudpickle is not installed')\n")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(ImportError):
        import cloudpickle  # noqa: F401
    return stub


def _cell_create(rank, size):
    import numpy as np

    from bluefog_tpu_torch import islands, topology_util

    islands.set_topology(topology_util.RingGraph(size))
    x = np.full((4,), float(rank), np.float32)
    islands.win_create(x, "live")
    islands.win_put(x, "live")
    islands.barrier()
    return float(rank)


def _cell_update(rank, size, rounds):
    import numpy as np

    from bluefog_tpu_torch import islands

    out = None
    for _ in range(rounds):
        out = islands.win_update("live")
        islands.win_put(out, "live")
        islands.barrier()
    return np.asarray(out).copy()


def _cell_free(rank, size):
    from bluefog_tpu_torch import islands

    islands.win_free("live")
    return True


def _cell_cloudpickle_importable(rank, size):
    try:
        import cloudpickle  # noqa: F401
    except ImportError:
        return False
    return True


def test_island_session_two_cells(no_cloudpickle):
    with IslandSession(2, timeout=240.0) as sess:
        assert sess.run(_cell_cloudpickle_importable) == [False, False]
        ranks = sess.run(_cell_create)
        assert ranks == [0.0, 1.0]
        # the window created in cell 1 is still alive in cell 2 — and the
        # repeated put/update rounds drive the ranks to consensus
        outs = sess.run(_cell_update, 12)
        spread = float(np.abs(np.asarray(outs[0]) - np.asarray(outs[1])).max())
        assert spread < 0.02, outs
        assert 0.0 < float(np.asarray(outs[0]).mean()) < 1.0, outs
        assert sess.run(_cell_free) == [True, True]
    assert not sess._alive


def test_island_session_closure_capture(no_cloudpickle):
    """Notebook-style: a closure over a local variable ships as source
    with its cell's value, without cloudpickle."""
    scale = 7.0

    def cell(rank, size):
        return rank * scale

    with IslandSession(2, timeout=240.0) as sess:
        assert sess.run(cell) == [0.0, 7.0]


def test_island_session_error_propagates(no_cloudpickle):
    def boom(rank, size):
        raise ValueError("cell exploded")

    sess = IslandSession(2, timeout=240.0)
    with pytest.raises(RuntimeError, match="cell exploded") as info:
        sess.run(boom)
    # the worker's traceback names the shipped cell and its source line
    assert "raise ValueError" in str(info.value)
    # errors terminate the session and reclaim segments
    assert not sess._alive
    assert not [f for f in os.listdir("/dev/shm") if sess.job in f]


def test_island_session_one_rank_fails_while_other_blocks(no_cloudpickle):
    """rank 1 raises before the barrier rank 0 is waiting in: the real
    traceback must surface promptly (cross-rank polling), not a timeout."""

    def cell(rank, size):
        from bluefog_tpu_torch import islands

        if rank == 1:
            raise ValueError("rank1 exploded")
        islands.barrier()  # waits for rank 1, which never arrives

    sess = IslandSession(2, timeout=600.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank1 exploded"):
        sess.run(cell)
    # surfaced by polling, far sooner than the 600 s timeout
    assert time.monotonic() - t0 < 120.0
    assert not sess._alive


# ---------------------------------------------------------------------------
# the shipping rules, in one process
# ---------------------------------------------------------------------------

_OFFSET = 100.0


def _helper(v):
    return v + _OFFSET


def test_shipping_by_reference_and_by_source(no_cloudpickle):
    """An importable top-level def goes by reference (its qualified name is
    in the bytes, its source is not); a closure, a lambda, a nested def
    with defaults and a nested helper go as source, with the globals they
    name and the modules they use."""
    import math

    blob = ii.dumps_cell(_helper, (1.0,))
    assert b"_helper" in blob and b"_OFFSET" not in blob

    k = 3

    def inner(v):
        return math.floor(v) * k

    def cell(rank, size, bias=0.5, *, mul=2):
        return _helper(inner(rank + 0.25) * mul) + bias

    lam = lambda rank, size: [rank, size, k]  # noqa: E731
    for fn, want in ((cell, _helper(inner(2.25) * 2) + 0.5), (lam, [2, 4, 3])):
        blob = ii.dumps_cell(fn)
        assert b"def " in blob or b"lambda" in blob
        got, args, kwargs = ii.loads_cell(blob)
        assert got is not fn
        assert got(2, 4, *args, **kwargs) == want
    # a shipped cell keeps its defaults and keyword-only defaults
    got = ii.loads_cell(ii.dumps_cell(cell))[0]
    assert got.__defaults__ == (0.5,) and got.__kwdefaults__ == {"mul": 2}


def test_unshippable_cell_raises_in_the_caller(no_cloudpickle):
    """A function without source (built by exec) cannot be shipped: a clear
    TypeError in the driving process, before anything is sent, and the
    session stays usable."""
    ns = {}
    exec("def ghost(rank, size):\n    return rank\n", ns)
    with pytest.raises(TypeError, match="cannot ship 'ghost'.*source"):
        ii.dumps_cell(ns["ghost"])
    with IslandSession(2, timeout=240.0) as sess:
        t0 = time.monotonic()
        with pytest.raises(TypeError, match="cannot ship"):
            sess.run(ns["ghost"])
        assert time.monotonic() - t0 < 5.0
        assert sess._alive
        assert sess.run(_cell_cloudpickle_importable) == [False, False]


def test_example_matches_reference_example(no_cloudpickle):
    """The port's example at 4 ranks: its per-rank means after 12 rounds
    equal the reference example's (run as a script, as a user runs it)
    and W^12 x in float64; rank 0's window on the requested device."""
    from bluefog_tpu_torch.examples import interactive_islands as ex

    out = ex.main(["--device", "cpu", "--ranks", "4"])
    assert out["ok"], out
    assert out["window_devices"] == ["cpu"] * 4
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", DEMO_RANKS="4")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "jax_interactive_islands.py")],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("cell 2"))
    ref = ast.literal_eval(line.split(": ", 1)[1])
    np.testing.assert_allclose(out["means"], ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["means"], out["expected_means"], rtol=0, atol=1e-5)


def test_setup_interactive_on_the_cpu():
    """The single-controller helper: N virtual ranks on the device asked
    for (the card by default)."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.run.interactive import setup_interactive

    with pytest.raises(ValueError, match="simulate_ranks"):
        setup_interactive(device="cpu")
    ctx = setup_interactive(simulate_ranks=4, device="cpu")
    try:
        assert bf.size() == 4 and ctx.size == 4
        assert bf.device() == torch.device("cpu")
    finally:
        bf.shutdown()
