"""``progress/`` of bluefog_tpu_torch against the JAX package.

One op script runs through both packages' engines in manual mode
(``start_worker=False``, an injected clock) with recording backends: the
executed batches, the fusion decisions, the requeues after an epoch move,
the handle results and ``stats()`` must be identical.  Staging is the
port's own (torch tensors): a CPU tensor is a zero-copy view, counted only
on the worker; the pinned-buffer path of a CUDA tensor is held against it
in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from bluefog_tpu import progress as jprogress
from bluefog_tpu_torch import progress as tprogress
from bluefog_tpu_torch.progress import staging
from bluefog_tpu_torch.telemetry import registry as _telemetry


class RecordingBackend:
    """Records every execute and fuse call; epoch and failures are set by
    the script."""

    def __init__(self):
        self.calls = []
        self.fuses = []
        self.fail_next = 0
        self.epoch_value = 0

    def execute(self, kind, window, payload, weights, kwargs):
        self.calls.append((kind, window, payload, weights, dict(kwargs)))
        if self.fail_next > 0:
            self.fail_next -= 1
            raise OSError("segment moved")
        return ("done", kind, window, payload)

    def fuse(self, kind, window, payloads):
        self.fuses.append((kind, window, list(payloads)))
        if kind == "put":
            return payloads[-1]
        return sum(payloads)

    def epoch(self):
        return self.epoch_value


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(pkg):
    be, clk = RecordingBackend(), Clock()
    eng = pkg.ProgressEngine(be, start_worker=False, clock=clk, queue_depth=64,
                             fusion_bytes=100)
    log, handles = [], []
    rng = np.random.default_rng(11)
    for i in range(120):
        r = rng.random()
        win = "ab"[int(rng.integers(0, 2))]
        if r < 0.4:
            handles.append(eng.submit("put", win, payload=i, nbytes=int(rng.integers(8, 60)),
                                      weights=None if rng.random() < 0.8 else {1: 0.5}))
        elif r < 0.7:
            handles.append(eng.submit("accumulate", win, payload=float(i), nbytes=30))
        elif r < 0.8:
            handles.append(eng.submit("update", win, self_weight=0.5))
        elif r < 0.85:
            # the epoch moves under the next op: it fails once, is requeued
            be.epoch_value += 1
            be.fail_next = 1
        elif r < 0.9:
            log.append(("quiesce", eng.quiesce()))
            log.append(("parked_step", eng.step()))
            eng.resume()
        else:
            log.append(("step", eng.step()))
        clk.t += float(rng.uniform(0.0, 0.5))
    while True:
        n = eng.step()
        log.append(("drain", n))
        if not n:
            break
    results = [(h.done(), h.result() if h.done() and h.exception() is None
                else repr(h.exception())) for h in handles]
    stats = eng.stats()
    eng.stop()
    return log, be.calls, be.fuses, results, stats, eng.queued_s_total


def test_manual_engine_script_matches_reference():
    got, want = _script(tprogress), _script(jprogress)
    assert got[0] == want[0]  # step sizes, quiesce counts
    assert got[1] == want[1]  # executed batches, in order
    assert got[2] == want[2]  # fusion decisions
    assert got[3] == want[3]  # handle results
    assert got[4] == want[4]  # stats()
    assert got[5] == want[5]
    assert got[4]["fused_batches"] > 0 and got[4]["requeued"] > 0


def test_engine_constants_and_env_knobs_match_reference(monkeypatch):
    assert tprogress.KINDS == jprogress.KINDS
    assert tprogress.MAX_REQUEUES == jprogress.MAX_REQUEUES
    for env in ({}, {"BFTPU_PROGRESS": "0", "BFTPU_PROGRESS_QUEUE_DEPTH": "7",
                     "BFTPU_PROGRESS_FUSION_MB": "0.5"},
                {"BFTPU_PROGRESS": "off", "BFTPU_PROGRESS_QUEUE_DEPTH": "x"}):
        for k in ("BFTPU_PROGRESS", "BFTPU_PROGRESS_QUEUE_DEPTH", "BFTPU_PROGRESS_FUSION_MB"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("enabled", "queue_depth", "fusion_bytes"):
            assert getattr(tprogress, fn)() == getattr(jprogress, fn)(), (env, fn)
    h = tprogress.completed(3)
    assert h.done() and h.result() == 3


def test_threaded_engine_drains_in_submission_order():
    be = RecordingBackend()
    eng = tprogress.ProgressEngine(be, queue_depth=8, fusion_bytes=0)
    hs = [eng.submit("put", "w", payload=i, nbytes=8) for i in range(20)]
    assert [h.result(timeout=10) for h in hs][-1][3] == 19
    eng.drain(timeout=10)
    assert [c[2] for c in be.calls] == list(range(20))
    eng.stop()


def test_staging_cpu_tensor_is_a_view_counted_on_the_worker(monkeypatch, tmp_path):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    _telemetry.reset()
    try:
        reg = _telemetry.get_registry()
        t = torch.arange(6, dtype=torch.float32)
        v = staging.stage(t, "w")
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
        t[0] = 42.0  # a view of the tensor's own storage
        assert v[0] == 42.0
        assert reg.counter("progress.staging_bytes_saved").value == 0
        with staging.worker_scope():
            assert staging.in_worker()
            staging.stage(t, "w")
        assert not staging.in_worker()
        assert reg.counter("progress.staging_bytes_saved").value == 24
        a = np.ones(3)
        assert staging.stage(a) is a
        assert staging.snapshot(t) is t  # CPU: nothing to freeze
        np.testing.assert_array_equal(staging.stage([1.0, 2.0]), [1.0, 2.0])
        # requires_grad tensors stage through detach()
        g = torch.ones(2, requires_grad=True)
        np.testing.assert_array_equal(staging.stage(g), [1.0, 1.0])
    finally:
        _telemetry.reset()


@pytest.mark.parametrize("shape", [(5,), (2, 3)])
def test_staging_stages_like_the_reference(shape):
    """The port stages a CPU tensor to the same host array as the
    reference stages the same tensor (its ``detach().cpu().numpy()``)."""
    from bluefog_tpu.progress import staging as jstaging

    t = torch.randn(*shape, generator=torch.Generator().manual_seed(0))
    got, want = staging.stage(t), jstaging.stage(t)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
