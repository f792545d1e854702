"""Port twin of ``tests/test_wire.py``: the same cases against
``bluefog_tpu_torch``.  The cases that need a module the port does not have yet (the
simulator, the analysis rule families other than ``trace_rules``, the
networkx corpus) wait for ROADMAP A7.4 and A8.

One wire protocol: quantized gossip deltas with error feedback
(docs/ISLANDS-TRANSPORT.md "One wire protocol").

Three layers of evidence:

- codec units: round-trip exactness, the conservation identity
  ``sum(inputs) == sum(delivered) + residual`` on a constant stream,
  int8 denormal/huge-magnitude chunks, and the non-finite -> RAW
  downgrade;
- np=2 TCP e2e: push-sum consensus per wire dtype with the telemetry
  mass ledger balanced (``python -m bluefog_tpu_torch.telemetry --check``) —
  the mass ``p`` rides exact in the commit frame, so quantizing the
  VALUES must never unbalance the ledger;
- chaos: SIGKILL a writer mid-chunk-stream and prove the dead-writer
  drain loses no COMMITTED mass and exposes no torn partial deposit
  (the ``TCP_DEAD_WRITER_DRAIN_STEPS`` theorem, model-checked in
  ``analysis/wire_rules.py``, exercised for real).
"""

import multiprocessing as mp
import os
import socket
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.native import wire_codec
from bluefog_tpu_torch.telemetry.__main__ import main as telemetry_cli

# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------


def test_raw_round_trip_exact():
    x = np.arange(-7, 9, dtype=np.float32) * 0.37
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_RAW)
    assert code == wire_codec.WIRE_RAW
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    np.testing.assert_array_equal(out, x)


def test_bf16_exact_for_representable_values():
    # bf16-representable f32s (small ints, powers of two) survive exactly
    x = np.array([0.0, 1.0, -2.0, 0.5, 96.0, -1024.0], np.float32)
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_BF16)
    assert code == wire_codec.WIRE_BF16 and len(payload) == 2 * x.size
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    np.testing.assert_array_equal(out, x)


def test_bf16_error_bounded_by_relative_step():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32)
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_BF16)
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    # bf16 has 8 mantissa bits: relative error <= 2**-8 for normals
    np.testing.assert_allclose(out, x, rtol=2.0 ** -8, atol=1e-30)


def test_int8_error_bounded_by_chunk_scale():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(2048) * 3.0).astype(np.float32)
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_INT8)
    assert code == wire_codec.WIRE_INT8 and len(payload) == x.size
    assert scale == pytest.approx(float(np.abs(x).max()) / 127.0)
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    # int8 error is relative to the CHUNK max, not per-element
    assert float(np.abs(out - x).max()) <= scale / 2 + 1e-12


def test_int8_denormal_chunk_survives():
    # a denormal-f32 max would round to 0 as f32 (divide by zero); the
    # f64 scale keeps the chunk finite and ~proportional
    x = np.full(16, 1e-44, np.float32)
    x[3] = -1e-44
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_INT8)
    assert code == wire_codec.WIRE_INT8 and scale > 0.0
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    assert np.isfinite(out).all()
    assert float(np.abs(out - x).max()) <= scale / 2 + 1e-50


def test_int8_huge_chunk_survives():
    # near-FLT_MAX chunks must not overflow the scale computation
    x = np.array([3.4e38, -3.4e38, 1.7e38, 0.0], np.float32)
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_INT8)
    assert code == wire_codec.WIRE_INT8
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    assert np.isfinite(out).all()
    assert float(np.abs(out - x).max()) <= scale / 2 * (1 + 1e-6)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("code",
                         [wire_codec.WIRE_BF16, wire_codec.WIRE_INT8])
def test_non_finite_chunk_downgrades_to_raw(bad, code):
    x = np.array([1.0, bad, 2.0], np.float32)
    code_used, payload, scale = wire_codec.encode_chunk(x, code)
    assert code_used == wire_codec.WIRE_RAW
    out = wire_codec.decode_chunk(payload, code_used, scale, np.float32,
                                  x.size)
    np.testing.assert_array_equal(
        np.isnan(out), np.isnan(x))
    np.testing.assert_array_equal(out[~np.isnan(x)], x[~np.isnan(x)])


def test_zero_chunk_int8_is_exact():
    x = np.zeros(32, np.float32)
    code, payload, scale = wire_codec.encode_chunk(x, wire_codec.WIRE_INT8)
    assert code == wire_codec.WIRE_INT8 and scale == 0.0
    out = wire_codec.decode_chunk(payload, code, scale, np.float32, x.size)
    np.testing.assert_array_equal(out, x)


def _ef_stream(x, code, rounds):
    """The sender's error-feedback loop exactly as ``deposit_chunked``
    runs it: fold the residual in, encode, settle the residual against
    what the wire delivered."""
    residual = np.zeros_like(x)
    delivered = np.zeros_like(x, dtype=np.float64)
    for _ in range(rounds):
        buf = x + residual
        code_i, payload, scale = wire_codec.encode_chunk(buf, code)
        out = wire_codec.decode_chunk(payload, code_i, scale, x.dtype,
                                      x.size)
        delivered += out.astype(np.float64)
        residual = (buf - out).astype(x.dtype)
    return delivered, residual


@pytest.mark.parametrize("code",
                         [wire_codec.WIRE_BF16, wire_codec.WIRE_INT8])
def test_error_feedback_conservation_constant_stream(code):
    """sum(inputs) == sum(delivered) + residual at every horizon, and
    the residual stays bounded by one quantization step (it drains into
    the deliveries instead of accumulating)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(512) * 2.0).astype(np.float32)
    rounds = 12
    delivered, residual = _ef_stream(x, code, rounds)
    lhs = rounds * x.astype(np.float64)
    np.testing.assert_allclose(delivered + residual, lhs,
                               rtol=1e-5, atol=1e-4)
    # bounded: one step of the quantizer, NOT rounds * step
    step = (np.abs(x).max() / 127.0) if code == wire_codec.WIRE_INT8 \
        else np.abs(x).max() * 2.0 ** -8
    assert float(np.abs(residual).max()) <= 2 * step


def test_error_feedback_residual_drains_on_representable_stream():
    # once the folded value is exactly representable the residual is 0
    x = np.array([1.0, -2.0, 0.5, 64.0], np.float32)
    delivered, residual = _ef_stream(x, wire_codec.WIRE_BF16, 5)
    np.testing.assert_array_equal(residual, np.zeros_like(x))
    np.testing.assert_allclose(delivered, 5 * x.astype(np.float64))


# ---------------------------------------------------------------------------
# np=2 TCP e2e: push-sum consensus per wire dtype + balanced ledger
# ---------------------------------------------------------------------------


def _worker_wire_pushsum(rank, size, steps):
    assert os.environ.get("BLUEFOG_ISLAND_TRANSPORT") == "tcp"
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    islands.turn_on_win_ops_with_associated_p()
    x = np.full((5,), float(rank * 10), np.float64)
    islands.win_create(x, "wps", zero_init=True)
    for _ in range(steps):
        islands.push_sum_round("wps")
    islands.barrier()
    for _ in range(int(np.ceil(np.log2(size))) + 2):
        islands.push_sum_round("wps")
        islands.barrier()
    val = islands.win_sync("wps") / islands.win_associated_p("wps")
    p = islands.win_associated_p("wps")
    islands.win_free("wps")
    return val.copy(), p


@pytest.mark.parametrize("wire_dtype,atol", [
    ("f32", 1e-7),
    # EF keeps the LONG-RUN average unbiased; what is left after the
    # drain rounds is the unsent residual (one quantizer step per
    # edge), amplified by the division by p
    ("bf16", 0.15),
    ("int8", 1.0),
])
def test_tcp_pushsum_consensus_and_ledger(monkeypatch, tmp_path,
                                          wire_dtype, atol):
    monkeypatch.setenv("BLUEFOG_ISLAND_TRANSPORT", "tcp")
    monkeypatch.setenv("BFTPU_WIRE_DTYPE", wire_dtype)
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    size, steps = 2, 20
    res = islands.spawn(_worker_wire_pushsum, size, args=(steps,),
                        job=f"wire_ps_{wire_dtype}", timeout=300.0)
    mean = np.mean([r * 10.0 for r in range(size)])
    for val, p in res:
        assert p > 0
        np.testing.assert_allclose(val, np.full(5, mean), rtol=0,
                                   atol=atol)
    # the mass ledger must balance EXACTLY regardless of the wire dtype:
    # p rides f64 in the commit frame, only values are quantized
    assert telemetry_cli([str(tmp_path), "--check"]) == 0


# ---------------------------------------------------------------------------
# chaos: SIGKILL mid-chunk-stream, drain loses no committed mass
# ---------------------------------------------------------------------------

_N = 5000  # 20000 B f32 -> 5 chunks of 4096 B


def _chaos_writer(job_name, coord):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow

    job = TcpShmJob(job_name, 1, 2, coord)
    win = TcpShmWindow(job_name, "w", 1, 2, 2, (_N,), np.float32, coord)
    job.barrier()
    x = np.arange(_N, dtype=np.float32)
    win.write(0, 0, x, p=0.5)           # committed deposit: must survive
    job.barrier()
    # die after 2 of 5 chunk frames of the second deposit: the stream is
    # open (wseq odd) and incomplete when the SIGKILL lands
    os.environ["BFTPU_CHAOS_KILL_CHUNK"] = "1:2"
    win.write(0, 1, x + 1.0, p=0.25)
    raise AssertionError("writer survived its own kill schedule")


def _chaos_reader(job_name, coord, q):
    os.environ["BLUEFOG_SHM_CHUNK_BYTES"] = "4096"
    from bluefog_tpu_torch.native.tcp_transport import TcpShmJob, TcpShmWindow
    from bluefog_tpu_torch.telemetry import registry as _telemetry

    job = TcpShmJob(job_name, 0, 2, coord)
    win = TcpShmWindow(job_name, "w", 0, 2, 2, (_N,), np.float32, coord)
    job.barrier()
    job.barrier()  # writer's slot-0 deposit is committed past here
    reg = _telemetry.get_registry()
    deadline = time.monotonic() + 60.0
    drains = 0
    while time.monotonic() < deadline:
        # a read during the mid-flight stream parks on the store
        # condition and is released by the dead-writer drain — it must
        # NEVER observe a torn (partial, uncommitted) deposit
        a1, p1, _ = win.read(1)
        assert p1 == 0.0, p1
        assert not a1.any(), "torn read: partial chunk stream visible"
        drains = reg.counter("tcp.mid_stream_drains").value \
            if reg.enabled else 0
        if drains:
            break
        time.sleep(0.05)
    a0, p0, _ = win.read(0, collect=True)
    q.put((drains, float(p0), float(a0.sum()),
           bool(np.array_equal(a0, np.arange(_N, dtype=np.float32)))))
    win.close()
    job.close()


def test_chaos_kill_mid_chunk_stream_drains_clean(monkeypatch, tmp_path):
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    monkeypatch.setenv("BFTPU_PEER_TIMEOUT_S", "45")
    monkeypatch.delenv("BFTPU_CHAOS_KILL_CHUNK", raising=False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    job_name = f"wirechaos{os.getpid()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pw = ctx.Process(target=_chaos_writer, args=(job_name, coord))
    pr = ctx.Process(target=_chaos_reader, args=(job_name, coord, q))
    pr.start()
    pw.start()
    drains, p0, asum, intact = q.get(timeout=120)
    pw.join(30)
    pr.join(30)
    assert pw.exitcode == -9, pw.exitcode      # the SIGKILL really fired
    assert pr.exitcode == 0, pr.exitcode
    # the drain ran (mid-stream: the disconnect found an odd wseq) ...
    assert drains >= 1, drains
    # ... and the COMMITTED deposit lost nothing
    assert intact and p0 == 0.5, (p0, asum)
