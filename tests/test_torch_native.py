"""``native/`` of bluefog_tpu_torch against the JAX package.

The port builds its library from its own copy of the C++ sources into
``bluefog_tpu_torch/_build/native/`` and declares the reference's ctypes
ABI.  The wire is shared: in one process, a window and a job segment that
the JAX ``shm_native`` writes are read by the port's, and the other way
round (write / accumulate / collect / expose, versions, the mutex), bit for
bit, for the native and the ``BLUEFOG_SHM_FALLBACK=1`` (lockf) transports;
a status page the port writes is read by the JAX reader.  The other native
consumers (plan compiler, timeline writer, data loader, wire codec) give
the reference's results, and the plan compiler the port's Python split's."""

import dataclasses
import json
import os

import numpy as np
import pytest

import bluefog_tpu.native as jnative
from bluefog_tpu import topology_util as jtu
from bluefog_tpu.core.plan import compile_plan as jax_compile_plan
from bluefog_tpu.introspect import statuspage as jstatus
from bluefog_tpu.native import shm_native as jshm
from bluefog_tpu.native import wire_codec as jcodec
import bluefog_tpu_torch.native as tnative
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.core import plan as tplan
from bluefog_tpu_torch.introspect import statuspage as tstatus
from bluefog_tpu_torch.native import plan_native
from bluefog_tpu_torch.native import shm_native as tshm
from bluefog_tpu_torch.native import wire_codec as tcodec


def test_library_is_built_from_the_port_sources_with_the_reference_abi():
    lib = tnative.get_lib()
    path = tnative.build_info["path"]
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(tnative.__file__), os.pardir, "_build", "native") or \
        os.path.realpath(os.path.dirname(path)) == os.path.realpath(tnative.BUILD_DIR)
    assert os.path.basename(path).startswith("libbluefog_native_")
    assert lib.bf_shm_abi_version() == 2
    for name in tnative.SOURCES:  # the reference's sources
        with open(os.path.join(os.path.dirname(tnative.__file__), name)) as f:
            mine = f.read().splitlines()
        with open(os.path.join(os.path.dirname(jnative.__file__), name)) as f:
            theirs = f.read().splitlines()
        if name == "timeline.cc":
            # one repair: a write lock around WriteFile (the flusher thread
            # and Flush() raced on the shared tmp path)
            extra = [l for l in mine if l not in theirs]
            assert [l for l in theirs if l not in mine] == [], extra
            assert sum("write_mu_" in l for l in extra) == 2, extra
        else:
            assert mine == theirs, name
    ref = jnative.get_lib()
    assert ref is not None and ref._name != lib._name
    declared = sorted(n for n in lib.__dict__ if n.startswith("bf_"))
    assert declared == sorted(n for n in ref.__dict__ if n.startswith("bf_"))
    for n in declared:
        a, b = getattr(lib, n), getattr(ref, n)
        assert a.restype == b.restype, n
        assert list(a.argtypes) == list(b.argtypes), n


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "library_path", lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    script = tmp_path / "badcxx"
    script.write_text("#!/bin/sh\necho 'fatal: planted compiler failure' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    with pytest.raises(RuntimeError, match="planted compiler failure"):
        tnative.build()


def test_fallback_transport_is_chosen_only_when_asked(monkeypatch, tmp_path):
    def no_lib():
        raise RuntimeError("native library cannot be built")

    monkeypatch.setattr(tshm, "get_lib", no_lib)
    monkeypatch.setattr(tshm, "_FALLBACK_DIR", str(tmp_path))
    job = f"tfb{os.getpid()}"
    monkeypatch.setenv("BLUEFOG_SHM_FALLBACK", "0")
    assert tshm.transport_kind() == "native"
    with pytest.raises(RuntimeError, match="cannot be built"):
        tshm.make_window(job, "x", 0, 1, 1, (2,), np.float32)
    monkeypatch.setenv("BLUEFOG_SHM_FALLBACK", "1")
    assert tshm.transport_kind() == "lockf"
    w = tshm.make_window(job, "x", 0, 1, 1, (2,), np.float32)
    assert isinstance(w, tshm.FallbackShmWindow)
    w.close(unlink=True)
    tshm.unlink_all(job)


def _segments(job):
    return [f for d in {"/dev/shm", jshm._FALLBACK_DIR}
            for f in (os.listdir(d) if os.path.isdir(d) else []) if job in f]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fallback", ["0", "1"])
def test_wire_one_job_both_packages(fallback, dtype, monkeypatch, tmp_path):
    monkeypatch.setenv("BLUEFOG_SHM_FALLBACK", fallback)
    if fallback == "1":
        monkeypatch.setattr(jshm, "_FALLBACK_DIR", str(tmp_path))
        monkeypatch.setattr(tshm, "_FALLBACK_DIR", str(tmp_path))
    job = f"twire{os.getpid()}_{fallback}_{np.dtype(dtype).name}"
    rng = np.random.default_rng(0)
    shape = (3, 5)
    a, b, c = (rng.standard_normal(shape).astype(dtype) for _ in range(3))
    # rank 0 is the JAX package, rank 1 the port; slot k of rank d is d's
    # k-th in-neighbor (here: the other rank is the only writer, slot 0)
    jw = jshm.make_window(job, "x", 0, 2, 1, shape, dtype)
    tw = tshm.make_window(job, "x", 1, 2, 1, shape, dtype)
    assert type(jw).__name__ == type(tw).__name__
    try:
        # JAX writes into the port's slot, the port reads it
        jw.write(1, 0, a, p=0.5)
        got, p, ver = tw.read(0)
        assert np.array_equal(got, a) and p == 0.5 and ver == 1
        assert tw.read_version(0) == 1
        jw.write(1, 0, b, p=0.25, accumulate=True)
        got, p, ver = tw.read(0, collect=True)
        want = a + b
        assert np.array_equal(got, want) and p == 0.75 and ver == 2
        got, p, _ = tw.read(0)
        assert np.array_equal(got, np.zeros(shape, dtype)) and p == 0.0
        # the port writes into the JAX rank's slot, JAX reads it
        tw.write(0, 0, c, p=2.0)
        tw.write(0, 0, a, p=1.0, accumulate=True)
        got, p, ver = jw.read(0, collect=True)
        assert np.array_equal(got, c + a) and p == 3.0 and ver == 2
        # scaled deposits, where the transport fuses the scale
        if getattr(tw, "supports_scale", False):
            tw.write(0, 0, b, p=0.5, scale=0.5)
            got, p, _ = jw.read(0)
            assert np.array_equal(got, b * dtype(0.5)) and p == 0.5
        # exposures both ways
        jw.expose(c, p=4.0)
        tw.expose(b, p=5.0)
        got, p, _ = tw.read_exposed(0)
        assert np.array_equal(got, c) and p == 4.0
        got, p, _ = jw.read_exposed(1)
        assert np.array_equal(got, b) and p == 5.0
    finally:
        tw.close()
        jw.close(unlink=True)
    jj = jshm.make_job(job, 0, 2)
    tj = tshm.make_job(job, 1, 2)
    try:
        jj.heartbeat()
        assert tj.liveness(0) > 0
        if fallback == "1":
            # lockf ranges lock per process: the fallback mutex is held
            # across packages in the mixed-fleet island test instead
            return
        jj.mutex_acquire(1)
        with pytest.raises(TimeoutError):
            tj.mutex_acquire(1, timeout=0.05)
        jj.mutex_release(1)
        tj.mutex_acquire(1, timeout=1.0)
        with pytest.raises(TimeoutError):
            jj.mutex_acquire(1, timeout=0.05)
        tj.mutex_release(1)
    finally:
        tj.close()
        jj.close(unlink=True)
        tshm.unlink_all(job)
    assert _segments(job) == []


def test_status_page_written_by_the_port_reads_in_the_reference(monkeypatch):
    job = f"tstat{os.getpid()}"
    page = tstatus.StatusPage(job, 2)
    try:
        page.publish(nranks=4, step=17, epoch=3, op_id=99, last_op="win_put",
                     ledger={"deposits": 5.0, "collected": 4.0, "pending": 1.0},
                     edges=[(1, 0, 0.25), (3, 1, 0.5)], qdepth=2, inflight="put:w",
                     conv_err=0.125, conv_round=8)
        assert tstatus.status_page_path(job, 2) == jstatus.status_page_path(job, 2)
        got = jstatus.read_status_page(jstatus.status_page_path(job, 2))
        mine = tstatus.read_status_page(tstatus.status_page_path(job, 2))
        assert got == mine
        assert got["rank"] == 2 and got["step"] == 17 and got["epoch"] == 3
        assert got["last_op"] == "win_put" and got["progress"]["qdepth"] == 2
        assert got["ledger"]["deposits"] == 5.0 and len(got["edges"]) == 2
        assert jstatus.find_status_pages(job) == {2: tstatus.status_page_path(job, 2)}
    finally:
        page.close(unlink=True)


@pytest.mark.parametrize("graph,n", [("ExponentialTwoGraph", 8), ("RingGraph", 5),
                                     ("MeshGrid2DGraph", 9), ("StarGraph", 6),
                                     ("FullyConnectedGraph", 4)])
def test_plan_compiler_native_matches_python_and_reference(graph, n):
    G = getattr(ttu, graph)(n)
    edges = sorted((u, v) for u, v in G.edges if u != v)
    cls_arr, slot_arr, _ = plan_native.compile_edge_classes(n, edges)
    assert ([int(c) for c in cls_arr], [int(k) for k in slot_arr]) == \
        tplan._edge_classes_and_slots(n, edges)
    ref = jax_compile_plan(getattr(jtu, graph)(n))
    got = tplan.compile_plan(G)
    assert got.self_weights == ref.self_weights and len(got.classes) == len(ref.classes)
    for a, b in zip(got.classes, ref.classes):
        assert a.perm == b.perm and a.recv_weights == b.recv_weights
        assert a.slot_index == b.slot_index


def test_native_timeline_writer(tmp_path):
    from bluefog_tpu_torch import timeline

    path = str(tmp_path / "t.json")
    w = timeline.TimelineWriter(path)
    assert w.route == "native"
    w.record("phase1", 1.0, 2.0, tid=3)
    w.record_counter("bytes", 4.0, 7.0)
    w.flush()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e["name"] == "phase1" and e["ph"] == "X" for e in events)
    assert any(e["name"] == "bytes" and e["ph"] == "C" for e in events)


def test_data_loader_batches_match_reference(tmp_path):
    from bluefog_tpu.native.data_native import NativeDataLoader as JLoader
    from bluefog_tpu_torch.native.data_native import NativeDataLoader as TLoader

    with TLoader((4, 8), depth=3, workers=1, seed=7) as t, \
            JLoader((4, 8), depth=3, workers=1, seed=7) as j:
        for _ in range(5):
            np.testing.assert_array_equal(t.next(), j.next())
    raw = np.arange(96, dtype=np.float32)
    path = str(tmp_path / "d.bin")
    raw.tofile(path)
    with TLoader((16,), depth=2, workers=1, path=path) as t:
        for i in range(6):
            np.testing.assert_array_equal(t.next(), raw[i * 16:(i + 1) * 16])


@pytest.mark.parametrize("code", ["WIRE_RAW", "WIRE_BF16", "WIRE_INT8"])
def test_wire_codec_matches_reference(code):
    rng = np.random.default_rng(1)
    assert getattr(tcodec, code) == getattr(jcodec, code)
    for scale in (1e-3, 1.0, 1e3):
        x = (rng.standard_normal(1000) * scale).astype(np.float32)
        got = tcodec.encode_chunk(x, getattr(tcodec, code))
        want = jcodec.encode_chunk(x, getattr(jcodec, code))
        assert got[0] == want[0] and bytes(got[1]) == bytes(want[1]) and got[2] == want[2]
        np.testing.assert_array_equal(
            tcodec.decode_chunk(got[1], got[0], got[2], np.float32, x.size),
            jcodec.decode_chunk(want[1], want[0], want[2], np.float32, x.size))


def test_transport_capabilities_match_reference():
    from bluefog_tpu.native import routed_transport as jrouted
    from bluefog_tpu.native import tcp_transport as jtcp
    from bluefog_tpu_torch.native import routed_transport as trouted
    from bluefog_tpu_torch.native import tcp_transport as ttcp

    pairs = [(tshm.NativeShmWindow, jshm.NativeShmWindow),
             (tshm.FallbackShmWindow, jshm.FallbackShmWindow),
             (ttcp.TcpShmWindow, jtcp.TcpShmWindow),
             (trouted.RoutedWindow, jrouted.RoutedWindow)]
    for t, j in pairs:
        assert dataclasses.asdict(t.CAPS) == dataclasses.asdict(j.CAPS), t.__name__
    assert trouted.parse_hostmap("a,a,b,b", 4) == jrouted.parse_hostmap("a,a,b,b", 4)
    assert tshm.seg_name("job", "win_x") == jshm.seg_name("job", "win_x")
