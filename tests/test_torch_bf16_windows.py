"""bf16 island windows: the port against the JAX package.

The JAX package's islands keep a bf16 window as ``ml_dtypes.bfloat16``
arrays; numpy alone has no bfloat16, so the port keeps the same two bytes
a value (``progress.staging.BF16``) and does the arithmetic on torch bf16
CPU tensors in the JAX package's order: a weighted deposit is
``bf16(f32(x) * f32(w))``, ``win_update``'s combine is
``bf16(f64(self) * w + sum f64(f32(slot) * f32(w)))`` and the debiased
estimate ``f32(x) / f32(p)``.  Every case here is held bit for bit: no
tolerance is needed.

- the expressions, element by element against ``ml_dtypes`` arrays;
- a mixed fleet (2 JAX + 2 torch islands in one job on a bf16 window:
  plain deposits, weighted deposits, ``win_get``, explicit and default
  combines) against an all-JAX fleet running the same script;
- the round-trip through the serve region (``bfloat16`` names the dtype
  either way).
"""

import multiprocessing as mp
import os
import traceback

import ml_dtypes
import numpy as np
import pytest
import torch

from bluefog_tpu_torch import islands as tislands
from bluefog_tpu_torch.native import shm_native
from bluefog_tpu_torch.progress import staging

BF = ml_dtypes.bfloat16


def _bits_of_ref(a):
    return np.asarray(a, dtype=BF).view(np.uint16)


def _bits_of_port(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _inputs(rank, n=512):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(n) * (1 + rank)).astype(np.float32).astype(BF)


def test_bf16_host_dtype_is_the_reference_layout():
    x = _inputs(0)
    t = staging.tensor_view(x.view(np.uint16).view(staging.BF16))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits_of_port(t), _bits_of_ref(x))
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    back = staging.host_view(t)
    assert back.dtype == staging.BF16 and back.itemsize == BF(0).itemsize
    np.testing.assert_array_equal(back.view(np.uint16), _bits_of_ref(x))


@pytest.mark.parametrize("w", [1 / 3, 0.2, 0.7, 1 / 7, 0.123456789, 0.5])
def test_bf16_arithmetic_matches_ml_dtypes(w):
    """Each expression of the reference's bf16 path, bit for bit."""
    a, b = _inputs(1, 4096), _inputs(2, 4096)
    ha = a.view(np.uint16).view(staging.BF16)
    hb = b.view(np.uint16).view(staging.BF16)
    # a weighted deposit: ml_dtypes computes f32, the deposit rounds to bf16
    np.testing.assert_array_equal(
        tislands._scaled(ha, w).view(np.uint16), _bits_of_ref((a * w).astype(BF)))
    # the non-fused win_update combine, in the reference's expression order
    acc = np.multiply(a, w, dtype=np.float64)
    scratch = np.empty_like(acc)
    np.multiply(b, 1 - w, out=scratch, casting="unsafe")
    np.add(acc, scratch, out=acc)
    want = acc.astype(BF)
    got = staging.tensor_view(ha).double() * w
    got += (staging.tensor_view(hb).float() * (1 - w)).double()
    np.testing.assert_array_equal(_bits_of_port(got.to(torch.bfloat16)), _bits_of_ref(want))
    # the debiased estimate x / p: f32
    np.testing.assert_array_equal((staging.tensor_view(ha).float() / w).numpy(),
                                  np.asarray(a) / w)


def _member(pkg, rank, size, job, q):
    try:
        if pkg == "jax":
            from bluefog_tpu import islands as isl
            from bluefog_tpu import topology_util as tu
            x = _inputs(rank)
        else:
            from bluefog_tpu_torch import islands as isl
            from bluefog_tpu_torch import topology_util as tu
            x = torch.from_numpy(_inputs(rank).view(np.int16)).view(torch.bfloat16)
        isl.init(rank, size, job)
        isl.set_topology(tu.ExponentialTwoGraph(size))
        isl.win_create(x, "b")
        outs = isl.out_neighbor_ranks()
        ins = isl.in_neighbor_ranks()
        got = []
        # 1: plain deposit, default (uniform) combine
        isl.win_put(x, "b")
        isl.barrier()
        got.append(_bits_of_port(isl.win_update("b")))
        isl.barrier()
        # 2: weighted deposits, explicit combine weights
        isl.win_put(isl.win_sync("b"), "b",
                    dst_weights={d: 0.3 + 0.1 * i for i, d in enumerate(outs)})
        isl.barrier()
        got.append(_bits_of_port(isl.win_update(
            "b", self_weight=0.45,
            neighbor_weights={s: 0.55 / len(ins) for s in ins})))
        isl.barrier()
        # 3: a weighted pull from the in-neighbors, then the default combine
        isl.win_get("b", src_weights={s: 0.7 for s in ins})
        isl.barrier()
        got.append(_bits_of_port(isl.win_update("b")))
        isl.barrier()
        out = isl.win_sync("b")
        kind = type(out).__name__ + ":" + str(getattr(out, "dtype", ""))
        isl.win_free("b")
        q.put((rank, True, (got, kind)))
        isl.barrier()
        isl.shutdown(unlink=(rank == 0))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, f"{e}\n{traceback.format_exc()}"))


def _fleet(pkgs, job):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_member, args=(pkg, r, len(pkgs), job, q))
             for r, pkg in enumerate(pkgs)]
    for p in procs:
        p.start()
    results, failures = {}, []
    try:
        for _ in pkgs:
            r, ok, out = q.get(timeout=300)
            (results.__setitem__(r, out) if ok else failures.append(out))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
        shm_native.unlink_all(job)
    assert not failures, "\n".join(failures)
    return results


@pytest.mark.island_e2e
def test_mixed_fleet_on_a_bf16_window_matches_the_reference_fleet(monkeypatch):
    """2 JAX + 2 torch islands share one bf16 window; every rank's result
    after each of the three rounds equals, bit for bit, what the same rank
    gets in a fleet of 4 JAX islands."""
    monkeypatch.setenv("BFTPU_STATUSPAGE", "0")
    mixed = _fleet(["jax", "jax", "torch", "torch"], f"tbfmix{os.getpid()}")
    ref = _fleet(["jax"] * 4, f"tbfref{os.getpid()}")
    for r in range(4):
        got, kind = mixed[r]
        want, ref_kind = ref[r]
        assert ref_kind == "ndarray:bfloat16"
        assert kind == ("ndarray:bfloat16" if r < 2 else "Tensor:torch.bfloat16")
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} round {step}")
    # the rounds moved the values (the check is not of an idle window)
    assert not np.array_equal(mixed[0][0][0], _bits_of_ref(_inputs(0)))


def test_bf16_window_round_trips_through_the_serve_region(tmp_path, monkeypatch):
    """A bf16 window published by the port reads back, through either
    package's region reader, as the same bf16 bytes."""
    from bluefog_tpu.serve.snapshot import read_committed as ref_read
    from bluefog_tpu_torch.serve.snapshot import read_committed

    job = f"tbfsrv{os.getpid()}"
    x = torch.from_numpy(_inputs(3).view(np.int16)).view(torch.bfloat16)
    tislands.init(0, 1, job)
    try:
        tislands.win_create(x, "w")
        assert tislands.serve_publish("w") == 1
        _, _, _, got = read_committed(job)
        assert got.dtype == staging.BF16
        np.testing.assert_array_equal(got.view(np.uint16), _bits_of_port(x))
        _, _, _, ref_got = ref_read(job)
        assert ref_got.dtype == BF
        np.testing.assert_array_equal(ref_got.view(np.uint16), _bits_of_port(x))
        tislands.win_free("w")
    finally:
        tislands.shutdown(unlink=True)
        shm_native.unlink_all(job)
