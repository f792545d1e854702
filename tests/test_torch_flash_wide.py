"""Flash attention above head dim 256, the rest of the JAX kernel's range:
the port's ``flash_attention_with_lse`` against the JAX package's Pallas
kernel (interpret mode on the CPU), forward (o, lse) and gradients through
``jax.vjp`` with a nonzero lse cotangent, at D = 320 and 512 in bf16, f16
and f32, and at D = 1024 (the reference example's ``--hidden 4096``) in
f32.  On the CPU the port's wrappers run their plain versions; the wide
CUDA kernels, which take D zero-padded to a multiple of 256, are held
against those plain versions on the card (``chip_smoke.py`` phase
``kernel_times_wide``).  Tolerances as ``test_torch_flash_d256.py``: f32 at
``ATOL`` against the JAX kernel; bf16 and f16 no farther from a float64
dense attention than the JAX kernel, plus one unit in the last place."""

import importlib

import numpy as np
import pytest
import torch

from test_torch_flash_d256 import ATOL, CASES, _dense64, _inputs, _jax, _port, _ulp

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")
torch.set_num_threads(1)
NAMES = ("o", "lse", "dq", "dk", "dv")


def _held_to_the_pallas_kernel(d, dtype, case):
    q_start, k_start, causal = CASES[case]
    args = _inputs(d + len(case), d, dtype)
    want = _jax(*args, q_start, k_start, causal, dtype)
    got = _port(*args, q_start, k_start, causal, dtype)
    if dtype == "float32":
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6 if name == "lse" else 0, atol=ATOL,
                                       err_msg=name)
        return
    truth = _dense64(*args, q_start, k_start, causal)
    for name, a, b, t in zip(NAMES, got, want, truth):
        scale = float(np.abs(t).max())
        port_err = float(np.abs(a - t).max())
        jax_err = float(np.abs(b - t).max())
        assert port_err <= jax_err + _ulp(dtype, scale), (name, port_err, jax_err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_above_head_dim_256_matches_the_pallas_kernel(d, dtype, case):
    _held_to_the_pallas_kernel(d, dtype, case)


def test_flash_at_head_dim_1024_matches_the_pallas_kernel():
    _held_to_the_pallas_kernel(1024, "float32", "causal")


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_head_dim_320_pads_to_the_wide_width_exactly(kernel):
    """pad_head_dim takes D = 320 to 512, the next multiple of the wide
    kernels' 256 (zero columns, results cut back): through the plain
    versions every output is within 1e-6 of the largest of the unpadded
    result, in the unpadded shape.  D = 512 and 1024 pass through."""
    rng = np.random.default_rng(320)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 80, 320)).astype(np.float32))
                  for _ in range(4))
    kw = dict(scale=320 ** -0.5, causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, 8, 0, **kw)
    corr = torch.from_numpy(rng.normal(size=(2, 80)).astype(np.float32)) - (o * g).sum(-1)
    args = {"fwd": (q, k, v, 8, 0), "dkv": (q, k, v, g, lse, corr, 8, 0),
            "dq": (q, k, v, g, lse, corr, 8, 0)}[kernel]
    plain = getattr(fa, f"flash_{kernel}_plain")
    seen = []

    def spy(*a, **kw_):
        seen.append(a[0].shape[-1])
        return plain(*a, **kw_)

    want = plain(*args, **kw)
    got = fa.pad_head_dim(spy, *args, **kw)
    assert seen == [512]
    want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), (a - b).abs().max()
    for d in (512, 1024):
        x = torch.zeros(1, 8, d)
        assert fa.pad_head_dim(lambda *a: a[0].shape[-1], x, x, x) == d


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_wide_launch_order_puts_the_column_slice_fastest(kernel):
    """Above 256 each block of the D <= 128 launch comes once for each
    column slice in a row (fwd and dQ 256 columns, dK/dV 128), D padded as
    the wrappers pad it."""
    base, rows = fa.launch_order(kernel, 512, 512, causal=True, bh=2, d=128)
    for d, slices in ((512, {"fwd": 2, "dkv": 4, "dq": 2}), (320, {"fwd": 2, "dkv": 4, "dq": 2}),
                      (1024, {"fwd": 4, "dkv": 8, "dq": 4})):
        wide, wide_rows = fa.launch_order(kernel, 512, 512, causal=True, bh=2, d=d)
        n = slices[kernel]
        assert wide_rows == rows and len(wide) == n * len(base)
        assert wide == [block for block in base for _ in range(n)]
