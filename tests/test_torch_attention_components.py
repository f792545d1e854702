"""The roofline's tile-component microkernels against the JAX package's own
Pallas bodies (``benchmarks/attention_roofline.py``, run in interpret mode on
the CPU).  The script's ``_pallas_component`` is replaced by a capture of
``(make_kernel, inputs, out_shape)``, so ``component_times`` and
``bwd_component_times`` hand over exactly the bodies and inputs they would
time; each body runs at ``reps`` 1 and 2 and the same inputs go to the port,
whose every slice (``TILES_PER_BLOCK`` tiles a block) is held against it.
On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (``chip_smoke.py``, ``test_torch_cuda.py``).

Tolerance: ``attention_components.compare``.  Both sides round to bf16 at the
same points, so every element agrees within 1e-5 (|ref| + rms(ref)) (f32 sums
in another order; measured here: at most 6e-7 of rms), except that at reps 2
one element of the fed-back row may round to the adjacent bf16 value, which
the rule bounds through the product.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bluefog_tpu_torch.kernels import attention_components as ac

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def captured():
    """{instance: (make_kernel, inputs, out_shape)} from the JAX script.

    Importing the script (and the repo-root ``bench`` it imports) points
    JAX's persistent compilation cache at /tmp; both settings are put back
    so later tests in this worker compile as before."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_attention_roofline", os.path.join(REPO, "benchmarks", "attention_roofline.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    caps = []

    def capture(make_kernel, inputs, out_shape, reps_pair=None):
        caps.append((make_kernel, inputs, out_shape))
        return 1.0

    script._pallas_component = capture
    out = {}
    for d in (64, 128):
        caps.clear()
        script.component_times(64, 64, d)
        # qk at D = 128 is undefined in the script (acc is 64 wide)
        if d == 64:
            out["qk64"], out["softmax_chain"] = caps[0], caps[2]
        out[f"pv{d}"] = caps[1]
    caps.clear()
    script.bwd_component_times(64, 64)
    out["bwd_chain_cast_p"], out["bwd_chain"] = caps
    return out


def _torch(x):
    a = np.asarray(x)
    t = torch.tensor(a.astype(np.float32))
    return t if a.dtype == np.float32 else t.to(torch.bfloat16)


PORT = {  # instance -> (component name, wrapper call, keyword arguments)
    "qk64": ("qk", lambda a, r: ac.qk_component(*a, r), {}),
    "pv64": ("pv", lambda a, r: ac.pv_component(*a, r), {}),
    "pv128": ("pv", lambda a, r: ac.pv_component(*a, r), {}),
    "softmax_chain": ("softmax_chain", lambda a, r: ac.softmax_chain_component(*a, r), {}),
    "bwd_chain_cast_p": ("bwd_chain", lambda a, r: ac.bwd_chain_component(*a, r, cast_p=True),
                         {"cast_p": True}),
    "bwd_chain": ("bwd_chain", lambda a, r: ac.bwd_chain_component(*a, r, cast_p=False),
                  {"cast_p": False}),
}


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("instance", sorted(PORT))
def test_component_matches_pallas_body(captured, instance, reps):
    make_kernel, inputs, out_shape = captured[instance]
    want = np.array(pl.pallas_call(make_kernel(reps), out_shape=out_shape,
                                   interpret=True)(*inputs))
    name, call, kw = PORT[instance]
    args = [_torch(x) for x in inputs]
    got = call(args, reps)
    assert got.shape == (ac.TILES_PER_BLOCK[name], *want.shape)
    res = ac.compare(name, got, torch.from_numpy(want).expand_as(got), args, reps, **kw)
    assert res["ok"], res
    assert res["tol_ratio"] <= 1.0, res  # no bf16 flip happens with these inputs


@pytest.mark.parametrize("reps", [1, 2])
def test_qk_at_d128_feeds_the_row_to_every_column(captured, reps):
    """The Pallas qk body is undefined at D = 128 with 64-wide tiles; the
    port feeds acc[0, j mod 64] to q's column j.  Held against the same
    recurrence written out in numpy on the script's D = 64 draws widened."""
    _, (q64, k64), _ = captured["qk64"]
    q = np.concatenate([np.asarray(q64, np.float32)] * 2, axis=1)  # [64, 128]
    k = np.concatenate([np.asarray(k64, np.float32)] * 2, axis=0)  # [128, 64]
    bf = lambda x: np.asarray(x.astype(jax.numpy.bfloat16), np.float32)
    acc = np.zeros((64, 64), np.float32)
    for _ in range(reps):
        row = np.tile(bf(acc[0:1]), (1, 2))
        acc = acc * 0.5 + bf(q + row) @ k
    args = [_torch(q).to(torch.bfloat16), _torch(k).to(torch.bfloat16)]
    got = ac.qk_component(*args, reps)
    assert got.shape == (ac.TILES_PER_BLOCK["qk"], 64, 64)
    res = ac.compare("qk", got, torch.from_numpy(acc).expand_as(got), args, reps)
    assert res["ok"] and res["tol_ratio"] <= 1.0, res


@pytest.mark.parametrize("name", sorted(ac.PLAIN))
def test_dependency_pass_alone(name):
    """body=False keeps only the fed-back row: acc <- 0.5 acc + (row + 1),
    every block equal, whatever the operands."""
    gen = torch.Generator().manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    args = {"qk": (torch.randn(64, 128, generator=gen).to(bf),
                   torch.randn(128, 64, generator=gen).to(bf)),
            "pv": (torch.randn(64, 64, generator=gen).to(bf),
                   torch.randn(64, 128, generator=gen).to(bf)),
            "softmax_chain": (torch.randn(64, 64, generator=gen, dtype=f32),),
            "bwd_chain": (torch.randn(64, 64, generator=gen, dtype=f32),) * 2}[name]
    kw = {"cast_p": True} if name == "bwd_chain" else {}
    wrapper = getattr(ac, f"{name}_component")
    out = wrapper(*args, 3, body=False, blocks=2, **kw)
    assert out.shape[0] == 2 * ac.TILES_PER_BLOCK[name]
    assert torch.equal(out, torch.full_like(out, 4.75))  # 1 -> 2.5 -> 4.75


@pytest.mark.parametrize("blocks", [1, 2, 3])
@pytest.mark.parametrize("name,d,kw", ac.INSTANCES)
def test_every_block_computes_tiles_per_block_equal_slices(name, d, kw, blocks):
    """A wrapper and its plain version both return ``blocks x
    TILES_PER_BLOCK[name]`` slices of the tile (two a block, one for each
    consumer warpgroup), every slice the one-block tile."""
    gen = torch.Generator().manual_seed(d + blocks)
    bf, f32 = torch.bfloat16, torch.float32
    args = {"qk": (torch.randn(64, d, generator=gen).to(bf),
                   torch.randn(d, 64, generator=gen).to(bf)),
            "pv": (torch.randn(64, 64, generator=gen).to(bf),
                   torch.randn(64, d, generator=gen).to(bf)),
            "softmax_chain": (torch.randn(64, 64, generator=gen, dtype=f32) * 0.1,),
            "bwd_chain": (torch.randn(64, 64, generator=gen, dtype=f32) * 0.1,) * 2}[name]
    width = d if name == "pv" else 64
    want_shape = (blocks * ac.TILES_PER_BLOCK[name], 64, width)
    one = ac.PLAIN[name](*args, 2, **kw)
    assert one.shape == (ac.TILES_PER_BLOCK[name], 64, width)
    for fn in (getattr(ac, f"{name}_component"), ac.PLAIN[name]):
        out = fn(*args, 2, blocks=blocks, **kw)
        assert out.shape == want_shape
        assert torch.equal(out, one[:1].expand(want_shape))


def test_wrappers_check_inputs_and_count_only_launches():
    ac.reset_launches()
    bf = torch.bfloat16
    q, k = torch.zeros(64, 64, dtype=bf), torch.zeros(64, 64, dtype=bf)
    ac.qk_component(q, k, 2, blocks=3)
    assert ac.launches == {"qk": 0, "pv": 0, "softmax_chain": 0, "bwd_chain": 0}
    with pytest.raises(ValueError, match="head dim"):
        ac.qk_component(torch.zeros(64, 32, dtype=bf), torch.zeros(32, 64, dtype=bf), 1)
    with pytest.raises(ValueError, match="shape"):
        ac.pv_component(torch.zeros(32, 64, dtype=bf), torch.zeros(64, 64, dtype=bf), 1)
    with pytest.raises(ValueError, match="float32"):
        ac.softmax_chain_component(torch.zeros(64, 64, dtype=bf), 1)
    with pytest.raises(ValueError, match="blocks"):
        ac.qk_component(q, k, 1, blocks=0)
    with pytest.raises(ValueError, match="smem"):
        ac.qk_component(q, k, 1, smem_bytes=ac.MAX_SMEM + 1)
