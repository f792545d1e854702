"""The float64 truth of benchmarks/flash_bf16_rounding.py, on the CPU.

``truth(q, k, v, g, lse, corr, scale)`` must be the exact gradient of
causal attention: given the exact logsumexp and ``corr = g_lse -
rowsum(o * g)`` it equals torch autograd of float64 attention with the
loss ``sum(o * g) + sum(lse * g_lse)``, to float64 roundoff (1e-10 of
each output's largest entry).  And the plain bf16 versions sit near it:
within 1e-2 in norm, the bf16 rule's norm bound.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from bluefog_tpu_torch.benchmarks.flash_bf16_rounding import truth

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")


def _inputs(bh, t, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, t, d), dtype=np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal((bh, t), dtype=np.float32))
    return q, k, v, g, g_lse


@pytest.mark.parametrize("bh,t,d", [(2, 64, 16), (3, 130, 32)])
def test_truth_is_the_float64_attention_gradient(bh, t, d):
    q, k, v, g, g_lse = _inputs(bh, t, d, seed=t)
    scale = 1.0 / math.sqrt(d)
    q64, k64, v64 = (x.double().requires_grad_(True) for x in (q, k, v))
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = (q64 @ k64.transpose(1, 2) * scale).masked_fill(~causal, -math.inf)
    lse = torch.logsumexp(s, -1)
    o = torch.softmax(s, -1) @ v64
    (o * g.double()).sum().add((lse * g_lse.double()).sum()).backward()
    corr = g_lse.double() - (o.detach() * g.double()).sum(-1)
    got = truth(q, k, v, g, lse.detach(), corr, scale)
    for name, want in (("o", o.detach()), ("dk", k64.grad), ("dv", v64.grad),
                       ("dq", q64.grad)):
        err = (got[name] - want).abs().max().item()
        assert err <= 1e-10 * want.abs().max().item(), (name, err)


def test_plain_versions_sit_near_the_truth():
    q, k, v, g, g_lse = _inputs(2, 192, 64, seed=0)
    kw = dict(scale=1.0 / math.sqrt(64), causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, 0, 0, **kw)
    corr = (g_lse - (o.float() * g.float()).sum(-1)).contiguous()
    dk, dv = fa.flash_dkv_plain(q, k, v, g, lse, corr, 0, 0, **kw)
    dq = fa.flash_dq_plain(q, k, v, g, lse, corr, 0, 0, **kw)
    exact = truth(q, k, v, g, lse, corr, kw["scale"])
    for name, got in (("o", o), ("dk", dk), ("dv", dv), ("dq", dq)):
        rel = ((got.double() - exact[name]).norm() / exact[name].norm()).item()
        assert rel <= 1e-2, (name, rel)
