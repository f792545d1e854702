"""Convolution, dense and batch-norm layers with flax's semantics.

The vision models of the JAX package (``bluefog_tpu/models/lenet.py`` and
``resnet.py``) are built from ``flax.linen`` layers, which differ from
``torch.nn``'s where it matters for carrying weights across and matching
results:

- ``padding="SAME"`` is asymmetric at stride 2: the extra row and column go
  at the end (:func:`same_padding`), so ``Conv2d(padding=k // 2)`` would
  shift the result by a pixel.
- ``BatchNorm`` normalizes with the *biased* batch variance, reduced in f32,
  feeds that same variance into its running average
  ``ra = momentum * ra + (1 - momentum) * batch``, and casts its output to
  ``dtype``.  ``torch.nn.BatchNorm2d`` feeds the unbiased variance instead.
- Initializers: lecun-normal kernels (normal truncated at two sigma, std
  1/sqrt(fan_in)), zero biases, ones (or zeros) for the norm scale.
- ``Dense(dtype=bf16)`` casts the f32 kernel and the input to bf16 and adds
  the bias after the product, in bf16 (:class:`Dense`'s ``compute_dtype``).
- ``LayerNorm`` takes epsilon 1e-6 (torch's default is 1e-5) and, with
  ``dtype=float32``, computes and returns f32 whatever its input
  (:class:`LayerNorm`).

Tensors inside are NCHW in shape and channels-last in memory (what cuDNN
runs fastest); the models take and flatten NHWC as the reference does.
Parameters and statistics are f32; ``dtype`` is the compute type.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm", "Conv2d", "Dense", "LayerNorm", "lecun_normal_", "max_pool_same",
           "same_padding"]

Padding = Union[str, Sequence[Tuple[int, int]]]
_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) cut at +-2


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal at +-2 sigma, rescaled so
    the truncated draw has std 1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under flax/XLA "SAME": the
    output has ceil(size / stride) positions, and an odd total pads one
    more at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_2d(x, pads: Sequence[Tuple[int, int]], value: float = 0.0):
    (hl, hh), (wl, wh) = pads
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors: ``weight [out, in, kh, kw]`` f32,
    optional bias, padding "SAME", "VALID" or explicit ``((lo, hi), (lo,
    hi))``; operands and result in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Padding = "SAME", bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if bias else None

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def _pads(self, x):
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        if self.padding == "SAME":
            return tuple(same_padding(n, k, self.stride)
                         for n, k in zip(x.shape[2:], self.kernel))
        return self.padding

    def forward(self, x):
        x = x.to(self.dtype)
        (hl, hh), (wl, wh) = pads = self._pads(x)
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if hl == hh and wl == wh:  # symmetric: the convolution pads
            return F.conv2d(x, w, b, self.stride, (hl, wl))
        return F.conv2d(_pad_2d(x, pads), w, b, self.stride)


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``nn.Linear`` with a lecun-normal f32 weight and a
    zero bias.  With ``compute_dtype`` (flax's ``dtype``) the weight and the
    input are cast to it and the bias is added after the product, in that
    dtype; without it the layer is ``nn.Linear`` in f32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=jnp.float32)`` over the last dim: mean and
    variance in f32, epsilon 1e-6, f32 ``scale`` (ones) and ``bias``
    (zeros), f32 output whatever the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of NCHW tensors.

    Training mode normalizes with this batch's mean and biased variance
    (computed in f32, in the same pass) and, under ``no_grad``, moves the
    buffers ``mean`` and ``var`` in place: ``ra = momentum * ra + (1 -
    momentum) * batch``, the variance recovered from the pass's
    1 / sqrt(var + eps).  Eval mode normalizes with the buffers.  Output in
    ``dtype``; ``scale`` and ``bias`` f32, ``scale`` starting at
    ``scale_init`` (1, or 0 for a residual block's last norm)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype=torch.float32, scale_init: float = 1.0, device=None):
        super().__init__()
        self.momentum, self.eps, self.dtype, self.scale_init = momentum, eps, dtype, scale_init
        self.scale = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(self.scale_init)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        if self.training:
            # one pass normalizes with the batch's own mean and biased
            # variance (reduced in f32), with the gradient through them, and
            # returns the mean and 1 / sqrt(var + eps) it used
            y, mu, invstd = torch.native_batch_norm(x, self.scale, self.bias, None, None,
                                                    True, 0.0, self.eps)
            with torch.no_grad():
                var = torch.clamp_min(invstd.pow(-2) - self.eps, 0.0)
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mu)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                             self.eps)
        return y.to(self.dtype)


def max_pool_same(x, kernel: int, stride: int):
    """flax ``nn.max_pool(padding="SAME")``: pads with -inf, the extra row
    and column at the end."""
    pads = [same_padding(n, kernel, stride) for n in x.shape[2:]]
    return F.max_pool2d(_pad_2d(x, pads, float("-inf")), kernel, stride)
