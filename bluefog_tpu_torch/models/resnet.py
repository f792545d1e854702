"""ResNet (counterpart of ``bluefog_tpu/models/resnet.py``): the model of
the repo's headline metric, ResNet-50 images/s/chip under gossip.

NHWC at the interface, as the reference; inside, NCHW tensors in
channels-last memory for cuDNN.  bf16 compute by default with f32
parameters and batch statistics; each BatchNorm normalizes with its rank's
own batch (:class:`~bluefog_tpu_torch.models.layers.BatchNorm`, flax's
semantics).  Convolutions and the max-pool pad as flax's "SAME" does: the
7x7/s2 stem at 224 pads (2, 3), a 3x3/s2 convolution or the 3x3/s2 max-pool
on an even size (0, 1).

Module names map onto the flax tree
(:func:`bluefog_tpu_torch.interop.jax_weights.resnet_state_dict`):
``conv_init``/``bn_init`` are flax's, block i is flax's ``<Block>_i``, its
``convs[j]``/``norms[j]`` flax's ``Conv_j``/``BatchNorm_j`` (the projection
of the residual last), ``fc`` flax's ``Dense_0``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bluefog_tpu_torch.models.layers import BatchNorm, Conv2d, Dense, max_pool_same

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet50",
           "space_to_depth"]


def space_to_depth(x, factor: int = 2):
    """NHWC space-to-depth: ``[B, H, W, C] -> [B, H/f, W/f, f*f*C]``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // factor, w // factor,
                                               factor * factor * c)


class _Block(nn.Module):
    """A residual block: ``convs``/``norms`` in flax's order, the residual's
    1x1 projection (when the shape changes) after them."""

    expansion = 1

    def __init__(self, convs: List[Conv2d], norms: List[BatchNorm], project: bool):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.project = project

    def forward(self, x):
        n_main = len(self.convs) - self.project
        y = x
        for j in range(n_main):
            y = self.norms[j](self.convs[j](y))
            if j < n_main - 1:
                y = F.relu(y)
        residual = self.norms[-1](self.convs[-1](x)) if self.project else x
        return F.relu(y + residual)


def _shape_changes(in_ch: int, out_ch: int, stride: int) -> bool:
    return in_ch != out_ch or stride != 1


class BasicBlock(_Block):
    """3x3 -> 3x3, the last norm's scale starting at 0."""

    def __init__(self, in_ch: int, filters: int, stride: int, dtype, device=None):
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device)
        convs = [conv(in_ch, filters, (3, 3), stride), conv(filters, filters, (3, 3))]
        norms = [norm(filters), norm(filters, scale_init=0.0)]
        project = _shape_changes(in_ch, filters, stride)
        if project:
            convs.append(conv(in_ch, filters, (1, 1), stride))
            norms.append(norm(filters))
        super().__init__(convs, norms, project)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided) -> 1x1 x4, the last norm's scale starting at 0."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, dtype, device=None):
        conv = functools.partial(Conv2d, dtype=dtype, device=device)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device)
        out = filters * 4
        convs = [conv(in_ch, filters, (1, 1)), conv(filters, filters, (3, 3), stride),
                 conv(filters, out, (1, 1))]
        norms = [norm(filters), norm(filters), norm(out, scale_init=0.0)]
        project = _shape_changes(in_ch, out, stride)
        if project:
            convs.append(conv(in_ch, out, (1, 1), stride))
            norms.append(norm(out))
        super().__init__(convs, norms, project)


class ResNet(nn.Module):
    """Configurable ResNet; ``stage_sizes=[3, 4, 6, 3]`` with
    :class:`BottleneckBlock` is ResNet-50.

    ``stem``: "conv" (the canonical 7x7/s2 convolution) or "space_to_depth"
    (2x2 space-to-depth, then a 4x4/s1 convolution padded (1, 2): an 8x8/s2
    convolution in effect).  ``small_images``: a 3x3/s1 stem and no max-pool
    (CIFAR).  ``forward(x)`` takes NHWC images and returns f32 logits; in
    training mode each BatchNorm uses this batch's statistics and moves its
    running averages, in eval mode it uses the running averages."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16, small_images: bool = False,
                 stem: str = "conv", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"stem must be 'conv' or 'space_to_depth', got {stem!r}")
        self.dtype, self.small_images, self.stem = dtype, small_images, stem
        if small_images:
            self.conv_init = Conv2d(3, num_filters, (3, 3), dtype=dtype, device=device)
        elif stem == "space_to_depth":
            self.conv_init = Conv2d(12, num_filters, (4, 4), padding=((1, 2), (1, 2)),
                                    dtype=dtype, device=device)
        else:
            self.conv_init = Conv2d(3, num_filters, (7, 7), stride=2, dtype=dtype,
                                    device=device)
        self.bn_init = BatchNorm(num_filters, dtype=dtype, device=device)
        blocks, ch = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(ch, num_filters * 2 ** i, stride, dtype, device))
                ch = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(ch, num_classes, device=device, dtype=torch.float32)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions from an explicit generator: lecun-normal
        convolution and dense kernels, zero dense bias, BatchNorm scale 1
        (0 on each block's last norm) and bias 0, statistics 0 and 1."""
        for mod in self.modules():
            if isinstance(mod, (Conv2d, Dense, BatchNorm)):
                mod.reset_parameters(generator)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "space_to_depth" and not self.small_images:
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last memory
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_images:
            x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean((2, 3))
        return self.fc(x.float())


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
