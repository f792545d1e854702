"""LeNet-5 for MNIST (counterpart of ``bluefog_tpu/models/lenet.py``), the
model of the repo's first tracked configuration (``examples/jax_mnist.py``).

NHWC ``[B, 28, 28, 1]`` in, f32 logits out, as the reference.  The
convolutions run NCHW (channels-last in memory); before the first dense
layer the features are flattened in (h, w, c) order, flax's order, so its
``Dense_0`` kernel carries over unchanged
(:func:`bluefog_tpu_torch.interop.jax_weights.lenet_state_dict`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bluefog_tpu_torch.models.layers import Conv2d, Dense

__all__ = ["LeNet5"]


class LeNet5(nn.Module):
    """Classic LeNet-5: two conv + pool stages, three dense layers."""

    def __init__(self, num_classes: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(1, 6, (5, 5), padding="SAME", bias=True, device=device)
        self.conv2 = Conv2d(6, 16, (5, 5), padding="VALID", bias=True, device=device)
        self.fc1 = Dense(16 * 5 * 5, 120, device=device, dtype=torch.float32)
        self.fc2 = Dense(120, 84, device=device, dtype=torch.float32)
        self.fc3 = Dense(84, num_classes, device=device, dtype=torch.float32)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions (lecun-normal kernels, zero biases) from an
        explicit generator: the same distributions, not the same bits."""
        for mod in (self.conv1, self.conv2, self.fc1, self.fc2, self.fc3):
            mod.reset_parameters(generator)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last memory
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)
