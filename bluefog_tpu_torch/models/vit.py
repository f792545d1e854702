"""Vision Transformer classifier (counterpart of ``bluefog_tpu/models/vit.py``).

A ViT-B/16-style classifier that drops into the same decentralized train
step (``training.make_decentralized_train_step`` with
``make_classifier_apply_fn``) as the ResNets.  It keeps the reference's
dtypes: patchify as one VALID strided convolution in ``dtype`` (bf16 by
default), a learned [CLS] token (zeros at start) and position embedding
(N(0, 0.02²)), the BERT encoder blocks (:class:`_EncoderBlock`, no mask),
then an f32 LayerNorm and an f32 head on token 0.  Attention is the plain
dense product, as in the reference, which runs it outside any Pallas
kernel.  Images are NHWC, as the port's ResNet takes them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from bluefog_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, lecun_normal_
from bluefog_tpu_torch.models.transformer import _EncoderBlock

__all__ = ["ViT", "ViT_S16", "ViT_B16"]


class ViT(nn.Module):
    """Vision Transformer classifier ([CLS]-token pooling).
    ``forward(images [B, S, S, 3], train=False)`` returns f32 logits
    ``[B, num_classes]``; ``train`` is unused (no dropout or batch
    statistics) and keeps the step signature shared."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 dff: int = 3072, image_size: int = 224, dtype=torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads {num_heads}")
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch {patch_size}")
        self.dtype = dtype
        self.hidden = hidden_size
        self.patch_embed = Conv2d(3, hidden_size, (patch_size, patch_size), stride=patch_size,
                                  padding="VALID", bias=True, dtype=dtype, device=device)
        tokens = 1 + (image_size // patch_size) ** 2
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_size, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, hidden_size, device=device))
        self.layers = nn.ModuleList(
            _EncoderBlock(hidden_size, num_heads, dff, dtype, device) for _ in range(num_layers))
        self.norm = LayerNorm(hidden_size, device=device)
        self.head = Dense(hidden_size, num_classes, device=device, compute_dtype=torch.float32)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions: lecun-normal kernels (the patchify
        convolution's fan-in is P·P·3), zero biases, a zero [CLS] token,
        N(0, 0.02²) positions, LayerNorm ones and zeros."""
        self.patch_embed.reset_parameters(generator)
        self.cls.zero_()
        self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, Dense):
                lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.reset_parameters()

    def forward(self, images, train: bool = False):
        del train
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))  # [B, hidden, S/P, S/P]
        x = x.flatten(2).transpose(1, 2)  # [B, (S/P)^2, hidden], rows then columns
        cls = self.cls.to(self.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.dtype)
        for layer in self.layers:
            x = layer(x, None)
        x = self.norm(x)  # f32
        return self.head(x[:, 0])


def ViT_S16(num_classes: int = 1000, **kw) -> ViT:
    """ViT-Small/16 (22M parameters)."""
    return ViT(num_classes=num_classes, hidden_size=384, num_layers=12, num_heads=6,
               dff=1536, **kw)


def ViT_B16(num_classes: int = 1000, **kw) -> ViT:
    """ViT-Base/16 (86M parameters)."""
    return ViT(num_classes=num_classes, **kw)
