"""Hand-written CUDA kernels for the hot ops (counterpart of
``bluefog_tpu/kernels``, whose kernels are Pallas for the TPU)."""

from bluefog_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    make_flash_attention_fn,
)

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "make_flash_attention_fn",
]
