"""Models of the port (counterpart of ``bluefog_tpu/models``)."""

from bluefog_tpu_torch.models.transformer import LlamaLM

__all__ = ["LlamaLM"]
