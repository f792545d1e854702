"""Models of the port (counterpart of ``bluefog_tpu/models``)."""

from bluefog_tpu_torch.models.lenet import LeNet5
from bluefog_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50
from bluefog_tpu_torch.models.transformer import BertEncoder, LlamaLM
from bluefog_tpu_torch.models.vit import ViT, ViT_B16, ViT_S16

__all__ = ["BertEncoder", "LeNet5", "LlamaLM", "ResNet", "ResNet18", "ResNet50", "ViT",
           "ViT_B16", "ViT_S16"]
