"""Models of horovod_tpu_torch, under the names ``horovod_tpu.models``
gives them."""
from .inception import InceptionV3
from .mlp import MLP, ConvNet
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from .transformer import TransformerLM
from .vgg import VGG, VGG16, VGG19

__all__ = ["ConvNet", "InceptionV3", "MLP", "ResNet", "ResNet101", "ResNet152",
           "ResNet18", "ResNet34", "ResNet50", "TransformerLM", "VGG", "VGG16",
           "VGG19"]
