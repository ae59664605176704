"""Model zoo (counterpart of ``paddle_tpu/models``): the ResNet family."""
from .resnet import resnet50, resnet_cifar, resnet_imagenet

__all__ = ["resnet_imagenet", "resnet50", "resnet_cifar"]
