"""Model zoo (counterpart of ``paddle_tpu/models``): the ResNet family,
the seq2seq+attention training network and Wide & Deep."""
from .resnet import resnet50, resnet_cifar, resnet_imagenet
from .seq2seq import seq2seq_attention
from .wide_deep import wide_deep

__all__ = ["resnet_imagenet", "resnet50", "resnet_cifar",
           "seq2seq_attention", "wide_deep"]
