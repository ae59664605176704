"""Model zoo (counterpart of ``paddle_tpu/models``): the ResNet family
and the seq2seq+attention training network."""
from .resnet import resnet50, resnet_cifar, resnet_imagenet
from .seq2seq import seq2seq_attention

__all__ = ["resnet_imagenet", "resnet50", "resnet_cifar",
           "seq2seq_attention"]
