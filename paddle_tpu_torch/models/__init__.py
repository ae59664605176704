"""Model zoo (counterpart of ``paddle_tpu/models``, under its names):
the reference benchmark's image and text models, the ResNet family,
the seq2seq+attention training and beam-search decoding networks and
Wide & Deep."""
from .mnist import mlp as mnist_mlp, lenet as mnist_lenet
from .alexnet import alexnet
from .vgg import vgg16, vgg19, vgg_cifar
from .resnet import resnet50, resnet_cifar, resnet_imagenet
from .googlenet import googlenet
from .lstm_textcls import lstm_text_classification
from .seq2seq import seq2seq_attention, seq2seq_infer
from .wide_deep import wide_deep

__all__ = [
    "mnist_mlp", "mnist_lenet", "alexnet", "vgg16", "vgg19", "vgg_cifar",
    "resnet_imagenet", "resnet50", "resnet_cifar", "googlenet",
    "lstm_text_classification", "seq2seq_attention", "seq2seq_infer",
    "wide_deep"]
