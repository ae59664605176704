"""MNIST models (counterpart of ``paddle_tpu/models/mnist.py``; the
book's recognize_digits mlp and conv networks)."""
from __future__ import annotations

from .. import layers, nets


def mlp(img, hidden_sizes=(128, 64), num_classes=10):
    """Fully connected layers with relu, then a softmax head."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size=size, act="relu")
    return layers.fc(h, size=num_classes, act="softmax")


def lenet(img, num_classes=10):
    """Two conv-pool blocks and a softmax head."""
    conv1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                      pool_size=2, pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=50, filter_size=5,
                                      pool_size=2, pool_stride=2, act="relu")
    return layers.fc(conv2, size=num_classes, act="softmax")
