"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``; reference
config benchmark/paddle/image/alexnet.py).  The same layers in the same
order, so the programs and their parameter names match."""
from __future__ import annotations

from .. import layers


def alexnet(img, num_classes=1000, use_lrn=True):
    conv1 = layers.conv2d(img, num_filters=64, filter_size=11, stride=4,
                          padding=2, act="relu")
    if use_lrn:
        conv1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2)

    conv2 = layers.conv2d(pool1, num_filters=192, filter_size=5, padding=2,
                          act="relu")
    if use_lrn:
        conv2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(conv2, pool_size=3, pool_stride=2)

    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3, padding=1,
                          act="relu")
    conv4 = layers.conv2d(conv3, num_filters=256, filter_size=3, padding=1,
                          act="relu")
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3, padding=1,
                          act="relu")
    pool3 = layers.pool2d(conv5, pool_size=3, pool_stride=2)

    fc1 = layers.fc(pool3, size=4096, act="relu")
    fc1 = layers.dropout(fc1, 0.5)
    fc2 = layers.fc(fc1, size=4096, act="relu")
    fc2 = layers.dropout(fc2, 0.5)
    return layers.fc(fc2, size=num_classes, act="softmax")
