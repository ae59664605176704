"""GoogLeNet / Inception-v1 (counterpart of
``paddle_tpu/models/googlenet.py``; reference config
benchmark/paddle/image/googlenet.py, main head only, as there).

With 1x1 convolutions whose input and output channels are multiples of
128 (inception 3b's and 4c's ``c1`` and ``c3r`` at batch 128), the
kernel route of ``ops/conv1x1.py`` takes them."""
from __future__ import annotations

from .. import layers


def inception(input, c1, c3r, c3, c5r, c5, proj):
    conv1 = layers.conv2d(input, num_filters=c1, filter_size=1, act="relu")
    conv3r = layers.conv2d(input, num_filters=c3r, filter_size=1, act="relu")
    conv3 = layers.conv2d(conv3r, num_filters=c3, filter_size=3, padding=1,
                          act="relu")
    conv5r = layers.conv2d(input, num_filters=c5r, filter_size=1, act="relu")
    conv5 = layers.conv2d(conv5r, num_filters=c5, filter_size=5, padding=2,
                          act="relu")
    pool = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1)
    convprj = layers.conv2d(pool, num_filters=proj, filter_size=1, act="relu")
    return layers.concat([conv1, conv3, conv5, convprj], axis=1)


def googlenet(img, num_classes=1000):
    conv = layers.conv2d(img, num_filters=64, filter_size=7, stride=2,
                         padding=3, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2)
    conv = layers.conv2d(pool, num_filters=64, filter_size=1, act="relu")
    conv = layers.conv2d(conv, num_filters=192, filter_size=3, padding=1,
                         act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2)

    ince3a = inception(pool, 64, 96, 128, 16, 32, 32)
    ince3b = inception(ince3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(ince3b, pool_size=3, pool_stride=2)

    ince4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    ince4b = inception(ince4a, 160, 112, 224, 24, 64, 64)
    ince4c = inception(ince4b, 128, 128, 256, 24, 64, 64)
    ince4d = inception(ince4c, 112, 144, 288, 32, 64, 64)
    ince4e = inception(ince4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(ince4e, pool_size=3, pool_stride=2)

    ince5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    ince5b = inception(ince5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(ince5b, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool5, 0.4)
    return layers.fc(drop, size=num_classes, act="softmax")
