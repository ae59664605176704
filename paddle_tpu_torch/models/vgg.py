"""VGG (counterpart of ``paddle_tpu/models/vgg.py``; reference configs
benchmark/paddle/image/vgg.py and the book's vgg16_bn_drop)."""
from __future__ import annotations

from .. import layers, nets

_VGG_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def _vgg_network(img, num_classes, depth, with_bn=False, fc_size=4096,
                 drop_rate=0.5):
    counts = _VGG_CFG[depth]
    filters = (64, 128, 256, 512, 512)
    tmp = img
    for n, nf in zip(counts, filters):
        tmp = nets.img_conv_group(
            tmp, conv_num_filter=[nf] * n, pool_size=2, pool_stride=2,
            conv_filter_size=3, conv_padding=1, conv_act="relu",
            conv_with_batchnorm=with_bn)
    fc1 = layers.fc(tmp, size=fc_size, act="relu")
    fc1 = layers.dropout(fc1, drop_rate)
    fc2 = layers.fc(fc1, size=fc_size, act="relu")
    fc2 = layers.dropout(fc2, drop_rate)
    return layers.fc(fc2, size=num_classes, act="softmax")


def vgg16(img, num_classes=1000, with_bn=False):
    return _vgg_network(img, num_classes, 16, with_bn)


def vgg19(img, num_classes=1000, with_bn=False):
    return _vgg_network(img, num_classes, 19, with_bn)


def vgg_cifar(img, num_classes=10):
    """vgg16 with batch norm and a 512-wide head (the book's
    vgg16_bn_drop; ``benchmark/run.py``'s smallnet)."""
    return _vgg_network(img, num_classes, 16, with_bn=True, fc_size=512)
