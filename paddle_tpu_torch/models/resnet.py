"""ResNet for ImageNet and CIFAR (counterpart of
``paddle_tpu/models/resnet.py``; the same layers in the same order, so
the programs and their parameter names match)."""
from __future__ import annotations

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, padding=None,
                  act="relu"):
    if padding is None:
        padding = (filter_size - 1) // 2
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def shortcut(input, ch_in, ch_out, stride):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None)
    return input


def bottleneck_block(input, ch_in, num_filters, stride):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck."""
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, 1, 0, act=None)
    short = shortcut(input, ch_in, num_filters * 4, stride)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, ch_in, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, 1)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, 1, act=None)
    short = shortcut(input, ch_in, num_filters, stride)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH_CFG = {
    # depth: (block fn, counts, expansion)
    18: (basic_block, (2, 2, 2, 2), 1),
    34: (basic_block, (3, 4, 6, 3), 1),
    50: (bottleneck_block, (3, 4, 6, 3), 4),
    101: (bottleneck_block, (3, 4, 23, 3), 4),
    152: (bottleneck_block, (3, 8, 36, 3), 4),
}


def resnet_imagenet(img, num_classes=1000, depth=50):
    """ResNet-{18,34,50,101,152} on 224x224."""
    block_fn, counts, expansion = _DEPTH_CFG[depth]
    conv = conv_bn_layer(img, 64, 7, stride=2, padding=3)
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    ch_in = 64
    filters = (64, 128, 256, 512)
    out = pool
    for stage, (nf, n) in enumerate(zip(filters, counts)):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            out = block_fn(out, ch_in, nf, stride)
            ch_in = nf * expansion
    pool = layers.pool2d(out, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=num_classes, act="softmax")


def resnet50(img, num_classes=1000):
    return resnet_imagenet(img, num_classes, depth=50)


def resnet_cifar(img, num_classes=10, depth=32):
    """3-stage CIFAR resnet."""
    if (depth - 2) % 6 != 0:
        raise ValueError(f"resnet_cifar: depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    conv = conv_bn_layer(img, 16, 3, 1, 1)
    out = conv
    ch_in = 16
    for stage, nf in enumerate((16, 32, 64)):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            out = basic_block(out, ch_in, nf, stride)
            ch_in = nf
    pool = layers.pool2d(out, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=num_classes, act="softmax")
