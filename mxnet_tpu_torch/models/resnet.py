"""ResNet (He et al. 2015), built on the port's symbol API exactly as the
JAX package builds it (``mxnet_tpu/models/resnet.py``): the bottleneck-v1
ImageNet networks (``get_resnet``, ``get_resnet50``) and the 6n+2-layer
CIFAR network (``get_resnet_cifar``).  Node names, and so parameter
names and checkpoints, are the reference's.
"""
from .. import symbol as sym


def _conv_bn(data, num_filter, kernel, stride, pad, name, act=True,
             fix_gamma=False):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           name=name + "_conv")
    bn = sym.BatchNorm(data=conv, fix_gamma=fix_gamma, eps=2e-5, momentum=0.9,
                       name=name + "_bn")
    if act:
        return sym.Activation(data=bn, act_type="relu", name=name + "_relu")
    return bn


def _bottleneck(data, num_filter, stride, dim_match, name):
    c1 = _conv_bn(data, num_filter // 4, (1, 1), (1, 1), (0, 0), name + "_b1")
    c2 = _conv_bn(c1, num_filter // 4, (3, 3), stride, (1, 1), name + "_b2")
    c3 = _conv_bn(c2, num_filter, (1, 1), (1, 1), (0, 0), name + "_b3",
                  act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", act=False)
    fused = sym.ElementWiseSum(c3, shortcut, name=name + "_sum")
    return sym.Activation(data=fused, act_type="relu", name=name + "_out")


def get_resnet(units, filter_list, num_classes=1000, image_shape=(3, 224, 224)):
    """Build a bottleneck ResNet. units e.g. [3,4,6,3] for ResNet-50."""
    data = sym.Variable("data")
    body = _conv_bn(data, filter_list[0], (7, 7), (2, 2), (3, 3), "stem")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="stem_pool")
    for stage, (n, flt) in enumerate(zip(units, filter_list[1:])):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = _bottleneck(body, flt, stride, False,
                           "stage%d_unit0" % (stage + 1))
        for i in range(1, n):
            body = _bottleneck(body, flt, (1, 1), True,
                               "stage%d_unit%d" % (stage + 1, i))
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="gap")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def get_resnet50(num_classes=1000, image_shape=(3, 224, 224)):
    return get_resnet([3, 4, 6, 3], [64, 256, 512, 1024, 2048],
                      num_classes, image_shape)


def _basic_unit(data, num_filter, stride, dim_match, name):
    """Two-3x3 residual unit for the 32x32 CIFAR network.  Downsampling
    shortcuts use a 2x2 non-learnable-free conv like the reference's
    reproduction (its notes found 1x1 would not reach paper accuracy)."""
    c1 = _conv_bn(data, num_filter, (3, 3), stride, (1, 1), name + "_a")
    c2 = _conv_bn(c1, num_filter, (3, 3), (1, 1), (1, 1), name + "_b",
                  act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (2, 2), stride, (0, 0),
                            name + "_sc", act=False)
    fused = sym.ElementWiseSum(c2, shortcut, name=name + "_sum")
    return sym.Activation(data=fused, act_type="relu", name=name + "_out")


def get_resnet_cifar(depth=20, num_classes=10):
    """6n+2-layer residual network for 32x32 inputs (He et al. 2015 §4.2;
    reference example/image-classification/train_cifar10_resnet.py).
    A BatchNorm directly on the data stands in for z-score input
    normalization, as in the reference reproduction."""
    assert (depth - 2) % 6 == 0, "depth must be 6n+2 (20, 32, 44, 56, 110)"
    n = (depth - 2) // 6
    data = sym.Variable("data")
    body = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                         momentum=0.9, name="zscore")
    body = _conv_bn(body, 16, (3, 3), (1, 1), (1, 1), "stem")
    for stage, flt in enumerate((16, 32, 64)):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = _basic_unit(body, flt, stride, stage == 0,
                           "stage%d_unit0" % (stage + 1))
        for i in range(1, n):
            body = _basic_unit(body, flt, (1, 1), True,
                               "stage%d_unit%d" % (stage + 1, i))
    pool = sym.Pooling(data=body, global_pool=True, kernel=(8, 8),
                       pool_type="avg", name="gap")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
