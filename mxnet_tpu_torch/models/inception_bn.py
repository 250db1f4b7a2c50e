"""Inception-BN (Ioffe & Szegedy 2015) and its CIFAR-scale form, built
on the port's symbol API exactly as the JAX package builds them
(``mxnet_tpu/models/inception_bn.py``)."""
from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name="conv_%s" % name)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="bn_%s" % name)
    act = sym.Activation(data=bn, act_type="relu", name="relu_%s" % name)
    return act


def _inception_a(data, num_1x1, num_3x3red, num_3x3, num_d3x3red, num_d3x3,
                 pool, proj, name):
    c1x1 = _conv_factory(data, num_1x1, (1, 1), name=name + "_1x1")
    c3x3r = _conv_factory(data, num_3x3red, (1, 1), name=name + "_3x3r")
    c3x3 = _conv_factory(c3x3r, num_3x3, (3, 3), pad=(1, 1), name=name + "_3x3")
    cd3x3r = _conv_factory(data, num_d3x3red, (1, 1), name=name + "_d3x3r")
    cd3x3 = _conv_factory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                          name=name + "_d3x3a")
    cd3x3 = _conv_factory(cd3x3, num_d3x3, (3, 3), pad=(1, 1),
                          name=name + "_d3x3b")
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool, name=name + "_pool")
    cproj = _conv_factory(pooling, proj, (1, 1), name=name + "_proj")
    return sym.Concat(c1x1, c3x3, cd3x3, cproj, name="ch_concat_" + name)


def _inception_b(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3, name):
    c3x3r = _conv_factory(data, num_3x3red, (1, 1), name=name + "_3x3r")
    c3x3 = _conv_factory(c3x3r, num_3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                         name=name + "_3x3")
    cd3x3r = _conv_factory(data, num_d3x3red, (1, 1), name=name + "_d3x3r")
    cd3x3 = _conv_factory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                          name=name + "_d3x3a")
    cd3x3 = _conv_factory(cd3x3, num_d3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                          name=name + "_d3x3b")
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name=name + "_pool")
    return sym.Concat(c3x3, cd3x3, pooling, name="ch_concat_" + name)


def get_inception_bn(num_classes=1000):
    data = sym.Variable("data")
    c1 = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    p1 = sym.Pooling(data=c1, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max")
    c2r = _conv_factory(p1, 64, (1, 1), name="2red")
    c2 = _conv_factory(c2r, 192, (3, 3), pad=(1, 1), name="2")
    p2 = sym.Pooling(data=c2, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max")
    in3a = _inception_a(p2, 64, 64, 64, 64, 96, "avg", 32, "3a")
    in3b = _inception_a(in3a, 64, 64, 96, 64, 96, "avg", 64, "3b")
    in3c = _inception_b(in3b, 128, 160, 64, 96, "3c")
    in4a = _inception_a(in3c, 224, 64, 96, 96, 128, "avg", 128, "4a")
    in4b = _inception_a(in4a, 192, 96, 128, 96, 128, "avg", 128, "4b")
    in4c = _inception_a(in4b, 160, 128, 160, 128, 160, "avg", 128, "4c")
    in4d = _inception_a(in4c, 96, 128, 192, 160, 192, "avg", 128, "4d")
    in4e = _inception_b(in4d, 128, 192, 192, 256, "4e")
    in5a = _inception_a(in4e, 352, 192, 320, 160, 224, "avg", 128, "5a")
    in5b = _inception_a(in5a, 352, 192, 320, 192, 224, "max", 128, "5b")
    avg = sym.Pooling(data=in5b, kernel=(7, 7), global_pool=True,
                      pool_type="avg", name="global_pool")
    flatten = sym.Flatten(data=avg)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_inception_bn_28small(num_classes=10):
    """The CIFAR-scale Inception-BN (reference b128 CIFAR benchmark model)."""
    data = sym.Variable("data")
    c1 = _conv_factory(data, 96, (3, 3), pad=(1, 1), name="s1")
    in3a = _inception_a(c1, 32, 32, 32, 32, 48, "avg", 32, "s3a")
    in3b = _inception_a(in3a, 32, 32, 48, 32, 48, "avg", 48, "s3b")
    in3c = _inception_b(in3b, 64, 80, 32, 48, "s3c")
    in4a = _inception_a(in3c, 112, 32, 48, 48, 64, "avg", 64, "s4a")
    in4b = _inception_a(in4a, 96, 48, 64, 48, 64, "avg", 64, "s4b")
    in4c = _inception_b(in4b, 80, 96, 64, 96, "s4c")
    in5a = _inception_a(in4c, 176, 96, 160, 80, 112, "avg", 64, "s5a")
    in5b = _inception_a(in5a, 176, 96, 160, 96, 112, "max", 64, "s5b")
    avg = sym.Pooling(data=in5b, kernel=(7, 7), global_pool=True,
                      pool_type="avg", name="global_pool")
    flatten = sym.Flatten(data=avg)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
