"""Inception-v3 (Szegedy et al. 2015, 299x299 input), built on the port's
symbol API exactly as the JAX package builds it
(``mxnet_tpu/models/inception_v3.py``)."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, suffix=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           name="%s%s_conv2d" % (name, suffix))
    bn = sym.BatchNorm(data=conv, fix_gamma=True, eps=0.001,
                       name="%s%s_batchnorm" % (name, suffix))
    return sym.Activation(data=bn, act_type="relu",
                          name="%s%s_relu" % (name, suffix))


def _inception7a(data, n1, n5r, n5, n3r, n3, pool, proj, name):
    t1 = _conv(data, n1, name=name + "_1x1")
    t5 = _conv(data, n5r, name=name + "_5x5r")
    t5 = _conv(t5, n5, (5, 5), pad=(2, 2), name=name + "_5x5")
    t3 = _conv(data, n3r, name=name + "_d3x3r")
    t3 = _conv(t3, n3, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    t3 = _conv(t3, n3, (3, 3), pad=(1, 1), name=name + "_d3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name=name + "_pool")
    p = _conv(p, proj, name=name + "_proj")
    return sym.Concat(t1, t5, t3, p, name="ch_concat_" + name)


def _inception7b(data, n3, n3dr, n3d, name):
    t3 = _conv(data, n3, (3, 3), stride=(2, 2), name=name + "_3x3")
    t3d = _conv(data, n3dr, name=name + "_d3x3r")
    t3d = _conv(t3d, n3d, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    t3d = _conv(t3d, n3d, (3, 3), stride=(2, 2), name=name + "_d3x3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(0, 0),
                    pool_type="max", name=name + "_pool")
    return sym.Concat(t3, t3d, p, name="ch_concat_" + name)


def _inception7c(data, n1, n7r, n7, n7dr, n7d, pool, proj, name):
    t1 = _conv(data, n1, name=name + "_1x1")
    t7 = _conv(data, n7r, name=name + "_7x7r")
    t7 = _conv(t7, n7r, (1, 7), pad=(0, 3), name=name + "_7x7a")
    t7 = _conv(t7, n7, (7, 1), pad=(3, 0), name=name + "_7x7b")
    t7d = _conv(data, n7dr, name=name + "_d7r")
    t7d = _conv(t7d, n7dr, (7, 1), pad=(3, 0), name=name + "_d7a")
    t7d = _conv(t7d, n7dr, (1, 7), pad=(0, 3), name=name + "_d7b")
    t7d = _conv(t7d, n7dr, (7, 1), pad=(3, 0), name=name + "_d7c")
    t7d = _conv(t7d, n7, (1, 7), pad=(0, 3), name=name + "_d7d")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name=name + "_pool")
    p = _conv(p, proj, name=name + "_proj")
    return sym.Concat(t1, t7, t7d, p, name="ch_concat_" + name)


def _inception7d(data, n3r, n3, n7r, n7, name):
    t3 = _conv(data, n3r, name=name + "_3x3r")
    t3 = _conv(t3, n3, (3, 3), stride=(2, 2), name=name + "_3x3")
    t7 = _conv(data, n7r, name=name + "_7x7r")
    t7 = _conv(t7, n7r, (1, 7), pad=(0, 3), name=name + "_7x7a")
    t7 = _conv(t7, n7r, (7, 1), pad=(3, 0), name=name + "_7x7b")
    t7 = _conv(t7, n7, (3, 3), stride=(2, 2), name=name + "_7x7c")
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name=name + "_pool")
    return sym.Concat(t3, t7, p, name="ch_concat_" + name)


def _inception7e(data, n1, n3r, n3, n3dr, n3d, pool, proj, name):
    t1 = _conv(data, n1, name=name + "_1x1")
    t3 = _conv(data, n3r, name=name + "_3x3r")
    t3a = _conv(t3, n3, (1, 3), pad=(0, 1), name=name + "_3x3a")
    t3b = _conv(t3, n3, (3, 1), pad=(1, 0), name=name + "_3x3b")
    t3d = _conv(data, n3dr, name=name + "_d3r")
    t3d = _conv(t3d, n3d, (3, 3), pad=(1, 1), name=name + "_d3")
    t3da = _conv(t3d, n3, (1, 3), pad=(0, 1), name=name + "_d3a")
    t3db = _conv(t3d, n3, (3, 1), pad=(1, 0), name=name + "_d3b")
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name=name + "_pool")
    p = _conv(p, proj, name=name + "_proj")
    return sym.Concat(t1, t3a, t3b, t3da, t3db, p,
                      name="ch_concat_" + name)


def get_inception_v3(num_classes=1000):
    data = sym.Variable("data")
    body = _conv(data, 32, (3, 3), stride=(2, 2), name="conv")
    body = _conv(body, 32, (3, 3), name="conv_1")
    body = _conv(body, 64, (3, 3), pad=(1, 1), name="conv_2")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pool_type="max")
    body = _conv(body, 80, (1, 1), name="conv_3")
    body = _conv(body, 192, (3, 3), name="conv_4")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pool_type="max")
    body = _inception7a(body, 64, 48, 64, 64, 96, "avg", 32, "mixed")
    body = _inception7a(body, 64, 48, 64, 64, 96, "avg", 64, "mixed_1")
    body = _inception7a(body, 64, 48, 64, 64, 96, "avg", 64, "mixed_2")
    body = _inception7b(body, 384, 64, 96, "mixed_3")
    body = _inception7c(body, 192, 128, 192, 128, 192, "avg", 192, "mixed_4")
    body = _inception7c(body, 192, 160, 192, 160, 192, "avg", 192, "mixed_5")
    body = _inception7c(body, 192, 160, 192, 160, 192, "avg", 192, "mixed_6")
    body = _inception7c(body, 192, 192, 192, 192, 192, "avg", 192, "mixed_7")
    body = _inception7d(body, 192, 320, 192, 192, "mixed_8")
    body = _inception7e(body, 320, 384, 384, 448, 384, "avg", 192, "mixed_9")
    body = _inception7e(body, 320, 384, 384, 448, 384, "max", 192,
                        "mixed_10")
    pool = sym.Pooling(body, kernel=(8, 8), global_pool=True,
                       pool_type="avg")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
