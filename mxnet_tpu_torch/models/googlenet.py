"""GoogLeNet / Inception-v1 (Szegedy et al. 2014, without the auxiliary
heads), built on the port's symbol API exactly as the JAX package builds
it (``mxnet_tpu/models/googlenet.py``)."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_%s" % name)
    return sym.Activation(data=c, act_type="relu", name="relu_%s" % name)


def _inception(data, n1x1, n3x3r, n3x3, n5x5r, n5x5, proj, name):
    c1 = _conv(data, n1x1, (1, 1), name=name + "_1x1")
    c3r = _conv(data, n3x3r, (1, 1), name=name + "_3x3r")
    c3 = _conv(c3r, n3x3, (3, 3), pad=(1, 1), name=name + "_3x3")
    c5r = _conv(data, n5x5r, (1, 1), name=name + "_5x5r")
    c5 = _conv(c5r, n5x5, (5, 5), pad=(2, 2), name=name + "_5x5")
    pool = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                       pool_type="max", name=name + "_pool")
    cp = _conv(pool, proj, (1, 1), name=name + "_proj")
    return sym.Concat(c1, c3, c5, cp, name="ch_concat_" + name)


def get_googlenet(num_classes=1000):
    data = sym.Variable("data")
    body = _conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _conv(body, 64, (1, 1), name="2r")
    body = _conv(body, 192, (3, 3), pad=(1, 1), name="2")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _inception(body, 64, 96, 128, 16, 32, 32, "3a")
    body = _inception(body, 128, 128, 192, 32, 96, 64, "3b")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _inception(body, 192, 96, 208, 16, 48, 64, "4a")
    body = _inception(body, 160, 112, 224, 24, 64, 64, "4b")
    body = _inception(body, 128, 128, 256, 24, 64, 64, "4c")
    body = _inception(body, 112, 144, 288, 32, 64, 64, "4d")
    body = _inception(body, 256, 160, 320, 32, 128, 128, "4e")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    body = _inception(body, 256, 160, 320, 32, 128, 128, "5a")
    body = _inception(body, 384, 192, 384, 48, 128, 128, "5b")
    pool = sym.Pooling(body, kernel=(7, 7), global_pool=True,
                       pool_type="avg")
    flat = sym.Flatten(pool)
    drop = sym.Dropout(flat, p=0.4)
    fc = sym.FullyConnected(drop, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
