"""VGG-16 (counterpart of ``mxnet_tpu/models/vgg.py``)."""
from .. import symbol as sym


def get_vgg(num_classes=1000):
    data = sym.Variable("data")

    def block(data, num_filter, n, stage):
        for i in range(n):
            data = sym.Convolution(data=data, kernel=(3, 3), pad=(1, 1),
                                   num_filter=num_filter,
                                   name="conv%d_%d" % (stage, i + 1))
            data = sym.Activation(data=data, act_type="relu",
                                  name="relu%d_%d" % (stage, i + 1))
        return sym.Pooling(data=data, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name="pool%d" % stage)

    body = block(data, 64, 2, 1)
    body = block(body, 128, 2, 2)
    body = block(body, 256, 3, 3)
    body = block(body, 512, 3, 4)
    body = block(body, 512, 3, 5)
    flatten = sym.Flatten(data=body, name="flatten")
    fc6 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(data=relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(data=drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(data=relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(data=drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=fc8, name="softmax")
