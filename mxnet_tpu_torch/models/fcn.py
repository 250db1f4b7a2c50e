"""FCN-32s/16s/8s semantic segmentation (Long et al. 2015), built on the
port's symbol API exactly as the JAX package builds them
(``mxnet_tpu/models/fcn.py``): VGG trunk + score conv + bilinear
UpSampling + Crop, trained with multi_output SoftmaxOutput."""
from .. import symbol as sym


def _vgg_trunk(data):
    body = data
    feats = {}
    for stage, (nf, n) in enumerate([(64, 2), (128, 2), (256, 3),
                                     (512, 3), (512, 3)]):
        for i in range(n):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=nf,
                                   name="conv%d_%d" % (stage + 1, i + 1))
            body = sym.Activation(body, act_type="relu",
                                  name="relu%d_%d" % (stage + 1, i + 1))
        body = sym.Pooling(body, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           name="pool%d" % (stage + 1))
        feats["pool%d" % (stage + 1)] = body
    return feats


def get_fcn32s(num_classes=21):
    """32x-upsample head (fcn-32s)."""
    data = sym.Variable("data")
    feats = _vgg_trunk(data)
    score = sym.Convolution(feats["pool5"], kernel=(1, 1),
                            num_filter=num_classes, name="score")
    up = sym.UpSampling(score, scale=32, sample_type="bilinear",
                        num_filter=num_classes, name="upsample32")
    up = sym.Crop(up, data, num_args=2, center_crop=True, name="crop32")
    return sym.SoftmaxOutput(up, multi_output=True, use_ignore=True,
                             ignore_label=255, name="softmax")


def _fused_pool4(data, num_classes):
    """pool5 score upsampled 2x and fused with the pool4 score — the
    skip connection shared by fcn16s and fcn8s; one definition keeps the
    layer names identical so stage-carried weights keep matching."""
    feats = _vgg_trunk(data)
    score5 = sym.Convolution(feats["pool5"], kernel=(1, 1),
                             num_filter=num_classes, name="score5")
    up2 = sym.UpSampling(score5, scale=2, sample_type="bilinear",
                         num_filter=num_classes, name="up2")
    score4 = sym.Convolution(feats["pool4"], kernel=(1, 1),
                             num_filter=num_classes, name="score4")
    up2c = sym.Crop(up2, score4, num_args=2, center_crop=True, name="crop4")
    return sym.ElementWiseSum(up2c, score4, name="fuse16"), feats


def get_fcn16s(num_classes=21):
    """16x head fusing pool4 (fcn-16s skip architecture)."""
    data = sym.Variable("data")
    fused, _ = _fused_pool4(data, num_classes)
    up16 = sym.UpSampling(fused, scale=16, sample_type="bilinear",
                          num_filter=num_classes, name="up16")
    up16 = sym.Crop(up16, data, num_args=2, center_crop=True, name="crop16")
    return sym.SoftmaxOutput(up16, multi_output=True, use_ignore=True,
                             ignore_label=255, name="softmax")


def get_fcn8s(num_classes=21):
    """8x head fusing pool4 AND pool3 (fcn-8s, the finest-grained
    variant; reference symbol_fcnxs.py get_fcn8s_symbol)."""
    data = sym.Variable("data")
    fused4, feats = _fused_pool4(data, num_classes)
    up4 = sym.UpSampling(fused4, scale=2, sample_type="bilinear",
                         num_filter=num_classes, name="up4")
    score3 = sym.Convolution(feats["pool3"], kernel=(1, 1),
                             num_filter=num_classes, name="score3")
    up4c = sym.Crop(up4, score3, num_args=2, center_crop=True, name="crop3")
    fused3 = sym.ElementWiseSum(up4c, score3, name="fuse8")
    up8 = sym.UpSampling(fused3, scale=8, sample_type="bilinear",
                         num_filter=num_classes, name="up8")
    up8 = sym.Crop(up8, data, num_args=2, center_crop=True, name="crop8")
    return sym.SoftmaxOutput(up8, multi_output=True, use_ignore=True,
                             ignore_label=255, name="softmax")
