"""Fast/Faster R-CNN detection heads (Girshick 2015, Ren et al. 2015),
built on the port's symbol API exactly as the JAX package builds them
(``mxnet_tpu/models/rcnn.py``).

Conv trunk + ROIPooling + shared FC head with a classification branch
(SoftmaxOutput) and a bbox-regression branch (smooth_l1 through MakeLoss) —
the reference's training heads.  Proposal generation (RPN anchors/NMS) is
host-side numpy, as in the reference's python layers.
"""
from .. import symbol as sym


def _trunk(data, small=False):
    cfg = [(64, 1), (128, 1)] if small else [(64, 2), (128, 2), (256, 3),
                                             (512, 3)]
    body = data
    for stage, (nf, n) in enumerate(cfg):
        for i in range(n):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=nf,
                                   name="conv%d_%d" % (stage + 1, i + 1))
            body = sym.Activation(body, act_type="relu",
                                  name="relu%d_%d" % (stage + 1, i + 1))
        if stage < len(cfg) - 1:
            body = sym.Pooling(body, pool_type="max", kernel=(2, 2),
                               stride=(2, 2), name="pool%d" % (stage + 1))
    return body


def get_fast_rcnn(num_classes=21, pooled_size=(7, 7), spatial_scale=0.5,
                  small=False):
    """Training symbol: inputs data, rois, label, bbox_target, bbox_weight."""
    data = sym.Variable("data")
    rois = sym.Variable("rois")
    label = sym.Variable("label")
    bbox_target = sym.Variable("bbox_target")
    bbox_weight = sym.Variable("bbox_weight")

    feat = _trunk(data, small=small)
    pool = sym.ROIPooling(feat, rois, pooled_size=pooled_size,
                          spatial_scale=spatial_scale, name="roi_pool")
    flat = sym.Flatten(pool)
    fc6 = sym.FullyConnected(flat, num_hidden=1024 if not small else 128,
                             name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu")
    fc7 = sym.FullyConnected(relu6, num_hidden=1024 if not small else 128,
                             name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu")

    cls_score = sym.FullyConnected(relu7, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(cls_score, label=label, normalization="batch",
                                 name="cls_prob")
    bbox_pred = sym.FullyConnected(relu7, num_hidden=4 * num_classes,
                                   name="bbox_pred")
    bbox_loss = sym.smooth_l1(bbox_weight * (bbox_pred - bbox_target),
                              sigma=1.0, name="bbox_l1")
    bbox_loss = sym.MakeLoss(bbox_loss, normalization="batch",
                             name="bbox_loss")
    return sym.Group([cls_prob, bbox_loss])


def get_rpn(num_anchors=9, small=False):
    """Region proposal network head: objectness + bbox deltas per anchor."""
    data = sym.Variable("data")
    feat = _trunk(data, small=small)
    rpn_conv = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                               num_filter=256 if small else 512,
                               name="rpn_conv")
    rpn_relu = sym.Activation(rpn_conv, act_type="relu")
    rpn_cls = sym.Convolution(rpn_relu, kernel=(1, 1),
                              num_filter=2 * num_anchors, name="rpn_cls_score")
    rpn_bbox = sym.Convolution(rpn_relu, kernel=(1, 1),
                               num_filter=4 * num_anchors, name="rpn_bbox_pred")
    label = sym.Variable("rpn_label")
    cls_prob = sym.SoftmaxOutput(rpn_cls, label=label, multi_output=True,
                                 use_ignore=True, ignore_label=-1,
                                 normalization="valid", name="rpn_cls_prob")
    return sym.Group([cls_prob, rpn_bbox])
