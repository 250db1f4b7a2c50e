"""The rest of the model zoo in the port against the JAX package.

* Every builder the JAX package's ``models/__init__.py`` exports exists in
  the port, and each of the image networks builds the same graph:
  ``list_arguments``, ``list_outputs``, ``list_auxiliary_states``,
  ``infer_shape`` and the symbol JSON equal the reference's (the cases of
  tests/test_models.py:117-197, and each network at its own input size).
* DCGAN's adversarial loop (example/gan/dcgan.py, through
  ``chip_smoke.dcgan_iteration``) at ngf = ndf = 8, batch 4, 3
  iterations, from one set of numpy-seeded params in both packages.
  The first iteration's gradients agree within 1e-4 of each tensor's
  largest value, D's outputs within rtol 1e-4; the params after 3 Adam
  steps within rtol 1e-4 and lr/4.  Adam's first steps move each element
  by about lr·sign(g), so an element whose gradient is small next to
  float noise moves by a fraction of a step apart (at most 0.08 lr
  here).
* ``fit`` trajectories of a narrow AlexNet (the zoo's layer sequence with
  LRN, at an eighth of its widths and 67x67 inputs), of
  ``get_inception_bn_28small`` and of Fast R-CNN (``small=True``, with
  ROIPooling on tied relu outputs), each from one checkpoint the JAX
  package wrote (the parity rule).  AlexNet's Dropout is set to p = 0:
  the packages draw from different random streams.  Tolerances follow
  tests/test_torch_module.py: AlexNet and Fast R-CNN after the first step
  and after 8 steps within rtol 1e-4, atol 1e-5.  The Inception-BN has
  relus after BatchNorm, where a float32 tie gates differently in the two
  packages (one gate flips at the first step at this seed): its first
  step is held to a relative L2 difference of 1e-2 and 0.1 of each
  tensor's scale, and after 8 steps it may leave the reference at most
  twice as far as the reference leaves itself when its data moves by one
  ulp.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
KINK_L2, KINK_SCALE = 1e-2, 0.1
# relus after BatchNorm: at this seed one pre-activation of bn_s3b_3x3
# (|x| = 4.6e-8) takes the other side of 0 in the two packages at the
# first step, which moves conv_s3b_proj_weight's gradient by 2 %
RELU_AFTER_BN = {"inception-bn-28small"}
# and its steps (lr 0.05, momentum 0.9, batch 4) amplify such a flip: the
# reference run on data one ulp away leaves the reference run as far
# (relative L2 0.123 after 8 steps; the port 0.128).  After 8 steps the
# port may drift from the reference at most twice as far as that
DRIFT_RATIO = 2.0


def test_port_exports_every_reference_builder():
    import mxnet_tpu.models as jm
    assert set(jm.__all__) <= set(tmx.models.__all__)
    for name in jm.__all__:
        assert callable(getattr(tmx.models, name)) or \
            isinstance(getattr(tmx.models, name), type)


# (id, builder (pkg -> symbol), input shapes)
GRAPHS = [
    ("alexnet", lambda m: m.models.get_alexnet(),
     {"data": (2, 3, 224, 224), "softmax_label": (2,)}),
    ("googlenet", lambda m: m.models.get_googlenet(),
     {"data": (2, 3, 224, 224), "softmax_label": (2,)}),
    ("inception-v3", lambda m: m.models.get_inception_v3(),
     {"data": (2, 3, 299, 299), "softmax_label": (2,)}),
    ("inception-bn", lambda m: m.models.get_inception_bn(),
     {"data": (2, 3, 224, 224), "softmax_label": (2,)}),
    ("inception-bn-28small", lambda m: m.models.get_inception_bn_28small(),
     {"data": (2, 3, 28, 28), "softmax_label": (2,)}),
    ("dcgan-g", lambda m: m.models.make_generator(code_dim=16),
     {"rand": (2, 16, 1, 1)}),
    ("dcgan-d", lambda m: m.models.make_discriminator(),
     {"data": (2, 3, 64, 64), "label": (2,)}),
    ("fcn32s", lambda m: m.models.get_fcn32s(num_classes=5),
     {"data": (1, 3, 64, 64), "softmax_label": (1, 64, 64)}),
    ("fcn16s", lambda m: m.models.get_fcn16s(num_classes=5),
     {"data": (1, 3, 64, 64), "softmax_label": (1, 64, 64)}),
    ("fcn8s", lambda m: m.models.get_fcn8s(num_classes=5),
     {"data": (1, 3, 64, 64), "softmax_label": (1, 64, 64)}),
    ("fcn32s-512", lambda m: m.models.get_fcn32s(num_classes=21),
     {"data": (1, 3, 512, 512), "softmax_label": (1, 512, 512)}),
    ("fast-rcnn-small", lambda m: m.models.get_fast_rcnn(
        num_classes=4, pooled_size=(3, 3), spatial_scale=0.5, small=True),
     {"data": (1, 3, 32, 32), "rois": (6, 5), "label": (6,),
      "bbox_target": (6, 16), "bbox_weight": (6, 16)}),
    ("fast-rcnn", lambda m: m.models.get_fast_rcnn(
        num_classes=21, pooled_size=(7, 7), spatial_scale=0.125),
     {"data": (2, 3, 600, 800), "rois": (128, 5), "label": (128,),
      "bbox_target": (128, 84), "bbox_weight": (128, 84)}),
    ("rpn", lambda m: m.models.get_rpn(num_anchors=3, small=True),
     {"data": (1, 3, 32, 32)}),
]


@pytest.mark.parametrize("case", GRAPHS, ids=[c[0] for c in GRAPHS])
def test_builder_graph_equals_jax(case):
    _, build, shapes = case
    syms = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            syms.append(build(pkg))
    want, got = syms
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    known = {k: v for k, v in shapes.items()
             if k in want.list_arguments()}
    assert got.infer_shape(**known) == want.infer_shape(**known)
    assert got.tojson() == want.tojson()


# -- DCGAN's adversarial loop -------------------------------------------------

GAN = dict(ngf=8, ndf=8, code=100, batch=4)
# a quarter of one Adam step (lr = 2e-4): the elements whose gradients are
# small next to float noise move by a fraction of a step apart (0.08 lr
# at most here, 69 of 102,400 elements of g1_weight beyond 1e-6 + 1e-4)
GAN_PARAM_ATOL = chip_smoke.DCGAN_OPT["learning_rate"] / 4


def _gan_run(pkg, params, data, iters):
    mod_g, mod_d = chip_smoke.dcgan_modules(pkg, pkg.cpu(), GAN["ngf"],
                                            GAN["ndf"], GAN["code"],
                                            GAN["batch"], params)
    label = pkg.nd.zeros((GAN["batch"],), ctx=pkg.cpu())
    grads, outs, snaps = {}, [], []
    for i in range(iters):
        rand, real = data[i]
        outs.append(chip_smoke.dcgan_iteration(
            pkg, mod_g, mod_d, pkg.nd.array(rand, ctx=pkg.cpu()),
            pkg.nd.array(real, ctx=pkg.cpu()), label,
            grads if i == 0 else None))
        snaps.append(chip_smoke.both_params(mod_g, mod_d))
    return grads, outs, snaps, (mod_g, mod_d)


def test_dcgan_adversarial_loop_equals_jax():
    params = chip_smoke.dcgan_params(jmx, GAN["ngf"], GAN["ndf"],
                                     GAN["code"], seed=12)
    data = chip_smoke.dcgan_data(GAN["code"], GAN["batch"], 3, seed=13)
    want_g, want_o, want_p, _ = _gan_run(jmx, params, data, 3)
    got_g, got_o, got_p, (mod_g, mod_d) = _gan_run(tmx, params, data, 3)
    assert sorted(got_g) == sorted(want_g) and len(got_g) > 20
    for k, w in want_g.items():
        # fix_gamma: BatchNorm's gamma takes no gradient in either package
        assert (np.abs(w).max() > 0) != k.endswith("_gamma"), k
        np.testing.assert_allclose(got_g[k], w, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(w).max(),
                                   err_msg=k)
    for g, w in zip(got_o, want_o):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=TRAJ_RTOL, atol=1e-6)
    for g, w in zip(got_p[-1], want_p[-1]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TRAJ_RTOL,
                                       atol=GAN_PARAM_ATOL, err_msg=k)
            start = params[0][0].get(k[2:], params[1][0].get(k[2:]))
            assert np.array_equal(w[k], start) == k.endswith("_gamma"), k
    # D keeps input gradients: the classic path; G left its fused step
    # at the first explicit head gradient, as in the reference
    assert mod_d._fused is None and mod_g._fused is None


# -- fit trajectories -----------------------------------------------------------

def _narrow_alexnet(pkg, classes=10):
    """get_alexnet's layers (conv 11/4, LRN, pools, conv 5 and 3s, three
    FCs) at an eighth of its widths, Dropout p = 0."""
    s = pkg.sym
    x = s.Variable("data")
    x = s.Convolution(x, kernel=(11, 11), stride=(4, 4), num_filter=12,
                      name="conv1")
    x = s.LRN(s.Activation(x, act_type="relu"), alpha=0.0001, beta=0.75,
              knorm=1, nsize=5)
    x = s.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = s.Convolution(x, kernel=(5, 5), pad=(2, 2), num_filter=32,
                      name="conv2")
    x = s.LRN(s.Activation(x, act_type="relu"), alpha=0.0001, beta=0.75,
              knorm=1, nsize=5)
    x = s.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    for i, nf in ((3, 48), (4, 48), (5, 32)):
        x = s.Activation(s.Convolution(x, kernel=(3, 3), pad=(1, 1),
                                       num_filter=nf, name="conv%d" % i),
                         act_type="relu")
    x = s.Flatten(s.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type="max"))
    for i in (1, 2):
        x = s.Dropout(s.Activation(s.FullyConnected(
            x, num_hidden=64, name="fc%d" % i), act_type="relu"), p=0.0)
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=classes,
                                            name="fc3"), name="softmax")


FIT = {
    "alexnet-narrow": dict(build=_narrow_alexnet, data=(3, 67, 67),
                           classes=10, batch=4),
    "inception-bn-28small": dict(
        build=lambda p: p.models.get_inception_bn_28small(),
        data=(3, 28, 28), classes=10, batch=4),
}


def _checkpoint(tmp_path, name, sym, shapes, label_names):
    mod = jmx.mod.Module(sym, data_names=[k for k in shapes
                                          if k not in label_names],
                         label_names=label_names, context=jmx.cpu())
    mod.bind([(k, v) for k, v in shapes.items() if k not in label_names],
             [(k, shapes[k]) for k in label_names])
    jmx.random.seed(1)
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / name)
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    return prefix


def _load(pkg, prefix):
    if pkg is jmx:
        return jmx.model.load_checkpoint(prefix, 0)
    return tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())


def _host(mod):
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _assert_params(got, want, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def _rel_l2(got, want):
    num = sum(float(((g[k] - w[k]) ** 2).sum())
              for g, w in zip(got, want) for k in w)
    den = sum(float((w[k] ** 2).sum()) for w in want for k in w)
    return np.sqrt(num / den)


def _assert_close_through_kinks(got, want):
    assert _rel_l2(got, want) < KINK_L2
    for g, w in zip(got, want):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= \
                KINK_SCALE * max(np.abs(w[k]).max(), 1e-2), k


def _image_fit(pkg, prefix, x, y, batch, n_batches, epochs):
    sym, arg, aux = _load(pkg, prefix)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    accs = []
    it = pkg.io.NDArrayIter(x[:n_batches * batch], y[:n_batches * batch],
                            batch_size=batch)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params=arg, aux_params=aux, eval_metric="acc",
            batch_end_callback=lambda p: accs.append(p.eval_metric.get()))
    return mod, _host(mod), accs


@pytest.mark.parametrize("name", sorted(FIT))
def test_image_fit_trajectory_matches_jax(name, tmp_path):
    cfg = FIT[name]
    b = cfg["batch"]
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4 * b,) + cfg["data"]).astype(np.float32)
    y = rng.randint(0, cfg["classes"], 4 * b).astype(np.float32)
    with jmx.name.NameManager():
        sym = cfg["build"](jmx)
    prefix = _checkpoint(tmp_path, name, sym,
                         {"data": (b,) + cfg["data"], "softmax_label": (b,)},
                         ["softmax_label"])
    first = [_image_fit(pkg, prefix, x, y, b, 1, 1)[1] for pkg in (jmx, tmx)]
    _, want, want_acc = _image_fit(jmx, prefix, x, y, b, 4, 2)
    mod, got, got_acc = _image_fit(tmx, prefix, x, y, b, 4, 2)
    if name in RELU_AFTER_BN:
        _assert_close_through_kinks(first[1], first[0])
        # the reference against itself with the data one ulp up
        _, nudged, _ = _image_fit(jmx, prefix, np.nextafter(x, np.float32(2)),
                                  y, b, 4, 2)
        assert _rel_l2(got, want) <= DRIFT_RATIO * _rel_l2(nudged, want)
    else:
        _assert_params(first[1], first[0])
        _assert_params(got, want)
    assert len(got_acc) == len(want_acc) == 8
    # after the trajectories part at a tie, the batch accuracies may too
    assert got_acc[:1 if name in RELU_AFTER_BN else 8] == \
        want_acc[:1 if name in RELU_AFTER_BN else 8]
    assert mod._fused is not None
    assert mod._fused.stats.report()["eager_steps"] == 8


RCNN_SHAPES = {"data": (1, 3, 32, 32), "rois": (6, 5), "label": (6,),
               "bbox_target": (6, 16), "bbox_weight": (6, 16)}
RCNN_LABELS = ["label", "bbox_target", "bbox_weight"]


def _rcnn_batches(pkg, n):
    rng = np.random.RandomState(4)
    out = []
    for _ in range(n):
        rois = np.zeros((6, 5), np.float32)
        c = np.sort(rng.uniform(0, 31, (6, 2, 2)), axis=1)
        rois[:, 1:] = np.stack([c[:, 0, 0], c[:, 0, 1], c[:, 1, 0],
                                c[:, 1, 1]], 1)
        data = [rng.randn(1, 3, 32, 32).astype(np.float32), rois]
        label = [rng.randint(0, 4, 6).astype(np.float32),
                 rng.randn(6, 16).astype(np.float32),
                 (rng.rand(6, 16) > 0.5).astype(np.float32)]
        out.append(pkg.io.DataBatch(
            data=[pkg.nd.array(a, ctx=pkg.cpu()) for a in data],
            label=[pkg.nd.array(a, ctx=pkg.cpu()) for a in label]))
    return out


def _rcnn_train(pkg, prefix, steps):
    sym, arg, aux = _load(pkg, prefix)
    mod = pkg.mod.Module(sym, data_names=["data", "rois"],
                         label_names=RCNN_LABELS, context=pkg.cpu())
    mod.bind([(k, RCNN_SHAPES[k]) for k in ("data", "rois")],
             [(k, RCNN_SHAPES[k]) for k in RCNN_LABELS])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    outs = []
    for batch in _rcnn_batches(pkg, steps):
        mod.forward_backward(batch)
        mod.update()
        outs.append([o.asnumpy() for o in mod.get_outputs()])
    return mod, _host(mod), outs


def test_fast_rcnn_small_trains_like_jax(tmp_path, monkeypatch):
    """Fast R-CNN (``small=True``, spatial scale 0.5) for 8 steps: two
    heads (SoftmaxOutput with batch normalization, smooth_l1 through
    MakeLoss), ROIPooling over relu'd trunk outputs, through the fused
    step in the port as in the reference, and the port's classic path
    within rtol 1e-5, atol 1e-6 of its fused one."""
    with jmx.name.NameManager():
        sym = jmx.models.get_fast_rcnn(num_classes=4, pooled_size=(3, 3),
                                       spatial_scale=0.5, small=True)
    prefix = _checkpoint(tmp_path, "rcnn", sym, RCNN_SHAPES, RCNN_LABELS)
    _, want, want_o = _rcnn_train(jmx, prefix, 8)
    mod, got, got_o = _rcnn_train(tmx, prefix, 8)
    _assert_params(got, want)
    for g, w in zip(got_o, want_o):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=TRAJ_RTOL, atol=1e-6)
    assert mod._fused is not None
    # the classic path copies the rois (128 rows for 2 images on the
    # card) whole, as the reference's executor group does
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    cmod, classic, _ = _rcnn_train(tmx, prefix, 8)
    assert cmod._fused is None
    _assert_params(classic, got, 1e-5, 1e-6)
