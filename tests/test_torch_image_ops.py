"""The port's image-layer ops against the JAX package's, through Executor.

``Deconvolution``, ``UpSampling``, ``LRN``, ``L2Normalization``,
``IdentityAttachKLSparseReg``, ``ROIPooling`` and ``SpatialTransformer``:
each case builds the same one-op graph in both packages, binds it on the
CPU with ``grad_req="write"``, feeds the same seeded numpy inputs, runs a
train forward and a backward with a seeded head gradient, and compares
the output, every argument's gradient and the aux states.  Tolerance:
rtol 1e-5, atol 1e-6 (float32 sums in other orders in XLA and PyTorch);
the cases that differ say why.

``ROIPooling`` is held on tied inputs (integer-valued, relu'd: most bins
hold several equal maxima, and JAX's reduce-max splits a bin's gradient
equally among them), on overlapping bins, empty bins, batch indices that
wrap or clamp, and on monotone data whose maxima sit at a bin's corner,
so any bin edge off by one shows.  One case runs at a shape where the
JAX formulation's per-ROI mask would take 1.6 GB, in a child process
whose peak memory is held under a stated bound.
"""
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u(rng, shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _run(pkg, build, values, head=None, aux=None, is_train=True):
    """-> (outputs, grads, aux after the step) as numpy; an eval forward
    runs no backward."""
    sym = build(pkg.sym)
    exe = sym.simple_bind(pkg.cpu(), grad_req="write",
                          **{n: v.shape for n, v in values.items()})
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    for n, v in (aux or {}).items():
        exe.aux_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    if is_train:
        exe.backward(head)
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None}
    return outs, grads, {n: a.asnumpy() for n, a in exe.aux_dict.items()}


def _op(op, inputs=("data",), **params):
    def build(s):
        return getattr(s, op)(*[s.Variable(n) for n in inputs], name="op",
                              **params)
    return build


def _compare(build, values, seed, rtol=RTOL, atol=ATOL, aux=None):
    rng = np.random.RandomState(seed)
    want_out, _, _ = _run(jmx, build, values, aux=aux, is_train=False)
    got_out, _, _ = _run(tmx, build, values, aux=aux, is_train=False)
    np.testing.assert_allclose(got_out[0], want_out[0], rtol=rtol, atol=atol)
    head = [_u(rng, want_out[0].shape)]
    want = _run(jmx, build, values, head=head, aux=aux)
    got = _run(tmx, build, values, head=head, aux=aux)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=rtol, atol=atol)
    assert sorted(got[1]) == sorted(want[1]) == sorted(values)
    for name in values:
        np.testing.assert_allclose(got[1][name], want[1][name], rtol=rtol,
                                   atol=atol, err_msg=name)
    assert sorted(got[2]) == sorted(want[2])
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name], rtol=rtol,
                                   atol=atol, err_msg=name)
    return got


def _w(rng, shape):
    return _u(rng, shape, 1 / np.sqrt(np.prod(shape[1:])))


def _relu_ints(rng, shape, hi=3):
    """Integer levels after a relu: many ties, most of them at 0."""
    return np.maximum(rng.randint(-hi, hi + 1, shape), 0).astype(np.float32)


def _rois(rng, r, n, w, h, scale, integral=False):
    x1 = rng.uniform(-6, w / scale + 6, r)
    y1 = rng.uniform(-6, h / scale + 6, r)
    x2 = x1 + rng.uniform(-3, w / scale, r)
    y2 = y1 + rng.uniform(-3, h / scale, r)
    b = rng.randint(0, n, r).astype(np.float32)
    out = np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)
    if integral:
        out[:, 1:] = np.round(out[:, 1:])
    return out


# (id, graph builder, inputs builder (rng -> {name: array}))
CASES = [
    # tests/test_operator.py:158: k4 s2 p1, 5 -> 3 channels
    ("deconv", _op("Deconvolution", ("data", "op_weight"), kernel=(4, 4),
                   stride=(2, 2), pad=(1, 1), num_filter=3),
     lambda r: {"data": _u(r, (2, 5, 7, 7)),
                "op_weight": _w(r, (5, 3, 4, 4))}),
    ("deconv-bias-adj", _op("Deconvolution", ("data", "op_weight",
                                              "op_bias"),
                            kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            adj=(1, 1), num_filter=4, no_bias=False),
     lambda r: {"data": _u(r, (2, 3, 5, 6)), "op_weight": _w(r, (3, 4, 3, 3)),
                "op_bias": _u(r, (4,))}),
    # PyTorch's output_padding must be below the stride; the lax lowering
    # takes any adj (rows past the full transposed conv are 0 + bias)
    ("deconv-adj-ge-stride", _op("Deconvolution", ("data", "op_weight",
                                                   "op_bias"),
                                 kernel=(3, 2), stride=(2, 1), pad=(1, 0),
                                 adj=(3, 2), num_filter=2, no_bias=False),
     lambda r: {"data": _u(r, (2, 3, 4, 5)), "op_weight": _w(r, (3, 2, 3, 2)),
                "op_bias": _u(r, (2,))}),
    ("deconv-adj-ge-stride-pad", _op("Deconvolution", ("data", "op_weight"),
                                     kernel=(4, 4), stride=(1, 2),
                                     pad=(2, 1), adj=(1, 2), num_filter=3),
     lambda r: {"data": _u(r, (1, 2, 5, 4)),
                "op_weight": _w(r, (2, 3, 4, 4))}),
    # tests/test_operator.py:554: groups regroup the (in_c, out/g) layout
    ("deconv-grouped", _op("Deconvolution", ("data", "op_weight"),
                           kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           num_filter=4, num_group=2),
     lambda r: {"data": _u(r, (2, 4, 5, 5)),
                "op_weight": _w(r, (4, 2, 3, 3))}),
    ("deconv-dcgan-first", _op("Deconvolution", ("data", "op_weight"),
                               kernel=(4, 4), num_filter=8),
     lambda r: {"data": _u(r, (3, 6, 1, 1)),
                "op_weight": _w(r, (6, 8, 4, 4))}),
    ("upsample-nearest", _op("UpSampling", scale=2, sample_type="nearest"),
     lambda r: {"data": _u(r, (1, 2, 3, 3))}),
    ("upsample-nearest-concat", _op("UpSampling", ("arg0", "arg1", "arg2"),
                                    scale=3, sample_type="nearest"),
     lambda r: {"arg0": _u(r, (2, 2, 3, 4)), "arg1": _u(r, (2, 1, 3, 4)),
                "arg2": _u(r, (2, 3, 3, 4))}),
    ("upsample-nearest-sum", _op("UpSampling", ("arg0", "arg1"), scale=2,
                                 sample_type="nearest",
                                 multi_input_mode="sum"),
     lambda r: {"arg0": _u(r, (2, 3, 3, 2)), "arg1": _u(r, (2, 3, 3, 2))}),
    ("upsample-bilinear-2", _op("UpSampling", ("data", "op_weight"), scale=2,
                                sample_type="bilinear", num_filter=3),
     lambda r: {"data": _u(r, (2, 3, 4, 5)),
                "op_weight": _u(r, (3, 1, 4, 4))}),
    ("upsample-bilinear-3", _op("UpSampling", ("data", "op_weight"), scale=3,
                                sample_type="bilinear", num_filter=2),
     lambda r: {"data": _u(r, (1, 2, 3, 3)),
                "op_weight": _u(r, (2, 1, 5, 5))}),
    ("lrn", _op("LRN", nsize=3, alpha=1e-4, beta=0.75, knorm=2.0),
     lambda r: {"data": _u(r, (2, 5, 3, 3), 3)}),
    # AlexNet's form; a large alpha so the norm term is not ~knorm
    ("lrn-alexnet", _op("LRN", nsize=5, alpha=0.5, beta=0.75, knorm=1),
     lambda r: {"data": _u(r, (2, 7, 3, 4), 2)}),
    ("lrn-even", _op("LRN", nsize=4, alpha=0.3, beta=0.6),
     lambda r: {"data": _u(r, (2, 6, 2, 3), 2)}),
    ("l2norm", _op("L2Normalization"), lambda r: {"data": _u(r, (3, 4, 5))}),
    ("l2norm-eps", _op("L2Normalization", eps=0.1),
     lambda r: {"data": _u(r, (4, 6), 0.2)}),
    ("spatial-transformer", _op("SpatialTransformer", ("data", "loc"),
                                target_shape=(5, 6)),
     lambda r: {"data": _u(r, (2, 3, 7, 8)),
                "loc": np.array([[0.9, 0.13, 0.07, -0.11, 0.8, 0.05],
                                 [1.2, -0.3, 0.21, 0.17, 1.1, -0.33]],
                                np.float32)}),
    # corners outside the image count 0
    ("spatial-transformer-outside", _op("SpatialTransformer",
                                        ("data", "loc"),
                                        target_shape=(4, 9)),
     lambda r: {"data": _u(r, (2, 2, 5, 6)),
                "loc": np.array([[1.7, 0.31, 0.43, -0.27, 1.6, -0.52],
                                 [0.6, 0.2, -0.9, 0.1, 0.5, 0.8]],
                                np.float32)}),
    # tests/test_operator.py:572 and test_operator_grad.py:413
    ("roi-basic", _op("ROIPooling", ("data", "rois"), pooled_size=(2, 2),
                      spatial_scale=1.0),
     lambda r: {"data": np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4),
                "rois": np.array([[0, 0, 0, 3, 3]], np.float32)}),
    # ties: relu'd integer levels, overlapping ROIs and bins (bin edges
    # floor/ceil), and ROIs past the image (empty bins give 0)
    ("roi-ties", _op("ROIPooling", ("data", "rois"), pooled_size=(3, 2),
                     spatial_scale=0.5),
     lambda r: {"data": _relu_ints(r, (2, 3, 9, 11)),
                "rois": np.concatenate([_rois(r, 6, 2, 11, 9, 0.5),
                                        np.array([[1, 0, 0, 21, 17],
                                                  [1, 0, 0, 21, 17],
                                                  [0, 30, 30, 40, 40],
                                                  [1, 4, 4, 5, 5]],
                                                 np.float32)])}),
    ("roi-ties-7x7", _op("ROIPooling", ("data", "rois"), pooled_size=(7, 7),
                         spatial_scale=0.125),
     lambda r: {"data": _relu_ints(r, (2, 4, 12, 10), 1),
                "rois": _rois(r, 9, 2, 10, 12, 0.125, integral=True)}),
    # batch indices: 0, N-1, truncation of 1.7 and -0.5, -1 wraps to
    # N-1, -N-1 wraps to -1 and clamps to 0, N+2 clamps to N-1
    ("roi-batch-index", _op("ROIPooling", ("data", "rois"),
                            pooled_size=(2, 3), spatial_scale=1.0),
     lambda r: {"data": _relu_ints(r, (3, 2, 6, 7)),
                "rois": np.array([[0, 0, 0, 6, 5], [2, 1, 0, 5, 5],
                                  [1.7, 0, 1, 4, 5], [-0.5, 2, 0, 6, 3],
                                  [-1, 0, 0, 6, 5], [-4, 0, 0, 6, 5],
                                  [5, 1, 1, 3, 3]], np.float32)}),
    # rounding half to even: 2.5 -> 2 and 3.5 -> 4 at scale 0.5 of 5, 7
    ("roi-round-half-even", _op("ROIPooling", ("data", "rois"),
                                pooled_size=(2, 2), spatial_scale=0.5),
     lambda r: {"data": _u(r, (1, 2, 8, 8)),
                "rois": np.array([[0, 5, 7, 13, 11], [0, 1, 3, 9, 15]],
                                 np.float32)}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_image_op_matches_jax(case):
    cid, build, inputs = case
    seed = zlib.crc32(cid.encode())
    _compare(build, inputs(np.random.RandomState(seed)), seed)


@pytest.mark.parametrize("kind", ["increasing", "decreasing"])
@pytest.mark.parametrize("pooled", [(7, 7), (3, 5), (1, 1)])
def test_roi_pooling_bin_edges_equal_jax(kind, pooled):
    """Monotone data puts each bin's maximum at one of its corners, so a
    bin edge that moved by one changes the output: the port's float32
    geometry (XLA multiplies by the reciprocal of pooled_size) must equal
    the JAX op's for ROIs of every integer size."""
    n, c, h, w = 2, 1, 20, 23
    data = np.arange(n * c * h * w, dtype=np.float32).reshape(n, c, h, w)
    if kind == "decreasing":
        data = -data
    rng = np.random.RandomState(sum(pooled))
    rois = np.concatenate([
        _rois(rng, 24, n, w, h, 1.0, integral=True),
        np.array([[0, 0, 0, s - 1, s - 1] for s in range(1, 22)],
                 np.float32)])
    build = _op("ROIPooling", ("data", "rois"), pooled_size=pooled,
                spatial_scale=1.0)
    want, _, _ = _run(jmx, build, {"data": data, "rois": rois},
                      is_train=False)
    got, _, _ = _run(tmx, build, {"data": data, "rois": rois},
                     is_train=False)
    np.testing.assert_array_equal(got[0], want[0])


def test_roi_pooling_gradient_splits_ties_equally():
    """One bin of four equal maxima: each takes a quarter of the bin's
    gradient (JAX's reduce-max rule; ``Pooling`` sends it to one)."""
    build = _op("ROIPooling", ("data", "rois"), pooled_size=(1, 1),
                spatial_scale=1.0)
    data = np.zeros((1, 1, 3, 3), np.float32)
    data[0, 0, 0, 0] = data[0, 0, 1, 2] = data[0, 0, 2, 1] = \
        data[0, 0, 2, 2] = 2.0
    values = {"data": data, "rois": np.array([[0, 0, 0, 2, 2]], np.float32)}
    head = [np.full((1, 1, 1, 1), 1.0, np.float32)]
    for pkg in (jmx, tmx):
        out, grads, _ = _run(pkg, build, values, head=head)
        assert out[0].item() == 2.0
        np.testing.assert_array_equal(grads["data"],
                                      np.where(data == 2.0, 0.25, 0.0))
        np.testing.assert_array_equal(grads["rois"], 0.0)


def test_roi_pooling_builds_no_mask_at_a_large_shape():
    """At 2x128x40x50 with 32 ROIs of 7x7 bins, the JAX formulation's mask
    (R, C, Ph, Pw, H, W) holds 401 M float32 elements (1.6 GB).  The port
    runs forward and backward there in a child process whose peak
    resident memory grows by less than 300 MB (its range tables and
    per-ROI column maxima are ~10 MB here), and its answer equals a
    plain per-ROI numpy loop."""
    code = r"""
import resource, sys
import numpy as np, torch
sys.path.insert(0, %r)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.special import _ROIPool
def run(n, c, h, w, r):
    rng = np.random.RandomState(3)
    data = torch.from_numpy(np.maximum(rng.randint(-3, 4, (n, c, h, w)), 0)
                            .astype(np.float32)).requires_grad_(True)
    x1 = rng.uniform(0, w * 8, r); y1 = rng.uniform(0, h * 8, r)
    rois = np.stack([rng.randint(0, n, r), x1, y1, x1 + rng.uniform(0, w * 8, r),
                     y1 + rng.uniform(0, h * 8, r)], 1).astype(np.float32)
    out = _ROIPool.apply(data, torch.from_numpy(rois), (7, 7), 0.125)
    out.backward(torch.ones_like(out))
    return data.detach().numpy(), rois, out.detach().numpy(), data.grad.numpy()
run(1, 2, 5, 6, 3)
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
res = run(2, 128, 40, 50, 32)
grow = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base
np.savez(sys.argv[1], *res, grow=grow)
""" % ROOT
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.npz")
        proc = subprocess.run([sys.executable, "-c", code, path],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        z = np.load(path)
        data, rois, out, grad = (z["arr_%d" % i] for i in range(4))
        grow_mb = int(z["grow"]) / 1024.0
    r, c, ph, pw = out.shape
    assert r * c * ph * pw * data.shape[2] * data.shape[3] * 4 > 1.5e9
    assert grow_mb < 300, grow_mb
    # a plain loop over ROIs and bins (the JAX op's geometry and ties)
    n, _, h, w = data.shape
    want = np.zeros_like(out)
    want_grad = np.zeros_like(data)
    sc = np.float32(0.125)
    for k, roi in enumerate(rois):
        b = int(roi[0])
        x1, y1, x2, y2 = (np.round(roi[i] * sc) for i in (1, 2, 3, 4))
        bh = np.float32(max(y2 - y1 + 1, 1)) * np.float32(1 / np.float32(7))
        bw = np.float32(max(x2 - x1 + 1, 1)) * np.float32(1 / np.float32(7))
        for i in range(ph):
            hs = int(min(max(np.floor(np.float32(i) * bh) + y1, 0), h))
            he = int(min(max(np.ceil(np.float32(i + 1) * bh) + y1, 0), h))
            for j in range(pw):
                ws = int(min(max(np.floor(np.float32(j) * bw) + x1, 0), w))
                we = int(min(max(np.ceil(np.float32(j + 1) * bw) + x1, 0), w))
                if he <= hs or we <= ws:
                    continue
                win = data[b, :, hs:he, ws:we]
                m = win.max(axis=(1, 2))
                want[k, :, i, j] = m
                tie = win == m[:, None, None]
                want_grad[b, :, hs:he, ws:we] += \
                    tie / tie.sum(axis=(1, 2))[:, None, None]
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=ATOL)


def test_kl_sparse_reg_gradient_and_moving_avg():
    """The KL penalty uses the batch's mean (clipped), not ``moving_avg``;
    a train forward commits momentum · old + (1 - momentum) · mean, an
    eval forward commits nothing; both as the JAX executor does."""
    build = _op("IdentityAttachKLSparseReg", sparseness_target=0.2,
                penalty=0.05, momentum=0.7)
    rng = np.random.RandomState(5)
    values = {"data": rng.uniform(0.05, 0.95, (6, 4)).astype(np.float32)}
    aux = {"op_moving_avg": np.array([0.4], np.float32)}
    got = _compare(build, values, 5, aux=aux)
    rho = values["data"].mean()
    np.testing.assert_allclose(got[2]["op_moving_avg"],
                               [0.7 * 0.4 + 0.3 * rho], rtol=RTOL)
    for pkg in (jmx, tmx):
        _, _, after = _run(pkg, build, values, aux=aux, is_train=False)
        np.testing.assert_array_equal(after["op_moving_avg"], aux["op_moving_avg"])
    # rho clipped: an all-zero batch takes rho = 1e-6
    zero = {"data": np.zeros((2, 3), np.float32)}
    head = [np.zeros((2, 3), np.float32)]
    want = _run(jmx, build, zero, head=head, aux=aux)
    got = _run(tmx, build, zero, head=head, aux=aux)
    np.testing.assert_allclose(got[1]["data"], want[1]["data"], rtol=RTOL)
    np.testing.assert_allclose(got[2]["op_moving_avg"],
                               want[2]["op_moving_avg"], rtol=RTOL)


def test_deconvolution_target_shape_is_read_by_infer_shape_only():
    """The JAX forward ignores ``target_shape``; only ``infer_shape``
    reads it (a reference quirk kept): both packages infer (2, 3, 9, 9)
    and compute the formula's (2, 3, 8, 8)."""
    build = _op("Deconvolution", ("data", "op_weight"), kernel=(4, 4),
                stride=(2, 2), pad=(1, 1), num_filter=3, target_shape=(9, 9))
    for pkg in (jmx, tmx):
        sym = build(pkg.sym)
        _, outs, _ = sym.infer_shape(data=(2, 5, 4, 4))
        assert outs[0] == (2, 3, 9, 9)
    rng = np.random.RandomState(2)
    values = {"data": _u(rng, (2, 5, 4, 4)), "op_weight": _w(rng, (5, 3, 4, 4))}
    want, _, _ = _run(jmx, build, values, is_train=False)
    got, _, _ = _run(tmx, build, values, is_train=False)
    assert got[0].shape == want[0].shape == (2, 3, 8, 8)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)


def test_grouped_deconvolution_equals_deconvolutions_of_the_halves():
    """tests/test_operator.py:554 in the port: num_group 2 equals two
    independent deconvolutions on the channel halves."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 4, 5, 5).astype(np.float32)
    w = rng.rand(4, 2, 3, 3).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), no_bias=True)
    out, _, _ = _run(tmx, _op("Deconvolution", ("data", "op_weight"),
                              num_filter=4, num_group=2, **kw),
                     {"data": x, "op_weight": w}, is_train=False)
    for g in range(2):
        half, _, _ = _run(tmx, _op("Deconvolution", ("data", "op_weight"),
                                   num_filter=2, **kw),
                          {"data": x[:, 2 * g:2 * g + 2],
                           "op_weight": w[2 * g:2 * g + 2]}, is_train=False)
        np.testing.assert_allclose(out[0][:, 2 * g:2 * g + 2], half[0],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op, kwargs, shapes", [
    ("Deconvolution", dict(kernel=(2, 2), stride=(2, 2), num_filter=3),
     [(1, 2, 3, 3), (2, 3, 2, 2)]),
    ("UpSampling", dict(scale=2, sample_type="nearest"), [(1, 2, 2, 3)]),
    ("UpSampling", dict(scale=2, sample_type="bilinear", num_filter=2),
     [(1, 2, 2, 3), (2, 1, 4, 4)]),
    ("LRN", dict(nsize=3), [(1, 4, 2, 2)]),
    ("L2Normalization", {}, [(2, 5)]),
    ("ROIPooling", dict(pooled_size=(2, 2), spatial_scale=1.0),
     [(1, 2, 4, 4), (2, 5)]),
    ("SpatialTransformer", dict(target_shape=(3, 3)), [(2, 1, 4, 4), (2, 6)]),
])
def test_image_ops_as_nd_functions(op, kwargs, shapes):
    """Each aux-free image op is ``mx.nd.<op>`` too, equal to its
    symbolic form (``IdentityAttachKLSparseReg`` has an aux state, so it
    is symbolic only: the nd bridge registers aux-free ops)."""
    rng = np.random.RandomState(7)
    arrays = [rng.rand(*s).astype(np.float32) for s in shapes]
    if op == "ROIPooling":
        arrays[1] = np.array([[0, 0, 0, 3, 3], [0, 1, 1, 2, 3]], np.float32)
    if op == "SpatialTransformer":
        arrays[1] = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    got = getattr(tmx.nd, op)(*[tmx.nd.array(a, ctx=tmx.cpu())
                                for a in arrays], **kwargs)
    sym = getattr(tmx.sym, op)(*[tmx.sym.Variable("in%d" % i)
                                 for i in range(len(arrays))], **kwargs)
    exe = sym.simple_bind(tmx.cpu(), grad_req="null",
                          **{"in%d" % i: a.shape for i, a in
                             enumerate(arrays)})
    want = exe.forward(**{"in%d" % i: a for i, a in enumerate(arrays)})
    np.testing.assert_array_equal(got.asnumpy(), want[0].asnumpy())
    assert not hasattr(tmx.nd, "IdentityAttachKLSparseReg")


def test_port_registers_every_reference_image_op():
    from mxnet_tpu.ops.registry import list_ops as jax_ops
    from mxnet_tpu_torch.ops.registry import list_ops, get_op
    new = ["Deconvolution", "UpSampling", "LRN", "L2Normalization",
           "IdentityAttachKLSparseReg", "ROIPooling", "SpatialTransformer"]

    def registered(names):
        # NumpyOp.get_symbol registers one _numpy_op_<id> op per instance
        # in its process, in both packages; another test file in the same
        # worker may have made some
        return {n for n in names if not n.startswith("_numpy_op_")}
    assert set(new) <= registered(list_ops()) <= registered(jax_ops())
    assert len(registered(list_ops())) == 120
    import mxnet_tpu.ops.registry as jreg
    for name in new:
        jop, top = jreg.get_op(name), get_op(name)
        assert [p.name for p in jop.params] == [p.name for p in top.params]
        assert jop.hint == top.hint
