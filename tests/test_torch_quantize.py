"""int8 and float16 serving ("quantize, then fuse") in the port, held
against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages.  What is held
and how closely:

* integer results are equal: weight codes, ``wscale`` vectors, int32
  sums and every int8 activation of a relu or identity epilogue;
* float outputs of the int8 ops with a relu or identity epilogue are
  equal bitwise: both compute ``acc * scale + bias`` with one rounding
  (XLA:CPU contracts it into a fused multiply-add; the port sums in
  float64 and rounds once);
* sigmoid, tanh and softrelu differ in the last ulp across libraries, so
  their floats are held to rtol 1e-6 and their int8 codes to |d| <= 1;
* calibration tables computed by both packages from one graph, params
  and feeds agree within rtol 1e-5 (float32 forwards summed in other
  orders); given one table, the quantized graphs and parameters are
  equal;
* float32 model outputs after the int8 layers (the float output layer
  and the softmax) within rtol 1e-5, atol 1e-7, as in
  ``test_torch_serve.py``;
* float16 mode: parameter bits equal, outputs within rtol 1e-2 (atol
  1e-3 on softmax probabilities), since the two libraries round float16
  products and sums at different places.
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import mxnet_tpu as mx
import mxnet_tpu.model
import mxnet_tpu.models
import mxnet_tpu.passes
import mxnet_tpu.predictor
import mxnet_tpu.serve
from mxnet_tpu.ops import get_op as jax_get_op
from mxnet_tpu.ops.registry import OpContext as JaxOpContext
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import int8 as i8
from mxnet_tpu_torch.ops.registry import OpContext

RTOL, ATOL = 1e-5, 1e-7
U8 = {"mean": 117.0, "scale": 1 / 58.0, "hwc": True}
BOTH = ("FullyConnected", "Convolution")
ACTS = ("none", "relu", "sigmoid", "tanh", "softrelu")
EXACT_ACTS = ("none", "relu")


# ---------------------------------------------------------------------------
# helpers

def _mlp(s, in_dim=16, hidden=32, classes=4):
    net = s.Variable("data")
    net = s.FullyConnected(net, num_hidden=hidden, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=hidden, name="fc2")
    net = s.Activation(net, act_type="tanh", name="tanh2")
    net = s.FullyConnected(net, num_hidden=classes, name="fc3")
    return s.SoftmaxOutput(net, name="softmax")


def _narrow_vgg(s, classes=5):
    """Two VGG conv blocks and the fc6/fc7/fc8 head, narrow."""
    body = s.Variable("data")
    for stage, filters in ((1, 8), (2, 16)):
        for i in (1, 2):
            body = s.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                 num_filter=filters,
                                 name="conv%d_%d" % (stage, i))
            body = s.Activation(data=body, act_type="relu",
                                name="relu%d_%d" % (stage, i))
        body = s.Pooling(data=body, pool_type="max", kernel=(2, 2),
                         stride=(2, 2), name="pool%d" % stage)
    body = s.Flatten(data=body, name="flatten")
    for layer in (6, 7):
        body = s.FullyConnected(data=body, num_hidden=32,
                                name="fc%d" % layer)
        body = s.Activation(data=body, act_type="relu",
                            name="relu%d" % layer)
        body = s.Dropout(data=body, p=0.5, name="drop%d" % layer)
    body = s.FullyConnected(data=body, num_hidden=classes, name="fc8")
    return s.SoftmaxOutput(data=body, name="softmax")


MODELS = {"mlp": (_mlp, {"data": (8, 16)}),
          "vgg": (_narrow_vgg, {"data": (8, 3, 16, 16)})}


def _params(sym, shapes, seed):
    """Uniform weights at sqrt(6 / fan_in), small uniform biases."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes or name.endswith("label"):
            continue
        scale = 0.01 if len(shape) == 1 else np.sqrt(6.0 / np.prod(shape[1:]))
        out[name] = (rng.uniform(-1, 1, shape) * scale).astype(np.float32)
    return out


def _model(name, seed=0):
    build, shapes = MODELS[name]
    sym = build(mx.sym)
    return build, shapes, _params(sym, shapes, seed)


def _feeds(shape, n=3, seed=1, u8=False):
    rng = np.random.RandomState(seed)
    if u8:
        return [{"data": rng.randint(0, 256, shape).astype(np.uint8)}
                for _ in range(n)]
    return [{"data": rng.uniform(0, 1, shape).astype(np.float32)}
            for _ in range(n)]


def _hwc(shape):
    return (shape[0], shape[2], shape[3], shape[1])


def _run(pkg, sym, params, feeds, internals=True):
    """Bind (the internals of) ``sym`` on the CPU with every param at its
    dtype, write ``feeds``, forward; -> {output name: numpy array}."""
    s = sym.get_internals() if internals else sym
    td = {k: np.asarray(v).dtype for k, v in params.items()}
    td.update({k: v.dtype for k, v in feeds.items()})
    shapes = {k: v.shape for k, v in feeds.items()}
    if "softmax_label" in s.list_arguments():
        shapes["softmax_label"] = (next(iter(feeds.values())).shape[0],)
    ex = s.simple_bind(pkg.cpu(), grad_req="null", type_dict=td, **shapes)
    ex.copy_params_from(params, {}, allow_extra_params=True)
    for k, v in feeds.items():
        ex.arg_dict[k][:] = v
    outs = ex.forward(is_train=False)
    return dict(zip(s.list_outputs(), [np.asarray(o.asnumpy())
                                       for o in outs]))


def _jax_table(sym, params, feeds, mode="percentile", percentile=99.99):
    return mx.passes.calibrate_arrays(sym, feeds, arg_params=params,
                                      mode=mode, percentile=percentile)


def _wired_table(build, shapes, params, u8):
    """A table computed by the JAX package on the graph the quantize pass
    sees: after the u8 wire (when ``u8``), folds, CSE and DCE."""
    item = _hwc(shapes["data"]) if u8 else shapes["data"]
    wired, _ = mx.passes.build_serving_pipeline(u8_wire=u8, fuse=False).run(
        build(mx.sym), dict(params))
    return _jax_table(wired, params, _feeds(item, u8=bool(u8))), item


def _pipelines(table, fuse=True, u8_wire=None, **qkw):
    """The same serving pipeline in both packages, one table."""
    qkw.setdefault("ops", BOTH)
    jpipe = mx.passes.build_serving_pipeline(
        quantize=dict(qkw, calib=table), u8_wire=u8_wire, fuse=fuse,
        name="t-jax")
    tpipe = mt.passes.build_serving_pipeline(
        quantize=dict(qkw, calib=mt.passes.CalibrationTable.fromjson(
            table.tojson())),
        u8_wire=u8_wire, fuse=fuse, name="t-port", ctx=mt.cpu())
    return jpipe, tpipe


def _ops(sym):
    return [n["op"] for n in json.loads(sym.tojson())["nodes"]
            if n["op"] != "null"]


def _nodes(sym):
    doc = json.loads(sym.tojson())
    doc["attrs"].pop("__passes__", None)
    return doc


def _assert_params_equal(jp, tp):
    assert sorted(jp) == sorted(tp)
    for k in jp:
        a, b = np.asarray(jp[k]), np.asarray(tp[k])
        assert a.dtype == b.dtype, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def _jax_op(name, params, inputs):
    """The reference op under ``jax.jit``, as its executor runs it (XLA
    fuses the epilogue: the multiply and the bias add become one fused
    multiply-add)."""
    op = jax_get_op(name)
    p = op.parse_params(params)
    fn = jax.jit(lambda *xs: op.forward(p, list(xs), [],
                                        JaxOpContext(is_train=False))[0])
    return np.asarray(fn(*[jnp.asarray(x) for x in inputs]))


def _port_op(name, params, inputs):
    op = mt.ops.get_op(name)
    outs = op.forward(op.parse_params(params),
                      [torch.from_numpy(np.array(x)) for x in inputs], [],
                      OpContext(is_train=False))
    return outs[0].numpy()


# ---------------------------------------------------------------------------
# quantize_array, _contrib_quantize, _contrib_dequantize

@pytest.mark.parametrize("shape,axis", [((16, 9), 0), ((16, 9), None),
                                        ((8, 3, 3, 3), 0), ((6, 4), 1),
                                        ((5, 7), 0)])
def test_quantize_array_bitwise(shape, axis):
    from mxnet_tpu.ops.quantized import quantize_array as jax_qa
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)
    w[2] = 0.0                                   # a zero slice: scale 1
    qj, sj = jax_qa(w, axis=axis)
    qt, st = mt.ops.quantized.quantize_array(w, axis=axis)
    assert qj.dtype == qt.dtype == np.int8 and np.array_equal(qj, qt)
    assert np.asarray(sj).dtype == np.asarray(st).dtype == np.float32
    assert np.array_equal(np.asarray(sj), np.asarray(st))


@pytest.mark.parametrize("scale", [0.25, 0.1, 3e-3])
def test_contrib_quantize_dequantize_bitwise(scale):
    rng = np.random.RandomState(4)
    s = np.float32(scale)
    ties = (np.arange(-20, 20) + np.float32(0.5)) * s   # .5 ties at 0.25
    clipped = np.array([200, -200, 127.6, -127.6, 1e6], np.float32) * s
    x = np.concatenate([ties.astype(np.float32), clipped,
                        rng.randn(200).astype(np.float32) * 40 * s])
    qj = _jax_op("_contrib_quantize", {"scale": scale}, [x])
    qt = _port_op("_contrib_quantize", {"scale": scale}, [x])
    assert qt.dtype == qj.dtype == np.int8
    assert np.array_equal(qt, qj)
    assert qt.max() == 127 and qt.min() == -127
    for codes in (qt, qt.astype(np.int32) * 300):
        dj = _jax_op("_contrib_dequantize", {"scale": scale}, [codes])
        dt = _port_op("_contrib_dequantize", {"scale": scale}, [codes])
        assert dt.dtype == dj.dtype == np.float32
        assert np.array_equal(dt, dj)


def test_contrib_quantize_rejects_bad_scale():
    with pytest.raises(mt.MXNetError, match="scale must be > 0"):
        _port_op("_contrib_quantize", {"scale": 0.0},
                 [np.ones(3, np.float32)])


# ---------------------------------------------------------------------------
# the int8 ops

def _int8_layer_inputs(family, seed, bias=True):
    rng = np.random.RandomState(seed)
    if family == "fc":
        x = rng.randint(-127, 128, (5, 3, 4, 4)).astype(np.int8)
        w = rng.randint(-127, 128, (24, 48)).astype(np.int8)
        params = {"num_hidden": 24, "scale_data": 0.02}
    else:
        x = rng.randint(-127, 128, (2, 6, 9, 7)).astype(np.int8)
        w = rng.randint(-127, 128, (8, 6, 3, 3)).astype(np.int8)
        params = {"kernel": (3, 3), "pad": (1, 1), "stride": (2, 1),
                  "num_filter": 8, "scale_data": 0.02}
    wscale = rng.uniform(1e-4, 1e-3, w.shape[0]).astype(np.float32)
    ins = [x, w, wscale]
    if bias:
        ins.append(rng.uniform(-0.5, 0.5, w.shape[0]).astype(np.float32))
    else:
        params["no_bias"] = True
    return params, ins


OPNAME = {"fc": "FullyConnected", "conv": "Convolution"}


@pytest.mark.parametrize("family", ["fc", "conv"])
@pytest.mark.parametrize("bias", [True, False])
def test_quantized_op_bitwise(family, bias):
    params, ins = _int8_layer_inputs(family, 5, bias)
    name = "_quantized_" + OPNAME[family]
    got = _port_op(name, params, ins)
    want = _jax_op(name, params, ins)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("family", ["fc", "conv"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("requant", [False, True])
def test_fused_quantized_op_matches_reference(family, act, requant):
    params, ins = _int8_layer_inputs(family, 6)
    params = dict(params, act_type=act)
    if requant:
        params["out_scale"] = 0.005
    name = "_fused_quantized_" + OPNAME[family]
    got = _port_op(name, params, ins)
    want = _jax_op(name, params, ins)
    assert got.dtype == want.dtype == (np.int8 if requant else np.float32)
    if act in EXACT_ACTS:
        assert np.array_equal(got, want)
    elif requant:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if requant:
        assert (np.abs(got) == 127).any() or act in ("sigmoid", "tanh")
        assert len(np.unique(got)) > 20                 # a real spread


def _past_2_24(family, seed):
    """int8 inputs whose int32 sums pass 2^24, where float32 sums lose
    their low bits: mostly +127 with some smaller codes mixed in."""
    rng = np.random.RandomState(seed)
    if family == "fc":
        xs, ws = (4, 4608), (16, 4608)
    else:
        xs, ws = (1, 512, 5, 5), (16, 512, 3, 3)
    x = np.full(xs, 127, np.int8)
    w = np.full(ws, 127, np.int8)
    for a in (x, w):
        mask = rng.uniform(size=a.shape) < 0.2
        a[mask] = rng.randint(-127, 128, int(mask.sum()))
    return x, w


def _oracle(family, x, w):
    """int64 numpy oracle of the int8 product."""
    if family == "fc":
        return x.astype(np.int64) @ w.astype(np.int64).T
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    out = np.zeros((n, o, h, wd), np.int64)
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, :, i:i + h, j:j + wd]
            out += np.einsum("nchw,oc->nohw", patch,
                             w[:, :, i, j].astype(np.int64))
    return out


def _port_int8(family, x, w, route):
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if family == "fc":
        return (i8._int_mm(xt, wt) if route
                else i8.int8_matmul(xt, wt)).numpy()
    args = ((1, 1), (1, 1), (1, 1), 1)
    return (i8._conv_route(xt, wt, *args) if route
            else i8.int8_conv2d(xt, wt, *args)).numpy()


@pytest.mark.parametrize("family", ["fc", "conv"])
def test_int8_sums_past_2_24_exact(family):
    x, w = _past_2_24(family, 7)
    want = _oracle(family, x, w)
    assert np.abs(want).max() > 2 ** 24
    # the plain version (float64) and the card route's Python (im2col,
    # padding; torch._int_mm on the CPU) both equal the oracle
    for route in (False, True):
        got = _port_int8(family, x, w, route)
        assert got.dtype == np.int32 and np.array_equal(got, want)
    # float32 sums are not exact here: the reason the route is int8
    xf, wf = torch.from_numpy(x).float(), torch.from_numpy(w).float()
    f32 = (xf @ wf.t() if family == "fc" else
           torch.nn.functional.conv2d(xf, wf, padding=1)).double().numpy()
    assert not np.array_equal(f32, want.astype(np.float64))
    # the quantized op sums exactly in both packages; its float32 output
    # is that exact sum rounded to float32 in both
    name = "_quantized_" + OPNAME[family]
    params = {"num_hidden": w.shape[0]} if family == "fc" else \
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": w.shape[0]}
    params.update(scale_data=1.0, no_bias=True)
    ins = [x, w, np.ones(w.shape[0], np.float32)]
    got = _port_op(name, params, ins)
    assert np.array_equal(got, _jax_op(name, params, ins))
    assert np.array_equal(got, want.astype(np.float32))


ROUTE_CASES = [
    # (x shape, w shape, stride, pad, dilate, groups)
    ((1, 3, 9, 9), (8, 3, 3, 3), (1, 1), (1, 1), (1, 1), 1),   # K 27 -> 32
    ((2, 4, 7, 5), (12, 4, 3, 3), (2, 2), (0, 0), (1, 1), 1),  # N 12 -> 16
    ((1, 8, 6, 6), (6, 4, 3, 3), (1, 1), (2, 2), (2, 2), 2),   # groups
    ((1, 16, 4, 4), (8, 16, 1, 1), (1, 1), (0, 0), (1, 1), 1),  # M 16 -> 17
    ((3, 5, 8, 6), (7, 5, 2, 3), (1, 2), (1, 0), (1, 1), 1),
]


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_int8_conv_route_and_plain_version_equal_oracle(case):
    xs, ws, stride, pad, dilate, groups = ROUTE_CASES[case]
    rng = np.random.RandomState(case)
    x = rng.randint(-127, 128, xs).astype(np.int8)
    w = rng.randint(-127, 128, ws).astype(np.int8)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.int64)), torch.from_numpy(
            w.astype(np.int64)), stride=stride, padding=pad,
        dilation=dilate, groups=groups).numpy()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = i8.int8_conv2d(xt, wt, stride, pad, dilate, groups)
    i8.reset_route_calls()
    route = i8._conv_route(xt, wt, stride, pad, dilate, groups)
    assert i8.ROUTE_CALLS == {"int_mm": groups, "im2col": groups}
    for got in (plain, route):
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(1, 27, 60), (16, 8, 8), (40, 100, 24)])
def test_int8_matmul_route_and_plain_version_equal_oracle(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    want = x.astype(np.int64) @ w.astype(np.int64).T
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (i8.int8_matmul(xt, wt), i8._int_mm(xt, wt)):
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert np.array_equal(got.numpy(), want)


def test_int8_cpu_tensors_take_plain_version_without_counting():
    i8.reset_route_calls()
    x = torch.ones((3, 8), dtype=torch.int8)
    i8.int8_matmul(x, x)
    i8.int8_conv2d(x.reshape(1, 1, 3, 8), x[:1, :4].reshape(1, 1, 2, 2),
                   (1, 1), (0, 0), (1, 1))
    assert i8.ROUTE_CALLS == {"int_mm": 0, "im2col": 0}
    with pytest.raises(mt.MXNetError, match="int8 inputs"):
        i8.int8_matmul(x.float(), x)


# ---------------------------------------------------------------------------
# calibration

def test_calibration_table_json_crosses_packages(tmp_path):
    build, shapes, params = _model("mlp")
    feeds = _feeds(shapes["data"])
    jt = _jax_table(build(mx.sym), params, feeds)
    tt = mt.passes.CalibrationTable.fromjson(jt.tojson())
    assert tt.digest() == jt.digest() and len(tt) == len(jt)
    assert tt.tojson() == jt.tojson()
    assert mx.passes.CalibrationTable.fromjson(tt.tojson()).digest() == \
        jt.digest()
    path = str(tmp_path / "calib.json")
    tt.save(path)
    assert mx.passes.CalibrationTable.load(path).digest() == jt.digest()
    assert mt.passes.CalibrationTable.load(path).scale("fc1_output") == \
        jt.scale("fc1_output")


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["minmax", "percentile"])
def test_calibration_agrees_with_reference(model, mode):
    build, shapes, params = _model(model)
    feeds = _feeds(shapes["data"])
    jt = _jax_table(build(mx.sym), params, feeds, mode=mode)
    tt = mt.passes.calibrate_arrays(build(mt.sym), feeds, arg_params=params,
                                    mode=mode, percentile=99.99,
                                    ctx=mt.cpu())
    assert sorted(tt.ranges) == sorted(jt.ranges)
    assert (tt.mode, tt.percentile, tt.num_batches) == \
        (jt.mode, jt.percentile, jt.num_batches)
    for k, (lo, hi) in jt.ranges.items():
        np.testing.assert_allclose(tt.ranges[k], (lo, hi), rtol=1e-5,
                                   atol=0, err_msg=k)


class _Batches:
    """The iterator surface ``calibrate`` reads: provide_data and
    provide_label, reset() and batches with data and label lists."""

    class _Batch:
        def __init__(self, data, label):
            self.data, self.label = [data], [label]

    def __init__(self, arrays, batch):
        self.arrays, self.batch = arrays, batch
        self.provide_data = [("data", (batch,) + arrays.shape[1:])]
        self.provide_label = [("softmax_label", (batch,))]

    def reset(self):
        pass

    def __iter__(self):
        for i in range(0, len(self.arrays), self.batch):
            yield self._Batch(self.arrays[i:i + self.batch],
                              np.zeros(self.batch, np.float32))


def test_calibrate_over_an_iterator_equals_calibrate_arrays():
    build, shapes, params = _model("mlp")
    arrays = np.random.RandomState(2).uniform(0, 1, (32, 16)).astype(
        np.float32)
    sym = build(mt.sym)
    t_iter = mt.passes.calibrate(sym, _Batches(arrays, 8), num_batches=3,
                                 arg_params=params, ctx=mt.cpu())
    t_arr = mt.passes.calibrate_arrays(
        sym, [{"data": arrays[i:i + 8]} for i in (0, 8, 16)],
        arg_params=params, ctx=mt.cpu())
    assert t_iter.num_batches == 3 and t_iter.digest() == t_arr.digest()


def test_self_calibration_in_the_pass_equals_the_reference_within_rounding():
    build, shapes, params = _model("vgg")
    calib = np.random.RandomState(3).randint(
        0, 256, (16,) + _hwc(shapes["data"])[1:]).astype(np.uint8)
    kw = dict(quantize={"dtype": "int8", "ops": BOTH}, calib_data=calib,
              calib_shapes={"data": _hwc(shapes["data"])}, u8_wire=U8)
    jpipe = mx.passes.build_serving_pipeline(**kw)
    tpipe = mt.passes.build_serving_pipeline(ctx=mt.cpu(), **kw)
    jsym, _ = jpipe.run(build(mx.sym), dict(params))
    tsym, _ = tpipe.run(build(mt.sym), dict(params))
    jq = [p for p in jpipe.passes if p.name == "quantize"][0]
    tq = [p for p in tpipe.passes if p.name == "quantize"][0]
    assert tq.calib.num_batches == jq.calib.num_batches == 2
    for k, r in jq.calib.ranges.items():
        np.testing.assert_allclose(tq.calib.ranges[k], r, rtol=1e-5)
    assert _ops(tsym) == _ops(jsym)


# ---------------------------------------------------------------------------
# QuantizePass given one table

VARIANTS = {"default": {}, "skip-fc6": {"skip": ("fc6",)},
            "skip-fc1": {"skip": ("fc1",)},
            "keep-output": {"skip_output_layer": False},
            "per-tensor": {"per_channel": False}}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fuse", [False, True])
def test_quantize_pass_given_one_table_equals_reference(model, variant,
                                                        fuse):
    build, shapes, params = _model(model)
    table = _jax_table(build(mx.sym), params, _feeds(shapes["data"]))
    jpipe, tpipe = _pipelines(table, fuse=fuse, **VARIANTS[variant])
    jsym, jp = jpipe.run(build(mx.sym), dict(params))
    tsym, tp = tpipe.run(build(mt.sym), dict(params))
    assert _nodes(tsym) == _nodes(jsym)
    assert tpipe.fingerprint() == jpipe.fingerprint()
    assert tsym._graph_attrs["__passes__"] == tpipe.fingerprint()
    _assert_params_equal(jp, tp)
    jq = [p for p in jpipe.passes if p.name == "quantize"][0]
    tq = [p for p in tpipe.passes if p.name == "quantize"][0]
    assert tq.summary == jq.summary


def test_skip_and_output_layer_rules_on_vgg():
    build, shapes, params = _model("vgg")
    table = _jax_table(build(mx.sym), params, _feeds(shapes["data"]))
    counts = {}
    for variant in ("default", "skip-fc6", "keep-output"):
        _jp, tpipe = _pipelines(table, fuse=False, **VARIANTS[variant])
        tsym, tp = tpipe.run(build(mt.sym), dict(params))
        ops = _ops(tsym)
        counts[variant] = (ops.count("_quantized_Convolution"),
                           ops.count("_quantized_FullyConnected"),
                           ops.count("FullyConnected"))
        assert tp["conv1_1_weight"].dtype == np.int8
    assert counts == {"default": (4, 2, 1), "skip-fc6": (4, 1, 2),
                      "keep-output": (4, 3, 0)}


def test_fused_int8_graph_golden():
    """After fusion each int8 layer is one _fused_quantized_* node; an
    int8 layer feeding another int8 layer directly absorbs the next
    layer's quantize node as out_scale (int8 out); a pooling layer in
    between keeps the output float; dropout is gone before quantize."""
    build, shapes, params = _model("vgg")
    table, _item = _wired_table(build, shapes, params, U8)
    jpipe, tpipe = _pipelines(table, u8_wire=U8)
    tsym, _ = tpipe.run(build(mt.sym), dict(params))
    jsym, _ = jpipe.run(build(mx.sym), dict(params))
    assert _nodes(tsym) == _nodes(jsym)
    nodes = [n for n in json.loads(tsym.tojson())["nodes"]
             if n["op"] != "null"]
    assert [n["op"] for n in nodes] == [
        "Cast", "_fused_elemwise", "transpose", "_contrib_quantize",
        "_fused_quantized_Convolution", "_fused_quantized_Convolution",
        "Pooling", "_contrib_quantize", "_fused_quantized_Convolution",
        "_fused_quantized_Convolution", "Pooling", "Flatten",
        "_contrib_quantize", "_fused_quantized_FullyConnected",
        "_fused_quantized_FullyConnected", "FullyConnected",
        "SoftmaxOutput"]
    out_scaled = [n["name"] for n in nodes if "out_scale" in n["param"]]
    assert out_scaled == ["relu1_1_output_quantize",
                          "relu2_1_output_quantize",
                          "relu6_output_quantize"]
    assert all(n["param"]["act_type"] == "relu" for n in nodes
               if n["op"].startswith("_fused_quantized"))


def test_skip_fc6_puts_the_fc_kernel_int8_epilogue_on_the_graph():
    """skip=("fc6",): fc6 stays float, fused with relu6 and with the
    quantize node feeding fc7 into one _fused_FullyConnected with
    out_scale, whose forward is the fc kernel's int8 epilogue."""
    build, shapes, params = _model("vgg")
    table, _item = _wired_table(build, shapes, params, U8)
    jpipe, tpipe = _pipelines(table, u8_wire=U8, skip=("fc6",))
    tsym, tp = tpipe.run(build(mt.sym), dict(params))
    jsym, jp = jpipe.run(build(mx.sym), dict(params))
    assert _nodes(tsym) == _nodes(jsym)
    fc = [n for n in json.loads(tsym.tojson())["nodes"]
          if n["op"] == "_fused_FullyConnected"]
    assert len(fc) == 1 and fc[0]["param"]["act_type"] == "relu"
    assert float(fc[0]["param"]["out_scale"]) > 0
    assert tp["fc6_weight"].dtype == np.float32
    X = {"data": _feeds(_hwc((2,) + shapes["data"][1:]), 1, 9,
                        u8=True)[0]["data"]}
    jo, to = _run(mx, jsym, jp, X), _run(mt, tsym, tp, X)
    name = fc[0]["name"] + "_output"
    assert to[name].dtype == np.int8
    # fc6's float32 sums run in another order in the two libraries, so
    # a code may move by one at a rounding tie
    assert np.abs(to[name].astype(int) - jo[name].astype(int)).max() <= 1


@pytest.mark.parametrize("model", sorted(MODELS))
def test_int8_internals_equal_reference(model):
    """Every int8 activation, and every float output of a relu/identity
    int8 layer, equals the reference's bitwise; the float output layer
    and the softmax within rtol 1e-5."""
    build, shapes, params = _model(model)
    u8 = U8 if model == "vgg" else None
    table, item = _wired_table(build, shapes, params, u8)
    jpipe, tpipe = _pipelines(table, u8_wire=u8)
    jsym, jp = jpipe.run(build(mx.sym), dict(params))
    tsym, tp = tpipe.run(build(mt.sym), dict(params))
    X = _feeds((2,) + item[1:], 1, 11, u8=bool(u8))[0]
    jo, to = _run(mx, jsym, jp, X), _run(mt, tsym, tp, X)
    int8_outs = [k for k, v in jo.items() if v.dtype == np.int8
                 and not k.endswith("_weight")]
    assert len(int8_outs) >= 2
    nodes = {n["name"]: n for n in json.loads(tsym.tojson())["nodes"]}
    for k in jo:
        assert to[k].dtype == jo[k].dtype, k
        node = nodes.get(k.rsplit("_output", 1)[0])
        exact = node is None or node["op"] == "null" or (
            node["param"].get("act_type", "none") in EXACT_ACTS
            and node["op"] not in ("FullyConnected", "SoftmaxOutput"))
        if exact:
            assert np.array_equal(to[k], jo[k]), k
        else:
            np.testing.assert_allclose(to[k], jo[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_quantize_model_offline_api_equals_reference():
    build, shapes, params = _model("mlp")
    calib = np.random.RandomState(1).rand(32, 16).astype(np.float32)
    jsym, jarg, jaux, jpipe = mx.passes.quantize_model(
        build(mx.sym), params, {}, calib_data=calib,
        calib_shapes={"data": (8, 16)})
    jtable = [p for p in jpipe.passes if p.name == "quantize"][0].calib
    tsym, targ, taux, tpipe = mt.passes.quantize_model(
        build(mt.sym), params, {},
        calib=mt.passes.CalibrationTable.fromjson(jtable.tojson()),
        ctx=mt.cpu())
    assert _nodes(tsym) == _nodes(jsym) and not taux and not jaux
    assert targ["fc1_weight"].dtype == np.int8
    _assert_params_equal(jarg, targ)


def test_transform_params_requantizes_fresh_weights_as_reference():
    build, shapes, params = _model("vgg")
    table = _jax_table(build(mx.sym), params, _feeds(shapes["data"]))
    jpipe, tpipe = _pipelines(table)
    jpipe.run(build(mx.sym), dict(params))
    tpipe.run(build(mt.sym), dict(params))
    fresh = _params(build(mx.sym), shapes, seed=42)
    jf, tf = jpipe.transform_params(fresh), tpipe.transform_params(fresh)
    _assert_params_equal(jf, tf)
    assert tf["fc6_weight"].dtype == np.int8
    again = tpipe.transform_params(tf)            # already int8: unchanged
    _assert_params_equal(tf, again)


def test_serving_pipeline_factory_rules():
    assert mt.passes.default_quantize_ops(mt.cpu()) == ("FullyConnected",)
    assert mt.passes.default_quantize_ops(mt.gpu(0)) == BOTH
    assert mt.passes.default_fallback_dtype(mt.cpu()) is None
    assert mt.passes.default_fallback_dtype(mt.gpu(0)) == "float16"
    with pytest.raises(mt.MXNetError, match="needs calibration"):
        mt.passes.build_serving_pipeline(quantize="int8", ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="int8|float16|bfloat16"):
        mt.passes.build_serving_pipeline(quantize="int4", ctx=mt.cpu())
    assert mt.passes.build_serving_pipeline(
        embed_dedup=True, ctx=mt.cpu()).passes[-1].name == "sparse_embed"
    # float16 mode takes no calibration, and calib_data is not forwarded
    with_cd = mt.passes.build_serving_pipeline(
        quantize="float16", calib_data=np.zeros((8, 16), np.float32),
        calib_shapes={"data": (8, 16)}, ctx=mt.cpu())
    without = mt.passes.build_serving_pipeline(quantize="float16",
                                               ctx=mt.cpu())
    q = [p for p in with_cd.passes if p.name == "quantize"][0]
    assert q.calib_data is None
    assert with_cd.fingerprint() == without.fingerprint() == \
        mx.passes.build_serving_pipeline(quantize="float16").fingerprint()


def test_quantize_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_QUANTIZE_OPS", "Convolution")
    monkeypatch.setenv("MXNET_QUANTIZE_FALLBACK", "bfloat16")
    monkeypatch.setenv("MXNET_QUANTIZE_SKIP", "fc7")
    q = mt.passes.QuantizePass(ctx=mt.cpu())
    assert q.ops == ("Convolution",) and q.fallback_dtype == "bfloat16"
    assert q.skip == ("fc7",)
    assert q.config() == mx.passes.QuantizePass().config()


# ---------------------------------------------------------------------------
# the uint8 wire

def test_u8_wire_prologue_chain_fuses_and_stays_bitwise():
    net_j, net_t = _mlp(mx.sym), _mlp(mt.sym)
    params = _params(net_j, {"data": (4, 16)}, 5)
    u8 = {"mean": 128.0, "scale": 1 / 128.0, "hwc": False}
    outs = {}
    for fuse in (False, True):
        jsym, _ = mx.passes.build_serving_pipeline(
            u8_wire=u8, fuse=fuse).run(net_j, dict(params))
        tsym, _ = mt.passes.build_serving_pipeline(
            u8_wire=u8, fuse=fuse).run(net_t, dict(params))
        assert tsym.tojson() == jsym.tojson()
        assert ("_fused_elemwise" in _ops(tsym)) == fuse
        X = {"data": np.random.RandomState(5).randint(
            0, 256, (4, 16)).astype(np.uint8)}
        outs[fuse] = _run(mt, tsym, params, X, internals=False)
        np.testing.assert_allclose(
            outs[fuse]["softmax_output"],
            _run(mx, jsym, params, X, internals=False)["softmax_output"],
            rtol=RTOL, atol=ATOL)
    assert np.array_equal(outs[False]["softmax_output"],
                          outs[True]["softmax_output"])


def test_u8_wire_pass_retypes_data_and_publishes_the_override():
    pipe = mt.passes.build_serving_pipeline(u8_wire=U8, fuse=False)
    sym, _ = pipe.run(_narrow_vgg(mt.sym), {})
    assert pipe.type_overrides == {"data": "uint8"}
    data = [n for n in json.loads(sym.tojson())["nodes"]
            if n["name"] == "data"][0]
    assert data["attr"]["__dtype__"] == "uint8"
    assert _ops(sym)[:4] == ["Cast", "_minus_scalar", "_mul_scalar",
                             "transpose"]
    with pytest.raises(mt.passes.PassError, match="not an argument"):
        mt.passes.PassPipeline([mt.passes.U8WirePass(data_name="img")]).run(
            _narrow_vgg(mt.sym), {})


def _conv_fc_net(s, classes=4):
    net = s.Variable("data")
    net = s.Convolution(net, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name="c1")
    net = s.Activation(net, act_type="relu", name="r1")
    net = s.Flatten(net, name="flat")
    net = s.FullyConnected(net, num_hidden=classes, name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def test_u8_wire_serve_matches_host_normalize():
    net = _conv_fc_net(mt.sym)
    params = _params(_conv_fc_net(mx.sym), {"data": (1, 3, 8, 8)}, 0)
    f32 = mt.serve.ServeEngine(
        net, dict(params), {"data": (1, 3, 8, 8), "softmax_label": (1,)},
        batch_buckets=(1, 2), dev_type="cpu", deadline_ms=0)
    u8 = mt.serve.ServeEngine(
        net, dict(params), {"data": (1, 8, 8, 3), "softmax_label": (1,)},
        batch_buckets=(1, 2), dev_type="cpu", deadline_ms=0,
        u8_wire={"mean": 128.0, "scale": 1 / 128.0})
    try:
        assert u8._data_dtype == np.dtype(np.uint8)
        img = np.random.RandomState(0).randint(0, 256, (8, 8, 3)).astype(
            np.uint8)
        host = ((img.astype(np.float32) - 128.0) / 128.0).transpose(2, 0, 1)
        np.testing.assert_array_equal(f32.predict(host, timeout=60),
                                      u8.predict(img, timeout=60))
        assert u8._validate(img).dtype == np.uint8
    finally:
        f32.close()
        u8.close()


# ---------------------------------------------------------------------------
# ServeEngine with quantize=

def _vgg_checkpoint(tmp_path, seed=2):
    sym = _narrow_vgg(mx.sym)
    shapes = {"data": (1, 3, 16, 16), "softmax_label": (1,)}
    params = _params(sym, shapes, seed)
    prefix = str(tmp_path / "narrow_vgg")
    mx.model.save_checkpoint(prefix, 1, sym,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    return prefix, params


def _serve_all(engine, items, n_threads=4):
    answers = [None] * len(items)
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(items[i]))
                    for i in range(idx, len(items), n_threads)]
            for i, f in futs:
                answers[i] = f.result(timeout=60)
        except Exception as e:              # reported by the assert below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return answers


def _u8_items(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
            for _ in range(n)]


def _engines(prefix, quantize, **kw):
    shapes = {"data": (1, 16, 16, 3), "softmax_label": (1,)}
    common = dict(u8_wire=U8, deadline_ms=0, **kw)
    jax_eng = mx.serve.ServeEngine.from_checkpoint(
        prefix, 1, shapes, quantize=quantize[0], dev_type="cpu", **common)
    port_eng = mt.serve.ServeEngine.from_checkpoint(
        prefix, 1, shapes, quantize=quantize[1], dev_type="cpu", **common)
    return jax_eng, port_eng


def _table_for(prefix):
    """One calibration table for both engines, computed by the JAX
    package on the u8-wire graph over 16 wire-format items."""
    sym = mx.sym.load("%s-symbol.json" % prefix)
    params = {k[4:]: v for k, v in mx.nd.load(
        "%s-0001.params" % prefix).items()}
    wired, _ = mx.passes.build_serving_pipeline(
        u8_wire=U8, fuse=False).run(sym, params)
    items = np.stack(_u8_items(16, 3))
    return mx.passes.calibrate_arrays(
        wired, [{"data": items[:8]}, {"data": items[8:]}],
        arg_params=params, mode="percentile", percentile=99.99)


def _q(table, **kw):
    return ({"calib": table, "ops": BOTH, **kw},
            {"calib": mt.passes.CalibrationTable.fromjson(table.tojson()),
             "ops": BOTH, **kw})


@pytest.mark.parametrize("skip", [(), ("fc6",)])
def test_int8_serve_engine_equals_reference_given_one_table(tmp_path, skip):
    prefix, _params_ = _vgg_checkpoint(tmp_path)
    table = _table_for(prefix)
    jax_eng, port_eng = _engines(prefix, _q(table, skip=skip))
    try:
        assert port_eng._predictor.symbol.tojson() == \
            jax_eng._predictor.symbol.tojson()
        items = _u8_items(12, 4)
        ref = _serve_all(jax_eng, items)
        out = _serve_all(port_eng, items)
        report = port_eng.stats.report()
    finally:
        jax_eng.close()
        port_eng.close()
    assert report["completed"] == 12 and report["failed"] == 0
    for a, r in zip(out, ref):
        assert a.shape == (5,) and a.dtype == np.float32
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


def test_int8_serve_engine_self_calibrates_like_the_reference(tmp_path):
    """quantize="int8" with calib_data: each engine calibrates on its
    own forward at the largest bucket; the tables agree within rtol 1e-5
    and the served graphs are the same (on the CPU the default ops are
    FullyConnected only, in both packages)."""
    prefix, _params_ = _vgg_checkpoint(tmp_path)
    calib = np.stack(_u8_items(16, 3))
    jax_eng, port_eng = _engines(prefix, ("int8", "int8"),
                                 calib_data=calib, batch_buckets=(1, 8))
    try:
        jq = [p for p in jax_eng.pipeline.passes if p.name == "quantize"][0]
        tq = [p for p in port_eng.pipeline.passes
              if p.name == "quantize"][0]
        assert tq.ops == jq.ops == ("FullyConnected",)
        assert tq.calib.num_batches == 2
        for k, r in jq.calib.ranges.items():
            np.testing.assert_allclose(tq.calib.ranges[k], r, rtol=1e-5)
        assert _ops(port_eng._predictor.symbol) == \
            _ops(jax_eng._predictor.symbol)
        item = _u8_items(1, 5)[0]
        np.testing.assert_allclose(port_eng.predict(item, timeout=60),
                                   jax_eng.predict(item, timeout=60),
                                   rtol=1e-3, atol=1e-5)
    finally:
        jax_eng.close()
        port_eng.close()


def test_int8_serve_hot_reload_requantizes(tmp_path):
    prefix, params = _vgg_checkpoint(tmp_path)
    table = _table_for(prefix)
    jax_eng, port_eng = _engines(prefix, _q(table))
    try:
        fresh = _params(_narrow_vgg(mx.sym), {"data": (1, 3, 16, 16)}, 42)
        assert jax_eng.reload(dict(fresh)) == port_eng.reload(
            {"arg:" + k: v for k, v in fresh.items()}) == 1
        w = port_eng._predictor._arg_params["conv1_1_weight"]
        assert w.asnumpy().dtype == np.int8
        jw = jax_eng._predictor._arg_params["conv1_1_weight"]
        assert np.array_equal(w.asnumpy(), np.asarray(jw.asnumpy()))
        for item in _u8_items(3, 6):
            np.testing.assert_allclose(port_eng.predict(item, timeout=60),
                                       jax_eng.predict(item, timeout=60),
                                       rtol=RTOL, atol=ATOL)
        assert port_eng.stats.report()["reloads"] == 1
    finally:
        jax_eng.close()
        port_eng.close()


# ---------------------------------------------------------------------------
# float16 and bfloat16 modes

@pytest.mark.parametrize("model", sorted(MODELS))
def test_float16_mode_params_bitwise_outputs_close(model):
    build, shapes, params = _model(model)
    jpipe = mx.passes.build_serving_pipeline(quantize="float16")
    tpipe = mt.passes.build_serving_pipeline(quantize="float16",
                                             ctx=mt.cpu())
    jsym, jp = jpipe.run(build(mx.sym), dict(params))
    tsym, tp = tpipe.run(build(mt.sym), dict(params))
    assert tsym.tojson() == jsym.tojson()
    _assert_params_equal(jp, tp)
    hidden = [k for k in tp if k.startswith(("fc1", "fc6", "conv"))]
    assert hidden and all(tp[k].dtype == np.float16 for k in hidden)
    assert _ops(tsym).count("Cast") >= 4
    X = _feeds((4,) + shapes["data"][1:], 1, 8)[0]
    got = _run(mt, tsym, tp, X, internals=False)["softmax_output"]
    want = _run(mx, jsym, jp, X, internals=False)["softmax_output"]
    f32 = _run(mt, build(mt.sym), params, X, internals=False)[
        "softmax_output"]
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(got, f32, rtol=1e-2, atol=1e-3)


def test_bfloat16_mode_params_bitwise():
    build, shapes, params = _model("mlp")
    jsym, jp = mx.passes.build_serving_pipeline(
        quantize="bfloat16").run(build(mx.sym), dict(params))
    tsym, tp = mt.passes.build_serving_pipeline(
        quantize="bfloat16", ctx=mt.cpu()).run(build(mt.sym), dict(params))
    assert tsym.tojson() == jsym.tojson()
    for k in ("fc1_weight", "fc2_bias"):
        got = tp[k]._get()
        assert got.dtype == torch.bfloat16
        want = np.asarray(jp[k]).astype(ml_dtypes.bfloat16)
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))


def test_float16_serve_engine_close_to_reference(tmp_path):
    prefix, _params_ = _vgg_checkpoint(tmp_path)
    jax_eng, port_eng = _engines(prefix, ("float16", "float16"),
                                 batch_buckets=(1, 2))
    try:
        assert port_eng._predictor.symbol.tojson() == \
            jax_eng._predictor.symbol.tojson()
        for item in _u8_items(4, 7):
            got = port_eng.predict(item, timeout=60)
            assert np.all(np.isfinite(got))
            np.testing.assert_allclose(got, jax_eng.predict(item, timeout=60),
                                       rtol=1e-2, atol=1e-3)
    finally:
        jax_eng.close()
        port_eng.close()


# ---------------------------------------------------------------------------
# the rest of ServeEngine's and Predictor's surface

def _mlp_engine(**kw):
    sym = mt.models.get_mlp()
    shapes = {"data": (1, 784), "softmax_label": (1,)}
    params = _params(mx.models.get_mlp(), shapes, 4)
    eng = mt.serve.ServeEngine(sym, params, shapes, dev_type="cpu",
                               deadline_ms=0, **kw)
    return eng, sym, shapes, params


def test_submit_many_and_predict_agree_with_a_predictor():
    eng, sym, shapes, params = _mlp_engine(fuse=True)
    try:
        xs = np.random.RandomState(6).uniform(0, 1, (5, 784)).astype(
            np.float32)
        many = [f.result(timeout=30) for f in eng.submit_many(xs)]
        pred = mt.Predictor(sym.tojson(), params,
                            {"data": (5, 784), "softmax_label": (5,)},
                            dev_type="cpu")
        want = pred.predict(xs)
        for i, x in enumerate(xs):
            np.testing.assert_allclose(many[i], want[i], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(eng.predict(x, timeout=30), want[i],
                                       rtol=RTOL, atol=ATOL)
        assert eng.outstanding() == 0 and eng.pending_requests() == 0
    finally:
        eng.close()


def test_pause_holds_batches_and_counts_pending():
    eng, _sym, _shapes, _params_ = _mlp_engine(batch_buckets=(1, 2))
    x = np.zeros(784, np.float32)
    try:
        eng.predict(x, timeout=30)
        with eng.pause():
            futs = eng.submit_many([x] * 5)
            with eng.pause():                 # nests on one thread
                assert eng.reload({}) == 1    # reload works inside
            deadline = 50
            while eng.pending_requests() + 2 > 5 and deadline:
                threading.Event().wait(0.01)  # the dispatcher takes a batch
                deadline -= 1
            assert eng.outstanding() == 5
            assert not any(f.done() for f in futs)
            with pytest.raises(mt.serve.ServeError, match="inside pause"):
                eng.close()
        for f in futs:
            f.result(timeout=30)
        assert eng.outstanding() == 0 and eng.pending_requests() == 0
    finally:
        eng.close()


def test_device_bytes_counts_each_buffer_once():
    eng, sym, shapes, params = _mlp_engine(batch_buckets=(1, 2, 4))
    try:
        param_bytes = sum(v.nbytes for v in params.values())
        # inputs per bucket b: data (b, 784) and label (b,), float32
        inputs = sum(4 * b * 785 for b in (1, 2, 4))
        assert eng.device_bytes() == param_bytes + inputs
    finally:
        eng.close()
    q, _sym, _shapes, params = _mlp_engine(
        batch_buckets=(1,), quantize="int8",
        calib_data=np.random.RandomState(0).uniform(
            0, 1, (4, 784)).astype(np.float32))
    try:
        assert q.device_bytes() < param_bytes      # int8 hidden weights
    finally:
        q.close()


def test_reload_from_checkpoint_swaps_weights(tmp_path):
    sym = mx.models.get_mlp()
    shapes = {"data": (1, 784), "softmax_label": (1,)}
    prefix = str(tmp_path / "mlp")
    for epoch, seed in ((1, 4), (2, 5)):
        mx.model.save_checkpoint(
            prefix, epoch, sym, {k: mx.nd.array(v) for k, v in
                                 _params(sym, shapes, seed).items()}, {})
    x = np.random.RandomState(6).uniform(0, 1, 784).astype(np.float32)
    eng = mt.serve.ServeEngine.from_checkpoint(prefix, 1, shapes,
                                               dev_type="cpu", deadline_ms=0)
    try:
        before = eng.predict(x, timeout=30)
        assert eng.reload_from_checkpoint(prefix, 2) == 1
        after = eng.predict(x, timeout=30)
        want = mt.create_predictor(prefix, 2, {"data": (1, 784),
                                               "softmax_label": (1,)},
                                   dev_type="cpu").predict(x[None])[0]
        np.testing.assert_allclose(after, want, rtol=RTOL, atol=ATOL)
        assert not np.allclose(before, after)
    finally:
        eng.close()


def test_predictor_output_shape_and_precompile():
    sym = mt.models.get_mlp()
    shapes = {"data": (2, 784), "softmax_label": (2,)}
    params = _params(mx.models.get_mlp(), shapes, 4)
    pred = mt.Predictor(sym.tojson(), params, shapes, dev_type="cpu")
    jpred = mx.predictor.Predictor(
        sym.tojson(), {k: mx.nd.array(v) for k, v in params.items()}, shapes)
    assert pred.get_output_shape(0) == jpred.get_output_shape(0) == (2, 10)
    sets = [{"data": (b, 784), "softmax_label": (b,)} for b in (1, 3)]
    assert pred.precompile(sets) == 2
    assert len(pred._exec_cache) == 3
    pred.reshape(sets[1])
    assert pred.get_output_shape(0) == (3, 10)
    pred.forward()
    assert pred.get_output_shape(0) == (3, 10)
