"""The tensor, output and loss ops the port registers for sequence-model
training, against the JAX package's, through Executor on the CPU.

Each case builds a one-op graph in both packages, compares
``infer_shape``, feeds the same seeded numpy inputs, runs
``forward(is_train=True)`` and ``backward`` (a seeded head gradient per
output, none for the loss layers, whose backward ignores it) and
compares every output and every argument's gradient.  Tolerance: rtol
1e-5, atol 1e-6 on O(1) values (float32 sums run in other orders in XLA
and in PyTorch's CPU kernels).  Then the reference's gradient semantics
where PyTorch's differ (``abs`` at 0, ties of maximum/minimum and of the
reductions), Embedding's out-of-range ids, ``Reshape``'s codes,
``BlockGrad``, several outputs with ``infer_shape_partial``, and the
samplers by their statistics (their draws are the port's own).
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _pos(rng, shape):
    return _u(rng, shape, 0.2, 2.0)


def _ints(rng, shape, k):
    return rng.randint(0, k, shape).astype(np.float32)


def _with_zeros(rng, shape):
    x = _u(rng, shape)
    x.flat[::3] = 0.0
    return x


def _levels(rng, shape):
    """Values on a few levels: ties everywhere."""
    return rng.randint(-2, 3, shape).astype(np.float32)


def _halves(rng, shape):
    """Values at and between halves, for round/floor/ceil."""
    return (rng.randint(-8, 9, shape) / 2.0 + rng.choice(
        [0.0, 0.25], shape)).astype(np.float32)


def _build(op, values, params):
    def build(s):
        ins = {n: s.Variable(n) for n in values}
        return getattr(s, op)(name="op", **ins, **params)
    return build


def _run(pkg, build, values, head):
    sym = build(pkg.sym)
    shapes = {n: v.shape for n, v in values.items()}
    exe = sym.simple_bind(pkg.cpu(), grad_req="write", **shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward(head)
    return (sym.infer_shape(**shapes), outs,
            {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None})


UNARY = ["abs", "ceil", "cos", "exp", "floor", "log", "round", "rsqrt",
         "sign", "sin", "sqrt", "square"]
UNARY_INPUT = {"abs": _with_zeros, "sign": _with_zeros, "log": _pos,
               "sqrt": _pos, "rsqrt": _pos, "round": _halves,
               "floor": _halves, "ceil": _halves}
SCALARS = [("_plus_scalar", 0.3, _u), ("_minus_scalar", 0.3, _u),
           ("_rminus_scalar", 0.3, _u), ("_mul_scalar", -1.7, _u),
           ("_div_scalar", 0.3, _u), ("_rdiv_scalar", 1.5, _pos),
           ("_power_scalar", 2.0, _u), ("_power_scalar", 0.7, _pos),
           ("_rpower_scalar", 2.0, _u), ("_maximum_scalar", 1.0, _levels),
           ("_minimum_scalar", 0.0, _levels)]


def _binary(rng, shape, pos=False, ties=False):
    f = _pos if pos else (_levels if ties else _u)
    return {"lhs": f(rng, shape), "rhs": f(rng, shape)}


# (id, op, params, inputs (rng -> {arg name: array}))
CASES = (
    [("binary" + n, n, {}, lambda r, n=n: _binary(
        r, (3, 4), pos=n == "_power", ties=n in ("_maximum", "_minimum")))
     for n in ("_plus", "_minus", "_mul", "_div", "_power", "_maximum",
               "_minimum")]
    + [("%s-%g" % (n, s), n, {"scalar": s}, lambda r, f=f: {
        "data": f(r, (3, 5))}) for n, s, f in SCALARS]
    + [(pre + n, pre + n, {}, lambda r, n=n: {"data": UNARY_INPUT.get(
        n, _u)(r, (4, 5))}) for n in UNARY for pre in ("", "_")]
    + [(n, n, {}, lambda r, n=n: {
        "lhs": (_pos if n == "broadcast_power" else _u)(r, (2, 1, 3)),
        "rhs": (_pos if n == "broadcast_power" else _u)(r, (1, 4, 3))})
       for n in ("broadcast_plus", "broadcast_minus", "broadcast_mul",
                 "broadcast_div", "broadcast_power")]
    + [("broadcast_axis", "broadcast_axis", {"axis": (1,), "size": (4,)},
        lambda r: {"data": _u(r, (2, 1, 3))}),
       ("broadcast_axis-2", "broadcast_axis", {"axis": (0, 2),
                                               "size": (3, 2)},
        lambda r: {"data": _u(r, (1, 4, 1))}),
       ("broadcast_to", "broadcast_to", {"shape": (0, 4, 3)},
        lambda r: {"data": _u(r, (2, 1, 3))})]
    + [(n, n, {}, lambda r: {"data": _u(r, (3, 4))})
       for n in ("sum", "max", "min", "norm")]
    + [("max-ties", "max", {}, lambda r: {"data": _levels(r, (3, 4))}),
       ("min-ties", "min", {}, lambda r: {"data": _levels(r, (3, 4))}),
       ("sum_axis", "sum_axis", {"axis": (1,)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("sum_axis-keep", "sum_axis", {"axis": (0, 2), "keepdims": True},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("max_axis-ties", "max_axis", {"axis": (1,)},
        lambda r: {"data": _levels(r, (2, 5, 3))}),
       ("min_axis-keep", "min_axis", {"axis": (2,), "keepdims": True},
        lambda r: {"data": _levels(r, (2, 3, 4))}),
       ("argmax_channel", "argmax_channel", {},
        lambda r: {"data": _u(r, (4, 6))}),
       ("dot-2x2", "dot", {}, lambda r: {"lhs": _u(r, (3, 4)),
                                         "rhs": _u(r, (4, 5))}),
       ("dot-1x1", "dot", {}, lambda r: {"lhs": _u(r, (4,)),
                                         "rhs": _u(r, (4,))}),
       ("dot-2x1", "dot", {}, lambda r: {"lhs": _u(r, (3, 4)),
                                         "rhs": _u(r, (4,))}),
       ("batch_dot", "batch_dot", {}, lambda r: {"lhs": _u(r, (2, 3, 4)),
                                                 "rhs": _u(r, (2, 4, 5))}),
       ("transpose", "transpose", {}, lambda r: {"data": _u(r, (2, 3, 4))}),
       ("transpose-axes", "transpose", {"axes": (1, 0, 2)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("expand_dims", "expand_dims", {"axis": 1},
        lambda r: {"data": _u(r, (2, 3))}),
       ("slice_axis", "slice_axis", {"axis": 1, "begin": 1, "end": 3},
        lambda r: {"data": _u(r, (2, 5, 3))}),
       ("slice_axis-neg", "slice_axis", {"axis": 2, "begin": -3, "end": -1},
        lambda r: {"data": _u(r, (2, 3, 5))}),
       ("slice_axis-to-end", "slice_axis", {"axis": 0, "begin": 1},
        lambda r: {"data": _u(r, (4, 3))}),
       ("flip", "flip", {"axis": 1}, lambda r: {"data": _u(r, (2, 4, 3))}),
       ("crop", "crop", {"begin": (0, 1), "end": (2, 4)},
        lambda r: {"data": _u(r, (3, 5))}),
       ("softmax_cross_entropy", "softmax_cross_entropy", {},
        lambda r: {"lhs": _u(r, (4, 6), -2, 2), "rhs": _ints(r, (4,), 6)}),
       ("smooth_l1", "smooth_l1", {}, lambda r: {"data": _u(r, (4, 5), -3,
                                                            3)}),
       ("smooth_l1-sigma2", "smooth_l1", {"sigma": 2.0},
        lambda r: {"data": _u(r, (4, 5))}),
       ("reshape-0-1", "Reshape", {"shape": (0, -1)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("reshape-flat", "Reshape", {"target_shape": (0,), "shape": (-1,)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("reshape-target", "Reshape", {"target_shape": (6, 4)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("reshape-keep-highest", "Reshape", {"target_shape": (5, -1),
                                            "keep_highest": True},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("reshape-0-mid", "Reshape", {"shape": (-1, 0, 2)},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("slicechannel", "SliceChannel", {"num_outputs": 3},
        lambda r: {"data": _u(r, (2, 6, 3))}),
       ("slicechannel-squeeze", "SliceChannel",
        {"num_outputs": 4, "axis": 1, "squeeze_axis": True},
        lambda r: {"data": _u(r, (3, 4, 5))}),
       ("slicechannel-axis0", "SliceChannel", {"num_outputs": 2, "axis": 0},
        lambda r: {"data": _u(r, (4, 3))}),
       ("swapaxis", "SwapAxis", {"dim1": 0, "dim2": 2},
        lambda r: {"data": _u(r, (2, 3, 4))}),
       ("blockgrad", "BlockGrad", {}, lambda r: {"data": _u(r, (3, 4))}),
       ("embedding", "Embedding", {"input_dim": 7, "output_dim": 5},
        lambda r: {"data": _ints(r, (3, 4), 7), "weight": _u(r, (7, 5))}),
       ("embedding-out-of-range", "Embedding",
        {"input_dim": 5, "output_dim": 3},
        lambda r: {"data": np.array([[-1, 5, 2.7, -5], [-6, 4, 0, 1.2]],
                                    np.float32),
                   "weight": _u(r, (5, 3))}),
       ("crop-hw", "Crop", {"h_w": (3, 2), "offset": (1, 2)},
        lambda r: {"data": _u(r, (2, 3, 5, 6))}),
       ("crop-center", "Crop", {"h_w": (3, 4), "center_crop": True},
        lambda r: {"data": _u(r, (2, 3, 6, 7))}),
       ("crop-like", "Crop", {"num_args": 2, "offset": (2, 1)},
        lambda r: {"arg0": _u(r, (2, 3, 6, 6)), "arg1": _u(r, (2, 1, 3, 4))}),
       ("crossdevicecopy", "_CrossDeviceCopy", {},
        lambda r: {"data": _u(r, (3, 4))}),
       ("softmaxactivation", "SoftmaxActivation", {},
        lambda r: {"data": _u(r, (3, 2, 4), -2, 2)}),
       ("softmaxactivation-channel", "SoftmaxActivation",
        {"mode": "channel"}, lambda r: {"data": _u(r, (2, 4, 3), -2, 2)})]
)

# the output and loss layers: no head gradient (their backward ignores it)
LOSS_CASES = [
    ("softmax-batch", "Softmax", {"normalization": "batch", "grad_scale": 2.0},
     lambda r: {"data": _u(r, (5, 6)), "label": _ints(r, (5,), 6)}),
    ("linear", "LinearRegressionOutput", {},
     lambda r: {"data": _u(r, (4, 3)), "label": _u(r, (4, 3))}),
    ("linear-scale-col", "LinearRegressionOutput", {"grad_scale": 3.0},
     lambda r: {"data": _u(r, (5, 1)), "label": _u(r, (5,))}),
    ("logistic", "LogisticRegressionOutput", {"grad_scale": 0.5},
     lambda r: {"data": _u(r, (4, 3), -3, 3), "label": _ints(r, (4, 3), 2)}),
    ("logistic-4d", "LogisticRegressionOutput", {},
     lambda r: {"data": _u(r, (2, 3, 2, 2), -3, 3),
                "label": _ints(r, (2, 3, 2, 2), 2)}),
    ("mae", "MAERegressionOutput", {"grad_scale": 2.0},
     lambda r: {"data": _u(r, (4, 3)), "label": _u(r, (4, 3))}),
    ("makeloss", "MakeLoss", {}, lambda r: {"data": _u(r, (4, 3))}),
    ("makeloss-batch", "MakeLoss", {"normalization": "batch",
                                    "grad_scale": 3.0},
     lambda r: {"data": _u(r, (4, 3))}),
    ("makeloss-valid", "MakeLoss", {"normalization": "valid",
                                    "valid_thresh": 0.25, "grad_scale": 2.0},
     lambda r: {"data": _u(r, (4, 3))}),
    ("svm-l2", "SVMOutput", {"margin": 0.5,
                             "regularization_coefficient": 0.7},
     lambda r: {"data": _u(r, (5, 4)), "label": _ints(r, (5,), 4)}),
    ("svm-l1", "SVMOutput", {"use_linear": True},
     lambda r: {"data": _u(r, (5, 4)), "label": _ints(r, (5,), 4)}),
]


def _check(cid, op, params, inputs, loss):
    rng = np.random.RandomState(zlib.crc32(cid.encode()))
    values = inputs(rng)
    build = _build(op, values, params)
    head = None
    if not loss:
        out_shapes = build(jmx.sym).infer_shape(
            **{n: v.shape for n, v in values.items()})[1]
        head = [_u(rng, s) for s in out_shapes]
    want_shapes, want, want_g = _run(jmx, build, values, head)
    got_shapes, got, got_g = _run(tmx, build, values, head)
    assert [list(map(tuple, s)) for s in got_shapes] == \
        [list(map(tuple, s)) for s in want_shapes]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert sorted(got_g) == sorted(want_g) == sorted(values)
    for n in values:
        np.testing.assert_allclose(got_g[n], want_g[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax_with_gradient(case):
    _check(*case, loss=False)


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_layer_injects_the_reference_gradient(case):
    _check(*case, loss=True)


def test_every_tensor_op_of_the_reference_is_registered():
    """Every op of ``mxnet_tpu/ops/tensor.py`` (``_sparse_embedding``
    included), the output and loss layers, and RNN."""
    def module_of(op):
        fn = getattr(op, "_fn", None)
        return (fn if fn is not None else type(op)).__module__
    names = {n for n, op in jmx.ops.registry._OP_REGISTRY.items()
             if module_of(op) == "mxnet_tpu.ops.tensor"}
    assert len(names) == 79 and "_sparse_embedding" in names
    names |= {"SoftmaxActivation", "Softmax", "LinearRegressionOutput",
              "LogisticRegressionOutput", "MAERegressionOutput", "MakeLoss",
              "SVMOutput", "RNN"}
    assert sorted(names - set(tmx.ops.list_ops())) == []


def test_abs_gradient_at_zero_is_the_references():
    x = np.array([0.0, -0.0, 1.5, -2.0], np.float32)
    build = _build("abs", {"data": x}, {})
    head = [np.ones(4, np.float32)]
    want = _run(jmx, build, {"data": x}, head)[2]["data"]
    got = _run(tmx, build, {"data": x}, head)[2]["data"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1.0, 1.0, 1.0, -1.0])


@pytest.mark.parametrize("op", ["_maximum", "_minimum"])
def test_binary_ties_split_the_gradient(op):
    v = {"lhs": np.array([1.0, 2.0, 3.0], np.float32),
         "rhs": np.array([1.0, 1.0, 3.0], np.float32)}
    head = [np.ones(3, np.float32)]
    got = _run(tmx, _build(op, v, {}), v, head)[2]
    want = _run(jmx, _build(op, v, {}), v, head)[2]
    for n in v:
        np.testing.assert_array_equal(got[n], want[n])
    assert got["lhs"][0] == got["rhs"][0] == 0.5


def test_embedding_out_of_range_rows():
    """-1 wraps to the last row, input_dim reads NaN, 2.7 reads row 2; a
    dropped id's gradient goes nowhere, a wrapped id's to its row."""
    w = np.arange(15, dtype=np.float32).reshape(5, 3)
    ids = np.array([[-1, 5, 2.7]], np.float32)
    v = {"data": ids, "weight": w}
    build = _build("Embedding", v, {"input_dim": 5, "output_dim": 3})
    head = [np.ones((1, 3, 3), np.float32)]
    _, outs, grads = _run(tmx, build, v, head)
    np.testing.assert_array_equal(outs[0][0, 0], w[4])
    assert np.isnan(outs[0][0, 1]).all()
    np.testing.assert_array_equal(outs[0][0, 2], w[2])
    np.testing.assert_array_equal(grads["weight"].sum(axis=1),
                                  [0, 0, 3, 0, 3])
    np.testing.assert_array_equal(grads["data"], 0.0)


def test_blockgrad_stops_the_gradient_in_a_graph():
    v = {"x": np.array([1.0, 2.0], np.float32),
         "y": np.array([3.0, 4.0], np.float32)}

    def build(s):
        x, y = s.Variable("x"), s.Variable("y")
        return s.BlockGrad(x) * y + x * 0.5

    head = [np.ones(2, np.float32)]
    want = _run(jmx, build, v, head)[2]
    got = _run(tmx, build, v, head)[2]
    for n in v:
        np.testing.assert_array_equal(got[n], want[n])
    np.testing.assert_array_equal(got["x"], [0.5, 0.5])
    np.testing.assert_array_equal(got["y"], v["x"])


def test_several_outputs_index_and_infer_shape_partial():
    """SliceChannel's heads by position and by name, and
    infer_shape_partial with an unknown input, as in the reference."""
    outs = []
    for pkg in (jmx, tmx):
        s = pkg.sym
        parts = s.SliceChannel(s.Variable("data"), num_outputs=3, axis=1,
                               squeeze_axis=True, name="sl")
        assert len(parts) == 3
        picked = parts[1] + parts["sl_output2"]
        grouped = s.Group([picked, s.FullyConnected(
            s.Variable("other"), num_hidden=4, name="fc")])
        partial = grouped.infer_shape_partial(data=(2, 3, 5))
        full = grouped.infer_shape(data=(2, 3, 5))
        outs.append((parts.list_outputs(), [p.name for p in parts],
                     [list(x) for x in partial], full))
    assert outs[0] == outs[1]
    assert outs[1][3] == (None, None, None)
    assert outs[1][2][1] == [(2, 5), None]


def test_symbol_json_with_arithmetic_crosses():
    for src, dst in ((jmx, tmx), (tmx, jmx)):
        x, y = src.sym.Variable("x"), src.sym.Variable("y")
        z = (2.0 - x * y + 3) / y - (-x) ** 2 + 1.5 / x
        z = src.sym.SliceChannel(z, num_outputs=2)[1]
        back = dst.sym.load_json(z.tojson())
        assert back.tojson() == z.tojson()
        assert back.list_outputs() == z.list_outputs()


@pytest.mark.parametrize("op,params,mean,std", [
    ("_sample_uniform", {"low": -1.0, "high": 3.0}, 1.0, 4 / np.sqrt(12)),
    ("_sample_normal", {"loc": 2.0, "scale": 0.5}, 2.0, 0.5)])
def test_samplers_by_their_statistics(op, params, mean, std):
    """Drawn from the port's generator (its numbers, not the reference's);
    shape from infer_shape; mean and spread within 5 sigma of the law."""
    tmx.random.seed(7)
    n = 20000
    sym = getattr(tmx.sym, op)(shape=(n,), name="s", **params)
    assert sym.list_arguments() == []
    assert sym.infer_shape()[1] == [(n,)]
    exe = sym.simple_bind(tmx.cpu())
    a = exe.forward()[0].asnumpy()
    b = exe.forward()[0].asnumpy()
    assert a.shape == (n,) and not np.array_equal(a, b)
    assert abs(a.mean() - mean) < 5 * std / np.sqrt(n)
    assert abs(a.std() - std) < 0.05 * std
    if op == "_sample_uniform":
        assert a.min() >= -1.0 and a.max() < 3.0
    jsym = getattr(jmx.sym, op)(shape=(n,), name="s", **params)
    assert jsym.infer_shape()[1] == sym.infer_shape()[1]
    assert jsym.tojson() == sym.tojson()
    with tmx.cpu():
        nd = getattr(tmx.nd, op)(shape=(4, 5), **params)
    assert nd.shape == (4, 5) and nd.context == tmx.cpu()
