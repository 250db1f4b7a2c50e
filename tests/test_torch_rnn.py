"""The ``RNN`` op, the scan-form LSTM, and Symbol and NDArray arithmetic
with the ``mx.nd`` functions, in the port against the JAX package on
the CPU.

``RNN`` runs in its 4 modes, 2 layers, with and without
``state_outputs``, through Executor in both packages from the same
seeded weights: outputs and every gradient within rtol 1e-5, atol 1e-6
(float32 recurrences of 4 steps, sums in other orders).  The scan form
against the unrolled form from one checkpoint uses the reference's own
tolerances (``tests/test_rnn_op.py``: relative difference 1e-4 on the
output, 1e-3 on gradients).  NDArray arithmetic and the ``mx.nd``
functions are elementwise or short sums: rtol 1e-6.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
MODES = ["rnn_relu", "rnn_tanh", "gru", "lstm"]


def _reldiff(a, b):
    diff = np.sum(np.abs(a - b))
    return 0.0 if diff == 0 else diff / (np.sum(np.abs(a)) + 1e-12)


def _rnn_values(sym, data_shape, seed):
    rng = np.random.RandomState(seed)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=data_shape)
    values = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        scale = 0.5 if n in ("data",) or "state" in n else 0.4
        values[n] = rng.uniform(-scale, scale, s).astype(np.float32)
    heads = [rng.uniform(-1, 1, s).astype(np.float32) for s in out_shapes]
    return values, heads


def _run(pkg, sym, values, heads):
    exe = sym.simple_bind(pkg.cpu(), grad_req="write",
                          **{n: v.shape for n, v in values.items()})
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward(heads)
    return outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()}


@pytest.mark.parametrize("state_outputs", [False, True],
                         ids=["output", "state-outputs"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, state_outputs):
    results = []
    for pkg in (jmx, tmx):
        sym = pkg.sym.RNN(pkg.sym.Variable("data"), state_size=5,
                          num_layers=2, mode=mode,
                          state_outputs=state_outputs, name="r")
        values, heads = _rnn_values(sym, (4, 3, 6),
                                    zlib.crc32(mode.encode()))
        results.append((sym.list_outputs(), sym.infer_shape(data=(4, 3, 6)),
                        _run(pkg, sym, values, heads)))
    (want_names, want_shapes, (want, want_g)), \
        (got_names, got_shapes, (got, got_g)) = results
    assert got_names == want_names
    assert got_shapes == want_shapes
    assert len(got) == (3 if state_outputs and mode == "lstm" else
                        2 if state_outputs else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert sorted(got_g) == sorted(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n], want_g[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    if state_outputs:
        # the last layer's final h is the output's last step
        np.testing.assert_allclose(got[1][-1], got[0][-1], atol=1e-7)


def test_rnn_dropout_without_a_generator_raises():
    op = tmx.ops.get_op("RNN")
    p = op.parse_params({"state_size": 3, "num_layers": 2, "mode": "lstm",
                         "p": 0.5})
    ins = [torch.zeros(2, 1, 4)] + [torch.zeros(s) for s in (
        (12, 4), (12,), (12, 3), (12,), (12, 3), (12,), (12, 3), (12,))] \
        + [torch.zeros(2, 1, 3), torch.zeros(2, 1, 3)]
    with pytest.raises(ValueError, match="requires an rng"):
        op.forward(p, ins, [], tmx.ops.OpContext(is_train=True))
    out = op.forward(p, ins, [], tmx.ops.OpContext(is_train=False))
    assert out[0].shape == (2, 1, 3)


def test_rnn_dropout_draws_from_the_generator():
    """With a generator the inter-layer mask is drawn (kept units scaled
    by 1 / (1 - p)); the same seed gives the same mask."""
    sym = tmx.sym.RNN(tmx.sym.Variable("data"), state_size=4, num_layers=2,
                      mode="rnn_tanh", p=0.5, name="r")
    values, heads = _rnn_values(sym, (3, 2, 5), 1)
    runs = []
    for seed in (3, 3, 4):
        tmx.random.seed(seed)
        runs.append(_run(tmx, sym, values, heads)[0][0])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    exe = sym.simple_bind(tmx.cpu(), grad_req="null",
                          **{n: v.shape for n, v in values.items()})
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    a = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(exe.forward(is_train=False)[0].asnumpy(),
                                  a)


@pytest.mark.parametrize("layers", [1, 2])
def test_scan_lstm_matches_unrolled_from_one_checkpoint(layers):
    """lstm_unroll and lstm_unroll_scan share their argument names and
    gate layout: the same parameters give the same outputs and gradients,
    in the port and in the JAX package."""
    T, B, V, H, E = 4, 3, 11, 6, 5
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    for i in range(layers):
        shapes["l%d_init_c" % i] = (B, H)
        shapes["l%d_init_h" % i] = (B, H)
    rng = np.random.RandomState(42)
    vals = {"data": rng.randint(0, V, (B, T)).astype(np.float32),
            "softmax_label": rng.randint(0, V, (B, T)).astype(np.float32)}
    for n in shapes:
        vals.setdefault(n, np.zeros(shapes[n], np.float32))
    results = {}
    for pkg, models in ((jmx, jmodels), (tmx, tmx.models)):
        for form in ("lstm_unroll", "lstm_unroll_scan"):
            net = getattr(models, form)(layers, T, V, H, E, V)
            arg_shapes, _, _ = net.infer_shape(**shapes)
            prng = np.random.RandomState(7)
            values = dict(vals)
            for n, s in sorted(zip(net.list_arguments(), arg_shapes)):
                if n not in values:
                    values[n] = prng.uniform(-0.2, 0.2, s).astype(np.float32)
            outs, grads = _run(pkg, net, values, None)
            results[(pkg is tmx, form)] = (outs[0], {
                n: g for n, g in grads.items() if n not in shapes})
    for port in (False, True):
        (oa, ga), (ob, gb) = (results[(port, "lstm_unroll")],
                              results[(port, "lstm_unroll_scan")])
        assert _reldiff(oa, ob) < 1e-4
        for k in ga:
            assert _reldiff(ga[k], gb[k]) < 1e-3, k
    for form in ("lstm_unroll", "lstm_unroll_scan"):
        (oj, gj), (op, gp) = results[(False, form)], results[(True, form)]
        np.testing.assert_allclose(op, oj, rtol=RTOL, atol=ATOL)
        for k in gj:
            np.testing.assert_allclose(gp[k], gj[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# -- Symbol arithmetic ------------------------------------------------------

SYMBOL_EXPRS = [
    ("add", lambda x, y: x + y), ("radd", lambda x, y: 2 + x),
    ("sub", lambda x, y: x - y), ("sub-scalar", lambda x, y: x - 0.3),
    ("rsub", lambda x, y: 0.3 - x), ("mul", lambda x, y: x * y),
    ("rmul", lambda x, y: 1.5 * y), ("mul-np", lambda x, y: y * np.float32(
        1.5)), ("div", lambda x, y: x / y),
    ("div-scalar", lambda x, y: x / 3), ("rdiv", lambda x, y: 1.5 / y),
    ("pow", lambda x, y: y ** x), ("pow-scalar", lambda x, y: x ** 2),
    ("neg", lambda x, y: -x),
    ("chain", lambda x, y: (x * y + 1) / (y * y) - x ** 3),
]


@pytest.mark.parametrize("case", SYMBOL_EXPRS,
                         ids=[c[0] for c in SYMBOL_EXPRS])
def test_symbol_arithmetic_matches_jax(case):
    cid, expr = case
    rng = np.random.RandomState(zlib.crc32(cid.encode()))
    values = {"x": rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32),
              "y": rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)}
    heads = [rng.uniform(-1, 1, (3, 4)).astype(np.float32)]
    got, want = [], []
    for pkg, out in ((jmx, want), (tmx, got)):
        with pkg.name.NameManager():     # fresh default names in both
            x, y = pkg.sym.Variable("x"), pkg.sym.Variable("y")
            sym = expr(x, y)
        used = {n: values[n] for n in sym.list_arguments()}
        out.append((sym.tojson(),) + _run(pkg, sym, used, heads))
    assert got[0][0] == want[0][0]          # the same graph, node for node
    np.testing.assert_allclose(got[0][1][0], want[0][1][0], rtol=RTOL,
                               atol=ATOL)
    for n in want[0][2]:
        np.testing.assert_allclose(got[0][2][n], want[0][2][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_symbol_arithmetic_rejects_other_operands():
    x = tmx.sym.Variable("x")
    with pytest.raises(TypeError):
        x + "a"
    with pytest.raises(TypeError):
        "a" - x
    grouped = tmx.sym.Group([x, x * 2])
    assert len(grouped) == 2 and [s.name for s in grouped][0] == "x"
    with pytest.raises(tmx.MXNetError, match="cannot find output"):
        grouped["nope"]


# -- NDArray arithmetic and the mx.nd functions ----------------------------

ND_EXPRS = [
    ("add", lambda a, b: a + b), ("add-scalar", lambda a, b: a + 0.3),
    ("radd", lambda a, b: 2 + a), ("sub", lambda a, b: a - b),
    ("rsub", lambda a, b: 1.5 - a), ("mul", lambda a, b: a * b),
    ("rmul", lambda a, b: 0.7 * b), ("mul-np", lambda a, b: b * np.float32(
        0.7)), ("div", lambda a, b: a / b),
    ("rdiv", lambda a, b: 3 / b), ("pow", lambda a, b: a ** 2),
    ("rpow", lambda a, b: 2 ** a), ("mod", lambda a, b: a % 0.7),
    ("neg", lambda a, b: -a),
]


def _nd_pair(pkg, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    return pkg.nd.array(a, ctx=pkg.cpu()), pkg.nd.array(b, ctx=pkg.cpu())


@pytest.mark.parametrize("case", ND_EXPRS, ids=[c[0] for c in ND_EXPRS])
def test_ndarray_arithmetic_matches_jax(case):
    cid, expr = case
    seed = zlib.crc32(cid.encode())
    want = expr(*_nd_pair(jmx, seed))
    got = expr(*_nd_pair(tmx, seed))
    assert isinstance(got, tmx.nd.NDArray) and got.dtype == want.dtype
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_ndarray_inplace_writes_the_shared_buffer(op):
    outs = []
    for pkg in (jmx, tmx):
        a, b = _nd_pair(pkg, 5)
        view = a
        exec("a %s b" % op, {}, {"a": a, "b": b})
        exec("a %s 2" % op, {}, {"a": a, "b": b})
        assert view is a
        outs.append(a.asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)
    # the port writes in place: an executor sharing the buffer sees it
    a, _ = _nd_pair(tmx, 5)
    ptr = a._get().data_ptr()
    a += 1
    assert a._get().data_ptr() == ptr
    ints = tmx.nd.array([1, 2], ctx=tmx.cpu(), dtype=np.int32)
    ints += 1.5
    jints = jmx.nd.array([1, 2], dtype=np.int32)
    jints += 1.5
    assert ints.dtype == jints.dtype
    np.testing.assert_array_equal(ints.asnumpy(), jints.asnumpy())


def _nd_calls(pkg):
    nd, ctx = pkg.nd, pkg.cpu()
    rng = np.random.RandomState(3)
    m = nd.array(rng.uniform(-1, 1, (4, 5)).astype(np.float32), ctx=ctx)
    n = nd.array(rng.uniform(-1, 1, (5, 3)).astype(np.float32), ctx=ctx)
    t = nd.array(rng.uniform(-1, 1, (2, 4, 5)).astype(np.float32), ctx=ctx)
    u = nd.array(rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32), ctx=ctx)
    idx = nd.array([0, 4, 2, 1], ctx=ctx)
    out = nd.zeros((4, 6), ctx=ctx)
    return {
        "ones": nd.ones((2, 3), ctx=ctx), "full": nd.full((2, 3), 2.5,
                                                          ctx=ctx),
        "arange": nd.arange(5, ctx=ctx), "arange3": nd.arange(1, 3, 0.5,
                                                               ctx=ctx),
        "concat": nd.concat(m, m, dim=0),
        "onehot": nd.onehot_encode(idx, out),
        "clip": nd.clip(m, -0.5, 0.5), "dot": nd.dot(m, n),
        "batch_dot": nd.batch_dot(t, u), "transpose": nd.transpose(m),
        "transpose-axes": nd.transpose(t, axes=(1, 0, 2)),
        "sum": nd.sum(m), "sum-axis": nd.sum(t, axis=1),
        "sum-keep": nd.sum(m, keepdims=True), "max": nd.max(m),
        "max-axis": nd.max(t, axis=(0, 2)), "min": nd.min(m),
        "min-axis-keep": nd.min(t, axis=2, keepdims=True),
        "norm": nd.norm(m), "argmax_channel": nd.argmax_channel(m),
        "choose": nd.choose_element_0index(m, idx),
        "bridge-exp": nd.exp(m), "bridge-_plus": nd._plus(m, m),
        "bridge-reshape": nd.Reshape(t, shape=(0, -1)),
        "bridge-broadcast": nd.broadcast_plus(t, nd.ones((2, 1, 5),
                                                          ctx=ctx)),
        "bridge-scalar": nd._rminus_scalar(m, scalar=0.3),
        "bridge-smooth_l1": nd.smooth_l1(m, sigma=2.0),
        "bridge-softmax": nd.SoftmaxActivation(m),
    }


def test_nd_functions_match_jax():
    want, got = _nd_calls(jmx), _nd_calls(tmx)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    tmx.nd.waitall()


def test_nd_bridge_covers_every_aux_free_op():
    """mx.nd.<op> for every registered op without aux states; several
    outputs come back as a list."""
    jfuncs = set(jmx.nd.list_functions())
    tfuncs = set(tmx.nd.list_functions())
    # the same functions, but for the ops the port has not yet
    assert tfuncs <= jfuncs
    unported = set(jmx.ops.registry._OP_REGISTRY) - set(tmx.ops.list_ops())
    assert jfuncs - tfuncs <= unported
    assert "BatchNorm" not in tfuncs and callable(tmx.nd.exp)
    with tmx.cpu():
        x = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(2, 6))
    parts = tmx.nd.SliceChannel(x, num_outputs=3)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    with pytest.raises(tmx.MXNetError, match="expects 2 NDArray inputs"):
        tmx.nd.broadcast_plus(x)


@pytest.mark.parametrize("model_fn,args", [
    ("lstm_unroll", (2, 4, 20, 6, 5, 20)),
    ("lstm_unroll-ctx-groups", (2, 4, 20, 6, 5, 20)),
    ("lstm_unroll_scan", (2, 4, 20, 6, 5, 20)),
    ("lstm_inference_symbol", (2, 20, 6, 5, 20)),
    ("gru_unroll", (2, 4, 20, 6, 5, 20)),
    ("rnn_unroll", (2, 4, 20, 6, 5, 20))])
def test_models_built_by_either_package_bind_in_the_port(model_fn, args):
    """The same JSON from both packages' model functions
    (``ctx_groups`` kept as the ``ctx_group`` attribute only), and the
    JAX package's graph binds and runs in the port with the port's own
    graph's output."""
    import mxnet_tpu.models.lstm as jlstm
    import mxnet_tpu_torch.models.lstm as tlstm
    name = model_fn.split("-")[0]
    kw = {"ctx_groups": ["g0", "g1"]} if "ctx" in model_fn else {}
    with jmx.name.NameManager():
        jsym = getattr(jmodels, name, None) or getattr(jlstm, name)
        jsym = jsym(*args, **kw)
    with tmx.name.NameManager():
        tsym = getattr(tmx.models, name, None) or getattr(tlstm, name)
        tsym = tsym(*args, **kw)
    assert tsym.tojson() == jsym.tojson()
    if kw:
        assert {a.get("ctx_group") for a in tsym.attr_dict().values()} \
            >= {"g0", "g1"}
    seq = 1 if name == "lstm_inference_symbol" else args[1]
    shapes = {"data": (3, seq), "softmax_label": (3, seq)}
    for n in tsym.list_arguments():
        if "init" in n:
            shapes[n] = (3, 6)
    outs = []
    for sym in (tmx.sym.load_json(jsym.tojson()), tsym):
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        exe = sym.simple_bind(tmx.cpu(), grad_req="null", **shapes)
        rng = np.random.RandomState(0)
        for n, s in zip(sym.list_arguments(), arg_shapes):
            exe.arg_dict[n][:] = (rng.randint(0, 20, s) if n in (
                "data", "softmax_label") else rng.uniform(-0.3, 0.3, s))
        outs.append(exe.forward(is_train=False)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (3 * seq, 20)
