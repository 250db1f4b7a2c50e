"""The port's correlation kernel path, Correlation op, LeakyReLU, Concat and
a narrow FlowNetC correlation stage against the JAX package's.

On the CPU the port's ``correlation`` takes its plain version
(``correlation_reference``); here it is held to the JAX package's Pallas
kernel run in interpret mode and to the numpy oracle of
``tests/test_pallas.py`` at atol 1e-5 (sums of a few products of values in
[0, 1), divided by C).  The op is held to ``mx.sym.Correlation`` through
Symbol -> Executor for the kernel's configuration and for the ones the
JAX package lowers with lax.  The CUDA kernel itself is held to the same
plain version on the card by ``chip_smoke.py``.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import get_op as jax_get_op
from mxnet_tpu.ops.pallas_kernels import correlation as pallas_corr
from mxnet_tpu.ops.registry import OpContext as JaxOpContext

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import get_op as port_get_op
from mxnet_tpu_torch.ops.registry import OpContext as PortOpContext

from chip_smoke import flownetc_symbol


def _numpy_correlation(an, bn, m, stride2, is_mult):
    """Independent numpy oracle (tests/test_pallas.py, correlation.cu
    semantics)."""
    n, c, h, w = an.shape
    ng = m // stride2
    d2 = 2 * ng + 1
    bpad = np.pad(bn, [(0, 0), (0, 0), (m, m), (m, m)])
    want = np.empty((n, d2 * d2, h, w), np.float32)
    for i, dy in enumerate(range(-ng, ng + 1)):
        for j, dx in enumerate(range(-ng, ng + 1)):
            oy, ox = m + dy * stride2, m + dx * stride2
            tile = bpad[:, :, oy:oy + h, ox:ox + w]
            val = an * tile if is_mult else np.abs(an - tile)
            want[:, i * d2 + j] = val.sum(axis=1) / c
    return want


@pytest.mark.parametrize("is_mult", [True, False])
@pytest.mark.parametrize("m,stride2", [(2, 1), (2, 2), (3, 2)])
def test_correlation_matches_pallas_interpret_and_numpy(m, stride2, is_mult):
    rng = np.random.RandomState(0)
    a = rng.rand(2, 4, 6, 6).astype(np.float32)
    b = rng.rand(2, 4, 6, 6).astype(np.float32)
    want = np.asarray(pallas_corr(jnp.asarray(a), jnp.asarray(b), m, stride2,
                                  is_mult, interpret=True))
    oracle = _numpy_correlation(a, b, m, stride2, is_mult)
    got = ck.correlation(torch.from_numpy(a), torch.from_numpy(b), m,
                         stride2, is_mult).numpy()
    assert got.shape == want.shape == oracle.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_correlation_beyond_the_tpu_unroll_limit_matches_numpy():
    # 441 displacements: the Pallas kernel declines D2^2 > 169; the port's
    # kernel (and so its plain version) takes any D2
    rng = np.random.RandomState(1)
    a = rng.rand(1, 3, 9, 11).astype(np.float32)
    b = rng.rand(1, 3, 9, 11).astype(np.float32)
    assert pallas_corr(jnp.asarray(a), jnp.asarray(b), 20, 2, True) is None
    got = ck.correlation(torch.from_numpy(a), torch.from_numpy(b), 20, 2)
    assert got.shape == (1, 441, 9, 11)
    np.testing.assert_allclose(got.numpy(),
                               _numpy_correlation(a, b, 20, 2, True),
                               rtol=0, atol=1e-5)


def test_correlation_wrapper_rejects_bad_arguments_and_counts_nothing():
    a = torch.zeros(1, 2, 4, 4)
    with pytest.raises(MXNetError):
        ck.correlation(a, torch.zeros(1, 2, 4, 5), 1)
    with pytest.raises(MXNetError):
        ck.correlation(a[0], a[0], 1)
    with pytest.raises(MXNetError):
        ck.correlation(a, a, 1, stride2=0)
    ck.reset_launches()
    ck.correlation(a, a, 2, 2, False)
    assert ck.LAUNCHES == {name: 0 for name in ck.SOURCES}


def test_correlation_source_builds_for_hopper():
    src = os.path.join(ck._CSRC, ck.SOURCES["correlation"])
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int mxtt_correlation(' in text
    assert "pallas_kernels.py:393" in text            # names the TPU kernel
    assert "atomic" not in text
    cmd = ck.nvcc_command(src, "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd


# ---------------------------------------------------------------------------
# the Correlation op through Symbol -> Executor

CORR_CONFIGS = [
    ("kernel-m2-s2", dict(kernel_size=1, max_displacement=2, stride1=1,
                          stride2=2, pad_size=2)),
    ("kernel-m3-s2-abs", dict(kernel_size=1, max_displacement=3, stride1=1,
                              stride2=2, pad_size=3, is_multiply=False)),
    ("ksize3", dict(kernel_size=3, max_displacement=2, stride1=1, stride2=1,
                    pad_size=3)),
    ("stride1-2", dict(kernel_size=1, max_displacement=2, stride1=2,
                       stride2=1, pad_size=2)),
    ("pad-not-m", dict(kernel_size=1, max_displacement=2, stride1=1,
                       stride2=1, pad_size=1)),
    ("ksize3-stride1-2-abs", dict(kernel_size=3, max_displacement=1,
                                  stride1=2, stride2=1, pad_size=2,
                                  is_multiply=False)),
]


def _bind_run(pkg, sym, feed):
    ctx = pkg.cpu()
    shapes = {k: v.shape for k, v in feed.items()}
    ex = sym.simple_bind(ctx, grad_req="null", **shapes)
    return ex.forward(is_train=False, **feed)[0].asnumpy()


@pytest.mark.parametrize("name,params", CORR_CONFIGS,
                         ids=[c[0] for c in CORR_CONFIGS])
def test_correlation_op_matches_jax_through_executor(name, params):
    rng = np.random.RandomState(len(name))
    feed = {"data1": rng.rand(2, 3, 7, 9).astype(np.float32),
            "data2": rng.rand(2, 3, 7, 9).astype(np.float32)}
    syms = []
    for pkg in (mx, mt):
        syms.append(pkg.sym.Correlation(pkg.sym.Variable("data1"),
                                        pkg.sym.Variable("data2"),
                                        name="corr", **params))
    jsym, tsym = syms
    assert tsym.tojson() == jsym.tojson()
    assert tsym.infer_shape(data1=(2, 3, 7, 9), data2=(2, 3, 7, 9)) == \
        jsym.infer_shape(data1=(2, 3, 7, 9), data2=(2, 3, 7, 9))
    want = _bind_run(mx, jsym, feed)
    got = _bind_run(mt, tsym, feed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_correlation_op_identical_inputs_center_is_mean_square():
    # tests/test_operator.py test_correlation_shapes, through the port
    av = np.random.RandomState(2).rand(1, 2, 6, 6).astype(np.float32)
    sym = mt.sym.Correlation(mt.sym.Variable("data1"),
                             mt.sym.Variable("data2"), kernel_size=1,
                             max_displacement=2, stride1=1, stride2=1,
                             pad_size=2)
    out = _bind_run(mt, sym, {"data1": av, "data2": av})
    assert out.shape == (1, 25, 6, 6)
    np.testing.assert_allclose(out[0, 12], (av[0] ** 2).sum(axis=0) / 2.0,
                               rtol=1e-5, atol=1e-6)


def test_correlation_op_training_takes_the_plain_lowering(monkeypatch):
    """is_train never reaches the kernel wrapper (the JAX package skips its
    Pallas kernel in training for the same split)."""
    calls = []
    real = ck.correlation
    monkeypatch.setattr(ck, "correlation",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    op = port_get_op("Correlation")
    p = op.parse_params(dict(kernel_size=1, max_displacement=1, pad_size=1))
    a = torch.rand(1, 2, 4, 4)
    train = op.forward(p, [a, a], [], PortOpContext(is_train=True))[0]
    assert not calls
    infer = op.forward(p, [a, a], [], PortOpContext(is_train=False))[0]
    assert calls == [1]
    torch.testing.assert_close(train, infer, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# LeakyReLU and Concat against the JAX ops

LEAKY_CASES = [("leaky", {"act_type": "leaky", "slope": 0.1}),
               ("leaky-default", {}),
               ("elu", {"act_type": "elu", "slope": 0.3}),
               ("prelu", {"act_type": "prelu"}),
               ("rrelu-inference", {"act_type": "rrelu",
                                    "lower_bound": 0.1,
                                    "upper_bound": 0.4})]


@pytest.mark.parametrize("name,params", LEAKY_CASES,
                         ids=[c[0] for c in LEAKY_CASES])
def test_leaky_relu_matches_jax(name, params):
    rng = np.random.RandomState(len(name))
    ins = [rng.uniform(-2, 2, (2, 3, 4, 5)).astype(np.float32)]
    if params.get("act_type") == "prelu":
        ins.append(rng.uniform(0, 0.5, (3,)).astype(np.float32))
    jop, top = jax_get_op("LeakyReLU"), port_get_op("LeakyReLU")
    jp, tp = jop.parse_params(dict(params)), top.parse_params(dict(params))
    assert jop.serialize_params(jp) == top.serialize_params(tp)
    assert jop.list_arguments(jp) == top.list_arguments(tp)
    shapes = [a.shape for a in ins]
    assert jop.infer_shape(jp, list(shapes)) == top.infer_shape(tp,
                                                                list(shapes))
    want = np.asarray(jop.forward(jp, [jnp.asarray(a) for a in ins], [],
                                  JaxOpContext(is_train=False))[0])
    got = top.forward(tp, [torch.from_numpy(a) for a in ins], [],
                      PortOpContext(is_train=False))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rrelu_in_training_raises_until_training_is_ported():
    op = port_get_op("LeakyReLU")
    p = op.parse_params({"act_type": "rrelu"})
    with pytest.raises(NotImplementedError):
        op.forward(p, [torch.zeros(2, 3)], [], PortOpContext(is_train=True))


@pytest.mark.parametrize("dim,n_in", [(1, 2), (0, 3), (3, 2)])
def test_concat_matches_jax(dim, n_in):
    rng = np.random.RandomState(dim * 10 + n_in)
    shapes = []
    for i in range(n_in):
        s = [2, 3, 4, 5]
        s[dim] = i + 1
        shapes.append(tuple(s))
    feed = {"x%d" % i: rng.rand(*s).astype(np.float32)
            for i, s in enumerate(shapes)}
    syms = [pkg.sym.Concat(*[pkg.sym.Variable("x%d" % i)
                             for i in range(n_in)], dim=dim, name="cat")
            for pkg in (mx, mt)]
    assert syms[1].tojson() == syms[0].tojson()
    assert syms[1].infer_shape(**{k: v.shape for k, v in feed.items()}) == \
        syms[0].infer_shape(**{k: v.shape for k, v in feed.items()})
    np.testing.assert_array_equal(_bind_run(mt, syms[1], feed),
                                  _bind_run(mx, syms[0], feed))


# ---------------------------------------------------------------------------
# a narrow FlowNetC stage through both packages' Predictor

NARROW = dict(widths=(8, 12, 16), redir=4, out=8, max_displacement=4,
              stride2=2)


def test_flownetc_graph_json_equal_and_shapes():
    jsym = flownetc_symbol(mx.sym, **NARROW)
    tsym = flownetc_symbol(mt.sym, **NARROW)
    assert tsym.tojson() == jsym.tojson()
    shapes = {"img1": (2, 3, 32, 48), "img2": (2, 3, 32, 48)}
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    _args, outs, _aux = tsym.infer_shape(**shapes)
    assert outs == [(2, 8, 4, 6)]
    # the two towers share one set of weights
    assert [a for a in tsym.list_arguments() if a.startswith("conv1")] == \
        ["conv1_weight", "conv1_bias"]
    full = flownetc_symbol(mt.sym)
    fshapes = {"img1": (8, 3, 384, 512), "img2": (8, 3, 384, 512)}
    args, outs, _ = full.infer_shape(**fshapes)
    assert outs == [(8, 256, 48, 64)]
    n_params = sum(int(np.prod(s)) for n, s in zip(full.list_arguments(),
                                                   args) if n not in fshapes)
    assert n_params == 2132128


def test_narrow_flownetc_predictor_matches_jax(tmp_path):
    """One checkpoint pair through both packages' Predictor on the CPU.
    Tolerance: five float32 convolution layers and the correlation sum in
    XLA's order and in torch's; outputs are O(0.1), so 1e-5 relative and
    absolute."""
    jsym = flownetc_symbol(mx.sym, **NARROW)
    shapes = {"img1": (2, 3, 32, 48), "img2": (2, 3, 32, 48)}
    args, _, _ = jsym.infer_shape(**shapes)
    rng = np.random.RandomState(7)
    params = {}
    for name, shape in zip(jsym.list_arguments(), args):
        if name in shapes:
            continue
        fan = float(np.prod(shape[1:])) if len(shape) > 1 else 100.0
        params[name] = rng.uniform(-1, 1, shape).astype(np.float32) * \
            np.float32(np.sqrt(6.0 / fan))
    prefix = str(tmp_path / "flownetc")
    mx.model.save_checkpoint(prefix, 3, jsym,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    img1 = rng.rand(*shapes["img1"]).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(2, 3)) + np.float32(0.05) * \
        rng.randn(*shapes["img2"]).astype(np.float32)
    outs = []
    for cls, kw in ((mx.predictor.Predictor, {}),
                    (mt.Predictor, {"dev_type": "cpu"})):
        pred = cls(prefix + "-symbol.json", prefix + "-0003.params",
                   input_shapes=shapes, **kw)
        pred.set_input("img1", img1)
        pred.set_input("img2", img2)
        pred.forward()
        outs.append(pred.get_output(0))
    want, got = outs
    assert got.shape == want.shape == (2, 8, 4, 6)
    assert np.abs(want).max() > 1e-3                 # the graph does work
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ck.reset_launches()
    assert ck.LAUNCHES["correlation"] == 0            # CPU: plain version


def test_flownetc_predictor_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sym = flownetc_symbol(mt.sym, **NARROW)
    with pytest.raises(MXNetError):
        mt.Predictor(sym.tojson(), {}, {"img1": (1, 3, 32, 48),
                                        "img2": (1, 3, 32, 48)})
