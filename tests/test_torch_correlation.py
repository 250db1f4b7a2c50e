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
import re

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

from chip_smoke import CORR_CASES, FLOWNETC, PWCNET, flownetc_symbol


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
    """Training is ported: rrelu in training mode draws one slope per
    element from U(lower_bound, upper_bound) with the context's generator
    (tests/test_torch_grad.py checks the draws' moments)."""
    op = port_get_op("LeakyReLU")
    p = op.parse_params({"act_type": "rrelu"})
    gen = torch.Generator().manual_seed(0)
    out = op.forward(p, [-torch.ones(2, 3)], [],
                     PortOpContext(is_train=True, generator=gen))[0]
    slopes = -out
    assert ((slopes >= p.lower_bound) & (slopes < p.upper_bound)).all()


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


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition, mirrored on the CPU
#
# csrc/correlation.cu's host code picks an instance and its geometry; the
# register-blocked instance's blocks, warps and lanes each own a fixed
# slice of the output.  The mirror below reads the kernel's constants
# from the source text, plans launches as ``rb_plan``/``lane_stride`` do,
# and replays every thread of the register-blocked instance with torch:
# the staged a tile and b window (zero outside the image and past C), the
# values each thread reads from them, and the outputs it stores.

def _cu_constants():
    with open(os.path.join(ck._CSRC, ck.SOURCES["correlation"])) as f:
        text = f.read()
    found = dict((k, int(eval(v))) for k, v in re.findall(
        r"^constexpr int (k\w+) = ([0-9 *]+);", text, re.M))
    for key in ("kTH", "kTW", "kAcc", "kChunk", "kFastStride", "kMaxSmem",
                "kP", "kLanesX", "kS1J", "kS1Chunk", "kS1Warps", "kS2J",
                "kS2Chunk", "kS2Warps"):
        assert key in found, key
    return found


K = _cu_constants()


def _runs(d2, s2, j):
    jg = -(-d2 // j)
    return jg if s2 == 1 else 2 * (-(-jg // 2))


def _thread(warp, lane, d2, s2, j):
    """(il, j0, ty, xoff) of a thread, as rb_thread places it."""
    runs, ty = _runs(d2, s2, j), lane // K["kLanesX"]
    if s2 == 1:
        return warp // runs, (warp % runs) * j, ty, \
            (lane % K["kLanesX"]) * K["kP"]
    pairs, w = runs // 2, warp % runs
    return warp // runs, (2 * (w % pairs) + (lane // 2) % 2) * j, ty, \
        (w // pairs) * K["kP"] * 2 + lane % 2


def _lane_stride(width, s2, j, b_reads):
    step = 4 if s2 == 2 else 1
    first = -(-width // step) * step
    for r in range(first, first + 64, step):
        addrs = set()
        for lane in range(32):
            il, j0, ty, xoff = _thread(0, lane, 2 * j, s2, j)
            addrs.add(ty * r + xoff + (j0 * s2 if b_reads else 0))
        if len({x % 32 for x in addrs}) == len(addrs):
            return r
    return first


def _rb_plan(d2, ng, s2, w=None):
    """The register-blocked geometry, or None where the general instance
    runs (stride2 above 2, or stride2 2 at a width W % 4 != 0, where
    16-byte copies cannot run)."""
    if s2 not in (1, 2) or (s2 == 2 and w is not None and w % 4):
        return None
    j = K["kS%dJ" % s2]
    warps, chunk = K["kS%dWarps" % s2], K["kS%dChunk" % s2]
    runs = _runs(d2, s2, j)
    if runs > warps:
        return None
    shift = (-ng * s2) % 4
    ra = _lane_stride(K["kTW"], s2, j, False)
    wcols = -(-(shift + K["kTW"] + (runs * j - 1) * s2) // 4) * 4
    rb = _lane_stride(wcols, s2, j, True)
    for cap in range(warps // runs, 0, -1):
        n_igroups = -(-d2 // cap)
        ni = -(-d2 // n_igroups)
        wrows = K["kTH"] + (ni - 1) * s2
        nbytes = 2 * 4 * chunk * (K["kTH"] * ra + wrows * rb)
        if nbytes <= K["kMaxSmem"]:
            return dict(j=j, runs=runs, ni=ni, n_igroups=n_igroups, ra=ra,
                        rb=rb, wrows=wrows, wcols=wcols,
                        threads=32 * ni * runs, bytes=nbytes, chunk=chunk)
    return None


def _launch_plan(n, c, h, w, m, s2):
    """(instance, grid, threads, shared bytes) as mxtt_correlation
    launches them."""
    ng, d2 = ck.correlation_geometry(m, s2)
    gx, gy = -(-w // K["kTW"]), -(-h // K["kTH"])
    pl = _rb_plan(d2, ng, s2, w)
    if pl is not None:
        return "rb", (gx, gy, n * pl["n_igroups"]), pl["threads"], \
            pl["bytes"]
    dd, acc = d2 * d2, K["kAcc"]
    n_groups = -(-dd // acc)
    window = 0
    for g in range(n_groups):
        d0, nd = g * acc, min(acc, dd - g * acc)
        rows = K["kTH"] + ((d0 + nd - 1) // d2 - d0 // d2) * s2
        cols = (K["kTW"] + (d2 - 1) * s2 + 6) // 4 * 4
        window = max(window, rows * cols)
    stride = K["kFastStride"] if window <= K["kFastStride"] else window
    threads = K["kTH"] * K["kTW"]
    return "general", (gx, gy, n * n_groups), threads, \
        2 * 4 * K["kChunk"] * (threads + stride)


def _emulate_rb(a, b, m, s2, is_multiply):
    """Every thread of the register-blocked instance, replayed: returns the
    output and how many times each element was stored."""
    n, c, h, w = a.shape
    ng, d2 = ck.correlation_geometry(m, s2)
    pl = _rb_plan(d2, ng, s2)
    th, tw, p_n, j_n = K["kTH"], K["kTW"], K["kP"], pl["j"]
    c_pad = -(-c // pl["chunk"]) * pl["chunk"]      # zero past C
    out = torch.full((n, d2 * d2, h, w), float("nan"))
    stores = torch.zeros((n, d2 * d2, h, w), dtype=torch.int32)

    def staged(img, y0, x0, rows, cols):
        """rows x cols of img from (y0, x0), zero outside the image."""
        win = torch.zeros((c_pad, rows, cols))
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + rows, h), min(x0 + cols, w)
        if ys < ye and xs < xe:
            win[:c, ys - y0:ye - y0, xs - x0:xe - x0] = img[:, ys:ye, xs:xe]
        return win

    p = torch.arange(p_n)
    jj = torch.arange(j_n)
    for bz in range(n * pl["n_igroups"]):
        nn, i_first = bz // pl["n_igroups"], (bz % pl["n_igroups"]) * pl["ni"]
        for by in range(-(-h // th)):
            for bx in range(-(-w // tw)):
                y0, x0 = by * th, bx * tw
                wx0 = (x0 - ng * s2) // 4 * 4     # 16-byte aligned origin
                shift = x0 - ng * s2 - wx0
                at = staged(a[nn], y0, x0, th, tw)
                bw = staged(b[nn], y0 + (i_first - ng) * s2, wx0,
                            pl["wrows"], pl["wcols"])
                for warp in range(pl["threads"] // 32):
                    il, j0, ty, xoff = (torch.tensor(v) for v in zip(*[
                        _thread(warp, lane, d2, s2, j_n)
                        for lane in range(32)]))
                    # a[ty, xoff + p s2]; b[ty + il s2, shift + xoff +
                    # (j0 + p + j) s2]
                    av = at[:, ty[:, None], xoff[:, None] + p * s2]
                    bq = bw[:, (ty + il * s2)[:, None, None],
                            shift + xoff[:, None, None] +
                            (j0[:, None, None] + p[:, None] + jj) * s2]
                    acc = torch.zeros((32, p_n, j_n))
                    for ci in range(c_pad):               # channel order
                        prod = av[ci][:, :, None] * bq[ci] if is_multiply \
                            else (av[ci][:, :, None] - bq[ci]).abs()
                        acc = acc + prod
                    for lane in range(32):
                        i, y = i_first + int(il[lane]), y0 + int(ty[lane])
                        for pp in range(p_n):
                            x = x0 + int(xoff[lane]) + pp * s2
                            for j in range(j_n):
                                jd = int(j0[lane]) + j
                                if i < d2 and y < h and x < w and jd < d2:
                                    out[nn, i * d2 + jd, y, x] = \
                                        acc[lane, pp, j] / c
                                    stores[nn, i * d2 + jd, y, x] += 1
    return out, stores


# (id, N, C, H, W, m, stride2): FlowNetC's geometry at narrow C, PWC-Net's,
# ragged edges with s2 not dividing m, m = 0, a tall one-channel map, and
# a wide window (31 x 31 displacements)
RB_CASES = [("flownetc-narrow", 1, 3, 16, 40, 20, 2),
            ("pwcnet-narrow", 1, 3, 12, 40, 4, 1),
            ("ragged-m3s2", 2, 5, 7, 44, 3, 2),
            ("m0", 1, 2, 5, 5, 0, 1),
            ("c1-tall", 1, 1, 67, 3, 2, 1),
            ("wide-window-s2", 1, 2, 10, 36, 30, 2)]


@pytest.mark.parametrize("is_mult", [True, False])
@pytest.mark.parametrize("case", RB_CASES, ids=[c[0] for c in RB_CASES])
def test_register_blocked_decomposition_matches_reference(case, is_mult):
    _id, n, c, h, w, m, s2 = case
    rng = np.random.RandomState(len(_id) + 10 * is_mult)
    an = rng.rand(n, c, h, w).astype(np.float32)
    bn = rng.rand(n, c, h, w).astype(np.float32)
    got, stores = _emulate_rb(torch.from_numpy(an), torch.from_numpy(bn),
                              m, s2, is_mult)
    assert int(stores.min()) == int(stores.max()) == 1   # each output once
    ref = ck.correlation_reference(torch.from_numpy(an), torch.from_numpy(bn),
                                   m, s2, is_mult)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    want = pallas_corr(jnp.asarray(an), jnp.asarray(bn), m, s2, is_mult,
                       interpret=True)
    if want is not None:                     # the TPU kernel's D2^2 <= 169
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(
            got.numpy(), _numpy_correlation(an, bn, m, s2, is_mult),
            rtol=0, atol=1e-5)


def test_flownetc_instance_blocks_registers_and_groups():
    ng, d2 = ck.correlation_geometry(FLOWNETC["m"], FLOWNETC["s2"])
    pl = _rb_plan(d2, ng, FLOWNETC["s2"])
    assert K["kP"] >= 4 and pl["j"] >= 4
    assert pl["n_igroups"] <= 3 and pl["threads"] <= 1024
    # shared words read per multiply-add, a thread and a channel
    assert (K["kP"] + K["kP"] + pl["j"] - 1) / (K["kP"] * pl["j"]) < 0.4
    ng, d2 = ck.correlation_geometry(PWCNET["m"], PWCNET["s2"])
    pw = _rb_plan(d2, ng, PWCNET["s2"])
    assert pw["n_igroups"] <= 2 and pw["j"] * pw["runs"] >= 9


@pytest.mark.parametrize("s2", [1, 2])
def test_lane_strides_hit_distinct_banks(s2):
    j = K["kS%dJ" % s2]
    for width in (32, 40, 58, 74, 100):
        for b_reads in (False, True):
            r = _lane_stride(width, s2, j, b_reads)
            assert width <= r < width + 8 and r % (4 if s2 == 2 else 1) == 0
            addrs = set()
            for lane in range(32):
                il, j0, ty, xoff = _thread(0, lane, 2 * j, s2, j)
                addrs.add(ty * r + xoff + (j0 * s2 if b_reads else 0))
            assert len({x % 32 for x in addrs}) == len(addrs)


@pytest.mark.parametrize("name,g", CORR_CASES, ids=[c[0] for c in CORR_CASES])
def test_launch_plans_fit_the_card(name, g):
    inst, grid, threads, nbytes = _launch_plan(g["n"], g["c"], g["h"],
                                               g["w"], g["m"], g["s2"])
    assert inst == ("rb" if g["s2"] == 1 or g["s2"] == 2 and g["w"] % 4 == 0
                    else "general")
    assert nbytes <= 227 * 1024 == K["kMaxSmem"]
    assert max(grid[1:]) <= 65535 and grid[0] < 2 ** 31
    assert 32 <= threads <= 1024 and threads % 32 == 0


# ---------------------------------------------------------------------------
# the tensor-core instance (16-bit products), mirrored lane by lane
#
# csrc/correlation.cu's correlation_tc_kernel computes, per warp, the band
# of S = A_y · B_{y+dy} for 16 pixels with mma.sync m16n8k16 on fragments
# read by ldmatrix.trans.  The mirror plans a launch as tc_plan does, stages
# a and b as the kernel's 16-byte copies do (each group of 8 wholly inside
# or outside the image), gives every lane the registers ldmatrix.trans
# gives it (lane
# (g, t) of matrix q: elements (2t, g) and (2t + 1, g) of the rows lanes
# 8q..8q+7 address), multiplies the fragments as mma.sync lays them out,
# and stores the band as the epilogue does.

def _tc_constants():
    with open(os.path.join(ck._CSRC, ck.SOURCES["correlation"])) as f:
        text = f.read()
    per_nt = int(re.search(r"constexpr int tc_rows\(int nt\) \{ return "
                           r"(\d+) / nt; \}", text).group(1))
    return dict(rows=K["kTcRows"], mtiles=K["kTcMTiles"],
                chunk=K["kTcChunk"], stages=K["kTcStages"],
                max_nt=K["kTcMaxNT"], per_nt=per_nt)


TC = _tc_constants()


def _odd8(n):
    return ((n + 7) // 8 | 1) * 8


def _tc_plan(n, h, w, m, s2, align_a=16, align_b=16):
    """tc_plan: (nt, ni, n_igroups, shift, grid, bytes), or None where
    the SIMT instances run (a W or an alignment 16-byte copies cannot
    stage, a window over kTcMaxNT n-tiles).  align_*: the operands'
    alignment in bytes."""
    if w % 8 or align_a % 16 or align_b % 16:
        return None
    ng, d2 = ck.correlation_geometry(m, s2)
    reach = ng * s2
    shift = (8 - reach % 8) % 8
    nt = (16 + shift + 2 * reach + 7) // 8
    if nt > TC["max_nt"]:
        return None
    cols, bs = 16 * TC["mtiles"], _odd8(16 * (TC["mtiles"] - 1) + 8 * nt)
    for cap in range(TC["per_nt"] // nt, 0, -1):
        nig = -(-d2 // cap)
        ni = -(-d2 // nig)
        nbytes = 2 * TC["stages"] * TC["chunk"] * (
            TC["rows"] * _odd8(cols) + (TC["rows"] + ni - 1) * bs)
        if nbytes <= K["kMaxSmem"]:
            grid = (-(-w // cols), s2 * -(-h // (TC["rows"] * s2)), n * nig)
            return dict(nt=nt, ni=ni, nig=nig, shift=shift, grid=grid,
                        bytes=nbytes)
    return None


def _ldmatrix_trans(smem, rows, nmat):
    """(32, nmat, 2): lane (g, t)'s registers of ldmatrix.x{nmat}.trans
    over the 8-element rows at ``rows`` (one address a lane)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    q = np.arange(nmat)
    lo = rows[8 * q[None, :] + 2 * t[:, None]] + g[:, None]
    return np.stack([smem[lo], smem[rows[8 * q[None, :] + 2 * t[:, None]
                                         + 1] + g[:, None]]], -1)


def _mma(acc, af, b0, b1):
    """acc (32, 4) += A · B of mma.sync m16n8k16 from the lanes' A
    registers af (32, 4, 2) and B registers b0, b1 (32, 2)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    a_m, b_m = np.zeros((16, 16)), np.zeros((16, 8))
    for half in (0, 1):
        k = 2 * t + half
        a_m[g, k], a_m[g + 8, k] = af[:, 0, half], af[:, 1, half]
        a_m[g, k + 8], a_m[g + 8, k + 8] = af[:, 2, half], af[:, 3, half]
        b_m[k, g], b_m[k + 8, g] = b0[:, half], b1[:, half]
    c = a_m @ b_m
    acc += np.stack([c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                     c[g + 8, 2 * t + 1]], -1)


def _emulate_tc(a, b, m, s2):
    """Every block, warp and lane of the tensor-core instance, replayed:
    -> (output, stores per element, plan)."""
    n, c, h, w = a.shape
    ng, d2 = ck.correlation_geometry(m, s2)
    pl = _tc_plan(n, h, w, m, s2)
    nt, ni, nig = pl["nt"], pl["ni"], pl["nig"]
    rows, mtiles, chunk = TC["rows"], TC["mtiles"], TC["chunk"]
    k_ni, cols = TC["per_nt"] // nt, 16 * mtiles
    a_s, wc = _odd8(cols), 16 * (mtiles - 1) + 8 * nt
    b_s, s_s = _odd8(wc), _odd8(8 * nt)
    wrows = rows + ni - 1
    a_elems = rows * chunk * a_s
    stage_elems = a_elems + wrows * chunk * b_s
    assert pl["bytes"] == 2 * TC["stages"] * stage_elems
    assert rows * mtiles * 16 * s_s <= stage_elems      # epilogue scratch
    out = np.full((n, d2 * d2, h, w), np.nan)
    stores = np.zeros(out.shape, np.int32)
    lane = np.arange(32)
    for bx, by, bz in np.ndindex(*pl["grid"]):
        nn, i_first = bz // nig, bz % nig * ni
        n_i = min(ni, d2 - i_first)
        ya0 = by // s2 * rows * s2 + by % s2
        wy0 = ya0 + (i_first - ng) * s2
        x0 = bx * cols
        wx0 = x0 - ng * s2 - pl["shift"]
        accs = np.zeros((rows * mtiles, k_ni, nt, 32, 4))
        for c0 in range(0, c, chunk):
            smem = np.full(stage_elems, np.nan)
            v = 8
            for img, y_0, x_0, n_rows, width, stride, off in (
                    (a, ya0, x0, rows, cols, a_s, 0),
                    (b, wy0, wx0, wrows, wc, b_s, a_elems)):
                assert x_0 % v == 0
                for row, ch, col in np.ndindex(n_rows, chunk, width // v):
                    yy, xx = y_0 + row * s2, x_0 + col * v
                    dst = off + (row * chunk + ch) * stride + col * v
                    inside = c0 + ch < c and 0 <= yy < h and 0 <= xx \
                        and xx + v <= w
                    smem[dst:dst + v] = img[nn, c0 + ch, yy, xx:xx + v] \
                        if inside else 0.0
            for warp in range(rows * mtiles):
                r, mt = divmod(warp, mtiles)
                if not (ya0 + r * s2 < h and x0 + 16 * mt < w):
                    continue
                a_lane = r * chunk * a_s + 16 * mt + \
                    ((lane & 7) + 8 * (lane >> 4)) * a_s + \
                    8 * ((lane >> 3) & 1)
                b_lane = a_elems + r * chunk * b_s + 16 * mt + \
                    ((lane & 7) + 8 * ((lane >> 3) & 1)) * b_s + \
                    8 * (lane >> 4)
                for ks in range(chunk // 16):
                    af = _ldmatrix_trans(smem, a_lane + ks * 16 * a_s, 4)
                    for il in range(min(k_ni, n_i)):
                        sb = b_lane + (il * chunk + ks * 16) * b_s
                        for j in range(0, nt - 1, 2):
                            bf = _ldmatrix_trans(smem, sb + 8 * j, 4)
                            _mma(accs[warp, il, j], af, bf[:, 0], bf[:, 1])
                            _mma(accs[warp, il, j + 1], af, bf[:, 2],
                                 bf[:, 3])
                        if nt % 2:
                            bf = _ldmatrix_trans(smem, sb + 8 * (nt - 1), 2)
                            _mma(accs[warp, il, nt - 1], af, bf[:, 0],
                                 bf[:, 1])
        for warp in range(rows * mtiles):
            r, mt = divmod(warp, mtiles)
            y = ya0 + r * s2
            if not (y < h and x0 + 16 * mt < w):
                continue
            for il in range(min(k_ni, n_i)):
                sc = np.full((16, s_s), np.nan)     # the warp's scratch
                g, t = lane >> 2, lane & 3
                for j in range(nt):
                    part = accs[warp, il, j] / c
                    sc[g, 8 * j + 2 * t], sc[g, 8 * j + 2 * t + 1] = \
                        part[:, 0], part[:, 1]
                    sc[g + 8, 8 * j + 2 * t], sc[g + 8, 8 * j + 2 * t + 1] \
                        = part[:, 2], part[:, 3]
                for ln in range(32):
                    mm = ln & 15
                    x = x0 + 16 * mt + mm
                    if x >= w:
                        continue
                    for jd in range(ln >> 4, d2, 2):
                        col = mm + pl["shift"] + jd * s2
                        assert col < 8 * nt
                        d = (i_first + il) * d2 + jd
                        out[nn, d, y, x] = sc[mm, col]
                        stores[nn, d, y, x] += 1
    return out, stores, pl


# (id, N, C, H, W, m, stride2): FlowNetC's geometry at narrow C and H,
# PWC-Net's, windows shifted off the 16-byte copies by 3 and by 7 columns
# (stride2 3), the widest window (8 n-tiles at shift 0), m = 0, a width
# narrower than the block's 64 columns
TC_CASES = [("flownetc-narrow", 1, 19, 6, 64, 20, 2),
            ("pwcnet-narrow", 1, 40, 5, 72, 4, 1),
            ("shift3-s1", 1, 6, 5, 64, 5, 1),
            ("s2-3-shift7", 1, 33, 7, 48, 9, 3),
            ("reach-24", 1, 3, 7, 64, 24, 1),
            ("m0", 1, 5, 5, 24, 0, 1),
            ("w40", 2, 9, 6, 40, 2, 1)]


@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_tensor_core_decomposition_matches_reference(case):
    _id, n, c, h, w, m, s2 = case
    rng = np.random.RandomState(len(_id))
    an = rng.randn(n, c, h, w).astype(np.float32)
    bn = rng.randn(n, c, h, w).astype(np.float32)
    got, stores, _pl = _emulate_tc(an, bn, m, s2)
    assert int(stores.min()) == int(stores.max()) == 1   # each output once
    ref = ck.correlation_reference(torch.from_numpy(an), torch.from_numpy(bn),
                                   m, s2)
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-5)


def test_flownetc_and_pwcnet_take_the_tensor_core_instance():
    for g, nt in ((FLOWNETC, 8), (PWCNET, 4)):
        pl = _tc_plan(g["n"], g["h"], g["w"], g["m"], g["s2"])
        assert pl is not None and pl["nt"] == nt and pl["shift"] == 4
        assert pl["bytes"] <= K["kMaxSmem"] and max(pl["grid"][1:]) <= 65535
        # a warp's accumulators: its displacement rows x n-tiles x 4
        assert pl["ni"] * nt * 4 <= 96
    fl = _tc_plan(FLOWNETC["n"], FLOWNETC["h"], FLOWNETC["w"], FLOWNETC["m"],
                  FLOWNETC["s2"])
    assert fl["ni"] == 3 and fl["nig"] == 7
    # windows over kTcMaxNT n-tiles, widths and alignments 16-byte copies
    # cannot stage run the SIMT instances
    assert _tc_plan(1, 10, 64, 30, 2) is None
    assert _tc_plan(1, 10, 64, 24, 1) is not None
    assert _tc_plan(1, 10, 44, 4, 2) is None
    assert _tc_plan(1, 10, 64, 4, 2, align_a=8) is None
    assert _tc_plan(1, 10, 64, 4, 2, align_b=2) is None
