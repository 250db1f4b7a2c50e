"""The port's ``plugins/`` against the JAX package's, on the CPU.

Carries ``tests/test_plugins.py``'s five tests over to the port, and:

* ``WarpCTC``: the softmax, and the CTC gradient against the JAX op's
  (``optax.ctc_loss``), at T 6 and 80, batch 2 and 32, label widths 1-4
  with repeated labels.  The recursion's float32 log-sum-exps run in
  other orders, and its log-domain values grow with T (~T log K), so the
  gradients are held within atol 2e-6 at T 6 and 1e-4 at T 80, and each
  package is held to a float64 run of the port's recursion as well (at
  T 80 the JAX op's gradient lies 5.4e-5 from it, the port's 2.7e-5).
  An infeasible alignment (more labels than frames can emit) keeps a
  finite loss and gradient, held within atol 1e-2: its paths all carry
  ``log_epsilon`` = -1e5, where float32 values are spaced 7.8e-3 apart,
  so either package knows those path weights only to ~0.8 % (the JAX
  op's lie 7.4e-3 from the float64 run, the port's 1.6e-3).  The
  gradient's rows sum to ~0 (atol 1e-4), and two backward runs under
  deterministic algorithms are bitwise equal.
* ``imresize`` up and down against ``jax.image.resize`` within one uint8
  code; ``copyMakeBorder`` and ``imdecode`` equal the JAX package's;
  ``SFrameIter``'s batches equal its, padding included; ``to_torch``
  shares the NDArray's storage.
"""
import io as _io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

CTC_ATOL = {6: 2e-6, 80: 1e-4}
CTC_INFEASIBLE_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu():
        yield


def test_warpctc_forward_backward():
    T, B, A, L = 6, 2, 5, 3
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    net = mx.sym.WarpCTC(data=data, label=label, label_length=L,
                         input_length=T)
    x = np.random.randn(T * B, A).astype(np.float32)
    y = np.array([[1, 2, 0], [3, 0, 0]], dtype=np.float32)
    ex = net.simple_bind(mx.cpu(), data=(T * B, A), label=(B, L))
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = y
    ex.forward(is_train=True)
    out = ex.outputs[0].asnumpy()
    e = np.exp(x - x.max(axis=1, keepdims=True))
    assert np.allclose(out, e / e.sum(axis=1, keepdims=True), atol=1e-5)
    ex.backward()
    g = ex.grad_dict["data"].asnumpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    assert np.allclose(g.sum(axis=1), 0, atol=1e-4)


def _ctc_labels(rng, B, L, T):
    """Labels in 1..A-1, 0-padded, of widths 1..L; row 0 repeats a
    label, and with T < 2L+1 the last row cannot be aligned."""
    y = np.zeros((B, L), np.float32)
    for b in range(B):
        w = 1 + b % L
        y[b, :w] = rng.randint(1, 11, w)
    if L > 1:
        y[0, :2] = 5                      # a repeated label
    return y


def _ctc_run(pkg, x, y, T, L):
    net = pkg.sym.WarpCTC(data=pkg.sym.Variable("data"),
                          label=pkg.sym.Variable("label"),
                          label_length=L, input_length=T)
    ex = net.simple_bind(pkg.cpu(), data=x.shape, label=y.shape)
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = y
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.ones(x.shape)])
    return out, ex.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("T,B,L", [(6, 2, 4), (6, 32, 4), (80, 2, 3),
                                   (80, 32, 4), (6, 4, 1)])
def test_warpctc_matches_jax(T, B, L):
    rng = np.random.RandomState(T * 100 + B + L)
    x = rng.randn(T * B, 11).astype(np.float32)
    y = _ctc_labels(rng, B, L, T)
    infeasible = np.zeros(B, bool)
    if T == 6 and L == 4:
        y[-1] = [7, 7, 7, 7]              # needs 7 frames: infeasible at 6
        infeasible[-1] = True
    got = _ctc_run(mx, x, y, T, L)
    want = _ctc_run(jmx, x, y, T, L)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert np.isfinite(got[1]).all()
    from mxnet_tpu_torch.plugins.warpctc import ctc_grad
    exact = ctc_grad(torch.from_numpy(x.astype(np.float64)),
                     torch.from_numpy(y.astype(np.float64)), T).numpy()
    # rows of data are (t, b) time-major
    rows = np.tile(infeasible, T)
    for a, b in ((got[1], want[1]), (got[1], exact), (want[1], exact)):
        np.testing.assert_allclose(a[~rows], b[~rows], atol=CTC_ATOL[T])
        np.testing.assert_allclose(a[rows], b[rows],
                                   atol=CTC_INFEASIBLE_ATOL)
    np.testing.assert_allclose(got[1].sum(axis=1), 0, atol=1e-4)


def test_warpctc_backward_is_bitwise_repeatable():
    rng = np.random.RandomState(5)
    T, B, L = 80, 32, 4
    x = rng.randn(T * B, 11).astype(np.float32)
    y = _ctc_labels(rng, B, L, T)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = _ctc_run(mx, x, y, T, L)[1]
        b = _ctc_run(mx, x, y, T, L)[1]
    finally:
        torch.use_deterministic_algorithms(prev)
    assert np.array_equal(a, b)


def test_torch_bridge():
    a = mx.nd.array(np.random.rand(3, 4))
    t = mx.th.to_torch(a)
    assert tuple(t.shape) == (3, 4)
    b = mx.th.from_torch(t * 2)
    assert np.allclose(b.asnumpy(), a.asnumpy() * 2)

    f = mx.th.torch_function(torch.sigmoid)
    out = f(a)
    assert np.allclose(out.asnumpy(), 1 / (1 + np.exp(-a.asnumpy())),
                       atol=1e-6)

    lin = torch.nn.Linear(4, 2)
    tm = mx.th.TorchModule(lin)
    y = tm.forward(a)
    assert y.shape == (3, 2)
    grads = tm.backward(mx.nd.ones((3, 2)))
    assert grads[0].shape == (3, 4)
    np.testing.assert_allclose(grads[0].asnumpy(),
                               np.ones((3, 2)) @ lin.weight.detach().numpy(),
                               atol=1e-6)


def test_to_torch_shares_storage():
    a = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    t = mx.th.to_torch(a)
    assert t.data_ptr() == a._get().data_ptr()
    t[0, 0] = 42.0
    assert a.asnumpy()[0, 0] == 42.0
    crit = mx.th.TorchCriterion(torch.nn.MSELoss())
    loss = crit.forward(a, mx.nd.zeros((2, 3)))
    assert loss.shape == (1,)
    g = crit.backward(mx.nd.ones((1,)))[0].asnumpy()
    np.testing.assert_allclose(g, 2 * a.asnumpy() / 6, atol=1e-6)


def test_opencv_plugin_resize_border():
    from mxnet_tpu_torch.plugins import opencv as cv
    img = mx.nd.array((np.random.rand(8, 6, 3) * 255).astype(np.uint8),
                      dtype=np.uint8)
    out = cv.imresize(img, 12, 16)
    assert out.shape == (16, 12, 3)
    out = cv.copyMakeBorder(img, 1, 2, 3, 4, fill_value=7)
    assert out.shape == (11, 13, 3)
    assert (out.asnumpy()[0] == 7).all()


@pytest.mark.parametrize("hw,size", [((8, 6), (12, 16)), ((37, 29), (7, 10)),
                                     ((20, 20), (5, 20)), ((9, 13), (4, 31))])
@pytest.mark.parametrize("interp", [0, 1])
def test_imresize_matches_jax(hw, size, interp):
    from mxnet_tpu.plugins import opencv as jcv
    from mxnet_tpu_torch.plugins import opencv as cv
    rng = np.random.RandomState(hw[0] * size[0] + interp)
    arr = (rng.rand(hw[0], hw[1], 3) * 255).astype(np.uint8)
    got = cv.imresize(mx.nd.array(arr, dtype=np.uint8), *size,
                      interpolation=interp).asnumpy()
    want = jcv.imresize(jmx.nd.array(arr, dtype=np.uint8), *size,
                        interpolation=interp).asnumpy()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (size[1], size[0], 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_copy_make_border_and_imdecode_equal_jax():
    pytest.importorskip("PIL")
    from PIL import Image
    from mxnet_tpu.plugins import opencv as jcv
    from mxnet_tpu_torch.plugins import opencv as cv
    rng = np.random.RandomState(1)
    arr = (rng.rand(5, 7, 3) * 255).astype(np.uint8)
    got = cv.copyMakeBorder(mx.nd.array(arr, dtype=np.uint8), 2, 1, 0, 3,
                            fill_value=9).asnumpy()
    want = jcv.copyMakeBorder(jmx.nd.array(arr, dtype=np.uint8), 2, 1, 0, 3,
                              fill_value=9).asnumpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    for flag in (1, 0):
        got = cv.imdecode(buf.getvalue(), flag).asnumpy()
        want = jcv.imdecode(buf.getvalue(), flag).asnumpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_opencv_imdecode_roundtrip():
    pytest.importorskip("PIL")
    from mxnet_tpu_torch.plugins import opencv as cv
    from PIL import Image
    arr = (np.random.rand(5, 7, 3) * 255).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    out = cv.imdecode(buf.getvalue())
    assert np.array_equal(out.asnumpy(), arr)


def test_sframe_iter_trains():
    """``tests/test_plugins.py``'s test, with the port's generator seeded:
    unseeded, the fit's default Uniform(0.01) init is drawn from whatever
    state the worker's generator is in, and at lr 0.5 an unlucky draw
    leaves relus dead (100 unseeded processes ranged from 0.825 to 1.0;
    one full-suite run under 6 workers read 0.7)."""
    from mxnet_tpu_torch.plugins.sframe import SFrameIter
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    n = 40
    X = rng.randn(n, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    frame = {"feat": list(X), "target": y}
    it = SFrameIter(frame, data_field="feat", label_field="target",
                    batch_size=8)
    assert it.provide_data[0][1] == (8, 6)
    batches = list(it)
    assert len(batches) == 5
    it.reset()
    mod = mx.mod.Module(_mlp_sym(6, 2), context=mx.cpu())
    mod.fit(it, num_epoch=4, optimizer_params={"learning_rate": 0.5})
    it.reset()
    acc = mod.score(it, "acc")[0][1]
    assert acc >= 0.8, acc


def test_sframe_batches_equal_jax():
    from mxnet_tpu.plugins.sframe import SFrameIter as JIter
    from mxnet_tpu_torch.plugins.sframe import SFrameIter
    rng = np.random.RandomState(2)
    n = 23
    frame = {"a": list(rng.randn(n, 2, 3)), "b": rng.randn(n),
             "t": rng.randint(0, 4, n)}
    kw = dict(data_field=["a", "b"], label_field="t", batch_size=5,
              data_shape=(7,))
    got, want = list(SFrameIter(frame, **kw)), list(JIter(frame, **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.pad == w.pad
        assert np.array_equal(g.data[0].asnumpy(), w.data[0].asnumpy())
        assert np.array_equal(g.label[0].asnumpy(), w.label[0].asnumpy())
        assert g.data[0].context == mx.cpu()
    assert got[-1].pad == 2
    assert SFrameIter(frame, **kw).provide_data == \
        JIter(frame, **kw).provide_data


def _mlp_sym(in_dim, classes):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes)
    return mx.sym.SoftmaxOutput(net, name="softmax")
