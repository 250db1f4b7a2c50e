"""The port's ``FeedForward`` (v0.7's estimator) against the JAX
package's, on the CPU.

* MLP (784-128-64-10) and LeNet (1x28x28) start from one checkpoint the
  JAX package wrote and train 2 epochs of 4 batches through
  ``FeedForward.fit`` in both packages (SGD, lr 0.05, momentum 0.9,
  wd 1e-4): params within rtol 1e-4, atol 1e-5 (float32 sums run in
  other orders in XLA and PyTorch), per-batch training accuracy equal.
  The port's fit takes the fused train step.
* The numpy ``X``/``y`` path (``NDArrayIter`` with ``roll_over``, batch
  ``min(n // 2, numpy_batch_size)``, shuffled by numpy's global stream),
  ``predict``/``score`` and ``save``/``load`` across the packages.
* ``sym_gen`` through ``BucketingModule``, ``epoch_size`` and
  ``begin_epoch``, the epoch-end callbacks, and
  ``test_module.py::test_feedforward_fit_and_checkpoint`` run on the
  port.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}

MODELS = {
    "mlp": (lambda m: m.models.get_mlp(),
            lambda r, n: r.uniform(-1, 1, (n, 784)).astype(np.float32)),
    "lenet": (lambda m: m.models.get_lenet(),
              lambda r, n: r.uniform(0, 1, (n, 1, 28, 28))
              .astype(np.float32)),
}


def _reference_checkpoint(tmp_path, name, batch=8, n=32):
    build, data_fn = MODELS[name]
    sym = build(jmx)
    rng = np.random.RandomState(0)
    x = data_fn(rng, n)
    y = rng.randint(0, 10, n).astype(np.float32)
    jmx.random.seed(1)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind([("data", (batch,) + x.shape[1:])],
             [("softmax_label", (batch,))])
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / name)
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    return prefix, x, y


def _load(pkg, prefix, epoch=0):
    if pkg is jmx:
        return jmx.model.load_checkpoint(prefix, epoch)
    return tmx.model.load_checkpoint(prefix, epoch, ctx=tmx.cpu())


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _ff_fit(pkg, prefix, x, y, batch=8, **kw):
    sym, arg, aux = _load(pkg, prefix)
    model = pkg.model.FeedForward(sym, ctx=pkg.cpu(), num_epoch=2,
                                  arg_params=arg, aux_params=aux, **OPT)
    accs, ends = [], []
    model.fit(pkg.io.NDArrayIter(x, y, batch_size=batch),
              batch_end_callback=lambda p: accs.append(p.eval_metric.get()),
              epoch_end_callback=lambda e, s, a, x_: ends.append(e), **kw)
    return model, accs, ends


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_matches_jax(name, tmp_path):
    prefix, x, y = _reference_checkpoint(tmp_path, name)
    got, got_acc, got_ends = _ff_fit(tmx, prefix, x, y)
    want, want_acc, want_ends = _ff_fit(jmx, prefix, x, y)
    _assert_close(_np(got.arg_params), _np(want.arg_params))
    assert got_acc == want_acc and got_ends == want_ends == [0, 1]
    fused = got._module._fused
    assert fused is not None and fused.stats.report()["eager_steps"] == 8
    # predict and score on the trained params, against the reference's
    it = lambda pkg: pkg.io.NDArrayIter(x, y, batch_size=8)  # noqa: E731
    np.testing.assert_allclose(got.predict(it(tmx)), want.predict(it(jmx)),
                               rtol=RTOL, atol=ATOL)
    assert got.score(it(tmx)) == want.score(it(jmx))


def test_numpy_path_predict_score_and_save_load_across(tmp_path):
    prefix, x, y = _reference_checkpoint(tmp_path, "mlp", n=40)
    models = {}
    for pkg in (tmx, jmx):
        sym, arg, aux = _load(pkg, prefix)
        model = pkg.model.FeedForward(sym, ctx=pkg.cpu(), num_epoch=2,
                                      numpy_batch_size=16, arg_params=arg,
                                      aux_params=aux, **OPT)
        np.random.seed(5)      # NDArrayIter(shuffle=True) draws from numpy
        model.fit(x, y)
        models[pkg] = model
    got, want = models[tmx], models[jmx]
    _assert_close(_np(got.arg_params), _np(want.arg_params))
    # eval over numpy input: batch numpy_batch_size, the pad rows cut
    pg, pw = got.predict(x), want.predict(x)
    assert pg.shape == pw.shape == (40, 10)
    np.testing.assert_allclose(pg, pw, rtol=RTOL, atol=ATOL)
    out, data, label = got.predict(x, return_data=True)
    np.testing.assert_array_equal(data, x)
    assert got.score(tmx.io.NDArrayIter(x, y, batch_size=8)) == \
        want.score(jmx.io.NDArrayIter(x, y, batch_size=8))
    # save in each package, load in the other: equal params and scores
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "ref"))
    back_j = jmx.model.FeedForward.load(str(tmp_path / "port"), 2,
                                        ctx=jmx.cpu())
    back_t = tmx.model.FeedForward.load(str(tmp_path / "ref"), 2,
                                        ctx=tmx.cpu(), numpy_batch_size=16)
    assert back_t.begin_epoch == back_j.begin_epoch == 2
    for k, v in got.arg_params.items():
        np.testing.assert_array_equal(back_j.arg_params[k].asnumpy(),
                                      v.asnumpy())
    for k, v in want.arg_params.items():
        np.testing.assert_array_equal(back_t.arg_params[k].asnumpy(),
                                      v.asnumpy())
    np.testing.assert_allclose(back_t.predict(x), want.predict(x),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="y must be specified"):
        got.fit(x)


class _Buckets:
    """Batches of one shape under two bucket keys (the parameters do not
    depend on the key), with the bucketing iterator surface."""

    def __init__(self, pkg, x, y, batch=8):
        self.pkg, self.x, self.y, self.batch_size = pkg, x, y, batch
        self.default_bucket_key = 6
        self.provide_data = [("data", (batch, x.shape[1]))]
        self.provide_label = [("softmax_label", (batch,))]
        self._pos = 0

    def reset(self):
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos + self.batch_size > len(self.x):
            raise StopIteration
        s = slice(self._pos, self._pos + self.batch_size)
        key = (4, 6)[(self._pos // self.batch_size) % 2]
        self._pos += self.batch_size
        nd = self.pkg.nd
        return self.pkg.io.DataBatch(
            data=[nd.array(self.x[s], ctx=self.pkg.cpu())],
            label=[nd.array(self.y[s], ctx=self.pkg.cpu())], pad=0,
            bucket_key=key, provide_data=self.provide_data,
            provide_label=self.provide_label)

    next = __next__


def _sym_gen(pkg):
    def gen(key):
        data = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = pkg.sym.Activation(h, act_type="tanh")
        h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax")
    return gen


def test_sym_gen_epoch_size_and_begin_epoch_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(40, 5).astype(np.float32)
    y = rng.randint(0, 3, 40).astype(np.float32)
    w = {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.3,
         "fc1_bias": np.zeros(8, np.float32),
         "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
         "fc2_bias": np.zeros(3, np.float32)}
    results = {}
    for pkg in (tmx, jmx):
        base = pkg.io.DataIter
        it = type("It", (_Buckets, base), {})(pkg, x, y)
        arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in w.items()}
        ends = []
        model = pkg.model.FeedForward(_sym_gen(pkg), ctx=pkg.cpu(),
                                      num_epoch=3, begin_epoch=1,
                                      epoch_size=3, arg_params=arg, **OPT)
        model.fit(it, epoch_end_callback=lambda e, s, a, x_: ends.append(
            (e, sorted(a))))
        results[pkg] = (_np(model.arg_params), ends)
    (got, got_ends), (want, want_ends) = results[tmx], results[jmx]
    assert got_ends == want_ends and [e for e, _ in got_ends] == [1, 2]
    _assert_close(got, want)


def make_blobs(n=400, dim=10, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    X, y = [], []
    for _ in range(n):
        c = rng.randint(classes)
        X.append(centers[c] + rng.randn(dim) * 0.5)
        y.append(c)
    return np.asarray(X, dtype=np.float32), np.asarray(y, dtype=np.float32)


def mlp_sym(mx, classes=4):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_feedforward_fit_and_checkpoint(tmp_path):
    """``test_module.py::test_feedforward_fit_and_checkpoint`` on the
    port, ``ctx=mx.cpu()``."""
    mx = tmx
    np.random.seed(0)
    mx.random.seed(0)
    X, y = make_blobs()
    it = mx.io.NDArrayIter(X, y, batch_size=40, shuffle=True)
    model = mx.model.FeedForward(mlp_sym(mx), ctx=mx.cpu(), num_epoch=4,
                                 learning_rate=0.5)
    model.fit(it)
    acc = model.score(it)
    assert acc > 0.9, acc
    prefix = str(tmp_path / "ffn")
    model.save(prefix)
    model2 = mx.model.FeedForward.load(prefix, 4, ctx=mx.cpu())
    acc2 = model2.score(it)
    assert abs(acc - acc2) < 1e-6
    pred = model2.predict(it)
    assert pred.shape == (400, 4)
    # create() is construct-and-fit
    model3 = mx.model.FeedForward.create(mlp_sym(mx), X, y, ctx=mx.cpu(),
                                         num_epoch=2, learning_rate=0.5)
    assert model3.score(it) > 0.5
