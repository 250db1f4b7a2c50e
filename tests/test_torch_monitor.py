"""Monitor and the sequential and python modules against the JAX package.

* ``Monitor``: on an MLP ``Module`` (tests/test_module.py:141) the stat
  names, their order and their values equal the reference's, for the
  default |x|/size stat and for the raw outputs, by ``install_monitor``
  and through ``fit(monitor=)`` with an interval; installing a monitor
  takes the module off the fused step, as the reference does.
* ``SequentialModule`` (an MLP body and a softmax head chained with
  ``auto_wiring``/``take_labels``, tests/test_module.py:195) and
  ``PythonLossModule`` (a numpy multiclass-hinge gradient behind an MLP,
  example/module/python_loss.py, tests/test_examples.py:176) train in
  both packages from one set of numpy-seeded params: params and the
  per-batch metric agree within rtol 1e-4, atol 1e-5 after 8 SGD steps
  with momentum (float32 sums in other orders, ~1e-6 relative a step).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
STAT_RTOL = 1e-5


def _blobs(n=64, dim=10, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    y = rng.randint(classes, size=n)
    x = centers[y] + rng.randn(n, dim) * 0.5
    return x.astype(np.float32), y.astype(np.float32)


def _mlp(pkg, classes=4):
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _params(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return {k: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
            for k, s in shapes.items()}


MLP_PARAMS = {"fc1_weight": (32, 10), "fc1_bias": (32,),
              "fc2_weight": (4, 32), "fc2_bias": (4,)}


def _nd(pkg, params):
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}


def _module(pkg, x, y, batch=16):
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_nd(pkg, _params(MLP_PARAMS)))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    return mod, it


def _stats(pkg, stat_func=None, pattern=".*"):
    x, y = _blobs()
    mod, it = _module(pkg, x, y)
    mon = pkg.Monitor(1, stat_func=stat_func, pattern=pattern)
    mod.install_monitor(mon)
    rows = []
    for batch in list(it)[:2]:
        mon.tic()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        rows.append(mon.toc())
    return mod, rows


def _values(text):
    return np.array([float(v) for v in text.split()], np.float64)


def test_monitor_default_stat_equals_jax():
    _, want = _stats(jmx)
    mod, got = _stats(tmx)
    assert mod._fused is None
    for g, w in zip(got, want):
        assert [(n, k) for n, k, _ in g] == [(n, k) for n, k, _ in w]
        assert [k for _, k, _ in g] == ["fc1_output", "activation0_output",
                                        "fc2_output", "softmax_output"]
        for (_, _, gv), (_, _, wv) in zip(g, w):
            np.testing.assert_allclose(_values(gv), _values(wv),
                                       rtol=STAT_RTOL)


def test_monitor_raw_outputs_with_a_pattern_equal_jax():
    """tests/test_module.py:141's monitor: the identity stat, names
    matching ``.*output``, through forward and backward."""
    def ident(x):
        return x
    _, want = _stats(jmx, ident, ".*fc.*output")
    _, got = _stats(tmx, ident, ".*fc.*output")
    for g, w in zip(got, want):
        assert [k for _, k, _ in g] == [k for _, k, _ in w] == \
            ["fc1_output", "fc2_output"]
        for (_, _, gv), (_, _, wv) in zip(g, w):
            np.testing.assert_allclose(_values(gv.replace("[", " ")
                                               .replace("]", " ")),
                                       _values(wv.replace("[", " ")
                                               .replace("]", " ")),
                                       rtol=STAT_RTOL, atol=1e-6)


class _Recorder:
    """A monitor that keeps what ``fit`` would log."""

    def __init__(self, pkg, interval):
        self.mon = pkg.Monitor(interval, sort=True)
        self.rows = []
        self.mon.toc_print = lambda: self.rows.append(self.mon.toc())


def _fit_with_monitor(pkg):
    x, y = _blobs()
    it = pkg.io.NDArrayIter(x, y, batch_size=16)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    rec = _Recorder(pkg, 2)
    mod.fit(it, num_epoch=2, monitor=rec.mon,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=_nd(pkg, _params(MLP_PARAMS)))
    arg, _ = mod.get_params()
    return mod, rec.rows, {k: v.asnumpy() for k, v in arg.items()}


def test_fit_with_a_monitor_equals_jax_and_runs_classic():
    _, want_rows, want = _fit_with_monitor(jmx)
    mod, got_rows, got = _fit_with_monitor(tmx)
    assert mod._fused is None and mod._monitor_installed
    # 8 batches at interval 2: stats at batches 0, 2, 4, 6, nothing else
    assert [len(r) > 0 for r in got_rows] == \
        [len(r) > 0 for r in want_rows] == [True, False] * 4
    for g, w in zip(got_rows, want_rows):
        assert [(n, k) for n, k, _ in g] == [(n, k) for n, k, _ in w]
        for (_, _, gv), (_, _, wv) in zip(g, w):
            np.testing.assert_allclose(_values(gv), _values(wv), rtol=RTOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_install_monitor_turns_the_fused_step_off():
    x, y = _blobs()
    mod, it = _module(tmx, x, y)
    assert mod._fused is not None
    batch = next(iter(it))
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    before = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mon = tmx.Monitor(1)
    mod.install_monitor(mon)
    assert mod._fused is None and mon.exes == mod._exec_group.execs
    # the classic path carries on from the fused step's params
    np.testing.assert_array_equal(
        mod._exec_group.execs[0].arg_dict["fc1_weight"].asnumpy(),
        before["fc1_weight"])
    mon.tic()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert len(mon.toc()) == 4
    with pytest.raises(AssertionError):
        tmx.mod.Module(_mlp(tmx), context=tmx.cpu()).install_monitor(mon)


def _sequential(pkg, loss_module):
    with pkg.name.NameManager():
        d1 = pkg.sym.Variable("data")
        body = pkg.sym.Activation(pkg.sym.FullyConnected(
            d1, num_hidden=12, name="fc1"), act_type="relu", name="relu1")
        d2 = pkg.sym.Variable("data")
        head = pkg.sym.FullyConnected(d2, num_hidden=3, name="fc2")
    if loss_module:
        first = pkg.mod.Module(pkg.sym.FullyConnected(
            body, num_hidden=3, name="fc2"), label_names=[],
            context=pkg.cpu())
        second = pkg.mod.PythonLossModule(grad_func=_hinge_grad)
    else:
        first = pkg.mod.Module(body, label_names=[], context=pkg.cpu())
        second = pkg.mod.Module(pkg.sym.SoftmaxOutput(head, name="softmax"),
                                context=pkg.cpu())
    seq = pkg.mod.SequentialModule()
    seq.add(first).add(second, take_labels=True, auto_wiring=True)
    return seq, first, second


def _hinge_grad(scores, labels):
    """example/module/python_loss.py's multiclass-hinge subgradient."""
    scores = scores.asnumpy()
    labels = labels.asnumpy().astype(int)
    rows = np.arange(scores.shape[0])
    margin = 1.0 + scores - scores[rows, labels][:, None]
    margin[rows, labels] = 0.0
    worst = margin.argmax(axis=1)
    grad = np.zeros_like(scores)
    np.subtract.at(grad, (rows, labels), 1.0)
    np.add.at(grad, (rows, worst), 1.0)
    return grad


@pytest.mark.parametrize("loss_module", [False, True],
                         ids=["softmax-head", "python-loss"])
def test_sequential_fit_equals_jax(loss_module):
    rng = np.random.RandomState(3)
    x = rng.randn(64, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0.5)
    params = _params({"fc1_weight": (12, 6), "fc1_bias": (12,),
                      "fc2_weight": (3, 12), "fc2_bias": (3,)})
    res = {}
    for pkg in (jmx, tmx):
        seq, first, _ = _sequential(pkg, loss_module)
        accs = []
        seq.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params=_nd(pkg, params), eval_metric="acc",
                batch_end_callback=lambda p: accs.append(
                    p.eval_metric.get()[1]))
        arg, _ = seq.get_params()
        res[pkg] = ({k: v.asnumpy() for k, v in arg.items()}, accs, first)
    (want, want_acc, _), (got, got_acc, first) = res[jmx], res[tmx]
    assert sorted(got) == sorted(want) == sorted(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.allclose(got[k], params[k])
    assert got_acc == want_acc and len(got_acc) == 8
    # the first member took head gradients: the classic path
    assert first._fused is None


def test_python_loss_module_alone():
    """tests/test_module.py:225 in the port."""
    m = tmx.mod.PythonLossModule(grad_func=lambda s, l: s.asnumpy()
                                 - l.asnumpy())
    m.bind(data_shapes=[("data", (4, 3))])
    x = tmx.nd.array(np.random.RandomState(0).rand(4, 3).astype(np.float32),
                     ctx=tmx.cpu())
    b = tmx.io.DataBatch(data=[x], label=[x], pad=0)
    m.forward(b, is_train=True)
    assert m.get_outputs()[0] is x
    m.backward()
    grads = m.get_input_grads()
    assert grads[0].shape == (4, 3) and grads[0].context == tmx.cpu()
    np.testing.assert_array_equal(grads[0].asnumpy(), 0.0)
    assert m.output_shapes == [("pyloss_output", (4, 3))]
    assert m.get_params() == ({}, {})
