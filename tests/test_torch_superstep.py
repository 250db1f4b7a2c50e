"""The superstep (``fit(superstep=K)``, ``Module.superstep_train``), the
metrics' device reducers and speculation in the port, on the CPU.

The cases of the reference's ``test_superstep.py`` that need no
``feed/``: K steps per drain equal K sequential fused steps bit for bit
(params, optimizer slots, step counts, metric values), with momentum
SGD and Adam, across an lr schedule, with a partial tail and through
``MXNET_SUPERSTEP``; each blocker (monitor, host-only metric,
``checkpoint_every % K``, a callback that inspects outputs) falls back
to K=1; each device reducer agrees with its host update within 1e-5;
the port's K=4 run agrees with the JAX package's K=4 run within rtol
1e-4, atol 1e-5 (float32 sums in other orders); and
``test_module.py::test_discarded_speculation_restores_num_update``.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck


def _mlp(pkg=mx):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data, num_hidden=8,
                                                  name="fc1"),
                           act_type="relu")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(h, num_hidden=3,
                                                        name="fc2"),
                                 name="softmax")


def _data(n=64, batch=16, pkg=mx):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 6).astype(np.float32)
    y = rng.randint(0, 3, n).astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=batch)


def _params0():
    rng = np.random.RandomState(11)
    return {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.5,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.5,
            "fc2_bias": np.zeros(3, np.float32)}


def _fit(superstep, n=64, num_epoch=2, metric="acc", sched=None,
         optimizer="sgd", monitor=None, pkg=mx, **opt_params):
    pkg.random.seed(7)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    met = pkg.metric.create(metric)
    opt_params.setdefault("learning_rate", 0.5)
    if sched is not None:
        opt_params["lr_scheduler"] = sched(pkg)
    arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in _params0().items()}
    mod.fit(_data(n, pkg=pkg), num_epoch=num_epoch, eval_metric=met,
            optimizer=optimizer, optimizer_params=opt_params,
            superstep=superstep, monitor=monitor, arg_params=arg)
    return mod, met


def _leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, prefix + "/" + str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, prefix + "/%d" % i))
    elif tree is not None:
        out[prefix] = tree.detach().cpu().numpy()
    return out


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _assert_bitwise(mod_a, mod_b):
    pa, pb = _params(mod_a), _params(mod_b)
    for k in pa:
        assert np.array_equal(pa[k], pb[k]), "param %s diverged" % k
    oa = _leaves(mod_a._fused.state["opt"])
    ob = _leaves(mod_b._fused.state["opt"])
    assert set(oa) == set(ob)
    for k in oa:
        assert np.array_equal(oa[k], ob[k]), "opt slot %s diverged" % k
    assert mod_a._fused_t == mod_b._fused_t
    assert float(mod_a._fused.state["t"]) == float(mod_b._fused.state["t"])
    assert mod_a._optimizer.num_update == mod_b._optimizer.num_update


# -- bitwise parity ------------------------------------------------------------

@pytest.mark.parametrize("metric", ["acc", "ce", ["acc", "ce"]],
                         ids=["acc", "ce", "composite"])
def test_superstep4_bitwise_matches_sequential(metric):
    m1, met1 = _fit(1, metric=metric, momentum=0.9)
    m4, met4 = _fit(4, metric=metric, momentum=0.9)
    assert m4._superstep_runs == 2 and m1._superstep_runs == 0
    _assert_bitwise(m1, m4)
    # the device totals run the same float32 additions one step at a
    # time and K steps per drain
    assert met1.get() == met4.get()
    stats = m4._superstep_stats.report()
    assert (stats["supersteps"], stats["steps"]) == (2, 8)


def test_superstep_adam_bitwise():
    m1, _ = _fit(1, optimizer="adam", learning_rate=0.01)
    m4, _ = _fit(4, optimizer="adam", learning_rate=0.01)
    _assert_bitwise(m1, m4)


def test_superstep_lr_scheduler_parity():
    def sched(pkg):
        return pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5)
    m1, _ = _fit(1, sched=sched, momentum=0.9)
    m4, _ = _fit(4, sched=sched, momentum=0.9)
    _assert_bitwise(m1, m4)
    assert m4._optimizer.lr_scheduler.state_dict() == \
        m1._optimizer.lr_scheduler.state_dict()


def test_superstep_partial_tail_trains_every_batch():
    m1, met1 = _fit(1, n=80, momentum=0.9)
    m4, met4 = _fit(4, n=80, momentum=0.9)
    _assert_bitwise(m1, m4)
    assert met4.num_inst == 80
    assert met1.get() == met4.get()


def test_superstep_env_knob(monkeypatch):
    monkeypatch.setenv("MXNET_SUPERSTEP", "4")
    m_env, _ = _fit(None, momentum=0.9)
    monkeypatch.delenv("MXNET_SUPERSTEP")
    m1, _ = _fit(1, momentum=0.9)
    assert m_env._superstep_runs
    _assert_bitwise(m1, m_env)


@pytest.mark.parametrize("optimizer,opt", [
    ("sgd", {"momentum": 0.9}), ("adam", {"learning_rate": 0.01})])
def test_superstep_matches_jax(optimizer, opt):
    got, gmet = _fit(4, metric=["acc", "ce"], optimizer=optimizer, **opt)
    want, wmet = _fit(4, metric=["acc", "ce"], optimizer=optimizer,
                      pkg=jmx, **opt)
    assert got._superstep_runs and want._superstep_progs
    pw = {k: v.asnumpy() for k, v in want.get_params()[0].items()}
    for k, v in _params(got).items():
        np.testing.assert_allclose(v, pw[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    (gn, gv), (wn, wv) = gmet.get(), wmet.get()
    assert gn == wn and gv[0] == wv[0]
    assert abs(gv[1] - wv[1]) < 1e-5


# -- fallbacks to K=1 ---------------------------------------------------------

def test_monitor_forces_per_batch():
    mod, _ = _fit(4, num_epoch=1, monitor=mx.monitor.Monitor(1))
    assert mod._fused is None and not mod._superstep_runs


def test_host_only_metric_falls_back(caplog):
    met = mx.metric.np_metric(
        lambda label, pred: float((np.argmax(pred, 1) == label).mean()))
    assert met.device_reducer() is None
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(_data(), num_epoch=1, eval_metric=met,
                optimizer_params={"learning_rate": 0.5}, superstep=4)
    assert not mod._superstep_runs
    assert met.num_inst == 4
    assert "has no device form" in caplog.text


def test_misaligned_checkpoint_every_falls_back(tmp_path):
    store = str(tmp_path / "store")
    mod, _ = _fit(4, num_epoch=1)
    assert mod._superstep_runs
    mx.random.seed(7)
    mod2 = mx.mod.Module(_mlp(), context=mx.cpu())
    mod2.fit(_data(), num_epoch=1, optimizer_params={"learning_rate": 0.5},
             superstep=4, checkpoint=store, checkpoint_every=3)
    assert not mod2._superstep_runs
    assert 3 in ck.all_steps(store)


def test_callback_inspects_outputs_falls_back():
    def cb(param):
        pass
    cb.inspects_outputs = True
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    mod.fit(_data(), num_epoch=1, optimizer_params={"learning_rate": 0.5},
            superstep=4, batch_end_callback=cb)
    assert not mod._superstep_runs


def test_batch_end_callback_fires_per_superstep():
    seen = []
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    mod.fit(_data(), num_epoch=1, optimizer_params={"learning_rate": 0.5},
            superstep=2, batch_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == [1, 3]


def test_pending_forward_blocks_superstep():
    mod, _ = _fit(1, num_epoch=1, momentum=0.9)
    batch = next(iter(_data()))
    mod.forward(batch, is_train=True)
    with pytest.raises(mx.base.MXNetError, match="uncommitted"):
        mod.superstep_train([batch, batch])
    mod.update()
    assert mod.superstep_train([batch, batch])


def test_dispatch_failure_rolls_counters_back(monkeypatch):
    mod, _ = _fit(1, num_epoch=1, momentum=0.9,
                  sched=lambda pkg: pkg.lr_scheduler.FactorScheduler(2, 0.5))
    before = (mod._fused_t, mod._optimizer.num_update,
              mod._optimizer.lr_scheduler.state_dict())

    def boom(*a, **k):
        raise RuntimeError("dispatch failed")
    monkeypatch.setattr(mod._fused, "superstep", boom)
    batch = next(iter(_data()))
    with pytest.raises(RuntimeError):
        mod.superstep_train([batch] * 3)
    assert (mod._fused_t, mod._optimizer.num_update,
            mod._optimizer.lr_scheduler.state_dict()) == before


def test_superstep_checkpoint_resume_bitwise(tmp_path):
    store = str(tmp_path / "store")
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    arg = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in _params0().items()}
    mod.fit(_data(n=80), num_epoch=1, arg_params=arg,
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            superstep=2, checkpoint=store, checkpoint_every=2)
    steps = ck.all_steps(store)
    assert 2 in steps and 4 in steps
    mx.random.seed(999)
    m2 = mx.mod.Module(_mlp(), context=mx.cpu())
    with ck.CheckpointManager(store, keep_last_n=None) as mgr:
        m2.fit(_data(n=80), num_epoch=2, superstep=2,
               optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
               checkpoint=mgr, resume=True)
    m_ref, _ = _fit(2, n=80, momentum=0.9)
    _assert_bitwise(m_ref, m2)


# -- device reducers ---------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("acc", {}), ("top_k_accuracy", {"top_k": 2}), ("ce", {}),
    ("mse", {}), ("mae", {}), ("rmse", {})])
def test_device_reducer_matches_host_update(name, kwargs):
    rng = np.random.RandomState(3)
    pred = rng.rand(32, 5).astype(np.float32)
    pred /= pred.sum(axis=1, keepdims=True)
    label = rng.randint(0, 5, 32).astype(np.float32)
    if name in ("mse", "mae", "rmse"):
        pred = rng.randn(32, 1).astype(np.float32)
        label = rng.randn(32).astype(np.float32)
    host = jmx.metric.create(name, **kwargs)
    host.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    dev = mx.metric.create(name, **kwargs)
    red = dev.device_reducer()
    assert red is not None
    acc = red.update(red.init("cpu"), [label],
                     [mx.nd.array(pred, ctx=mx.cpu())])
    red.absorb([float(a) for a in acc])
    hn, hv = host.get()
    dn, dv = dev.get()
    assert hn == dn
    assert abs(hv - dv) < 1e-5, (name, hv, dv)
    assert host.num_inst == dev.num_inst


def test_subclassed_host_metric_falls_back():
    class EveryOtherAcc(mx.metric.Accuracy):
        def _score(self, label, pred):
            return 0, label.size
    m = EveryOtherAcc()
    assert m.device_reducer() is None
    m.update([np.zeros(4)], [mx.nd.array(np.eye(4), ctx=mx.cpu())])
    assert m.get() == ("accuracy", 0.0) and m.num_inst == 4

    class WeightedAcc(mx.metric.Accuracy):
        def update(self, labels, preds):
            pass
    assert WeightedAcc().device_reducer() is None
    assert mx.metric.Accuracy().device_reducer() is not None


def test_composite_and_wrapped_reducers():
    assert mx.metric.create(["acc", "ce"]).device_reducer() is not None
    comp2 = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.np_metric(lambda l, p: 0.0)])
    assert comp2.device_reducer() is None
    rng = np.random.RandomState(4)
    pred = rng.rand(8, 3).astype(np.float32)
    label = rng.randint(0, 3, 8).astype(np.float32)
    extra = rng.rand(8, 1).astype(np.float32)
    for make in (lambda m: m.metric.OutputSlice("acc", 0, 1),
                 lambda m: m.metric.OutputMean(1)):
        host, dev = make(jmx), make(mx)
        host.update([jmx.nd.array(label)],
                    [jmx.nd.array(pred), jmx.nd.array(extra)])
        red = dev.device_reducer()
        acc = red.update(red.init("cpu"), [label],
                         [mx.nd.array(pred, ctx=mx.cpu()),
                          mx.nd.array(extra, ctx=mx.cpu())])
        red.absorb([float(a) for a in acc])
        assert dev.get()[0] == host.get()[0]
        assert abs(dev.get()[1] - host.get()[1]) < 1e-6


def test_speedometer_handles_superstep_jumps(caplog):
    from collections import namedtuple
    P = namedtuple("P", ["nbatch", "epoch", "eval_metric"])
    spd = mx.callback.Speedometer(batch_size=16, frequent=4)
    with caplog.at_level(logging.INFO):
        for n in (1, 3, 5, 7, 9):
            spd(P(nbatch=n, epoch=0, eval_metric=None))
    assert any("samples/sec" in r.message for r in caplog.records)


def test_integer_hit_counts_stay_exact_past_float32():
    """Hit counts and instance counts stay exact integers past 2**24,
    where a float32 total would round, one step at a time and per
    superstep."""
    big = 2 ** 24 + 1
    met = mx.metric.Accuracy()
    met.sum_metric, met.num_inst = big, big
    ones = mx.nd.array(np.ones(3), ctx=mx.cpu())
    met.update([np.ones(3)], [ones])
    assert (met.sum_metric, met.num_inst) == (big + 3, big + 3)
    red = met.device_reducer()
    acc = red.update(red.init("cpu"), [np.ones(3)], [ones])
    red.absorb([float(a) for a in acc])
    assert (met.sum_metric, met.num_inst) == (big + 6, big + 6)
    assert met.get() == ("accuracy", 1.0)


def test_metric_totals_stay_on_the_device_until_read():
    met = mx.metric.create("ce")
    before = mx.metric.host_syncs()
    rng = np.random.RandomState(5)
    for _ in range(3):
        pred = rng.rand(4, 3).astype(np.float32)
        met.update([rng.randint(0, 3, 4)], [mx.nd.array(pred, ctx=mx.cpu())])
    assert mx.metric.host_syncs() == before
    met.get()
    assert mx.metric.host_syncs() == before + 1


# -- speculation ---------------------------------------------------------------

def make_blobs(n=400, dim=10, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    X, y = [], []
    for _ in range(n):
        c = rng.randint(classes)
        X.append(centers[c] + rng.randn(dim) * 0.5)
        y.append(c)
    return np.asarray(X, dtype=np.float32), np.asarray(y, dtype=np.float32)


def test_discarded_speculation_restores_num_update():
    """``test_module.py::test_discarded_speculation_restores_num_update``
    on the port, and the state the discarded step wrote is put back."""
    np.random.seed(4)
    mx.random.seed(4)
    X, y = make_blobs(n=80)
    it = mx.io.NDArrayIter(X, y, batch_size=40)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    assert mod._fused is not None
    batches = list(it)
    start = _params(mod)
    mod.forward(batches[0], is_train=True)
    before = mod._optimizer.num_update
    early = mod.get_outputs()[0].asnumpy()
    assert mod._fused_next is not None
    assert mod._optimizer.num_update == before + 1
    # the step has not committed: params of record are the old ones
    for k, v in _params(mod).items():
        np.testing.assert_array_equal(v, start[k])
    mod.forward(batches[1], is_train=True)
    assert mod._fused_next is None
    assert mod._optimizer.num_update == before
    for k, v in mod._fused.state["params"].items():
        np.testing.assert_array_equal(v.detach().numpy(), start[k])
    mod.update()
    assert mod._optimizer.num_update == before + 1
    # an early step that commits equals the plain step
    mod2 = mx.mod.Module(_mlp(), context=mx.cpu())
    mod2.bind(it.provide_data, it.provide_label)
    mod2.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                 for k, v in start.items()})
    mod2.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    mod2.forward(batches[1], is_train=True)
    mod2.get_outputs()
    mod2.update()
    for k, v in _params(mod2).items():
        np.testing.assert_array_equal(v, _params(mod)[k])
    mod2.forward(batches[0], is_train=True)
    mod2.update()
    np.testing.assert_array_equal(mod2.get_outputs()[0].asnumpy().shape,
                                  early.shape)
