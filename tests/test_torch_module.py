"""The port's training loop against the JAX package's, on the CPU.

* ``NDArrayIter``: batches, pads and orders equal the reference's exactly
  (pad, discard, roll_over; shuffle from one numpy seed).
* Metrics: values equal the reference's on the same predictions
  (argmax ties pick the lowest index in both).
* Trajectories: the MLP (784-128-64-10), LeNet (1x28x28) and a
  ResNet-CIFAR of depth 8 (BatchNorm aux states) start from one
  checkpoint the JAX package wrote and run ``Module.fit`` for 2 epochs of
  4 batches in both packages: SGD, lr 0.05, momentum 0.9, wd 1e-4.
  The first step's params and aux agree within rtol 1e-4, atol 1e-5
  (float32 sums run in other orders in XLA and PyTorch: ~1e-6 relative
  per step).  After 8 steps the MLP's and LeNet's still do, at the same
  tolerance; ResNet-CIFAR's are held to a relative L2 difference of 1e-2
  over all params and aux, and each tensor to 0.1 of its largest value
  (of 1e-2 for the BatchNorm betas and means, which start at 0),
  because its relus sit after BatchNorm: about one pre-activation a step
  lies within float32 rounding of 0, the two packages gate it
  differently, and that one element moves the next gradients by a few
  percent (found and measured on this data: one gate in 131,072 flipped
  at step 2 and moved conv weight gradients by 3% of their largest
  value; 8 steps end at a relative L2 difference of 4.4e-3).  The
  per-batch training accuracy is equal for all three, and the port's
  fused and classic (``MXNET_FUSED_TRAIN=0``) paths agree within rtol
  1e-5, atol 1e-6 (the same kernels; only the optimizer's scalar factors
  fold in another precision).
* Checkpoints written by ``Module.save_checkpoint`` in either package
  load in the other; ResNet-50's arguments, aux states, shapes and JSON
  equal the reference's.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.module.fused import WARMUP_STEPS

TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
RELU_AFTER_BN = {"resnet-cifar8"}
KINK_L2, KINK_SCALE = 1e-2, 0.1
PATH_RTOL, PATH_ATOL = 1e-5, 1e-6
OPT_PARAMS = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


# -- NDArrayIter --------------------------------------------------------------

def _batches(pkg, epochs=2, **kw):
    rng = np.random.RandomState(0)
    data = rng.rand(10, 3).astype(np.float32)
    label = np.arange(10, dtype=np.float32)
    np.random.seed(11)
    it = pkg.io.NDArrayIter(data, label, batch_size=4, **kw)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out, it.provide_data, it.provide_label


@pytest.mark.parametrize("kw", [
    {}, {"last_batch_handle": "discard"}, {"last_batch_handle": "roll_over"},
    {"shuffle": True}, {"shuffle": True, "last_batch_handle": "roll_over"}],
    ids=["pad", "discard", "roll_over", "shuffle-pad", "shuffle-roll_over"])
def test_ndarray_iter_equals_jax(kw):
    want, wpd, wpl = _batches(jmx, **kw)
    got, gpd, gpl = _batches(tmx, **kw)
    assert (gpd, gpl) == (wpd, wpl)
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_ndarray_iter_batches_live_on_the_host():
    it = tmx.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    batch = next(iter(it))
    assert batch.data[0].context == tmx.cpu() and batch.label == []
    assert tmx.io.DataDesc("data", (2, 2)).shape == (2, 2)


# -- metrics --------------------------------------------------------------------

def _preds(seed, rows=12, classes=5):
    rng = np.random.RandomState(seed)
    pred = rng.rand(rows, classes).astype(np.float32)
    pred[0, :] = 0.5          # an all-tie row: argmax is class 0
    pred[1, 1] = pred[1, 3] = 2.0
    label = rng.randint(0, classes, rows).astype(np.float32)
    label[0], label[1] = 0, 1
    return label, pred


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(axis=1)).sum()), label.size


METRICS = [
    ("acc", lambda m: m.metric.create("acc")),
    ("top_k", lambda m: m.metric.create("top_k_accuracy", top_k=3)),
    ("ce", lambda m: m.metric.create("ce")),
    ("mae", lambda m: m.metric.MAE()),
    ("mse", lambda m: m.metric.MSE()),
    ("rmse", lambda m: m.metric.RMSE()),
    ("torch", lambda m: m.metric.create("torch")),
    ("custom", lambda m: m.metric.CustomMetric(_feval, name="dist")),
    ("np", lambda m: m.metric.np(_feval)),
    ("composite", lambda m: m.metric.create(["acc", "ce"])),
    ("slice", lambda m: m.metric.OutputSlice("acc", 0, 1)),
    ("mean", lambda m: m.metric.OutputMean(1)),
]


@pytest.mark.parametrize("name,make", METRICS, ids=[m[0] for m in METRICS])
def test_metric_values_equal_jax(name, make):
    got_m, want_m = make(tmx), make(jmx)
    for seed in (1, 2):
        label, pred = _preds(seed)
        if name in ("mae", "mse", "rmse"):
            pred = pred[:, :1]
        preds_t = [tmx.nd.array(pred, ctx=tmx.cpu())]
        preds_j = [jmx.nd.array(pred)]
        labels = [label]
        if name in ("slice", "mean"):
            preds_t.append(tmx.nd.array(pred[:, :1], ctx=tmx.cpu()))
            preds_j.append(jmx.nd.array(pred[:, :1]))
        got_m.update(labels, preds_t)
        want_m.update(labels, preds_j)
    got, want = got_m.get_name_value(), want_m.get_name_value()
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6)
    if name == "acc":
        assert got == want          # exact: integer hit counts
        got_m.reset()
        assert np.isnan(got_m.get()[1]) and got_m.sum_metric == 0


def test_f1_equals_jax():
    rng = np.random.RandomState(3)
    pred = rng.rand(20, 2).astype(np.float32)
    label = rng.randint(0, 2, 20).astype(np.float32)
    a, b = tmx.metric.create("f1"), jmx.metric.create("f1")
    a.update([label], [tmx.nd.array(pred, ctx=tmx.cpu())])
    b.update([label], [jmx.nd.array(pred)])
    assert a.get() == b.get()


# -- trajectories -----------------------------------------------------------------

def _lenet_data(rng, n):
    return rng.uniform(0, 1, (n, 1, 28, 28)).astype(np.float32)


MODELS = {
    "mlp": (lambda m: m.models.get_mlp(),
            lambda r, n: r.uniform(-1, 1, (n, 784)).astype(np.float32),
            10, 8),
    "lenet": (lambda m: m.models.get_lenet(), _lenet_data, 10, 8),
    "resnet-cifar8": (lambda m: m.models.get_resnet_cifar(depth=8),
                      lambda r, n: r.uniform(-1, 1, (n, 3, 32, 32))
                      .astype(np.float32), 10, 8),
}


def _reference_checkpoint(tmp_path, name):
    """The JAX package initializes the model (Xavier, seeded) and writes
    the checkpoint pair both runs start from."""
    build, data_fn, classes, batch = MODELS[name]
    sym = build(jmx)
    rng = np.random.RandomState(0)
    x = data_fn(rng, 4 * batch)
    y = rng.randint(0, classes, 4 * batch).astype(np.float32)
    jmx.random.seed(1)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind([("data", (batch,) + x.shape[1:])],
             [("softmax_label", (batch,))])
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / name)
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    return prefix, x, y, batch


def _fit(pkg, prefix, x, y, batch, **fit_kw):
    if pkg is jmx:
        sym, arg, aux = jmx.model.load_checkpoint(prefix, 0)
    else:
        sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    accs = []
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params=dict(OPT_PARAMS), arg_params=arg,
            aux_params=aux, eval_metric="acc",
            batch_end_callback=lambda p: accs.append(p.eval_metric.get()),
            **fit_kw)
    a, x_ = mod.get_params()
    return mod, ({k: v.asnumpy() for k, v in a.items()},
                 {k: v.asnumpy() for k, v in x_.items()}), accs


def _assert_params(got, want, rtol, atol):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def _assert_close_through_kinks(got, want):
    num = sum(float(((g[k] - w[k]) ** 2).sum())
              for g, w in zip(got, want) for k in w)
    den = sum(float((w[k] ** 2).sum()) for w in want for k in w)
    assert np.sqrt(num / den) < KINK_L2
    for g, w in zip(got, want):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= \
                KINK_SCALE * max(np.abs(w[k]).max(), 1e-2), k


def _one_step(pkg, prefix, x, y, batch):
    if pkg is jmx:
        sym, arg, aux = jmx.model.load_checkpoint(prefix, 0)
    else:
        sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT_PARAMS))
    mod.forward_backward(next(iter(it)))
    mod.update()
    a, x_ = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x_.items()})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_trajectory_matches_jax(name, tmp_path, monkeypatch):
    prefix, x, y, batch = _reference_checkpoint(tmp_path, name)
    _assert_params(_one_step(tmx, prefix, x, y, batch),
                   _one_step(jmx, prefix, x, y, batch), TRAJ_RTOL, TRAJ_ATOL)
    _, want, want_acc = _fit(jmx, prefix, x, y, batch)
    mod, got, got_acc = _fit(tmx, prefix, x, y, batch)
    if name in RELU_AFTER_BN:
        _assert_close_through_kinks(got, want)
    else:
        _assert_params(got, want, TRAJ_RTOL, TRAJ_ATOL)
    assert got_acc == want_acc
    # the fused step ran every batch, eagerly on the CPU
    assert mod._fused is not None
    assert mod._fused.stats.report() == {"captures": 0, "replays": 0,
                                         "eager_steps": 8}
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    classic_mod, classic, classic_acc = _fit(tmx, prefix, x, y, batch)
    assert classic_mod._fused is None
    _assert_params(classic, got, PATH_RTOL, PATH_ATOL)
    assert classic_acc == got_acc
    if name.startswith("resnet"):
        assert got[1] and all(v.any() for v in got[1].values())


def test_checkpoints_cross_between_packages(tmp_path):
    prefix, x, y, batch = _reference_checkpoint(tmp_path, "lenet")
    mod, (arg, aux), _ = _fit(tmx, prefix, x, y, batch)
    port_prefix = str(tmp_path / "port")
    mod.save_checkpoint(port_prefix, 2, save_optimizer_states=False)
    assert tmx.checkpoint.latest_step(port_prefix + "-ckpt") is None
    # with the optimizer state: the pair and the train state as step 2,
    # which the reference's discovery finds
    mod.save_checkpoint(port_prefix, 2)
    assert jmx.checkpoint.latest_step(port_prefix + "-ckpt") == 2
    sym, jarg, jaux = jmx.model.load_checkpoint(port_prefix, 2)
    assert sym.tojson() == mod.symbol.tojson()
    for k, v in arg.items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v)
    # the reference's checkpoint loads in the port with the reference's
    # values, and a port module scores with them as the reference does
    tsym, targ, _ = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    jsym, jarg0, _ = jmx.model.load_checkpoint(prefix, 0)
    for k, v in jarg0.items():
        np.testing.assert_array_equal(targ[k].asnumpy(), v.asnumpy())
    scores = []
    for pkg, s, a in ((tmx, tsym, targ), (jmx, jsym, jarg0)):
        m = pkg.mod.Module(s, context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=batch)
        m.bind(it.provide_data, it.provide_label, for_training=False)
        m.set_params(a, {})
        scores.append(m.score(it, "acc"))
    assert scores[0] == scores[1]


def test_resnet50_symbol_equals_jax():
    shapes = {"data": (2, 3, 224, 224)}
    # fresh name managers: the auto-named Flatten counts from 0 in both
    with tmx.name.NameManager():
        a = tmx.models.get_resnet50()
    with jmx.name.NameManager():
        b = jmx.models.get_resnet50()
    assert a.list_arguments() == b.list_arguments()
    assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert a.list_outputs() == b.list_outputs()
    sa, sb = a.infer_shape(**shapes), b.infer_shape(**shapes)
    for x, y in zip(sa, sb):
        assert [tuple(s) for s in x] == [tuple(s) for s in y]
    assert a.tojson() == b.tojson()
    assert len(a.list_auxiliary_states()) == 2 * 53


# -- the fused path's edges ---------------------------------------------------------

def _mlp_module(batch=4, **opt):
    sym = tmx.models.get_mlp()
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind([("data", (batch, 784))], [("softmax_label", (batch,))])
    tmx.random.seed(0)
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=dict(OPT_PARAMS, **opt))
    return mod


def _mlp_batches(n=4, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    it = tmx.io.NDArrayIter(rng.uniform(-1, 1, (n * batch, 784)),
                            rng.randint(0, 10, n * batch), batch_size=batch)
    return list(it)


def _params_np(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_hparam_change_leaves_the_fused_path_with_its_state(monkeypatch):
    """Changing wd mid-training takes _disable_fused: the classic updater
    continues from the fused step's params, momentum and step count, as
    a classic-only run that changes wd at the same step does."""
    batches = _mlp_batches()
    fused = _mlp_module()
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    classic = _mlp_module()
    monkeypatch.delenv("MXNET_FUSED_TRAIN")
    assert fused._fused is not None and classic._fused is None
    for i, b in enumerate(batches):
        if i == 2:
            fused._optimizer.wd = classic._optimizer.wd = 0.01
        for mod in (fused, classic):
            mod.forward_backward(b)
            mod.update()
    assert fused._fused is None
    got, want = _params_np(fused), _params_np(classic)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PATH_RTOL,
                                   atol=PATH_ATOL, err_msg=k)


def test_explicit_head_gradients_leave_the_fused_path():
    mod = _mlp_module()
    b = _mlp_batches(1)[0]
    mod.forward(b, is_train=True)
    mod.backward([tmx.nd.zeros((4, 10), ctx=tmx.cpu())])
    assert mod._fused is None
    before = _params_np(mod)
    mod.update()
    # SoftmaxOutput ignores the head gradient: the step still moves
    assert any(not np.array_equal(before[k], v)
               for k, v in _params_np(mod).items())


def test_outputs_before_update_commit_nothing_and_eval_uses_live_params():
    mod = _mlp_module()
    b = _mlp_batches(1)[0]
    mod.forward(b, is_train=True)
    early = mod.get_outputs()[0].asnumpy()
    before = _params_np(mod)
    mod.update()
    after_outs = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(early, after_outs, rtol=1e-6)
    assert not np.array_equal(before["fc1_weight"],
                              _params_np(mod)["fc1_weight"])
    mod.forward(b, is_train=False)
    live = mod.get_outputs()[0].asnumpy()
    assert not np.allclose(live, after_outs)
    pred = mod.predict(tmx.io.NDArrayIter(b.data[0].asnumpy(),
                                          batch_size=4))
    np.testing.assert_allclose(pred.asnumpy(), live, rtol=1e-6)


def test_fit_rejects_unported_options():
    mod = tmx.mod.Module(tmx.models.get_mlp(), context=tmx.cpu())
    it = tmx.io.NDArrayIter(np.zeros((4, 784)), np.zeros(4), batch_size=4)
    for kw, item in (({"mesh": "dp=1", "sharding": "auto"}, "item 10c"),
                     ({"autotune": True}, "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            mod.fit(it, num_epoch=1, **kw)
    # a mesh wider than the process group (one process here) is refused
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmx.mod.Module(tmx.models.get_mlp(), context=tmx.cpu()).fit(
            it, num_epoch=1, mesh="dp=2")


def test_callbacks_and_epoch_checkpoints(tmp_path, caplog):
    mod = _mlp_module()
    it = tmx.io.NDArrayIter(np.random.RandomState(0).rand(8, 784), np.zeros(8),
                            batch_size=4)
    prefix = str(tmp_path / "cb")
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2,
                batch_end_callback=[tmx.callback.Speedometer(4, 1),
                                    tmx.callback.log_train_metric(1)],
                epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    assert "samples/sec" in caplog.text
    sym, arg, _ = tmx.model.load_checkpoint(prefix, 2, ctx=tmx.cpu())
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v.asnumpy())
    # with the module: the train state too, as step 3 under prefix-ckpt
    tmx.callback.do_checkpoint(prefix, module=mod)(2, mod.symbol, *
                                                   mod.get_params())
    tree, meta = tmx.checkpoint.CheckpointManager(
        prefix + "-ckpt", async_save=False).restore()
    assert meta["step"] == 3 and meta["epoch"] == 3
    np.testing.assert_array_equal(
        np.asarray(tree["params"]["fc1_weight"]),
        mod.get_params()[0]["fc1_weight"].asnumpy())


def test_fused_step_counts_and_graph_stats_on_cpu():
    mod = _mlp_module()
    for b in _mlp_batches(3):
        mod.forward_backward(b)
        mod.update()
    fused = mod._fused
    assert not fused.captured
    assert fused.stats.report() == {"captures": 0, "replays": 0,
                                    "eager_steps": 3}
    assert float(fused.state["t"]) == 3.0 and mod._optimizer.num_update == 3
    assert isinstance(fused.state["params"]["fc1_weight"], torch.Tensor)


def test_capture_failure_raises_and_runs_no_eager_step(monkeypatch):
    """On a CUDA context the step past its warm-up is captured; a capture
    that fails raises out of update(), and no eager step runs in its
    place (the state does not move)."""
    mod = _mlp_module()
    fused = mod._fused
    monkeypatch.setattr(type(fused), "captured", property(lambda s: True))

    class Refused(RuntimeError):
        pass

    class FakeGraph:
        pass

    def refuse(graph):
        raise Refused("capture refused")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    b = _mlp_batches(1)[0]
    mod.forward(b, is_train=True)
    # its warm-up steps done: the next step is the capture
    fused._warm[fused._key(mod._fused_pending)] = WARMUP_STEPS
    before = {k: v.detach().clone()
              for k, v in fused.state["params"].items()}
    with pytest.raises(Refused):
        mod.update()
    assert fused.stats.report() == {"captures": 0, "replays": 0,
                                    "eager_steps": 0}
    for k, v in fused.state["params"].items():
        assert torch.equal(v.detach(), before[k]), k


def test_input_gradients_through_the_classic_path():
    """inputs_need_grad keeps the module on the classic path; the input
    gradient equals the executor's."""
    sym = tmx.models.get_mlp()
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind([("data", (4, 784))], [("softmax_label", (4,))],
             inputs_need_grad=True)
    tmx.random.seed(0)
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer_params=dict(OPT_PARAMS))
    assert mod._fused is None
    b = _mlp_batches(1)[0]
    mod.forward_backward(b)
    (got,) = mod.get_input_grads()
    arg, _ = mod.get_params()
    exe = sym.simple_bind(tmx.cpu(), data=(4, 784))
    exe.copy_params_from(arg)
    exe.arg_dict["data"][:] = b.data[0]
    exe.arg_dict["softmax_label"][:] = b.label[0]
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_array_equal(got.asnumpy(),
                                  exe.grad_dict["data"].asnumpy())
