"""Several contexts in the port against the JAX package, on the CPU.

Distinct ``cpu(i)`` contexts stand for several devices (reference
``test_multi_device_exec.py:1-6``).  The MLP starts from one checkpoint
the JAX package wrote and trains 2 epochs of 4 batches of 8 through
``Module(context=[cpu(0), cpu(1)])`` in both packages, with kvstore
``local`` (auto-selected as ``local_update_cpu``), ``device`` and None,
``work_load_list`` [1, 1] and [1, 3], on the fused step (the first
device over the whole batch) and on the classic path
(``MXNET_FUSED_TRAIN=0``: one executor per device over its slice, the
gradients summed through the kvstore in context order): params within
rtol 1e-4, atol 1e-5 of the reference's (float32 sums in other orders).
Then the reference's ``test_ctx_group``,
``test_model_parallel_matches_single_device`` (``group2ctx``),
``test_module_multi_device_data_parallel`` and
``test_models.py::test_lstm_model_parallel_groups`` on the port, and the
executor manager's helpers.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package initializes the MLP and writes the pair both runs
    start from."""
    sym = jmx.models.get_mlp()
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (32, 784)).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.float32)
    jmx.random.seed(1)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind([("data", (8, 784))], [("softmax_label", (8,))])
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path_factory.mktemp("md") / "mlp")
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    return prefix, x, y


def _fit(pkg, prefix, x, y, kvstore, wl):
    if pkg is jmx:
        sym, arg, aux = jmx.model.load_checkpoint(prefix, 0)
    else:
        sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    mod = pkg.mod.Module(sym, context=[pkg.cpu(0), pkg.cpu(1)],
                         work_load_list=wl)
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
            kvstore=kvstore, optimizer_params=dict(OPT), arg_params=arg,
            aux_params=aux)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("path", ["fused", "classic"])
@pytest.mark.parametrize("wl", [[1, 1], [1, 3]], ids=["even", "1-3"])
@pytest.mark.parametrize("kvstore", ["local", "device", None],
                         ids=["local", "device", "none"])
def test_data_parallel_matches_jax(reference, kvstore, wl, path,
                                   monkeypatch):
    prefix, x, y = reference
    if path == "classic":
        monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    mod, got = _fit(tmx, prefix, x, y, kvstore, wl)
    _, want = _fit(jmx, prefix, x, y, kvstore, wl)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if path == "fused":
        assert mod._fused is not None
        return
    assert mod._fused is None and len(mod._exec_group.execs) == 2
    sizes = [s.stop - s.start for s in mod._exec_group.slices]
    assert sizes == ([4, 4] if wl == [1, 1] else [2, 6])
    want_kv = {"local": "local_update_cpu", "device": "device",
               None: None}[kvstore]
    assert (mod._kvstore.type if mod._kvstore else None) == want_kv


def test_duplicate_contexts_take_the_classic_path(reference, monkeypatch):
    """[cpu(0), cpu(0)] is how several devices run on one card: two
    executors, classic steps, equal to one context's fused run."""
    prefix, x, y = reference
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    mods = {}
    for ctx in ([tmx.cpu(0), tmx.cpu(0)], [tmx.cpu(0)]):
        mod = tmx.mod.Module(sym, context=ctx)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                kvstore="device", optimizer_params=dict(OPT),
                arg_params=arg, aux_params=aux)
        mods[len(ctx)] = mod
    assert mods[2]._fused is None and mods[1]._fused is not None
    two, one = (
        {k: v.asnumpy() for k, v in m.get_params()[0].items()}
        for m in (mods[2], mods[1]))
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_executor_manager_helpers_equal_jax():
    from mxnet_tpu import executor_manager as jem
    tem = tmx.executor_manager
    for bs, wl in ((8, [1, 1]), (10, [1, 3]), (7, [2, 1, 1])):
        assert tem._split_input_slice(bs, wl) == jem._split_input_slice(
            bs, wl)
    with pytest.raises(ValueError, match="empty"):
        tem._split_input_slice(2, [1, 1, 1])
    a = tmx.sym.Variable("a")
    dup = tmx.sym.Group([tmx.sym.FullyConnected(a, num_hidden=2, name="f"),
                         tmx.sym.FullyConnected(a, num_hidden=2, name="f")])
    with pytest.raises(ValueError, match="duplicated"):
        tem._check_arguments(dup)
    # the manager over two devices: per-device executors on the slices,
    # and copy_to averages over them
    sym = tmx.models.get_mlp()
    it = tmx.io.NDArrayIter(np.ones((8, 784), np.float32), np.zeros(8),
                            batch_size=8)
    args = sym.list_arguments()
    params = [n for n in args if n not in ("data", "softmax_label")]
    mgr = tem.DataParallelExecutorManager(
        sym, [tmx.cpu(0), tmx.cpu(1)], it, params, args,
        sym.list_auxiliary_states(), work_load_list=[1, 3])
    assert [e.arg_dict["data"].shape[0] for e in mgr.execgrp.train_execs] \
        == [2, 6]
    arg = {n: tmx.nd.zeros(mgr.param_arrays[i][0].shape, ctx=tmx.cpu())
           for i, n in enumerate(params)}
    mgr.param_arrays[0][0][:] = 1.0
    mgr.param_arrays[0][1][:] = 3.0
    mgr.copy_to(arg, {})
    assert float(arg[params[0]].asnumpy().mean()) == 2.0
    batch = next(iter(it))
    mgr.load_data_batch(batch)
    mgr.forward(is_train=True)
    mgr.backward()
    metric = tmx.metric.create("acc")
    mgr.update_metric(metric, batch.label)
    assert metric.num_inst == 8


def _ctx_group_net(mx):
    with mx.AttrScope(ctx_group="stage1"):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=16)
        act1 = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    set_stage1 = set(act1.list_arguments())
    with mx.AttrScope(ctx_group="stage2"):
        fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=8)
        act2 = mx.sym.Activation(data=fc2, name="relu2", act_type="relu")
        fc3 = mx.sym.FullyConnected(data=act2, name="fc3", num_hidden=4)
        mlp = mx.sym.SoftmaxOutput(data=fc3, name="softmax")
    return mlp, set_stage1


def test_ctx_group():
    """The reference's test_ctx_group, with the outputs and gradients
    held to the JAX package's."""
    outs = {}
    rng = np.random.RandomState(0)
    vals = {"data": rng.randn(8, 10).astype(np.float32)}
    for n, sh in (("fc1_weight", (16, 10)), ("fc2_weight", (8, 16)),
                  ("fc3_weight", (4, 8))):
        vals[n] = rng.randn(*sh).astype(np.float32) * 0.1
    for mx in (tmx, jmx):
        mlp, set_stage1 = _ctx_group_net(mx)
        set_stage2 = set(mlp.list_arguments()) - set_stage1 - \
            {"softmax_label"}
        group2ctx = {"stage1": mx.cpu(1), "stage2": mx.cpu(2)}
        texec = mlp.simple_bind(mx.cpu(0), group2ctx=group2ctx,
                                data=(8, 10), softmax_label=(8,))
        for name, arr in texec.arg_dict.items():
            if name in set_stage1:
                assert arr.context == group2ctx["stage1"], name
            elif name in set_stage2:
                assert arr.context == group2ctx["stage2"], name
        for n, v in vals.items():
            texec.arg_dict[n][:] = v
        texec.forward(is_train=True)
        out = texec.outputs[0].asnumpy()
        assert out.shape == (8, 4)
        assert np.allclose(out.sum(axis=1), 1, atol=1e-5)
        texec.backward()
        outs[mx] = [out] + [texec.grad_dict[n].asnumpy()
                            for n in ("fc1_weight", "fc3_weight")]
    for g, w in zip(outs[tmx], outs[jmx]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_model_parallel_matches_single_device():
    """The reference's test (test_model_parallel.py) on the port: the
    model-parallel forward and backward equal the single-context ones."""
    mx = tmx
    np.random.seed(0)
    shape = (4, 5)
    data1 = mx.sym.Variable("data1")
    data2 = mx.sym.Variable("data2")
    data3 = mx.sym.Variable("data3")
    with mx.AttrScope(ctx_group="dev1"):
        net = data1 + data2
        net = net * 3.0
    with mx.AttrScope(ctx_group="dev2"):
        net = net + data3
    arr = [mx.nd.array(np.random.rand(*shape), ctx=mx.cpu())
           for _ in range(3)]
    names = ["data1", "data2", "data3"]
    results = []
    for group2ctx in (None, {"dev1": mx.cpu(3), "dev2": mx.cpu(4)}):
        grads = [mx.nd.empty(shape, ctx=mx.cpu()) for _ in range(3)]
        exe = net.bind(mx.cpu(), args=dict(zip(names, arr)),
                       args_grad=dict(zip(names, grads)),
                       group2ctx=group2ctx)
        exe.forward(is_train=True)
        out = exe.outputs[0].asnumpy()
        exe.backward([mx.nd.ones(shape, ctx=mx.cpu())])
        results.append([out] + [g.asnumpy() for g in grads])
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_lstm_model_parallel_groups():
    """``test_models.py::test_lstm_model_parallel_groups`` on the port:
    ``models/lstm.py``'s ctx_group attributes bind with group2ctx, and
    the outputs equal the ungrouped bind's bit for bit."""
    mx = tmx
    net = mx.models.lstm_unroll(num_lstm_layer=2, seq_len=2, input_size=20,
                                num_hidden=8, num_embed=4, num_label=20,
                                ctx_groups=["g0", "g1"])
    bs = 2
    shapes = {"data": (bs, 2), "softmax_label": (bs, 2)}
    for i in range(2):
        shapes["l%d_init_c" % i] = (bs, 8)
        shapes["l%d_init_h" % i] = (bs, 8)
    outs = []
    rng = np.random.RandomState(0)
    init = {}
    for group2ctx in ({"g0": mx.cpu(1), "g1": mx.cpu(2)}, None):
        ex = net.simple_bind(mx.cpu(0), group2ctx=group2ctx, **shapes)
        for n, a in ex.arg_dict.items():
            if n not in init:
                init[n] = rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
            a[:] = init[n]
        ex.arg_dict["data"][:] = np.zeros((bs, 2), "f")
        ex.forward(is_train=True)
        outs.append(ex.outputs[0].asnumpy())
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def make_blobs(n=400, dim=10, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    X, y = [], []
    for _ in range(n):
        c = rng.randint(classes)
        X.append(centers[c] + rng.randn(dim) * 0.5)
        y.append(c)
    return np.asarray(X, dtype=np.float32), np.asarray(y, dtype=np.float32)


def test_module_multi_device_data_parallel(monkeypatch):
    """``test_module.py::test_module_multi_device_data_parallel`` on the
    port, on the fused step and on the classic path."""
    mx = tmx
    for fused in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSED_TRAIN", fused)
        np.random.seed(0)
        mx.random.seed(0)
        X, y = make_blobs()
        it = mx.io.NDArrayIter(X, y, batch_size=40, shuffle=True)
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=[mx.cpu(i) for i in range(4)])
        mod.fit(it, num_epoch=5, optimizer_params={"learning_rate": 0.5})
        acc = mod.score(it, "acc")
        assert acc[0][1] > 0.95, acc
        assert (mod._fused is not None) == (fused == "1")
