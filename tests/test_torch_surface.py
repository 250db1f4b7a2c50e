"""The port's NDArray/Symbol/Executor/Module surface and its small modules
against the JAX package, on the CPU.

Each test feeds both packages the same seeded numpy inputs and compares:
NDArray writes and views, ``file://`` paths, symbol and executor
introspection, ``Module.reshape`` and ``bind(no_slice_names=)``, a
quantized graph bound by ``simple_bind``, ``PassPipeline``'s ordering
error and stats, the top-level names, ``engine``/``misc``/``symbol_doc``/
``libinfo``, and the fault plane's schedule.

Tolerances: integer results, token ids, fault schedules and strings are
compared exactly; float results of one op are bitwise equal unless a
test says otherwise; a trained model's parameters agree to 1e-5.
"""
import ast
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.engine
import mxnet_tpu.faults
import mxnet_tpu.libinfo
import mxnet_tpu.misc
import mxnet_tpu.symbol_doc
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _both(fn):
    """fn(pkg) for the JAX package and the port."""
    return fn(mx), fn(mt)


# -- fault 1: NDArray writes ---------------------------------------------------

@pytest.mark.parametrize("key", [1, slice(1, 3), slice(None), slice(0, 2),
                                 slice(2, None)])
def test_setitem_int_and_slice_keys_match_jax(key):
    shape = (3, 4, 2)
    v = np.random.RandomState(0).randn(*shape)[key].astype(np.float64)

    def run(pkg):
        out = []
        for value in (7, v, pkg.nd.array(v)):
            x = pkg.nd.zeros(shape)
            x[key] = value
            out.append(x.asnumpy())
        return out
    for a, b in zip(*_both(run)):
        np.testing.assert_array_equal(a, b)


def test_setitem_tuple_key_and_dtype_cast():
    x = mt.nd.zeros((3, 4), dtype=np.int32)
    x[1, 1:3] = np.array([2.7, -3.9])       # cast to int32: toward zero
    x[(2, 0)] = 5
    ref = np.zeros((3, 4), np.int32)
    ref[1, 1:3] = np.array([2.7, -3.9]).astype(np.int32)
    ref[2, 0] = 5
    np.testing.assert_array_equal(x.asnumpy(), ref)
    assert x.dtype == np.int32
    for bad in (slice(None, None, 2), -1, 3, slice(-1, None),
                slice(0, 9)):
        for pkg, arr in ((mt, x), (mx, mx.nd.zeros((3, 4)))):
            with pytest.raises(pkg.MXNetError):
                arr[bad] = 1


def test_slice_and_reshape_views_write_through():
    def run(pkg):
        a = pkg.nd.array(np.arange(12).reshape(3, 4))
        r = a.reshape((4, 3))
        r[1:3] = -1
        row = a[2]
        row[:] = 7
        s = a[0:2]
        s[:] = s.asnumpy() * 10
        return a.asnumpy(), r.asnumpy(), row.asnumpy()
    for x, y in zip(*_both(run)):
        np.testing.assert_array_equal(x, y)


# -- fault 2: NDArray methods --------------------------------------------------

def test_ndarray_methods_match_jax():
    src = np.random.RandomState(1).randn(1, 3).astype(np.float32)

    def run(pkg):
        a = pkg.nd.array(src)
        b = a.broadcast_to((4, 3))
        c = a.astype(np.int32)
        return (b.asnumpy(), c.asnumpy(), c.dtype, a.T.asnumpy(), a.ndim,
                str(a.ctx), a.as_in_context(pkg.cpu()).asnumpy(),
                a.writable)
    for x, y in zip(*_both(run)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    a = mt.nd.array(src)
    assert a.as_in_context(mt.cpu()) is a
    assert a.handle is a._get()
    a.wait_to_read()
    a.wait_to_write()
    with pytest.raises(mt.MXNetError):
        a.broadcast_to((4, 2))


def test_read_only_array_refuses_writes():
    a = mt.nd.ones((2, 2))
    a.writable = False
    view = a[0]
    with pytest.raises(mt.MXNetError, match="read-only"):
        a[:] = 0
    with pytest.raises(mt.MXNetError, match="read-only"):
        view[:] = 0
    np.testing.assert_array_equal(a.asnumpy(), np.ones((2, 2)))


# -- fault 3: file:// paths ------------------------------------------------------

def test_save_load_file_uri_both_ways(tmp_path):
    v = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    jpath = "file://" + str(tmp_path / "j.nd")
    tpath = "file://" + str(tmp_path / "t.nd")
    mx.nd.save(jpath, {"a": mx.nd.array(v)})
    mt.nd.save(tpath, {"a": mt.nd.array(v)})
    np.testing.assert_array_equal(mt.nd.load(jpath)["a"].asnumpy(), v)
    np.testing.assert_array_equal(mx.nd.load(tpath)["a"].asnumpy(), v)
    with pytest.raises(mt.MXNetError, match="bogus-scheme"):
        mt.nd.save("bogus-scheme://bucket/x.nd", {"a": mt.nd.ones((2,))})
    assert not os.path.exists("bogus-scheme:")


def test_checkpoint_pair_through_file_uri(tmp_path):
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
    w = {"fc_weight": mt.nd.array(np.eye(3, 4)), "fc_bias": mt.nd.zeros(3)}
    prefix = "file://" + str(tmp_path / "m")
    mt.model.save_checkpoint(prefix, 1, net, w, {})
    sym, arg, _ = mx.model.load_checkpoint(prefix, 1)
    assert sym.list_arguments() == net.list_arguments()
    sym2, arg2, _ = mt.model.load_checkpoint(prefix, 1)
    assert sym2.tojson() == net.tojson()
    np.testing.assert_array_equal(arg2["fc_weight"].asnumpy(),
                                  arg["fc_weight"].asnumpy())


# -- fault 4: introspection ------------------------------------------------------

def _attr_graph(pkg):
    with pkg.name.NameManager():
        with pkg.AttrScope(group="4", data="great"):
            data = pkg.sym.Variable("data", attr={"dtype": "data",
                                                  "group": "1"})
            fc = pkg.sym.FullyConnected(data, num_hidden=2, name="fc")
        with pkg.AttrScope(group="3"):
            act = pkg.sym.Activation(fc, act_type="relu", name="act")
        return data, fc, act


def test_symbol_attr_list_attr_debug_str_match_jax():
    def run(pkg):
        data, fc, act = _attr_graph(pkg)
        return (data.attr("group"), fc.attr("group"), act.attr("group"),
                act.attr("missing"), act.list_attr(),
                act.list_attr(recursive=True), act.attr_dict_flat(),
                pkg.sym.Group([fc, act]).attr("group"), act.debug_str())
    assert run(mx) == run(mt)


def test_symbol_eval_and_grad_match_jax():
    a = np.random.RandomState(3).randn(2, 3).astype(np.float32)

    def run(pkg):
        x = pkg.sym.Variable("x")
        y = pkg.sym.Variable("y")
        out = (x * 2.0 + y).eval(ctx=pkg.cpu(), x=pkg.nd.array(a),
                                 y=pkg.nd.array(a))
        with pytest.raises(pkg.MXNetError, match="deprecated"):
            x.grad(["x"])
        return out[0].asnumpy()
    np.testing.assert_array_equal(*_both(run))


def test_executor_debug_str_matches_jax():
    def run(pkg):
        with pkg.name.NameManager():
            x = pkg.sym.Variable("x")
            y = pkg.sym.FullyConnected(x, num_hidden=2, name="fc")
            exe = y.simple_bind(pkg.cpu(), x=(2, 2))
        return exe.debug_str().replace("cpu(0)", "CTX")
    ref, port = _both(run)
    assert port == ref
    assert "fc" in port and "MB allocated" in port


# -- fault 5: Module.reshape and no_slice_names ---------------------------------

def _softmax_fc(pkg):
    data = pkg.sym.Variable("data")
    return pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(data, num_hidden=2, name="fc"),
        name="softmax")


def _fc_params(seed=4):
    rng = np.random.RandomState(seed)
    return {"fc_weight": (rng.randn(2, 6) * 0.3).astype(np.float32),
            "fc_bias": np.zeros(2, np.float32)}


def _bound(pkg, batch, **kw):
    mod = pkg.mod.Module(_softmax_fc(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (batch, 6))],
             label_shapes=[("softmax_label", (batch,))], **kw)
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in _fc_params().items()},
                    aux_params={})
    return mod


def test_module_reshape_syncs_dirty_params_like_jax():
    rng = np.random.RandomState(5)
    X = rng.randn(8, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)

    def run(pkg):
        mod = _bound(pkg, 8)
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X)],
                                 label=[pkg.nd.array(y)])
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        # no get_params() before the reshape: it must sync by itself
        mod.reshape(data_shapes=[("data", (4, 6))],
                    label_shapes=[("softmax_label", (4,))])
        assert mod.data_shapes[0][1] == (4, 6)
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(X[:4])],
                                     label=[pkg.nd.array(y[:4])]),
                    is_train=False)
        return (mod.get_params()[0]["fc_weight"].asnumpy(),
                mod.get_outputs()[0].asnumpy())
    ref, port = _both(run)
    for a, b in zip(ref, port):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_module_reshape_keeps_grad_req_add_like_jax():
    X = np.random.RandomState(6).randn(4, 6).astype(np.float32)

    def run(pkg):
        mod = _bound(pkg, 8, grad_req="add")
        mod.reshape(data_shapes=[("data", (4, 6))],
                    label_shapes=[("softmax_label", (4,))])
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X)],
                                 label=[pkg.nd.array(np.zeros(4))])
        grads = []
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            grads.append([g[0].asnumpy().copy()
                          for g in mod._exec_group.grad_arrays])
        return grads
    ref, port = _both(run)
    for gr, gp in zip(ref, port):
        for a, b in zip(gr, gp):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(*port):
        np.testing.assert_allclose(2 * a, b, rtol=1e-6, atol=1e-7)


def test_no_slice_names_like_jax():
    B = 4

    def run(pkg):
        rois = pkg.sym.Variable("rois")
        net = pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(rois, num_hidden=2, name="fc"),
            name="softmax")
        shapes = dict(data_shapes=[("rois", (B, 3))],
                      label_shapes=[("softmax_label", (B,))])
        msgs = []
        mod = pkg.mod.Module(net, data_names=("rois",),
                             context=[pkg.cpu(0), pkg.cpu(1)])
        with pytest.raises(pkg.MXNetError) as e:
            mod.bind(no_slice_names=("rois",), **shapes)
        msgs.append(str(e.value))
        mod = pkg.mod.Module(net, data_names=("rois",), context=pkg.cpu())
        with pytest.raises(pkg.MXNetError) as e:
            mod.bind(no_slice_names=("roi",), **shapes)
        msgs.append(str(e.value))
        assert not mod.binded
        mod.bind(no_slice_names=("rois",), **shapes)
        (slc, _), = mod._exec_group.data_arrays[0]
        return msgs, (slc.start, slc.stop), mod._exec_group.no_slice
    ref, port = _both(run)
    assert port == ref
    assert "no-slice" in port[0][0] and "match no bound" in port[0][1]


# -- fault 6: a quantized graph bound by simple_bind ----------------------------

IN_DIM, HIDDEN, CLASSES = 16, 32, 4


def _mlp_conv(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=4,
                              name="conv1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu0")
    net = pkg.sym.Flatten(net, name="flat")
    net = pkg.sym.FullyConnected(net, num_hidden=HIDDEN, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=HIDDEN, name="fc2")
    net = pkg.sym.Activation(net, act_type="relu", name="relu2")
    net = pkg.sym.FullyConnected(net, num_hidden=CLASSES, name="fc3")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_conv_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"conv1_weight": (rng.randn(4, 2, 3, 3) * 0.3).astype(np.float32),
            "conv1_bias": (rng.randn(4) * 0.1).astype(np.float32),
            "fc1_weight": (rng.randn(HIDDEN, 4 * 4 * 4) * 0.2
                           ).astype(np.float32),
            "fc1_bias": (rng.randn(HIDDEN) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(HIDDEN, HIDDEN) * 0.3
                           ).astype(np.float32),
            "fc2_bias": (rng.randn(HIDDEN) * 0.1).astype(np.float32),
            "fc3_weight": (rng.randn(CLASSES, HIDDEN) * 0.3
                           ).astype(np.float32),
            "fc3_bias": np.zeros(CLASSES, np.float32)}


def _quantized_graph(pkg, ops):
    params = _mlp_conv_params()
    rng = np.random.RandomState(1)
    feeds = [{"data": rng.rand(8, 2, 4, 4).astype(np.float32)}
             for _ in range(4)]
    sym = _mlp_conv(pkg)
    calib = pkg.passes.calibrate_arrays(sym, feeds, arg_params=params)
    pipe = pkg.passes.default_inference_pipeline(
        quantize=pkg.passes.QuantizePass(calib=calib, ops=ops), name="t-q")
    return pipe.run(sym, params)


def _simple_bind_forward(pkg, qsym, qparams, X):
    exe = qsym.simple_bind(pkg.cpu(), grad_req="null", data=X.shape,
                           softmax_label=(X.shape[0],))
    exe.copy_params_from({k: pkg.nd.array(np.asarray(v),
                                          dtype=np.asarray(v).dtype)
                          for k, v in qparams.items()}, {},
                         allow_extra_params=True)
    exe.arg_dict["data"][:] = X
    return exe, exe.forward(is_train=False)[0].asnumpy()


def test_quantized_graph_bound_by_simple_bind_matches_jax():
    X = np.random.RandomState(11).rand(8, 2, 4, 4).astype(np.float32)

    def run(pkg):
        qsym, qparams = _quantized_graph(pkg, ("FullyConnected",))
        qops = [n.op.name for n in pkg.symbol._topo(qsym._heads)
                if not n.is_variable]
        assert qops.count("_quantized_FullyConnected") == 2
        exe, out = _simple_bind_forward(pkg, qsym, qparams, X)
        # both packages bind the int8 weights as float32 arrays here
        assert exe.arg_dict["fc1_weight"].dtype == np.float32
        return out
    ref, port = _both(run)
    # the float conv and softmax round differently (XLA's sums against
    # PyTorch's): 1e-6 relative on the probabilities
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-7)


def test_quantized_fc_op_on_float32_codes_bitwise_like_jax():
    rng = np.random.RandomState(13)
    x = rng.randint(-127, 128, (5, 24)).astype(np.int8)
    w = rng.randint(-127, 128, (7, 24)).astype(np.float32)
    wscale = (rng.rand(7) * 0.01).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)

    def run(pkg):
        sym = pkg.sym._quantized_FullyConnected(
            pkg.sym.Variable("data"), num_hidden=7, scale_data=0.037,
            name="q")
        args = {"data": pkg.nd.array(x, dtype=np.int8),
                "q_weight": pkg.nd.array(w),
                "q_wscale": pkg.nd.array(wscale),
                "q_bias": pkg.nd.array(bias)}
        return sym.bind(pkg.cpu(), args).forward()[0].asnumpy()
    np.testing.assert_array_equal(*_both(run))


def test_quantized_conv_bound_as_float32_raises_like_jax():
    """lax.conv_general_dilated refuses int8 data with float32 weights,
    so the JAX package raises here; so does the port."""
    X = np.random.RandomState(12).rand(2, 2, 4, 4).astype(np.float32)
    for pkg in (mx, mt):
        qsym, qparams = _quantized_graph(pkg, ("Convolution",))
        with pytest.raises(Exception, match="int8|dtype"):
            _simple_bind_forward(pkg, qsym, qparams, X)


def test_quantized_fc_truncates_float_operands_as_xla():
    """Float operands that are not whole codes convert toward zero, as
    XLA's convert under preferred_element_type=int32 does."""
    import jax.numpy as jnp
    from jax import lax
    import torch
    from mxnet_tpu_torch.ops.quantized import quantized_fc
    rng = np.random.RandomState(2)
    x = rng.randint(-127, 128, (3, 5)).astype(np.int8)
    w = (rng.randint(-127, 128, (4, 5)) + 0.4).astype(np.float32)
    ref = np.asarray(lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    p = mt.base._AttrDict(scale_data=1.0, no_bias=True)
    out = quantized_fc(p, [torch.from_numpy(x), torch.from_numpy(w),
                           torch.ones(4)])
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.float32))


# -- fault 7: PassPipeline -----------------------------------------------------

def test_pass_ordering_error_carries_corrected_order_like_jax():
    def run(pkg):
        with pytest.raises(pkg.passes.PassError) as e:
            pkg.passes.PassPipeline([pkg.passes.FuseEpiloguePass(),
                                     pkg.passes.QuantizePass(),
                                     pkg.passes.FoldConstantsPass()],
                                    name="bad")
        return str(e.value)
    ref, port = _both(run)
    assert port == ref
    assert "Corrected order: ['quantize', 'fuse_epilogue'" in port


def test_canonical_order_and_stats_match_jax():
    params = _mlp_conv_params()
    X = {"data": (2, 2, 4, 4)}

    def run(pkg):
        pipe = pkg.passes.default_inference_pipeline(name="p", fuse=True)
        order = [p.name for p in pipe.canonical_order()]
        pipe.run(_mlp_conv(pkg), params)
        pipe.run(_mlp_conv(pkg), params)
        rep = pipe.stats.report()
        for d in rep["passes"].values():
            d.pop("wall_s")
        rows = [(r["pass"], r["nodes_in"], r["nodes_out"])
                for r in pipe.last_report]
        lines = pipe.report_str().splitlines()
        return order, rep, rows, lines[0], len(lines)
    assert run(mx) == run(mt)
    assert isinstance(mt.passes.PassStats("x").report(), dict)
    del X


# -- fault 8 and item 15: names and small modules ------------------------------

def test_top_level_names_and_small_modules():
    for name in ("NDArray", "Symbol", "Executor", "Optimizer", "Prefix",
                 "engine", "misc", "symbol_doc", "libinfo", "faults",
                 "profiler"):
        assert hasattr(mt, name), name
    assert mt.NDArray is mt.nd.NDArray and mt.Symbol is mt.sym.Symbol
    assert mt.Executor is mt.executor.Executor
    assert mt.Optimizer is mt.optimizer.Optimizer
    with mt.Prefix("pre_"):
        assert mt.sym.FullyConnected(mt.sym.Variable("d"),
                                     num_hidden=2).name == "pre_fullyconnected0"
    assert mt.__version__ == mt.libinfo.__version__ == mx.libinfo.__version__
    for cls in ("LRScheduler", "FactorScheduler", "MultiFactorScheduler"):
        assert getattr(mt.misc, cls) is getattr(mt.lr_scheduler, cls)
    ref = mx.misc.FactorScheduler(step=2, factor=0.5)
    port = mt.misc.FactorScheduler(step=2, factor=0.5)
    ref.base_lr = port.base_lr = 0.1
    assert [ref(i) for i in range(8)] == [port(i) for i in range(8)]


def test_symbol_doc_output_shape_matches_jax():
    def run(pkg):
        sym = _mlp_conv(pkg)
        return (pkg.symbol_doc.get_output_shape(sym, data=(3, 2, 4, 4)),
                pkg.symbol_doc.SymbolDoc.get_output_shape(
                    sym, data=(1, 2, 4, 4)))
    assert run(mx) == run(mt)


def test_libinfo_points_at_kernel_builds():
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    built = [n for n in ck.SOURCES if os.path.isfile(ck._lib_path(n))]
    if built:
        assert mt.libinfo.find_lib_path(built[0]) == \
            [ck._lib_path(built[0])]
    else:
        with pytest.raises(RuntimeError, match="build"):
            mt.libinfo.find_lib_path()
    # the JAX package's name for its native library finds the port's
    # host and I/O libraries (built at first use)
    from mxnet_tpu_torch import native_build as nb
    assert mt.libinfo.find_lib_path("libmxtpu.so") == \
        [nb.path("host"), nb.path("io")]
    with pytest.raises(RuntimeError, match="unknown"):
        mt.libinfo.find_lib_path("libnothing.so")
    assert os.path.dirname(ck._lib_path("paged_attention")) == \
        os.path.join(ROOT, "mxnet_tpu_torch", "_build")


def test_engine_naive_mode_and_waits():
    eng = mt.engine.engine()
    assert not eng.is_naive and mx.engine.engine().is_naive is False
    with mt.engine.naive_mode():
        assert eng.is_naive
        a = mt.nd.ones((4, 4)) * 3
        b = mt.nd.sum(a)
        assert (a.asnumpy() == 3).all() and b.asscalar() == 48
    assert not eng.is_naive
    a = mt.nd.zeros((10, 10))
    for _ in range(10):
        a += 1
    mt.engine.wait_for_all()
    mt.nd.waitall()
    assert (a.asnumpy() == 10).all()
    assert mt.engine.track(a) is a


# -- the fault plane ------------------------------------------------------------

SPECS = ["seed=7,rate=0.3,kinds=error|delay,delay_ms=0",
         "seed=3,rate=1,points=decode.step|serve.dispatch,after=2,max=3",
         "seed=11,rate=0.5,kinds=delay|error|delay,delay_ms=0,points="
         "paged.step"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plane_fires_at_the_same_calls_as_jax(spec):
    calls = [("decode.step", {"active": i % 3}) for i in range(20)] + \
        [("serve.dispatch", {"n": 1}) for _ in range(10)] + \
        [("paged.step", {"active": 1}) for _ in range(20)]

    def run(pkg):
        fired = []
        with pkg.faults.active(spec):
            for i, (name, ctx) in enumerate(calls):
                before = pkg.faults.stats().report()["by_kind"]
                try:
                    pkg.faults.point(name, **ctx)
                except pkg.faults.InjectedFault:
                    fired.append((i, "error"))
                    continue
                after = pkg.faults.stats().report()["by_kind"]
                if after != before:
                    fired.append((i, "delay"))
        return fired
    ref, port = _both(run)
    assert port == ref and ref
    assert not mt.faults.enabled()


def test_fault_plan_rules_and_parse_errors_match_jax():
    def run(pkg):
        plan = pkg.faults.parse_spec("seed=5,rate=0.5,kinds=error,"
                                     "points=a@s1|b,after=1,max=2,"
                                     "attempts=0|1")
        draws = [plan.decide(n, {"stage": st}) is not None
                 for n, st in [("a", "s1"), ("a", "s2"), ("b", None)] * 6]
        errs = []
        for bad in ("rate", "seed=1,bogus=2", "kinds=nope"):
            with pytest.raises(pkg.MXNetError) as e:
                pkg.faults.parse_spec(bad)
            errs.append(str(e.value))
        return draws, errs
    assert run(mx) == run(mt)


def test_backoff_restart_window_retry_call_match_jax():
    def run(pkg):
        b = pkg.faults.Backoff(base_s=0.01, factor=2.0, max_s=0.05,
                               jitter=0.5, seed=[977, 1])
        waits = [b.next_wait() for _ in range(6)]
        b.reset()
        again = [b.next_wait() for _ in range(3)]
        w = pkg.faults.RestartWindow(2, window_s=10.0)
        counts = [w.note(now=t) for t in (0.0, 1.0, 2.0, 20.0)]
        n = {"calls": 0}

        def flaky():
            n["calls"] += 1
            if n["calls"] < 3:
                raise ValueError("x")
            return n["calls"]
        out = pkg.faults.retry_call(
            flaky, retries=3, backoff=pkg.faults.Backoff(base_s=0.0))
        return waits, again, counts, w.exceeded(now=20.5), out
    assert run(mx) == run(mt)


# -- the port's import rule -------------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert len(files) > 50 and not bad, bad
