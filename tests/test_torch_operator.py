"""The port's Python custom ops (``operator.py``) against the JAX
package's, on the CPU.

* The three softmax heads of ``example/numpy-ops`` (``NumpyOp``,
  ``NDArrayOp`` through ``mx.rtc.Rtc`` callables, ``CustomOp`` through
  ``sym.Custom``): forward and the input gradient equal the JAX
  package's within atol 1e-6 on the same seeded inputs.
* ``sym.Custom`` with extra kwargs writes the JAX package's symbol JSON
  byte for byte; ``_Native`` and ``_NDArray`` raise its messages.
* The partial-shape ``infer_shape`` rule and ``declare_backward_
  dependency`` answer as the JAX package's.
* ``Module.fit``, 5 steps of the 784-128-64-10 MLP at batch 100 with a
  ``CustomOp`` head, from one checkpoint the JAX package wrote: params
  within atol 1e-5 of the JAX fit's.  The data is uniform in [-1, 1), as
  ``test_torch_module.py``'s MLP data is: with uniform [0, 1) data at
  this seed one fc2 pre-activation of the first batch lies 2.8e-8 from
  0, under the float32 rounding of its sum, and the two packages' relus
  gate it differently (the recorded relu-tie difference, ROADMAP.md);
  that moves the fc2 update by 4 %, for SoftmaxOutput as for the Custom
  head.
* The fused step's capture decision, read without a card: a graph
  holding a Python op is not captured, the same graph with
  ``SoftmaxOutput`` is.
* A ``Custom`` node in the middle of a graph goes through each package's
  ``Predictor``; the port's serving pipeline fuses the FC epilogues and
  leaves the ``Custom`` node as it is; answers within atol 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ATOL_OP = 1e-6
ATOL_FIT = 1e-5


def _make_ops(mx, rtc_fns):
    """The example/numpy-ops heads and a scaling Custom op, in package
    ``mx``; ``rtc_fns`` are the softmax and its gradient as functions of
    that package's arrays (the Rtc callables)."""
    softmax_fn, grad_fn = rtc_fns

    class NumpySoftmax(mx.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            dx = in_grad[0]
            dx[:] = out_data[0]
            dx[np.arange(lab.shape[0]), lab] -= 1.0

    class NDArraySoftmax(mx.operator.NDArrayOp):
        def __init__(self):
            super().__init__(False)
            self.fwd_kernel = self.bwd_kernel = None

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            xa = mx.nd.array(x)
            if self.fwd_kernel is None:
                self.fwd_kernel = mx.rtc.Rtc("softmax", [("x", xa)],
                                             [("y", xa)], softmax_fn)
            yout = mx.nd.empty(y.shape)
            self.fwd_kernel.push([xa], [yout], (1, 1, 1), (x.shape[0], 1, 1))
            y[:] = yout.asnumpy()

        def backward(self, out_grad, in_data, out_data, in_grad):
            label, y, dx = in_data[1], out_data[0], in_grad[0]
            ya, la = mx.nd.array(y), mx.nd.array(label)
            if self.bwd_kernel is None:
                self.bwd_kernel = mx.rtc.Rtc(
                    "softmax_grad", [("y", ya), ("l", la)], [("dx", ya)],
                    grad_fn)
            dxout = mx.nd.empty(dx.shape)
            self.bwd_kernel.push([ya, la], [dxout], (y.shape[0], 1, 1),
                                 (y.shape[1], 1, 1))
            dx[:] = dxout.asnumpy()

    class CustomSoftmaxOp(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(int)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("test_custom_softmax")
    class CustomSoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return CustomSoftmaxOp()

    class ScaleOp(mx.operator.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.factor)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.factor)

    @mx.operator.register("test_scale")
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaleOp(self.factor)

    return NumpySoftmax, NDArraySoftmax


def _jax_rtc_fns():
    import jax.numpy as jnp

    def softmax_rows(x):
        e = jnp.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def softmax_grad(y, lab):
        onehot = jnp.arange(y.shape[1])[None, :] == \
            lab.astype(jnp.int32)[:, None]
        return y - onehot.astype(y.dtype)
    return softmax_rows, softmax_grad


def _torch_rtc_fns():
    def softmax_rows(x):
        e = torch.exp(x - x.max(dim=1, keepdim=True).values)
        return e / e.sum(dim=1, keepdim=True)

    def softmax_grad(y, lab):
        onehot = torch.arange(y.shape[1])[None, :] == \
            lab.to(torch.int64)[:, None]
        return y - onehot.to(y.dtype)
    return softmax_rows, softmax_grad


JOPS = _make_ops(jmx, _jax_rtc_fns())
TOPS = _make_ops(tmx, _torch_rtc_fns())


def _head(mx, ops, flavor, data, label):
    numpy_op, ndarray_op = ops
    if flavor == "numpy":
        return numpy_op()(data=data, label=label, name="softmax")
    if flavor == "ndarray":
        return ndarray_op()(data=data, label=label, name="softmax")
    return mx.sym.Custom(data, label, op_type="test_custom_softmax",
                         name="softmax")


@pytest.fixture(autouse=True)
def _on_the_host():
    with tmx.cpu():
        yield


@pytest.mark.parametrize("flavor", ["numpy", "ndarray", "custom"])
def test_softmax_heads_forward_backward_equal_jax(flavor):
    rng = np.random.RandomState(0)
    x = rng.randn(16, 10).astype(np.float32)
    lab = rng.randint(0, 10, 16).astype(np.float32)
    res = {}
    for mx, ops in ((jmx, JOPS), (tmx, TOPS)):
        net = _head(mx, ops, flavor, mx.sym.Variable("data"),
                    mx.sym.Variable("label"))
        ex = net.simple_bind(mx.cpu(), data=x.shape, label=lab.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["label"][:] = lab
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.ones(x.shape)])
        res[mx] = (out, ex.grad_dict["data"].asnumpy())
    e = np.exp(x - x.max(axis=1, keepdims=True))
    np.testing.assert_allclose(res[tmx][0], e / e.sum(1, keepdims=True),
                               atol=ATOL_OP)
    for got, want in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(got, want, atol=ATOL_OP)
    np.testing.assert_allclose(res[tmx][1].sum(axis=1), 0, atol=ATOL_OP)


def test_custom_extra_kwargs_json_equals_jax():
    out = {}
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            data = mx.sym.Variable("data")
            net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
            net = mx.sym.Custom(net, op_type="test_scale", factor=2.5,
                                name="scale")
            out[mx] = net.tojson()
    assert out[tmx] == out[jmx]
    assert '"factor": "2.5"' in out[tmx]
    # the JSON round-trips into either package with the extras kept
    back = tmx.sym.load_json(out[jmx])
    assert back.tojson() == out[jmx]
    assert set(tmx.operator.get_all_registered_operators()) <= \
        set(jmx.operator.get_all_registered_operators())
    assert {"test_scale", "test_custom_softmax"} <= \
        set(tmx.operator.get_all_registered_operators())
    with pytest.raises(tmx.MXNetError, match="requires parameter 'op_type'"):
        tmx.sym.Custom(tmx.sym.Variable("x"))
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tmx.sym.Custom(tmx.sym.Variable("x"), op_type="no_such_op")


@pytest.mark.parametrize("op", ["_Native", "_NDArray"])
def test_native_and_ndarray_shims_raise_the_references_message(op):
    msgs = {}
    for mx in (jmx, tmx):
        net = getattr(mx.sym, op)(mx.sym.Variable("data"), name="shim")
        ex = net.simple_bind(mx.cpu(), data=(2, 3))
        with pytest.raises(Exception) as e:
            ex.forward()
        msgs[mx] = str(e.value)
    assert msgs[tmx] == msgs[jmx]
    assert "pointer-passing is not used" in msgs[tmx]


def test_partial_shape_rule_and_backward_dependency_equal_jax():
    for mx, ops in ((jmx, JOPS), (tmx, TOPS)):
        net = ops[0]()(data=mx.sym.Variable("data"),
                       label=mx.sym.Variable("label"))
        args, outs, _ = net.infer_shape(data=(4, 10))
        assert args == [(4, 10), (4,)] and outs == [(4, 10)]

    def make(mx):
        class Strict(mx.operator.NumpyOp):
            def list_arguments(self):
                return ["data", "aux_in"]

            def infer_shape(self, in_shape):
                # indexes the secondary shape: raises while it is unknown
                if in_shape[1][0] != in_shape[0][0]:
                    raise ValueError("rows differ")
                return in_shape, [in_shape[0]]
        return Strict()

    for mx in (jmx, tmx):
        net = make(mx)(data=mx.sym.Variable("data"),
                       aux_in=mx.sym.Variable("aux_in"))
        # partial shapes: the op's raise defers the node
        args, outs, _ = net.infer_shape_partial(data=(4, 10))
        assert outs == [None] or outs == [()]
        # every shape known: the user's error propagates
        with pytest.raises(Exception, match="rows differ"):
            net.infer_shape(data=(4, 10), aux_in=(3, 2))
    for mx in (jmx, tmx):
        prop = mx.operator.CustomOpProp(need_top_grad=False)
        assert prop.declare_backward_dependency([1], [2, 3], [4]) == [2, 3, 4]
        prop = mx.operator.CustomOpProp()
        assert prop.declare_backward_dependency([1], [2, 3], [4]) == \
            [1, 2, 3, 4]
        assert prop.infer_shape([[2, 3]]) == ([[2, 3]], [[2, 3]], [])


def _mlp(mx, head):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    if head == "custom":
        return mx.sym.Custom(net, mx.sym.Variable("softmax_label"),
                             op_type="test_custom_softmax", name="softmax")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _mlp_checkpoint(tmp_path, batch=100, n=500):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (n, 784)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    jmx.random.seed(1)
    mod = jmx.mod.Module(_mlp(jmx, "softmax"), context=jmx.cpu())
    mod.bind([("data", (batch, 784))], [("softmax_label", (batch,))])
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    return prefix, x, y, batch


def _fit_custom(mx, prefix, x, y, batch):
    if mx is jmx:
        _s, arg, aux = jmx.model.load_checkpoint(prefix, 0)
    else:
        _s, arg, aux = tmx.model.load_checkpoint(prefix, 0, ctx=tmx.cpu())
    mod = mx.mod.Module(_mlp(mx, "custom"), context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod.fit(it, num_epoch=1, optimizer="sgd", arg_params=arg,
            aux_params=aux, optimizer_params={"learning_rate": 0.05,
                                              "momentum": 0.9})
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_with_a_custom_op_head_matches_jax(tmp_path):
    prefix, x, y, batch = _mlp_checkpoint(tmp_path)
    _, want = _fit_custom(jmx, prefix, x, y, batch)
    mod, got = _fit_custom(tmx, prefix, x, y, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL_FIT,
                                   err_msg=k)
    assert mod._fused is not None and mod._fused.host_ops == ["softmax"]
    assert mod._fused.stats.report() == {"captures": 0, "replays": 0,
                                         "eager_steps": 5}


@pytest.mark.parametrize("head", ["custom", "softmax"])
def test_capture_decision_without_a_card(head):
    mod = tmx.mod.Module(_mlp(tmx, head), context=tmx.cpu())
    mod.bind([("data", (4, 784))], [("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer()
    fused = mod._fused
    assert not fused.captured and fused.capture_reason() is None
    # the decision as it reads on a card
    fused.device = torch.device("cuda", 0)
    if head == "custom":
        assert not fused.captured
        assert fused.capture_reason() == \
            "python op softmax runs on the host"
    else:
        assert fused.captured and fused.capture_reason() is None


def _custom_mid(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.Custom(net, op_type="test_scale", factor=0.5, name="scale")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_predictor_with_a_custom_node_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    jmx.random.seed(2)
    mod = jmx.mod.Module(_custom_mid(jmx), context=jmx.cpu())
    mod.bind([("data", (8, 784))], [("softmax_label", (8,))])
    mod.init_params(initializer=jmx.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / "mid")
    mod.save_checkpoint(prefix, 0, save_optimizer_states=False)
    x = rng.rand(8, 784).astype(np.float32)
    want = jmx.predictor.create_predictor(prefix, 0, {"data": (8, 784)})
    want.set_input("data", x)
    want.forward()
    pipe = tmx.passes.build_serving_pipeline(fuse=True, ctx=tmx.cpu())
    sym_json, params = tmx.predictor.load_checkpoint_pair(prefix, 0)
    got = tmx.predictor.Predictor(sym_json, params, {"data": (8, 784)},
                                  dev_type="cpu", pipeline=pipe)
    ops = [n["op"] for n in __import__("json").loads(
        got.symbol.tojson())["nodes"]]
    assert ops.count("Custom") == 1
    assert ops.count("_fused_FullyConnected") >= 2
    got.set_input("data", x)
    got.forward()
    np.testing.assert_allclose(got.get_output(0), want.get_output(0),
                               atol=ATOL_FIT)
