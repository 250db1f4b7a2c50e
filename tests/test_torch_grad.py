"""The port's gradients against the JAX package's, through Executor.

Each case builds the same one-op (or few-op) graph in both packages,
binds it on the CPU with ``grad_req="write"``, feeds the same seeded
numpy inputs, runs ``forward(is_train=True)`` and ``backward`` (with a
seeded head gradient, or none for the loss layer), and compares the
outputs, every argument's gradient and the updated aux states.
Tolerance: rtol 1e-5, atol 1e-6 on O(1) values (float32 sums run in
other orders in XLA and in PyTorch's CPU kernels).  Then the ties of
max pooling, ``grad_req="add"``, the missing-head-gradient rule,
BatchNorm's biased moving variance, and Dropout/rrelu in training (drawn
from the port's own generator: their draws are not the reference's).
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _u(rng, shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _run(pkg, build, values, head=None, aux=None, grad_req="write",
         is_train=True):
    """-> (outputs, grads, aux after the step) as numpy; an eval forward
    runs no backward."""
    sym = build(pkg.sym)
    shapes = {n: v.shape for n, v in values.items()}
    exe = sym.simple_bind(pkg.cpu(), grad_req=grad_req, **shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    for n, v in (aux or {}).items():
        exe.aux_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    if is_train:
        exe.backward(head)
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None}
    return outs, grads, {n: a.asnumpy() for n, a in exe.aux_dict.items()}


def _op(op, n_in=1, **params):
    """A graph of one op on data (and arg1.. for several inputs)."""
    def build(s):
        ins = [s.Variable("data")] + [s.Variable("arg%d" % i)
                                      for i in range(1, n_in)]
        return getattr(s, op)(*ins, name="op", **params)
    return build


def _conv_w(rng, f, c, k):
    return _u(rng, (f, c, k, k), 1 / np.sqrt(c * k * k))


# (id, graph builder, inputs builder (rng -> {name: array}))
CASES = [
    ("fc", _op("FullyConnected", num_hidden=6),
     lambda r: {"data": _u(r, (4, 10)), "op_weight": _u(r, (6, 10), 0.3),
                "op_bias": _u(r, (6,))}),
    ("fc-nobias-4d", _op("FullyConnected", num_hidden=5, no_bias=True),
     lambda r: {"data": _u(r, (3, 2, 3, 2)),
                "op_weight": _u(r, (5, 12), 0.3)}),
    ("conv", _op("Convolution", kernel=(3, 3), num_filter=4, pad=(1, 1)),
     lambda r: {"data": _u(r, (2, 3, 6, 6)), "op_weight": _conv_w(r, 4, 3, 3),
                "op_bias": _u(r, (4,))}),
    ("conv-stride-dilate-nobias",
     _op("Convolution", kernel=(3, 3), num_filter=4, stride=(2, 2),
         dilate=(2, 1), pad=(1, 2), no_bias=True),
     lambda r: {"data": _u(r, (2, 3, 9, 8)),
                "op_weight": _conv_w(r, 4, 3, 3)}),
    ("conv-groups", _op("Convolution", kernel=(1, 1), num_filter=4,
                        num_group=2),
     lambda r: {"data": _u(r, (2, 4, 5, 5)), "op_weight": _conv_w(r, 4, 2, 1),
                "op_bias": _u(r, (4,))}),
    ("act-relu", _op("Activation", act_type="relu"),
     lambda r: {"data": _u(r, (3, 7))}),
    ("act-sigmoid", _op("Activation", act_type="sigmoid"),
     lambda r: {"data": _u(r, (3, 7), 4)}),
    ("act-tanh", _op("Activation", act_type="tanh"),
     lambda r: {"data": _u(r, (3, 7), 3)}),
    ("act-softrelu", _op("Activation", act_type="softrelu"),
     lambda r: {"data": _u(r, (3, 7), 6)}),
    ("leaky", _op("LeakyReLU", act_type="leaky", slope=0.2),
     lambda r: {"data": _u(r, (3, 7))}),
    ("elu", _op("LeakyReLU", act_type="elu", slope=0.3),
     lambda r: {"data": _u(r, (3, 7))}),
    ("prelu", _op("LeakyReLU", act_type="prelu"),
     lambda r: {"data": _u(r, (2, 3, 4)), "op_gamma": _u(r, (3,), 0.5)}),
    ("pool-max", _op("Pooling", kernel=(2, 2), stride=(2, 2)),
     lambda r: {"data": _u(r, (2, 3, 6, 6))}),
    ("pool-max-pad", _op("Pooling", kernel=(3, 3), stride=(2, 2),
                         pad=(1, 1)),
     lambda r: {"data": _u(r, (2, 3, 7, 6))}),
    # ties: values on a few levels, so most windows hold equal maxima;
    # both packages send the gradient to the first in row-major order
    ("pool-max-ties", _op("Pooling", kernel=(3, 3), stride=(1, 1),
                          pad=(1, 1)),
     lambda r: {"data": r.randint(0, 3, (2, 2, 6, 6)).astype(np.float32)}),
    ("pool-avg-pad", _op("Pooling", kernel=(3, 3), stride=(2, 2),
                         pad=(1, 1), pool_type="avg"),
     lambda r: {"data": _u(r, (2, 3, 7, 7))}),
    ("pool-sum", _op("Pooling", kernel=(2, 3), stride=(1, 2),
                     pool_type="sum"),
     lambda r: {"data": _u(r, (2, 3, 5, 7))}),
    ("pool-global-avg", _op("Pooling", kernel=(1, 1), global_pool=True,
                            pool_type="avg"),
     lambda r: {"data": _u(r, (2, 3, 4, 5))}),
    ("pool-global-max", _op("Pooling", kernel=(1, 1), global_pool=True),
     lambda r: {"data": _u(r, (2, 3, 4, 5))}),
    ("flatten", _op("Flatten"), lambda r: {"data": _u(r, (3, 2, 2, 3))}),
    ("esum", _op("ElementWiseSum", n_in=3),
     lambda r: {"data": _u(r, (2, 5)), "arg1": _u(r, (2, 5)),
                "arg2": _u(r, (2, 5))}),
    ("dropout-p0", _op("Dropout", p=0.0), lambda r: {"data": _u(r, (3, 4))}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_gradient_matches_jax(case):
    cid, build, inputs = case
    rng = np.random.RandomState(zlib.crc32(cid.encode()))
    values = inputs(rng)
    want_out, _, _ = _run(jmx, build, values, head=None, is_train=False)
    head = [_u(rng, want_out[0].shape)]
    want = _run(jmx, build, values, head=head)
    got = _run(tmx, build, values, head=head)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=RTOL, atol=ATOL)
    assert sorted(got[1]) == sorted(want[1]) == sorted(values)
    for name in values:
        np.testing.assert_allclose(got[1][name], want[1][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_max_pool_ties_gradient_is_one_hot_per_window():
    """The tie case's point: a window of equal maxima passes its whole
    gradient to one element, the same one in both packages."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    build = _op("Pooling", kernel=(2, 2), stride=(2, 2))
    head = [np.ones((1, 1, 2, 2), np.float32)]
    want = _run(jmx, build, {"data": x}, head=head)[1]["data"]
    got = _run(tmx, build, {"data": x}, head=head)[1]["data"]
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 4.0 and got[0, 0, 0, 0] == 1.0


def test_int_pooling_stays_off_the_gradient_path():
    """Integer max pooling takes the window-view path at inference; the
    float path (and its gradient) is max_pool2d."""
    op = tmx.ops.get_op("Pooling")
    p = op.parse_params({"kernel": (3, 3), "pad": (1, 1)})
    ctx = tmx.ops.OpContext(is_train=True)
    xi = torch.arange(36, dtype=torch.int32).reshape(1, 1, 6, 6)
    out = op.forward(p, [xi], [], ctx)[0]
    assert out.dtype == torch.int32 and not out.requires_grad
    xf = xi.float().requires_grad_(True)
    outf = op.forward(p, [xf], [], ctx)[0]
    assert outf.grad_fn is not None
    np.testing.assert_array_equal(outf.detach().numpy(), out.numpy())


def _softmax_build(**params):
    def build(s):
        return s.SoftmaxOutput(s.Variable("data"), name="softmax", **params)
    return build


SOFTMAX_CASES = [
    ("null", {}, (5, 7), lambda r: r.randint(0, 7, (5,))),
    ("batch", {"normalization": "batch", "grad_scale": 2.0}, (5, 7),
     lambda r: r.randint(0, 7, (5,))),
    ("valid-ignore", {"normalization": "valid", "use_ignore": True,
                      "ignore_label": 3}, (6, 5),
     lambda r: np.array([3, 1, 3, 0, 4, 2])),
    ("null-ignore", {"use_ignore": True, "ignore_label": -1}, (4, 6),
     lambda r: np.array([-1, 2, 5, -1])),
    ("4d-flat", {}, (3, 2, 2, 2), lambda r: r.randint(0, 8, (3,))),
    ("multi-null", {"multi_output": True}, (2, 4, 3, 2),
     lambda r: r.randint(0, 4, (2, 3, 2))),
    ("multi-batch", {"multi_output": True, "normalization": "batch"},
     (2, 4, 3, 2), lambda r: r.randint(0, 4, (2, 3, 2))),
    ("multi-valid-ignore", {"multi_output": True, "normalization": "valid",
                            "use_ignore": True, "ignore_label": 0},
     (2, 4, 5), lambda r: r.randint(0, 4, (2, 5))),
    ("prob-label", {"prob_label": True, "grad_scale": 0.5}, (3, 4),
     lambda r: np.full((3, 4), 0.25)),
]


@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=[c[0] for c in SOFTMAX_CASES])
def test_softmax_output_gradient_matches_jax(case):
    cid, params, shape, labels = case
    rng = np.random.RandomState(zlib.crc32(cid.encode()))
    values = {"data": _u(rng, shape, 3),
              "softmax_label": np.asarray(labels(rng), np.float32)}
    build = _softmax_build(**params)
    want = _run(jmx, build, values)
    got = _run(tmx, build, values)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=RTOL, atol=ATOL)
    for name in values:
        np.testing.assert_allclose(got[1][name], want[1][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the head gradient is ignored: any head gives the same gradient
    again = _run(tmx, build, values, head=[_u(rng, shape)])
    np.testing.assert_array_equal(again[1]["data"], got[1]["data"])


def _bn_build(**params):
    def build(s):
        return s.BatchNorm(s.Variable("data"), name="bn", **params)
    return build


BN_CASES = [
    ("train-fix-gamma", {}, True),
    ("train-gamma", {"fix_gamma": False, "eps": 2e-5, "momentum": 0.8}, True),
    ("train-global-stats", {"fix_gamma": False, "use_global_stats": True},
     True),
    ("eval", {"fix_gamma": False}, False),
    ("train-2d", {"fix_gamma": False}, True),
]


@pytest.mark.parametrize("case", BN_CASES, ids=[c[0] for c in BN_CASES])
def test_batchnorm_gradient_and_aux_match_jax(case):
    cid, params, is_train = case
    rng = np.random.RandomState(zlib.crc32(cid.encode()))
    shape = (6, 3) if cid.endswith("2d") else (2, 3, 2, 2)
    values = {"data": _u(rng, shape, 2) + 0.5,
              "bn_gamma": _u(rng, (3,)) + 1.5, "bn_beta": _u(rng, (3,))}
    aux = {"bn_moving_mean": _u(rng, (3,)),
           "bn_moving_var": rng.uniform(0.5, 2, (3,)).astype(np.float32)}
    build = _bn_build(**params)
    head = [_u(rng, shape)]
    want = _run(jmx, build, values, head=head, aux=aux, is_train=is_train)
    got = _run(tmx, build, values, head=head, aux=aux, is_train=is_train)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=RTOL, atol=ATOL)
    for name in (values if is_train else ()):
        np.testing.assert_allclose(got[1][name], want[1][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name in aux:
        np.testing.assert_allclose(got[2][name], want[2][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if params.get("fix_gamma", True):
        assert not got[1]["bn_gamma"].any()


def test_batchnorm_moving_var_is_the_biased_variance():
    """8 values per channel: an unbiased update (F.batch_norm's own
    running_var) would move the moving variance by 8/7 of the batch
    variance's share and fail this comparison."""
    rng = np.random.RandomState(3)
    x = _u(rng, (2, 3, 2, 2), 2)
    values = {"data": x, "bn_gamma": np.ones(3, np.float32),
              "bn_beta": np.zeros(3, np.float32)}
    aux = {"bn_moving_mean": np.zeros(3, np.float32),
           "bn_moving_var": np.ones(3, np.float32)}
    got = _run(tmx, _bn_build(momentum=0.5), values,
               head=[np.zeros_like(x)], aux=aux)[2]["bn_moving_var"]
    biased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1)
    np.testing.assert_allclose(got, 0.5 + 0.5 * biased, rtol=RTOL)
    assert np.abs(got - (0.5 + 0.5 * biased * 8 / 7)).max() > 1e-3


def test_grad_req_add_accumulates():
    build = _op("FullyConnected", num_hidden=4)
    rng = np.random.RandomState(4)
    values = {"data": _u(rng, (3, 5)), "op_weight": _u(rng, (4, 5)),
              "op_bias": _u(rng, (4,))}
    head = [_u(rng, (3, 4))]
    for pkg in (jmx, tmx):
        sym = build(pkg.sym)
        exe = sym.simple_bind(pkg.cpu(), grad_req={"op_weight": "add",
                                                   "op_bias": "write"},
                              data=(3, 5))
        for n, v in values.items():
            exe.arg_dict[n][:] = v
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward(head)
        if pkg is jmx:
            want = {n: exe.grad_dict[n].asnumpy() for n in ("op_weight",
                                                            "op_bias")}
            assert exe.grad_dict.get("data") is None
        else:
            got = {n: exe.grad_dict[n].asnumpy() for n in ("op_weight",
                                                           "op_bias")}
            assert exe.grad_dict.get("data") is None
    single = _run(tmx, build, values, head=head)[1]
    np.testing.assert_allclose(got["op_weight"], 2 * single["op_weight"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["op_bias"], single["op_bias"], rtol=RTOL,
                               atol=ATOL)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL)


def test_missing_head_gradient_rule_follows_the_reference():
    def build(s):
        data = s.Variable("data")
        fc = s.FullyConnected(data, num_hidden=3, name="fc")
        return s.Group([s.SoftmaxOutput(fc, name="softmax"),
                        s.Activation(fc, act_type="tanh", name="act")])
    rng = np.random.RandomState(5)
    values = {"data": _u(rng, (2, 4)), "fc_weight": _u(rng, (3, 4)),
              "fc_bias": _u(rng, (3,)),
              "softmax_label": np.array([0, 2], np.float32)}
    for pkg in (jmx, tmx):
        exe = build(pkg.sym).simple_bind(pkg.cpu(), data=(2, 4))
        for n, v in values.items():
            exe.arg_dict[n][:] = v
        exe.forward(is_train=True)
        with pytest.raises(pkg.MXNetError, match="requires a head gradient"):
            exe.backward([])
    # a graph whose only head is the loss may omit its head gradient
    loss = _softmax_build()
    vals = {"data": _u(rng, (2, 3)),
            "softmax_label": values["softmax_label"]}
    want = _run(jmx, loss, vals, head=[])
    got = _run(tmx, loss, vals, head=[])
    np.testing.assert_allclose(got[1]["data"], want[1]["data"], rtol=RTOL,
                               atol=ATOL)


def test_bind_with_args_grad_and_outputs():
    sym = _op("FullyConnected", num_hidden=2)(tmx.sym)
    rng = np.random.RandomState(6)
    cpu = tmx.cpu()
    args = {"data": tmx.nd.array(_u(rng, (3, 4)), ctx=cpu),
            "op_weight": tmx.nd.array(_u(rng, (2, 4)), ctx=cpu),
            "op_bias": tmx.nd.array(_u(rng, (2,)), ctx=cpu)}
    grads = {"op_weight": tmx.nd.zeros((2, 4), ctx=cpu)}
    exe = sym.bind(cpu, args, args_grad=grads)
    out = exe.forward(is_train=True)[0]
    assert list(exe.output_dict) == ["op_output"]
    exe.backward([np.ones((3, 2), np.float32)])
    np.testing.assert_allclose(
        grads["op_weight"].asnumpy(),
        np.ones((2, 3), np.float32) @ args["data"].asnumpy(), rtol=RTOL)
    assert exe.grad_arrays == [None, grads["op_weight"], None]
    np.testing.assert_allclose(out.asnumpy(),
                               exe.outputs[0].asnumpy())


def _one_op(op_name, params, x, is_train, gen):
    op = tmx.ops.get_op(op_name)
    p = op.parse_params(params)
    ctx = tmx.ops.OpContext(is_train=is_train, generator=gen)
    return op.forward(p, [x], [], ctx)[0]


def test_dropout_in_training_keeps_and_scales():
    p = 0.3
    x = torch.full((200, 100), 2.0, requires_grad=True)
    gen = torch.Generator().manual_seed(11)
    y = _one_op("Dropout", {"p": p}, x, True, gen)
    kept = (y != 0)
    n, k = kept.numel(), int(kept.sum())
    # kept fraction within 5 binomial standard deviations of 1 - p
    sd = np.sqrt(n * p * (1 - p))
    assert abs(k - n * (1 - p)) < 5 * sd
    np.testing.assert_allclose(y[kept].detach().numpy(), 2.0 / (1 - p),
                               rtol=1e-6)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.numpy(), kept.float().numpy() / (1 - p),
                               rtol=1e-6)
    # inference is the identity; one seed gives one mask
    assert torch.equal(_one_op("Dropout", {"p": p}, x, False, gen), x)
    y2 = _one_op("Dropout", {"p": p}, x, True,
                 torch.Generator().manual_seed(11))
    assert torch.equal(y2, y)


def test_rrelu_in_training_draws_slopes_in_bounds():
    x = -torch.ones(50, 40)
    gen = torch.Generator().manual_seed(2)
    params = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.4}
    y = _one_op("LeakyReLU", params, x, True, gen)
    slopes = (-y).numpy()
    assert slopes.min() >= 0.1 and slopes.max() < 0.4
    assert abs(slopes.mean() - 0.25) < 0.01
    pos = _one_op("LeakyReLU", params, torch.ones(3, 4), True, gen)
    assert torch.equal(pos, torch.ones(3, 4))


def test_executor_train_forward_commits_aux_states():
    sym = _bn_build(fix_gamma=False)(tmx.sym)
    exe = sym.simple_bind(tmx.cpu(), grad_req="null", data=(4, 2))
    exe.arg_dict["data"][:] = np.arange(8, dtype=np.float32).reshape(4, 2)
    exe.arg_dict["bn_gamma"][:] = 1.0
    exe.aux_dict["bn_moving_var"][:] = 1.0
    exe.forward(is_train=False)
    assert not exe.aux_dict["bn_moving_mean"].asnumpy().any()
    exe.forward(is_train=True)
    np.testing.assert_allclose(exe.aux_dict["bn_moving_mean"].asnumpy(),
                               0.1 * np.array([3.0, 4.0]), rtol=1e-6)
    exe.backward()
