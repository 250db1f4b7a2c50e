"""The port's ops against the JAX package's, op by op.

Each case feeds the same numpy inputs (from a seed) through the JAX op
and the port's op of the same name, on the CPU, and compares shape
inference and outputs.  Tolerances: float32 ops whose sums run in other
orders (matmul, convolution, pooling sums, softmax) agree to 1e-5
relative and absolute on O(1) values; pure elementwise and selection ops
(relu, max pooling, flatten, dropout at inference) agree to 1e-6; int8
codes and integer max pooling are compared for equality.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_get_op
from mxnet_tpu.ops.registry import OpContext as JaxOpContext
from mxnet_tpu_torch.ops import get_op as port_get_op
from mxnet_tpu_torch.ops.registry import OpContext as PortOpContext


def _u(rng, shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _fc(rng, n, k, m=4, bias=True):
    ins = [_u(rng, (m, k)), _u(rng, (n, k), 1 / np.sqrt(k))]
    return ins + ([_u(rng, (n,), 0.5)] if bias else [])


def _conv(rng, c, f, kh, groups=1, hw=9, bias=True):
    fan = c // groups * kh * kh
    ins = [_u(rng, (2, c, hw, hw)), _u(rng, (f, c // groups, kh, kh),
                                        1 / np.sqrt(fan))]
    return ins + ([_u(rng, (f,), 0.5)] if bias else [])


def _ints(rng, m, k, n):
    return [rng.randint(-3, 4, (m, k)).astype(np.float32),
            rng.randint(-2, 3, (n, k)).astype(np.float32),
            rng.randint(-5, 6, (n,)).astype(np.float32)]


# (id, op name, params, inputs builder, tolerance)
CASES = [
    ("act-relu", "Activation", {"act_type": "relu"},
     lambda r: [_u(r, (3, 7, 5))], 1e-6),
    ("act-sigmoid", "Activation", {"act_type": "sigmoid"},
     lambda r: [_u(r, (3, 7, 5), 4)], 1e-6),
    ("act-tanh", "Activation", {"act_type": "tanh"},
     lambda r: [_u(r, (3, 7, 5), 4)], 1e-6),
    ("act-softrelu", "Activation", {"act_type": "softrelu"},
     lambda r: [_u(r, (3, 7, 5), 30)], 1e-6),
    ("fc", "FullyConnected", {"num_hidden": 24},
     lambda r: _fc(r, 24, 40), 1e-5),
    ("fc-nobias-4d", "FullyConnected", {"num_hidden": 6, "no_bias": True},
     lambda r: [_u(r, (3, 2, 4, 5)), _u(r, (6, 40), 0.2)], 1e-5),
    ("conv", "Convolution", {"kernel": (3, 3), "num_filter": 8,
                             "pad": (1, 1)},
     lambda r: _conv(r, 4, 8, 3), 1e-5),
    ("conv-stride-dilate", "Convolution",
     {"kernel": (3, 3), "num_filter": 6, "stride": (2, 2),
      "dilate": (2, 2), "pad": (2, 1)},
     lambda r: _conv(r, 3, 6, 3, hw=11), 1e-5),
    ("conv-groups-nobias", "Convolution",
     {"kernel": (1, 1), "num_filter": 8, "num_group": 2, "no_bias": True},
     lambda r: _conv(r, 4, 8, 1, groups=2, bias=False), 1e-5),
    ("pool-max", "Pooling", {"kernel": (2, 2), "stride": (2, 2)},
     lambda r: [_u(r, (2, 3, 9, 8))], 1e-6),
    ("pool-max-pad", "Pooling", {"kernel": (3, 3), "stride": (2, 2),
                                 "pad": (1, 1)},
     lambda r: [_u(r, (2, 3, 9, 8))], 1e-6),
    # integer max pooling pads with the type's least value, as the
    # reference does (-inf has no int32 form)
    ("pool-max-pad-int32", "Pooling", {"kernel": (3, 3), "pad": (1, 1)},
     lambda r: [r.randint(-50, 50, (1, 2, 4, 4)).astype(np.int32)], 0.0),
    ("pool-max-global-int32", "Pooling", {"kernel": (1, 1),
                                          "global_pool": True},
     lambda r: [r.randint(-50, 50, (2, 3, 5, 6)).astype(np.int32)], 0.0),
    ("pool-avg-pad", "Pooling", {"kernel": (3, 3), "pool_type": "avg",
                                 "pad": (1, 1)},
     lambda r: [_u(r, (2, 3, 7, 7))], 1e-5),
    ("pool-sum", "Pooling", {"kernel": (2, 3), "pool_type": "sum",
                             "stride": (1, 2)},
     lambda r: [_u(r, (2, 3, 7, 7))], 1e-5),
    ("pool-global", "Pooling", {"kernel": (1, 1), "global_pool": True,
                                "pool_type": "avg"},
     lambda r: [_u(r, (2, 3, 5, 6))], 1e-5),
    ("dropout-eval", "Dropout", {"p": 0.5},
     lambda r: [_u(r, (4, 9))], 0.0),
    ("softmax", "SoftmaxOutput", {},
     lambda r: [_u(r, (4, 10), 3), np.zeros(4, np.float32)], 1e-6),
    ("softmax-multi", "SoftmaxOutput", {"multi_output": True},
     lambda r: [_u(r, (2, 5, 3, 4), 3), np.zeros((2, 3, 4), np.float32)],
     1e-6),
    ("flatten", "Flatten", {}, lambda r: [_u(r, (3, 2, 4, 5))], 0.0),
    ("fused-fc-relu", "_fused_FullyConnected",
     {"num_hidden": 24, "act_type": "relu"}, lambda r: _fc(r, 24, 40), 1e-5),
    ("fused-fc-softrelu-nobias", "_fused_FullyConnected",
     {"num_hidden": 24, "act_type": "softrelu", "no_bias": True},
     lambda r: _fc(r, 24, 40, bias=False), 1e-5),
    ("fused-fc-int8", "_fused_FullyConnected",
     {"num_hidden": 16, "act_type": "relu", "out_scale": 2.0},
     lambda r: _ints(r, 5, 32, 16), 0.0),
    ("fused-conv-relu", "_fused_Convolution",
     {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1), "act_type": "relu"},
     lambda r: _conv(r, 4, 8, 3), 1e-5),
    ("fused-conv-int8", "_fused_Convolution",
     {"kernel": (3, 3), "num_filter": 4, "act_type": "none",
      "out_scale": 2.0},
     lambda r: [r.randint(-2, 3, (1, 2, 5, 5)).astype(np.float32),
                r.randint(-2, 3, (4, 2, 3, 3)).astype(np.float32),
                r.randint(-3, 4, (4,)).astype(np.float32)], 0.0),
    ("fused-elemwise", "_fused_elemwise",
     {"steps": "relu;_mul_scalar:0.5;_plus_scalar:1.0;exp;sqrt"},
     lambda r: [_u(r, (4, 6), 2)], 1e-6),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _id, name, params, build, tol = case
    rng = np.random.RandomState(zlib.crc32(_id.encode()))
    ins = build(rng)
    jop, top = jax_get_op(name), port_get_op(name)
    jp, tp = jop.parse_params(dict(params)), top.parse_params(dict(params))
    assert jop.serialize_params(jp) == top.serialize_params(tp)
    assert jop.list_arguments(jp) == top.list_arguments(tp)
    shapes = [a.shape for a in ins]
    assert jop.infer_shape(jp, list(shapes)) == \
        top.infer_shape(tp, list(shapes))
    types = [a.dtype for a in ins]
    assert jop.infer_type(jp, types) == top.infer_type(tp, types)
    ref = np.asarray(jop.forward(jp, [jnp.asarray(a) for a in ins], [],
                                 JaxOpContext(is_train=False))[0])
    out = top.forward(tp, [torch.from_numpy(a) for a in ins], [],
                      PortOpContext(is_train=False))[0].numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if tol == 0.0:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
