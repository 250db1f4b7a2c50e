"""The port's C ABI library (``libmxtpu_torch_capi.so``, built from
``mxnet_tpu_torch/csrc/capi`` against the repository's ``include/``) and
its predict-only library, driven from C on the CPU.

* ``tests/cpp/test_c_api.cc``, unchanged, against the port's library:
  NDArray, registry invoke, symbol/executor, kvstore/optimizer, recordio,
  the predict leg on a checkpoint the port wrote, raw bytes, custom op
  and monitor callbacks.  It prints ``ALL C API TESTS PASSED``.
* The predict-only library (``libmxtpu_torch_predict.so``, and the
  in-process build without ``-lpython``), opened with ``ctypes`` in a
  clean subprocess, serves an MLP and a LeNet checkpoint through
  ``MXPredCreate``/``SetInput``/``Forward``/``GetOutput`` within
  ``allclose`` of the JAX package's Python ``Predictor`` on the same
  checkpoint, itself run in a clean subprocess.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native_build

from _torch_native import ROOT, compile_harness, run


def _write_mlp(prefix):
    """The checkpoint ``tests/test_c_api.py`` writes, written by the
    port."""
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        fc = tmx.sym.FullyConnected(data=data, name="fc1", num_hidden=3)
        net = tmx.sym.SoftmaxOutput(data=fc, name="softmax")
        net.save(prefix + "-symbol.json")
        rng = np.random.RandomState(0)
        tmx.nd.save(prefix + "-0001.params", {
            "arg:fc1_weight": tmx.nd.array(rng.uniform(-0.1, 0.1, (3, 8))),
            "arg:fc1_bias": tmx.nd.array(np.zeros(3))})


def test_c_api_harness_against_port(tmp_path):
    prefix = str(tmp_path / "capimlp")
    _write_mlp(prefix)
    binary = compile_harness("test_c_api.cc", str(tmp_path / "test_c_api"))
    res = run(binary, [prefix])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ALL C API TESTS PASSED" in res.stdout


_PRED_CHILD = r'''
import ctypes, json, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
sym = open(sys.argv[2]).read()
params = open(sys.argv[3], "rb").read()
shape = json.loads(sys.argv[4])
x = np.load(sys.argv[5])
h = ctypes.c_void_p()
keys = (ctypes.c_char_p * 1)(b"data")
indptr = (ctypes.c_uint * 2)(0, len(shape))
dims = (ctypes.c_uint * len(shape))(*shape)
def ok(rc):
    if rc != 0:
        raise SystemExit("ABI error: " + lib.MXGetLastError().decode())
lib.MXGetLastError.restype = ctypes.c_char_p
ok(lib.MXPredCreate(sym.encode(), params, len(params), 1, 0, 1, keys,
                    indptr, dims, ctypes.byref(h)))
ok(lib.MXPredSetInput(h, b"data", x.ctypes.data_as(
    ctypes.POINTER(ctypes.c_float)), x.size))
ok(lib.MXPredForward(h))
nd = ctypes.c_uint()
od = ctypes.POINTER(ctypes.c_uint)()
ok(lib.MXPredGetOutputShape(h, 0, ctypes.byref(od), ctypes.byref(nd)))
oshape = [od[i] for i in range(nd.value)]
out = np.empty(oshape, np.float32)
ok(lib.MXPredGetOutput(h, 0, out.ctypes.data_as(
    ctypes.POINTER(ctypes.c_float)), out.size))
ok(lib.MXPredFree(h))
np.save(sys.argv[6], out)
'''


def _lenet(pkg):
    data = pkg.sym.Variable("data")
    c = pkg.sym.Convolution(data=data, kernel=(5, 5), num_filter=6,
                            name="conv1")
    a = pkg.sym.Activation(data=c, act_type="tanh")
    p = pkg.sym.Pooling(data=a, pool_type="max", kernel=(2, 2),
                        stride=(2, 2))
    f = pkg.sym.FullyConnected(data=pkg.sym.Flatten(data=p), num_hidden=10,
                               name="fc1")
    return pkg.sym.SoftmaxOutput(data=f, name="softmax")


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(data=pkg.sym.FullyConnected(
        data=data, num_hidden=16, name="fc1"), act_type="relu")
    f = pkg.sym.FullyConnected(data=h, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=f, name="softmax")


MODELS = {"mlp": (_mlp, (5, 12)), "lenet": (_lenet, (3, 1, 16, 16))}


_JAX_CHILD = r'''
import sys
import numpy as np
import mxnet_tpu as mx
sym, par, shape, x, out = sys.argv[1:6]
pred = mx.predictor.Predictor(open(sym).read(), par,
                              {"data": tuple(eval(shape))}, "cpu", 0)
pred.set_input("data", np.load(x))
pred.forward()
np.save(out, np.asarray(pred.get_output(0)))
'''


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each model's checkpoint (written by the port), input and the JAX
    package's Predictor output, the latter from a fresh process so that no
    other test's state reaches the reference."""
    out = {}
    for model, (build, shape) in MODELS.items():
        d = tmp_path_factory.mktemp(model)
        rs = np.random.RandomState(7)
        with tmx.cpu():
            net = build(tmx)
            arg_shapes, _, _ = net.infer_shape(data=shape)
            params = {"arg:" + n: tmx.nd.array(
                rs.uniform(-0.3, 0.3, s).astype(np.float32))
                for n, s in zip(net.list_arguments(), arg_shapes)
                if n not in ("data", "softmax_label")}
            net.save(str(d / "m-symbol.json"))
            tmx.nd.save(str(d / "m-0000.params"), params)
        np.save(str(d / "x.npy"),
                rs.uniform(-1, 1, shape).astype(np.float32))
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
        res = subprocess.run(
            [sys.executable, "-c", _JAX_CHILD, str(d / "m-symbol.json"),
             str(d / "m-0000.params"), repr(list(shape)), str(d / "x.npy"),
             str(d / "want.npy")], env=env, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        out[model] = (d, shape, np.load(str(d / "want.npy")))
    return out


@pytest.mark.parametrize("variant", ["predict", "predict_inproc"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_predict_library_matches_jax_predictor(checkpoints, tmp_path,
                                               model, variant):
    d, shape, want = checkpoints[model]
    res = subprocess.run(
        [sys.executable, "-c", _PRED_CHILD, native_build.path(variant),
         str(d / "m-symbol.json"), str(d / "m-0000.params"),
         json.dumps(list(shape)), str(d / "x.npy"), str(tmp_path / "y.npy")],
        env=native_build.embed_env(), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.load(str(tmp_path / "y.npy"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
