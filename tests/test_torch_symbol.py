"""Files and graphs shared by the port and the JAX package.

Symbol JSON, the serving pipeline's rewritten JSON (``__passes__``
fingerprint included), ``.params`` files (bfloat16 entries included) and
checkpoint pairs written by either package load in the other unchanged;
``convert.convert_params`` carries the JAX package's arrays across as a
typed copy.  Everything is compared exactly: these are formats, not
arithmetic.
"""
import json

import numpy as np
import pytest
import torch

import ml_dtypes

import mxnet_tpu as mx
import mxnet_tpu.model
import mxnet_tpu.models
import mxnet_tpu.passes
import mxnet_tpu_torch as mt

MODELS = {"vgg16": lambda m: m.get_vgg(), "mlp": lambda m: m.get_mlp()}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_json_identical_and_cross_loads(model):
    jax_json = MODELS[model](mx.models).tojson()
    port_json = MODELS[model](mt.models).tojson()
    assert port_json == jax_json
    assert mt.sym.load_json(jax_json).tojson() == jax_json
    assert mx.sym.load_json(port_json).tojson() == port_json


@pytest.mark.parametrize("model", sorted(MODELS))
def test_serving_pipeline_json_identical(model):
    jax_out, _ = mx.passes.build_serving_pipeline(fuse=True).run(
        mx.sym.load_json(MODELS[model](mx.models).tojson()), {})
    port_out, _ = mt.passes.build_serving_pipeline(fuse=True).run(
        mt.sym.load_json(MODELS[model](mt.models).tojson()), {})
    assert port_out.tojson() == jax_out.tojson()
    graph = json.loads(port_out.tojson())
    assert graph["attrs"]["__passes__"] == \
        mx.passes.build_serving_pipeline(fuse=True).fingerprint()
    ops = [n["op"] for n in graph["nodes"] if n["op"] != "null"]
    if model == "vgg16":
        # fc6 and fc7 fuse with their relus; dropout is gone; fc8 feeds
        # the softmax unfused
        assert ops.count("_fused_FullyConnected") == 2
        assert ops.count("_fused_Convolution") == 13
        assert "Dropout" not in ops and "Activation" not in ops
        assert ops[-2:] == ["FullyConnected", "SoftmaxOutput"]


def test_vgg16_infer_shape_matches():
    shapes = {"data": (8, 3, 224, 224), "softmax_label": (8,)}
    assert mt.models.get_vgg().infer_shape(**shapes) == \
        mx.models.get_vgg().infer_shape(**shapes)


def _mixed_arrays():
    rng = np.random.RandomState(5)
    return {
        "w32": rng.randn(4, 3).astype(np.float32),
        "w16": rng.randn(5).astype(np.float16),
        "wbf16": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
        "codes": rng.randint(-127, 128, (6,)).astype(np.int8),
        "ids": rng.randint(0, 1000, (3,)).astype(np.int32),
    }


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_params_file_jax_to_port(tmp_path):
    arrays = _mixed_arrays()
    fname = str(tmp_path / "jax.params")
    mx.nd.save(fname, {k: mx.nd.array(v, dtype=v.dtype)
                       for k, v in arrays.items()})
    loaded = mt.nd.load(fname, ctx=mt.cpu())
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        assert _same(loaded[k].asnumpy(), v), k
    assert loaded["wbf16"]._get().dtype == torch.bfloat16


def test_params_file_port_to_jax(tmp_path):
    arrays = _mixed_arrays()
    fname = str(tmp_path / "port.params")
    mt.nd.save(fname, {k: mt.nd.array(v, ctx=mt.cpu(), dtype=v.dtype)
                       for k, v in arrays.items()})
    loaded = mx.nd.load(fname)
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        assert _same(loaded[k].asnumpy(), v), k
    # a list save round-trips as a list
    mt.nd.save(fname, [mt.nd.array(arrays["w32"], ctx=mt.cpu())])
    assert _same(mx.nd.load(fname)[0].asnumpy(), arrays["w32"])


# The reference runs with jax's 64-bit types off: its arrays narrow int64
# to int32 and float64 to float32, and the port's do the same.
NARROW_CASES = [("int64", np.int64, np.int32),
                ("float64", np.float64, np.float32)]


@pytest.mark.parametrize("name,wide,narrow", NARROW_CASES,
                         ids=[c[0] for c in NARROW_CASES])
def test_64bit_arrays_narrow_as_in_the_reference(name, wide, narrow):
    src = (np.arange(-6, 6) * 3).reshape(3, 4).astype(wide)
    for make in (lambda pkg, **kw: pkg.nd.array(src, dtype=wide, **kw),
                 lambda pkg, **kw: pkg.nd.zeros((3, 4), dtype=wide, **kw),
                 lambda pkg, **kw: pkg.nd.empty((3, 4), dtype=wide, **kw)):
        want = make(mx)
        got = make(mt, ctx=mt.cpu())
        assert want.dtype == got.dtype == np.dtype(narrow)
        assert got.asnumpy().dtype == want.asnumpy().dtype
    np.testing.assert_array_equal(mt.nd.array(src, ctx=mt.cpu(),
                                              dtype=wide).asnumpy(),
                                  np.asarray(mx.nd.array(src, dtype=wide)
                                             .asnumpy()))
    t = mt.nd.array(torch.from_numpy(src), ctx=mt.cpu(), dtype=wide)
    assert t._get().dtype == mt.nd.torch_dtype(narrow)


def _write_mxtpu001(fname, names, arrays):
    """An NDArray file (ndarray.py's MXTPU001 layout) holding the arrays
    in their own numpy dtypes, as a writer with 64-bit types on makes."""
    import io
    import pickle
    import struct
    blob = io.BytesIO()
    np.savez(blob, *arrays)
    meta = pickle.dumps({"names": names,
                         "dtypes": [a.dtype.name for a in arrays]})
    with open(fname, "wb") as f:
        f.write(b"MXTPU001" + struct.pack("<Q", len(meta)) + meta +
                blob.getvalue())


def test_64bit_file_loads_narrowed_as_in_the_reference(tmp_path):
    rng = np.random.RandomState(11)
    arrays = [rng.randint(-2 ** 30, 2 ** 30, (4, 5)).astype(np.int64),
              rng.randn(3, 2).astype(np.float64),
              rng.randn(2).astype(np.float32)]
    fname = str(tmp_path / "wide.params")
    _write_mxtpu001(fname, ["ids", "w64", "w32"], arrays)
    want = mx.nd.load(fname)
    got = mt.nd.load(fname, ctx=mt.cpu())
    assert list(got) == list(want) == ["ids", "w64", "w32"]
    for k in want:
        w, g = want[k].asnumpy(), got[k].asnumpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w)
    assert got["ids"].dtype == np.int32 and got["w64"].dtype == np.float32
    with open(fname, "rb") as f:
        blob = f.read()
    assert mt.nd.loads(blob, ctx=mt.cpu())["ids"].dtype == np.int32


def test_fully_connected_on_float64_gives_float32_in_both(tmp_path):
    rng = np.random.RandomState(12)
    feed = {"data": rng.randn(3, 10), "fc_weight": rng.randn(4, 10) * 0.3,
            "fc_bias": rng.randn(4)}
    types = {k: np.float64 for k in feed}
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                     num_hidden=4, name="fc")
        ex = sym.simple_bind(ctx, grad_req="null", type_dict=types,
                             data=(3, 10))
        for k, v in feed.items():
            ex.arg_dict[k][:] = pkg.nd.array(v, ctx=ctx, dtype=np.float64)
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    want, got = outs
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_checkpoint_pair_both_directions(tmp_path):
    sym_j = mx.models.get_mlp()
    shapes = sym_j.infer_shape(data=(2, 784))[0]
    rng = np.random.RandomState(0)
    params = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(sym_j.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    pj = str(tmp_path / "from_jax")
    mx.model.save_checkpoint(pj, 3, sym_j,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    sym_t, arg_t, aux_t = mt.model.load_checkpoint(pj, 3, ctx=mt.cpu())
    assert sym_t.tojson() == sym_j.tojson() and aux_t == {}
    assert all(_same(arg_t[k].asnumpy(), v) for k, v in params.items())
    pt = str(tmp_path / "from_port")
    mt.model.save_checkpoint(pt, 4, sym_t, arg_t, aux_t)
    sym_b, arg_b, aux_b = mx.model.load_checkpoint(pt, 4)
    assert sym_b.tojson() == sym_j.tojson() and aux_b == {}
    assert all(_same(arg_b[k].asnumpy(), v) for k, v in params.items())
    with pytest.raises(mt.MXNetError, match="missing"):
        mt.model.load_checkpoint(pt, 5, ctx=mt.cpu())


def test_convert_params_is_a_typed_copy():
    arrays = _mixed_arrays()
    arrays["conv1_weight"] = np.random.RandomState(1).randn(
        8, 3, 3, 3).astype(np.float32)                      # OIHW
    jax_side = {("aux:" if k == "ids" else "arg:" if k.startswith("w")
                 else "") + k: mx.nd.array(v, dtype=v.dtype).asnumpy()
                for k, v in arrays.items()}
    arg, aux = mt.convert.convert_params(jax_side, ctx=mt.cpu())
    assert sorted(arg) == sorted(k for k in arrays if k != "ids")
    assert list(aux) == ["ids"]
    for k, v in arrays.items():
        got = (aux if k == "ids" else arg)[k]
        assert got.context == mt.cpu()
        assert _same(got.asnumpy(), v), k
    # a copy: writing the port's array leaves the JAX side untouched
    arg["w32"][:] = 0.0
    assert _same(jax_side["arg:w32"], arrays["w32"])


def test_nd_defaults_to_the_card():
    assert mt.current_context() == mt.gpu(0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context works")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2, 2))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.array(np.ones(3))
    with mt.cpu():
        assert mt.nd.zeros((2, 2)).context == mt.cpu()
