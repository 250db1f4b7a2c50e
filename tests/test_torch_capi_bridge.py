"""The port's C ABI bridge (``mxnet_tpu_torch/capi_bridge.py``) held call
for call against the JAX package's (``mxnet_tpu.capi_bridge``): the same
plain-typed arguments go to both, integers and JSON must match exactly
and floats within ``allclose``.

Families: ndarray create / copy-from / copy-to / slice / reshape /
``save_raw`` bytes; ``func_invoke`` of registry ops; symbol JSON,
``infer_shape`` and ``infer_type``; executor bind / forward / backward;
kvstore push/pull; ``pred_*`` and ``ndlist_*``.  Then the port's
recorded differences: dtype code 5 is ``torch.bfloat16``; device code 4
raises naming code 2, and code 2 without a card raises through
``MXGetLastError`` of the in-process ABI library; ``rtc_create`` takes
CUDA source; ``pred_partial_forward`` runs the whole forward at step 0.
"""
import ctypes
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import capi_bridge as jb
from mxnet_tpu_torch import capi_bridge as tb
from mxnet_tpu_torch import native_build
from mxnet_tpu_torch.base import MXNetError

BRIDGES = (jb, tb)
CPU = 1


def _f32(a):
    return np.ascontiguousarray(a, np.float32).tobytes()


def _arr(b, h):
    shape = b.ndarray_get_shape(h)
    code = b.ndarray_get_dtype(h)
    dt = {0: np.float32, 3: np.uint8, 4: np.int32, 2: np.float16}[code]
    return np.frombuffer(b.ndarray_sync_copy_to(h), dt).reshape(shape)


def test_ndarray_family_matches():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 6).astype(np.float32)
    res = []
    for b in BRIDGES:
        h = b.ndarray_create([4, 6], CPU, 0, 0)
        b.ndarray_sync_copy_from(h, _f32(x), 24)
        s = b.ndarray_slice(h, 1, 3)
        a = b.ndarray_at(h, 2)
        r = b.ndarray_reshape(h, [6, 4])
        res.append(dict(
            shape=b.ndarray_get_shape(h), dtype=b.ndarray_get_dtype(h),
            item=b.ndarray_get_itemsize(h), ctx=b.ndarray_get_context(h),
            data=b.ndarray_sync_copy_to(h, 24),
            slice=(b.ndarray_get_shape(s), b.ndarray_sync_copy_to(s)),
            at=(b.ndarray_get_shape(a), b.ndarray_sync_copy_to(a)),
            reshape=(b.ndarray_get_shape(r), b.ndarray_sync_copy_to(r)),
            raw=b.ndarray_save_raw(h),
            check=b.ndarray_check_copy_size(h, 24)))
        u = b.ndarray_create([3, 5], CPU, 0, 3)
        b.ndarray_sync_copy_from(u, bytes(range(15)), 15)
        res[-1]["u8"] = (b.ndarray_get_dtype(u), b.ndarray_save_raw(u))
        back = b.ndarray_load_raw(res[-1]["raw"])
        res[-1]["roundtrip"] = b.ndarray_sync_copy_to(back)
        with pytest.raises(ValueError):
            b.ndarray_sync_copy_from(h, _f32(x), 23)
    assert res[0] == res[1]
    assert res[1]["data"] == x.tobytes()


def test_ndarray_save_load_files_cross(tmp_path):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for src, dst in ((tb, jb), (jb, tb)):
        h = src.ndarray_create([2, 3], CPU, 0, 0)
        src.ndarray_sync_copy_from(h, _f32(x))
        path = str(tmp_path / ("%s.nd" % src.__name__))
        src.ndarray_save(path, [h], ["w"])
        handles, names = dst.ndarray_load(path)
        assert names == ["w"]
        assert dst.ndarray_sync_copy_to(handles[0]) == x.tobytes()


INVOKES = [
    ("_plus", 2, [], {}),
    ("_mul_scalar", 1, [2.5], {}),
    ("clip", 1, [-0.5, 0.5], {}),
    ("dot", 2, [], {}),
    ("sum", 1, [], {"axis": "1"}),
]


@pytest.mark.parametrize("name,nuse,scalars,kw", INVOKES,
                         ids=[c[0] for c in INVOKES])
def test_func_invoke_matches(name, nuse, scalars, kw):
    rs = np.random.RandomState(1)
    ins = [rs.randn(4, 4).astype(np.float32) for _ in range(nuse)]
    outs = []
    for b in BRIDGES:
        assert b.func_describe(name)[:3] == jb.func_describe(name)[:3]
        hs = []
        for x in ins:
            h = b.ndarray_create([4, 4], CPU, 0, 0)
            b.ndarray_sync_copy_from(h, _f32(x))
            hs.append(h)
        out_shape = [4] if name == "sum" else [4, 4]
        o = b.ndarray_create(out_shape, CPU, 0, 0)
        b.func_invoke(name, hs, scalars, [o], list(kw), list(kw.values()))
        outs.append(_arr(b, o))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def _mlp_handles(b):
    d = b.symbol_create_variable("data")
    fc = b.symbol_create_atomic("FullyConnected", ["num_hidden", "name"],
                                ["5", "fc1"])
    b.symbol_compose(fc, "fc1", ["data"], [d])
    act = b.symbol_create_atomic("Activation", ["act_type", "name"],
                                 ["tanh", "act1"])
    b.symbol_compose(act, "act1", [], [fc])
    out = b.symbol_create_atomic("SoftmaxOutput", ["name"], ["softmax"])
    b.symbol_compose(out, "softmax", [], [act])
    return out


def test_symbol_family_matches():
    res = []
    for b in BRIDGES:
        s = _mlp_handles(b)
        b.symbol_set_attr(s, "ctx_group", "dev1")
        res.append(dict(
            args=b.symbol_list_arguments(s), outs=b.symbol_list_outputs(s),
            aux=b.symbol_list_aux(s), name=b.symbol_get_name(s),
            attr=b.symbol_get_attr(s, "ctx_group"),
            shape=b.symbol_infer_shape(s, ["data"], [[3, 7]], False),
            partial=b.symbol_infer_shape(s, [], [], True),
            types=b.symbol_infer_type(s, ["data"], [0]),
            internals=b.symbol_list_outputs(b.symbol_get_internals(s)),
            out1=b.symbol_list_outputs(b.symbol_get_output(
                b.symbol_get_internals(s), 1))))
        js = json.loads(b.symbol_to_json(s))
        res[-1]["json_nodes"] = [(n["op"], n["name"]) for n in js["nodes"]]
        res[-1]["json_back"] = b.symbol_list_arguments(
            b.symbol_from_json(b.symbol_to_json(s)))
    assert res[0] == res[1]


def test_symbol_json_crosses_bridges():
    """A graph saved by either bridge loads in the other with the same
    arguments and outputs."""
    for src, dst in ((tb, jb), (jb, tb)):
        js = src.symbol_to_json(_mlp_handles(src))
        h = dst.symbol_from_json(js)
        assert dst.symbol_list_arguments(h) == src.symbol_list_arguments(
            src.symbol_from_json(js))


def test_executor_family_matches():
    rs = np.random.RandomState(2)
    vals = {"data": rs.randn(3, 7), "fc1_weight": rs.randn(5, 7) * 0.3,
            "fc1_bias": rs.randn(5) * 0.1,
            "softmax_label": np.array([0, 3, 1])}
    got = []
    for b in BRIDGES:
        s = _mlp_handles(b)
        names = b.symbol_list_arguments(s)
        args, grads = [], []
        for n in names:
            v = np.asarray(vals[n], np.float32)
            h = b.ndarray_create(list(v.shape), CPU, 0, 0)
            b.ndarray_sync_copy_from(h, _f32(v))
            args.append(h)
            g = b.ndarray_create(list(v.shape), CPU, 0, 0)
            grads.append(g)
        e = b.executor_bind(s, CPU, 0, [], [], [], args, grads,
                            [1] * len(names), [])
        b.executor_forward(e, 1)
        outs = [_arr(b, o) for o in b.executor_outputs(e)]
        b.executor_backward(e, [])
        got.append((outs, {n: _arr(b, g) for n, g in zip(names, grads)
                           if n != "softmax_label"}))
    for a, c in zip(got[0][0], got[1][0]):
        np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-6)
    for n in got[0][1]:
        np.testing.assert_allclose(got[1][1][n], got[0][1][n], rtol=1e-5,
                                   atol=1e-6)


def test_kvstore_family_matches():
    res = []
    for b in BRIDGES:
        kv = b.kvstore_create("local")
        hs = []
        for k in range(2):
            h = b.ndarray_create([2, 3], CPU, 0, 0)
            b.ndarray_sync_copy_from(h, _f32(np.full((2, 3), k + 1.0)))
            hs.append(h)
        b.kvstore_init(kv, [3, 5], hs)
        push = []
        for k in range(2):
            h = b.ndarray_create([2, 3], CPU, 0, 0)
            b.ndarray_sync_copy_from(h, _f32(np.arange(6) * (k + 2)))
            push.append(h)
        b.kvstore_push(kv, [3, 5], push, 0)
        outs = [b.ndarray_create([2, 3], CPU, 0, 0) for _ in range(2)]
        b.kvstore_pull(kv, [3, 5], outs, 0)
        res.append((b.kvstore_get_type(kv), b.kvstore_get_rank(kv),
                    b.kvstore_get_group_size(kv),
                    [b.ndarray_sync_copy_to(o) for o in outs]))
    assert res[0] == res[1]


def test_optimizer_update_matches():
    res = []
    w0 = np.linspace(-1, 1, 6).astype(np.float32)
    g0 = np.linspace(0.5, -0.5, 6).astype(np.float32)
    for b in BRIDGES:
        assert b.optimizer_find_creator("sgd") == 1
        assert b.optimizer_find_creator("nosuch") == 0
        opt = b.optimizer_create("sgd", ["momentum", "rescale_grad"],
                                 ["0.9", "0.5"])
        w, g = (b.ndarray_create([6], CPU, 0, 0) for _ in range(2))
        b.ndarray_sync_copy_from(w, _f32(w0))
        b.ndarray_sync_copy_from(g, _f32(g0))
        for _ in range(3):
            b.optimizer_update(opt, 0, w, g, 0.1, 0.01)
        res.append(_arr(b, w))
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6, atol=1e-7)


def _pred_blob(b, tmp_path):
    rs = np.random.RandomState(4)
    s = _mlp_handles(b)
    js = b.symbol_to_json(s)
    params = {"arg:fc1_weight": rs.randn(5, 7).astype(np.float32),
              "arg:fc1_bias": rs.randn(5).astype(np.float32)}
    with tmx.cpu():
        path = str(tmp_path / "p.params")
        tmx.nd.save(path, {k: tmx.nd.array(v) for k, v in params.items()})
    return js, open(path, "rb").read()


def test_pred_and_ndlist_families_match(tmp_path):
    js, blob = _pred_blob(tb, tmp_path)
    x = np.random.RandomState(5).randn(3, 7).astype(np.float32)
    res = []
    for b in BRIDGES:
        p = b.pred_create(js, blob, CPU, 0, ["data"], [[3, 7]])
        b.pred_set_input(p, "data", _f32(x))
        assert b.pred_partial_forward(p, 0) == 0
        out0 = b.pred_get_output(p, 0)
        b.pred_forward(p)
        po = b.pred_create(js, blob, CPU, 0, ["data"], [[3, 7]], ["fc1"])
        b.pred_set_input(po, "data", _f32(x))
        b.pred_forward(po)
        nl, names = b.ndlist_create(blob)
        res.append(dict(
            shape=b.pred_get_output_shape(p, 0),
            out=np.frombuffer(b.pred_get_output(p, 0), np.float32),
            out0=np.frombuffer(out0, np.float32),
            fc=np.frombuffer(b.pred_get_output(po, 0), np.float32),
            fc_shape=b.pred_get_output_shape(po, 0),
            names=names,
            items=[b.ndlist_get(nl, i) for i in range(len(names))]))
    for k in ("shape", "fc_shape", "names", "items"):
        assert res[0][k] == res[1][k], k
    for k in ("out", "out0", "fc"):
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(res[1]["out"], res[1]["out0"])


def test_recordio_family_matches(tmp_path):
    for b in BRIDGES:
        path = str(tmp_path / ("%s.rec" % b.__name__))
        w = b.recordio_writer_create(path)
        for i in range(3):
            b.recordio_write(w, bytes([i]) * (5 + i))
        b.recordio_close(w)
        r = b.recordio_reader_create(path)
        assert [b.recordio_read(r) for _ in range(4)] == \
            [bytes([i]) * (5 + i) for i in range(3)] + [None]
        b.recordio_close(r)
    assert open(str(tmp_path / "mxnet_tpu.capi_bridge.rec"), "rb").read() \
        == open(str(tmp_path / "mxnet_tpu_torch.capi_bridge.rec"),
                "rb").read()


# -- the port's recorded differences ------------------------------------------

def test_bfloat16_crosses_as_code_5():
    """Code 5 is torch.bfloat16; its bits cross unchanged, and save_raw
    frames them as the JAX bridge does."""
    x = torch.tensor([1.5, -2.25, 3.0, 0.1], dtype=torch.bfloat16)
    bits = x.view(torch.int16).numpy().tobytes()
    res = []
    for b in BRIDGES:
        h = b.ndarray_create([4], CPU, 0, 5)
        assert b.ndarray_get_dtype(h) == 5 and b.ndarray_get_itemsize(h) == 2
        b.ndarray_sync_copy_from(h, bits, 4)
        res.append((b.ndarray_sync_copy_to(h), b.ndarray_save_raw(h)))
    assert res[0] == res[1] and res[1][0] == bits
    h = tb.ndarray_load_raw(res[1][1])
    assert tb._get(h)._get().dtype == torch.bfloat16
    assert tb.ndarray_sync_copy_to(h) == bits


def test_device_code_4_raises_naming_code_2():
    with pytest.raises(MXNetError, match="code 2"):
        tb.ndarray_create([2], 4, 0, 0)
    with pytest.raises(MXNetError, match="code 2"):
        tb.pred_create("{}", b"", 4, 0, ["data"], [[1]])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_gpu_request_without_card_raises_through_last_error():
    """The in-process ABI library: a code-2 array on a machine with no
    card fails with the reason in MXGetLastError; it never lands on the
    CPU."""
    lib = ctypes.CDLL(native_build.path("capi_inproc"))
    lib.MXGetLastError.restype = ctypes.c_char_p
    shape = (ctypes.c_uint * 2)(2, 3)
    out = ctypes.c_void_p()
    assert lib.MXNDArrayCreate(shape, 2, 2, 0, 0, ctypes.byref(out)) == -1
    assert b"CUDA" in lib.MXGetLastError() or \
        b"gpu" in lib.MXGetLastError()
    assert lib.MXNDArrayCreate(shape, 2, 4, 0, 0, ctypes.byref(out)) == -1
    assert b"code 2" in lib.MXGetLastError()
    assert lib.MXNDArrayCreate(shape, 2, 1, 0, 0, ctypes.byref(out)) == 0
    ctx = (ctypes.c_int(), ctypes.c_int())
    assert lib.MXNDArrayGetContext(out, ctypes.byref(ctx[0]),
                                   ctypes.byref(ctx[1])) == 0
    assert (ctx[0].value, ctx[1].value) == (1, 0)
    assert lib.MXNDArrayFree(out) == 0


def test_rtc_create_takes_cuda_source():
    """The port's rtc_create builds mx.rtc from the CUDA body (decorated
    with the prototypes); the push of a CUDA kernel needs the card, so on
    host arrays it raises rather than run anything on the CPU."""
    body = "  int i = threadIdx.x; y[i] = 2.0f * x[i];"
    x = tb.ndarray_create([8], CPU, 0, 0)
    y = tb.ndarray_create([8], CPU, 0, 0)
    h = tb.rtc_create("twice", ["x"], [x], ["y"], [y], body)
    rtc = tb._get(h)
    assert "__global__ void twice(const float* x, float* y)" in rtc.source
    assert body in rtc.source
    with pytest.raises(MXNetError):
        tb.rtc_push(h, [x], [y], [1, 1, 1], [8, 1, 1])

