"""The port's serving path against the JAX package's, on the CPU.

Full-depth VGG-16 through both packages' fused Predictors, a narrow
VGG-shaped checkpoint pair written by the JAX package and served by both
ServeEngines, and the port's rules: it imports no JAX, it runs on the
card by default and raises without one, and the serving options it does
not carry yet raise instead of being ignored (the int8, float16 and
uint8-wire options are held in ``test_torch_quantize.py``).

Tolerance for float32 model outputs: both packages compute in float32
with sums in different orders (XLA against PyTorch's CPU kernels); the
softmax outputs agree to 1e-5 relative with a 1e-7 absolute floor.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.model
import mxnet_tpu.models
import mxnet_tpu.passes
import mxnet_tpu.predictor
import mxnet_tpu.serve
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(sym, shapes, seed):
    """Uniform weights at sqrt(6 / fan_in), small uniform biases."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        scale = 0.01 if len(shape) == 1 else np.sqrt(6.0 / np.prod(shape[1:]))
        out[name] = (rng.uniform(-1, 1, shape) * scale).astype(np.float32)
    return out


def test_full_depth_vgg16_predictor_parity():
    # all 16 layers at 32x32 input, 10 classes: 34 M parameters; fc6
    # (K=512, N=4096) and fc7 (4096 x 4096) run fused in both packages
    sym = mx.models.get_vgg(num_classes=10)
    shapes = {"data": (2, 3, 32, 32), "softmax_label": (2,)}
    params = _params(sym, shapes, seed=0)
    x = np.random.RandomState(1).uniform(0, 1, shapes["data"]).astype(
        np.float32)
    jax_pred = mx.predictor.Predictor(
        sym.tojson(), {k: mx.nd.array(v) for k, v in params.items()},
        shapes, pipeline=mx.passes.build_serving_pipeline(fuse=True))
    ref = jax_pred.predict(x)
    port_pred = mt.Predictor(
        mt.models.get_vgg(num_classes=10).tojson(), params, shapes,
        dev_type="cpu", pipeline=mt.passes.build_serving_pipeline(fuse=True))
    assert port_pred.symbol.tojson() == jax_pred.symbol.tojson()
    out = port_pred.predict(x)
    assert out.shape == (2, 10) and np.all(np.isfinite(out))
    assert out.max() > 0.2            # far from uniform: a real signal
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    unfused = mt.Predictor(sym.tojson(), params, shapes, dev_type="cpu")
    np.testing.assert_allclose(unfused.predict(x), out, rtol=RTOL,
                               atol=ATOL)


def _narrow_vgg(sym_mod, classes=5):
    """Two conv blocks and the fc6/fc7/fc8 head of VGG-16, narrow."""
    data = sym_mod.Variable("data")
    body = data
    for stage, (filters, n) in enumerate(((8, 2), (16, 2)), start=1):
        for i in range(n):
            body = sym_mod.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                       num_filter=filters,
                                       name="conv%d_%d" % (stage, i + 1))
            body = sym_mod.Activation(data=body, act_type="relu",
                                      name="relu%d_%d" % (stage, i + 1))
        body = sym_mod.Pooling(data=body, pool_type="max", kernel=(2, 2),
                               stride=(2, 2), name="pool%d" % stage)
    body = sym_mod.Flatten(data=body, name="flatten")
    for layer in (6, 7):
        body = sym_mod.FullyConnected(data=body, num_hidden=32,
                                      name="fc%d" % layer)
        body = sym_mod.Activation(data=body, act_type="relu",
                                  name="relu%d" % layer)
        body = sym_mod.Dropout(data=body, p=0.5, name="drop%d" % layer)
    body = sym_mod.FullyConnected(data=body, num_hidden=classes, name="fc8")
    return sym_mod.SoftmaxOutput(data=body, name="softmax")


def _serve_all(engine, items, n_threads=4):
    answers = [None] * len(items)
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(items[i]))
                    for i in range(idx, len(items), n_threads)]
            for i, f in futs:
                answers[i] = f.result(timeout=60)
        except Exception as e:              # reported by the assert below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return answers


def test_serve_engine_parity_with_jax(tmp_path):
    sym = _narrow_vgg(mx.sym)
    assert _narrow_vgg(mt.sym).tojson() == sym.tojson()
    shapes = {"data": (1, 3, 16, 16), "softmax_label": (1,)}
    params = _params(sym, shapes, seed=2)
    prefix = str(tmp_path / "narrow_vgg")
    mx.model.save_checkpoint(prefix, 1, sym,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    rng = np.random.RandomState(3)
    items = [rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
             for _ in range(16)]
    # deadline_ms=0: no queue deadline, so a loaded test host cannot
    # expire a request; answers are what this test compares
    jax_eng = mx.serve.ServeEngine.from_checkpoint(
        prefix, 1, shapes, fuse=True, dev_type="cpu", deadline_ms=0)
    try:
        ref = _serve_all(jax_eng, items)
    finally:
        jax_eng.close()
    port_eng = mt.serve.ServeEngine.from_checkpoint(
        prefix, 1, shapes, fuse=True, dev_type="cpu", deadline_ms=0)
    try:
        assert port_eng.buckets == jax_eng.buckets == (1, 2, 4, 8)
        assert port_eng._predictor.symbol.tojson() == \
            jax_eng._predictor.symbol.tojson()
        out = _serve_all(port_eng, items)
        report = port_eng.stats.report()
    finally:
        port_eng.close()
    assert report["completed"] == 16 and report["failed"] == 0
    assert sum(report["bucket_hits"].values()) == report["batches"]
    for a, r in zip(out, ref):
        assert a.shape == (5,)
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


def test_port_imports_no_jax():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.ops.cuda_kernels, mxnet_tpu_torch.trace, "
            "mxnet_tpu_torch.online, mxnet_tpu_torch.dist.shardsearch, "
            "mxnet_tpu_torch.dist.report, chip_smoke, kernel_ab\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_attention_ab_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "kernel_ab.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "paged_ms" not in proc.stdout


def test_default_device_predictor_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: gpu(0) is valid")
    sym = mt.models.get_mlp()
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.Predictor(sym.tojson(), {}, {"data": (1, 784)})
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serve.ServeEngine(sym, {}, {"data": (1, 784)})


@pytest.mark.parametrize("option", ["mesh", "param_specs", "autotune"])
def test_unported_serve_options_raise(option, tmp_path, monkeypatch):
    """Every option is ported now: ``autotune`` builds the engine
    (``tests/test_torch_autotune.py`` holds its answers); ``mesh`` and
    ``param_specs`` (``tests/test_torch_multichip.py``) refuse what the
    JAX package refuses: a mesh wider than the process group, specs
    without a mesh."""
    sym = mt.models.get_mlp()
    if option == "autotune":
        monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
        eng = mt.serve.ServeEngine(sym, {}, {"data": (1, 784)},
                                   dev_type="cpu", batch_buckets=(1, 2),
                                   autotune=True)
        eng.close()
        assert mt.autotune.recent_stats()[-1].name == "serve:pipeline"
        return
    value, error, match = {
        "mesh": ("tp=2", ValueError, "needs 2 devices, have 1"),
        "param_specs": ({"a": 1}, mt.serve.ServeError,
                        "without mesh")}[option]
    with pytest.raises(error, match=match):
        mt.serve.ServeEngine(sym, {}, {"data": (1, 784)}, dev_type="cpu",
                             **{option: value})


def test_serve_engine_reload_swaps_weights_between_batches():
    sym = mt.models.get_mlp()
    shapes = {"data": (1, 784), "softmax_label": (1,)}
    old, new = _params(sym, shapes, seed=4), _params(sym, shapes, seed=5)
    x = np.random.RandomState(6).uniform(0, 1, (784,)).astype(np.float32)

    def expected(params):
        pred = mt.Predictor(sym.tojson(), params, shapes, dev_type="cpu")
        return pred.predict(x[None])[0]

    eng = mt.serve.ServeEngine(sym, old, shapes, fuse=True, dev_type="cpu",
                               deadline_ms=0)
    try:
        np.testing.assert_allclose(eng.submit(x).result(timeout=30),
                                   expected(old), rtol=RTOL, atol=ATOL)
        assert eng.reload({"arg:" + k: v for k, v in new.items()}) == 1
        np.testing.assert_allclose(eng.submit(x).result(timeout=30),
                                   expected(new), rtol=RTOL, atol=ATOL)
        assert eng.stats.report()["reloads"] == 1
    finally:
        eng.close()


def test_batcher_start_failure_raises_and_stops_threads():
    def boom():
        raise mt.serve.ServeError("warmup failed")

    before = {t.name for t in threading.enumerate()}
    with pytest.raises(mt.serve.ServeError, match="warmup failed"):
        mt.serve.MicroBatcher(lambda reqs: None, lambda h: [],
                              max_batch_size=2, max_delay_ms=1.0,
                              queue_depth=4, name="startfail",
                              on_start=boom)
    assert {t.name for t in threading.enumerate()} <= before
