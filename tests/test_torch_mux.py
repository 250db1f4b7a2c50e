"""The port's ModelMultiplexer against the JAX package's, on the CPU, and
the serve report's rows for every kind of component.

Three small MLPs (bench_serve's shapes: 6 inputs, hidden 8/16/24, 3
classes) sit behind both packages' multiplexers; the same submissions
must give the same swap-ins, evictions, live sets and counters (exact)
and the same answers (1e-5 relative: float32 sums in different orders).
The port's multiplexer also holds a DecodeEngine and a PagedDecodeEngine
beside a ServeEngine, and an evicted engine must be freed (no reference
left), which is what gives its card memory back.
"""
import gc
import threading
import weakref

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.profiler
import mxnet_tpu.serve
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

IN_DIM, CLASSES = 6, 3
HIDDENS = {"a": 8, "b": 16, "c": 24}
SHAPES = {"data": (1, IN_DIM), "softmax_label": (1,)}
RTOL, ATOL = 1e-5, 1e-7


def _net(pkg, hidden):
    data = pkg.sym.Variable("data")
    n = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    n = pkg.sym.Activation(n, act_type="relu")
    n = pkg.sym.FullyConnected(n, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


def _params(hidden, seed):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(hidden, IN_DIM).astype(np.float32),
            "fc1_bias": np.zeros(hidden, np.float32),
            "fc2_weight": rng.randn(CLASSES, hidden).astype(np.float32),
            "fc2_bias": np.zeros(CLASSES, np.float32)}


def _factory(pkg, model, built=None):
    h = HIDDENS[model]
    kw = {"dev_type": "cpu"} if pkg is mt else {}

    def make():
        eng = pkg.serve.ServeEngine(
            _net(pkg, h), _params(h, ord(model)), SHAPES,
            batch_buckets=(1, 2, 4), max_delay_ms=2.0,
            name="model-%s" % model, **kw)
        if built is not None:
            built.append(weakref.ref(eng))
        return eng
    return make


def _mux(pkg, built=None, **kw):
    kw.setdefault("name", "test-mux")
    mux = pkg.serve.ModelMultiplexer(**kw)
    for m in HIDDENS:
        mux.add_model(m, _factory(pkg, m, built))
    return mux


@pytest.fixture(scope="module")
def X():
    return np.random.RandomState(7).randn(24, IN_DIM).astype(np.float32)


def _both(fn):
    return fn(mx), fn(mt)


def test_lazy_swap_in_and_lru_eviction_max_live(X):
    def run(pkg):
        mux = _mux(pkg, max_live=2)
        try:
            assert mux.live_models() == []
            ys = [mux.predict(m, X[0], timeout=30) for m in "abc"]
            live = sorted(mux.live_models())
            ys.append(mux.predict("a", X[0], timeout=30))
            rep = mux.stats.report()
            return ys, live, rep, sorted(mux.live_models())
        finally:
            mux.close()
    (ry, rl, rr, rl2), (py, pl, pr, pl2) = _both(run)
    for a, b in zip(ry, py):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(py[0], py[3])     # rebuilt: same answer
    assert (pl, pl2) == (rl, rl2) == (["b", "c"], ["a", "c"])
    for k in ("kind", "models", "live", "swap_ins", "evictions",
              "rejected", "submits", "max_live", "budget_bytes"):
        assert pr[k] == rr[k], k
    assert pr["swap_ins"] == 4 and pr["evictions"] == 2


def test_bytes_budget_eviction_and_release(X):
    built = []

    def run(pkg):
        bytes_of = {}
        for m in ("a", "b"):
            probe = _factory(pkg, m)()
            bytes_of[m] = probe.device_bytes()
            probe.close()
        budget = bytes_of["a"] + bytes_of["b"]
        mux = _mux(pkg, built if pkg is mt else None, budget_bytes=budget)
        try:
            mux.predict("a", X[0], timeout=30)
            mux.predict("b", X[0], timeout=30)
            full = mux.stats.report()["bytes_live"]
            mux.predict("c", X[0], timeout=30)
            rep = mux.stats.report()
            return bytes_of, full, rep, sorted(mux.live_models())
        finally:
            mux.close()
    ref, port = _both(run)
    assert port == ref
    assert port[1] == sum(port[0].values())
    assert port[2]["evictions"] >= 1 and "c" in port[3]
    # every engine the multiplexer let go is freed: nothing holds it
    gc.collect()
    assert built and all(r() is None for r in built)


def test_busy_model_not_evicted(X):
    mux = _mux(mt, max_live=1)
    try:
        eng_a = mux.ensure_live("a")
        with eng_a.pause():
            fut = mux.submit("a", X[0])
            with pytest.raises(mt.serve.ServeOverloadError, match="busy"):
                mux.predict("b", X[1], timeout=30)
            assert mux.stats.report()["rejected"] == 1
        np.testing.assert_array_equal(fut.result(timeout=30),
                                      eng_a.predict(X[0], timeout=30))
        del eng_a
        mux.predict("b", X[1], timeout=30)
        assert mux.live_models() == ["b"]
    finally:
        mux.close()


def test_unknown_model_closed_double_register_evict_prewarm(X):
    def run(pkg):
        mux = _mux(pkg)
        msgs = []
        try:
            for call in (lambda: mux.submit("nope", X[0]),
                         lambda: mux.add_model("a", _factory(pkg, "a")),
                         lambda: mux.add_model("d", None),
                         lambda: mux.evict("nope")):
                with pytest.raises(pkg.serve.ServeError) as e:
                    call()
                msgs.append(str(e.value))
            mux.prewarm(["a", "b"])
            state = [mux.live_models(), mux.evict("a"), mux.evict("a"),
                     mux.live_models()]
        finally:
            mux.close()
        with pytest.raises(pkg.serve.ServeClosedError):
            mux.submit("a", X[0])
        mux.close()
        return msgs, state
    assert run(mx) == run(mt)


def test_mixed_kinds_flood_parity(X):
    """A ServeEngine, a DecodeEngine and a PagedDecodeEngine behind one
    port multiplexer under a 4-thread flood: every answer equals the
    model's own serial answer (tokens exact, the MLP's rows within 1e-5:
    a flood batches them into other buckets), zero dropped."""
    from test_torch_decode import HID, _decode_net, _params as dparams
    cfg = mt.serve.LMConfig(vocab=32, dim=16, heads=2, layers=1,
                            max_context=48)
    lm = mt.serve.init_lm_params(cfg, seed=0)
    mux = mt.serve.ModelMultiplexer(name="kinds-mux")
    mux.add_model("mlp", _factory(mt, "a"))
    mux.add_model("rnn", lambda: mt.serve.DecodeEngine(
        _decode_net(mt), dparams(), state_shapes={"h": (HID,)},
        num_slots=2, dev_type="cpu", name="mux-rnn"))
    mux.add_model("lm", lambda: mt.serve.PagedDecodeEngine(
        lm, cfg, num_slots=2, ctx=mt.cpu(), name="mux-lm"))
    reqs = {"mlp": X[0], "rnn": np.array([1, 2, 3]),
            "lm": np.array([4, 5, 6, 7])}
    kw = {"mlp": {}, "rnn": {"max_new_tokens": 5},
          "lm": {"max_new_tokens": 5}}
    try:
        mux.prewarm()
        refs = {m: mux.predict(m, reqs[m], timeout=60, **kw[m])
                for m in reqs}
        results, errors = [], []

        def client(t):
            try:
                for j in range(6):
                    m = sorted(reqs)[(t + j) % 3]
                    results.append((m, mux.predict(m, reqs[m], timeout=60,
                                                   **kw[m])))
            except Exception as e:      # pragma: no cover - fail loud below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors and len(results) == 24
        for m, y in results:
            if m == "mlp":      # another bucket sums in another order
                np.testing.assert_allclose(y, refs[m], rtol=RTOL, atol=ATOL)
            else:               # token streams: exact
                np.testing.assert_array_equal(y, refs[m])
        assert mux.stats.report()["live"] == 3
    finally:
        mux.close()


def test_serve_report_rows_for_every_kind():
    """ServeEngine, DecodeEngine, PagedDecodeEngine, ModelMultiplexer and
    ServeRouter each register a row with their kind; the JAX package's
    rows for the same components carry the same keys."""
    from test_torch_decode import HID, _decode_net, _params as dparams
    cfg = mt.serve.LMConfig(vocab=32, dim=16, heads=2, layers=1,
                            max_context=48)
    eng = _factory(mt, "a")()
    dec = mt.serve.DecodeEngine(_decode_net(mt), dparams(),
                                state_shapes={"h": (HID,)}, num_slots=2,
                                dev_type="cpu", name="row-decode")
    paged = mt.serve.PagedDecodeEngine(mt.serve.init_lm_params(cfg), cfg,
                                       num_slots=2, ctx=mt.cpu(),
                                       name="row-paged")
    mux = mt.serve.ModelMultiplexer(name="row-mux")
    router = mt.serve.ServeRouter(lambda i: _factory(mt, "b")(),
                                  replicas=2, name="row-router")
    jeng = _factory(mx, "a")()
    jrouter = mx.serve.ServeRouter(lambda i: _factory(mx, "b")(),
                                   replicas=1, name="row-router")
    try:
        rep = mt.profiler.serve_report()
        kinds = {}
        for name in ("model-a", "row-decode", "row-paged", "row-mux",
                     "row-router"):
            rows = [v for k, v in rep.items() if k.startswith(name + "#")]
            assert rows, name
            kinds[name] = rows[-1]["kind"]
        assert kinds == {"model-a": "engine", "row-decode": "decode",
                         "row-paged": "paged", "row-mux": "mux",
                         "row-router": "router"}
        jrep = mx.profiler.serve_report()
        for name in ("model-a", "row-router"):
            jrow = [v for k, v in jrep.items() if k.startswith(name + "#")]
            prow = [v for k, v in rep.items() if k.startswith(name + "#")]
            assert set(prow[-1]) == set(jrow[-1]), name
        text = mt.profiler.serve_report_str()
        for head in ("serve engine 'model-a'", "decode engine 'row-decode'",
                     "paged decode engine 'row-paged'",
                     "model multiplexer 'row-mux'",
                     "serve router 'row-router'"):
            assert head in text, head
    finally:
        for e in (eng, dec, paged, mux, router, jeng, jrouter):
            e.close()
