"""The port's ServeRouter against the JAX package's, on the CPU.

Both packages' routers front replicas of the same small MLP (bench_serve's
6 -> 8 -> 3) or fake engines whose failures the test flips; the same
calls must give the same dispatch counts, replica states, probe and
retry counters (exact) and the same answers (1e-5 relative: float32
sums in different orders; token streams exact).  The router flood with
a draining restart runs in-process with its own time limit, over the
port's ServeEngines and over PagedDecodeEngines with ``rolling_restart``.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.predictor
import mxnet_tpu.profiler
import mxnet_tpu.serve
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

IN_DIM, HID, CLASSES = 6, 8, 3
SHAPES = {"data": (1, IN_DIM), "softmax_label": (1,)}
RTOL, ATOL = 1e-5, 1e-7
FLOOD_LIMIT_S = 60.0


def _net(pkg):
    data = pkg.sym.Variable("data")
    n = pkg.sym.FullyConnected(data, num_hidden=HID, name="fc1")
    n = pkg.sym.Activation(n, act_type="relu")
    n = pkg.sym.FullyConnected(n, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(HID, IN_DIM).astype(np.float32),
            "fc1_bias": np.zeros(HID, np.float32),
            "fc2_weight": rng.randn(CLASSES, HID).astype(np.float32),
            "fc2_bias": np.zeros(CLASSES, np.float32)}


def _factory(pkg, seed=0, **kw):
    def build(i):
        eng_kw = dict(batch_buckets=(1, 2, 4), max_delay_ms=2.0,
                      name="rep%d" % i)
        if pkg is mt:
            eng_kw["dev_type"] = "cpu"
        eng_kw.update(kw)
        return pkg.serve.ServeEngine(_net(pkg), _params(seed), SHAPES,
                                     **eng_kw)
    return build


@pytest.fixture(scope="module")
def X():
    return np.random.RandomState(7).randn(24, IN_DIM).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_dispatch_balances_and_parity(X):
    def run(pkg):
        router = pkg.serve.ServeRouter(_factory(pkg), replicas=2,
                                       name="balance")
        try:
            ys = [router.predict(x, timeout=30) for x in X[:4]]
            futs = [router.submit(X[0]) for _ in range(24)]
            outs = [f.result(timeout=30) for f in futs]
            return ys, outs, router.stats.report()
        finally:
            router.close()
    (ry, ro, rr), (py, po, pr) = run(mx), run(mt)
    for a, b in zip(ry + ro, py + po):
        _close(a, b)
    assert pr["kind"] == "router" and pr["replicas"] == 2
    assert pr["failed"] == rr["failed"] == 0
    dispatched = [row["dispatched"] for row in pr["per_replica"].values()]
    assert all(d > 0 for d in dispatched) and sum(dispatched) == 28
    assert set(pr) == set(rr)


def test_restart_rebuild_and_weight_reload(X):
    def run(pkg):
        router = pkg.serve.ServeRouter(_factory(pkg), replicas=2,
                                       name="restart")
        try:
            ref1 = router.predict(X[0], timeout=30)
            router.rolling_restart(reload=_params(seed=9), timeout=60)
            got2 = router.predict(X[0], timeout=30)
            router.restart(0, factory=_factory(pkg), timeout=60)
            router.restart(1, factory=_factory(pkg), timeout=60)
            got1 = router.predict(X[0], timeout=30)
            r = router.stats.report()
            return (ref1, got2, got1, r["drains"],
                    [row["restarts"] for row in r["per_replica"].values()],
                    router.replica_states())
        finally:
            router.close()
    ref, port = run(mx), run(mt)
    for a, b in zip(ref[:3], port[:3]):
        _close(a, b)
    assert not np.allclose(port[0], port[1], atol=1e-3)
    np.testing.assert_array_equal(port[0], port[2])
    assert port[3:] == ref[3:] == (4, [2, 2], ["live", "live"])


def test_drain_unavailable_and_closed(X):
    def run(pkg):
        router = pkg.serve.ServeRouter(_factory(pkg), replicas=1,
                                       name="drain1")
        router.predict(X[0], timeout=30)
        router.drain(0, timeout=30)
        states = [router.replica_states()]
        with pytest.raises(pkg.serve.ServeUnavailableError):
            router.submit(X[0])
        router.restart(0, reload=_params(), timeout=60)
        states.append(router.replica_states())
        y = router.predict(X[0], timeout=30)
        text = pkg.profiler.serve_report_str()
        assert "serve router 'drain1'" in text and "rollup" in text
        router.close()
        with pytest.raises(pkg.serve.ServeClosedError):
            router.submit(X[0])
        router.close()
        return states, y
    (rs, ry), (ps, py) = run(mx), run(mt)
    assert ps == rs == [["draining"], ["live"]]
    _close(ry, py)


def test_overload_walks_all_replicas(X):
    router = mt.serve.ServeRouter(
        _factory(mt, queue_depth=1, max_delay_ms=200.0), replicas=2,
        name="overload")
    try:
        with router.replica(0).pause(), router.replica(1).pause():
            admitted = []
            with pytest.raises(mt.serve.ServeOverloadError):
                for _ in range(32):
                    admitted.append(router.submit(X[0]))
            assert router.stats.report()["rejected"] >= 1
            assert 2 <= len(admitted) <= 6
        for f in admitted:
            f.result(timeout=30)
    finally:
        router.close()


def test_crashed_replica_routed_around_and_marked_down(X):
    def run(pkg):
        router = pkg.serve.ServeRouter(_factory(pkg), replicas=2,
                                       name="crash", unhealthy_after=2)
        try:
            ref = router.predict(X[0], timeout=30)
            router.replica(0).close(drain=False)
            outs = [router.predict(X[0], timeout=30) for _ in range(12)]
            states = router.replica_states()
            downs = router.stats.report()["downs"]
            router.restart(states.index("down"), timeout=60)
            return ref, outs, states, downs, router.replica_states()
        finally:
            router.close()
    ref, port = run(mx), run(mt)
    for y in port[1]:
        np.testing.assert_array_equal(y, port[0])
    _close(ref[0], port[0])
    assert port[2:] == ref[2:]
    assert port[2] == ["down", "live"] and port[3] == 1


class _FakeEngine:
    """Minimal replica surface with a flippable failure mode."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.fail = False
        self.submitted = 0

    def submit(self, data, deadline_ms=None, **kw):
        self.submitted += 1
        fut = Future()
        if self.fail:
            fut.set_exception(self.pkg.serve.ServeError(
                "injected replica failure"))
        else:
            fut.set_result(np.asarray(data, np.float32) * 2)
        return fut

    def pending_requests(self):
        return 0

    def outstanding(self):
        return 0

    def close(self, drain=True):
        pass


def _fake_router(pkg, **kw):
    engines = {}

    def factory(i):
        engines[i] = _FakeEngine(pkg)
        return engines[i]
    return pkg.serve.ServeRouter(factory, **kw), engines


def _counts(router):
    r = router.stats.report()
    return ({k: r[k] for k in ("rejected", "retried", "drains", "downs",
                               "probes", "reinstated")},
            [(row["state"], row["dispatched"], row["failures"],
              row["probes"], row["reinstated"])
             for row in r["per_replica"].values()])


def test_half_open_probe_retrips_then_reinstates_like_jax():
    x = np.zeros(2, np.float32)

    def run(pkg):
        router, engines = _fake_router(pkg, replicas=2, unhealthy_after=2,
                                       retries=2, probe_after_s=0.05,
                                       name="probe")
        trace = []
        try:
            engines[0].fail = True
            for _ in range(8):
                assert router.submit(x).result(timeout=10) is not None
            trace.append((router.replica_states(), engines[0].submitted))
            time.sleep(0.12)
            assert router.submit(x).result(timeout=10) is not None
            trace.append((router.replica_states(), engines[0].submitted,
                          _counts(router)))
            engines[0].fail = False
            deadline = time.perf_counter() + 10.0
            while router.replica_states()[0] != "live":
                assert time.perf_counter() < deadline
                router.submit(x).result(timeout=10)
                time.sleep(0.02)
            r = router.stats.report()
            trace.append((r["reinstated"], r["per_replica"][0]["failures"]))
            before = engines[0].submitted
            for _ in range(6):
                router.submit(x).result(timeout=10)
            trace.append(engines[0].submitted > before)
        finally:
            router.close()
        return trace
    ref, port = run(mx), run(mt)
    assert port == ref
    assert port[0][0][0] == "down" and port[1][1] == port[0][1] + 1
    assert port[2] == (1, 0) and port[3]


def test_probe_disabled_and_probe_needs_retry_budget_like_jax():
    x = np.zeros(2, np.float32)

    def run(pkg):
        out = []
        for kw in ({"unhealthy_after": 1, "retries": 1, "probe_after_s": 0},
                   {"unhealthy_after": 1, "retries": 0,
                    "probe_after_s": 0.02}):
            router, engines = _fake_router(pkg, replicas=2, name="np", **kw)
            try:
                engines[0].fail = True
                try:
                    router.submit(x).result(timeout=10)
                except pkg.serve.ServeError:
                    pass            # retries=0: the failure surfaces
                time.sleep(0.1)
                down = engines[0].submitted
                for _ in range(4):
                    router.submit(x).result(timeout=10)
                out.append((router.replica_states(),
                            engines[0].submitted - down, _counts(router)))
                engines[0].fail = False
                router.restart(0, factory=lambda i: engines[0], timeout=10)
                out.append(router.replica_states())
            finally:
                router.close()
        return out
    ref, port = run(mx), run(mt)
    assert port == ref
    assert port[0][1] == 0 and port[2][1] == 0     # never probed


def test_retry_budget_like_jax():
    x = np.zeros(2, np.float32)

    def run(pkg):
        router, engines = _fake_router(pkg, replicas=2, unhealthy_after=0,
                                       retries=0, probe_after_s=0,
                                       name="budget0")
        try:
            engines[0].fail = True
            with pytest.raises(pkg.serve.ServeError, match="injected"):
                router.submit(x).result(timeout=10)
        finally:
            router.close()
        router, engines = _fake_router(pkg, replicas=2, unhealthy_after=0,
                                       retries=2, probe_after_s=0,
                                       name="budget2")
        try:
            engines[0].fail = True
            y = router.submit(x).result(timeout=10)
            r = router.stats.report()
            assert r["retry_wait_s"] > 0
            return y, _counts(router)
        finally:
            router.close()
    ref, port = run(mx), run(mt)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == ref[1] and port[1][0]["retried"] == 1


def test_capture_hook_offers_every_success():
    class Capture:
        def __init__(self):
            self.pairs = []

        def offer(self, data, result):
            self.pairs.append((np.asarray(data), np.asarray(result)))
            return len(self.pairs) % 2 == 1     # keep every other pair
    cap = Capture()
    router, _ = _fake_router(mt, replicas=2, capture=cap, name="cap")
    xs = [np.full(2, i, np.float32) for i in range(7)]
    try:
        outs = [router.submit(x).result(timeout=10) for x in xs]
        router.capture_sync(timeout=10)
        assert len(cap.pairs) == 7
        for (d, r), x, y in zip(cap.pairs, xs, outs):
            np.testing.assert_array_equal(d, x)
            np.testing.assert_array_equal(r, y)
        assert router.stats.report()["captured"] == 4
    finally:
        router.close()


def _flood(router, submit, n_threads, reqs, mid, expected):
    """Closed-loop flood from ``n_threads`` threads with ``mid()`` called
    once every thread has requests in flight; -> (results, errors)."""
    results = {}
    errors = []
    started = threading.Barrier(n_threads + 1)

    def client(t):
        try:
            for j in range(reqs):
                results[(t, j)] = submit(t, j)
                if j == 1:
                    started.wait(FLOOD_LIMIT_S)
        except Exception as e:          # pragma: no cover - fail loud below
            errors.append(repr(e))
    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    started.wait(FLOOD_LIMIT_S)
    mid()
    for t in threads:
        t.join(max(1.0, FLOOD_LIMIT_S - (time.perf_counter() - t0)))
    assert not any(t.is_alive() for t in threads), "flood over its limit"
    assert not errors, errors
    assert len(results) == expected, "dropped %d" % (expected - len(results))
    return results


def test_draining_restart_under_flood_zero_dropped(X):
    """4 threads x 20 requests against 3 replicas while replica 1 does a
    full draining rebuild: zero dropped, zero errors, every row equal to
    the JAX package's batch-1 Predictor within 1e-5."""
    pred = mx.predictor.Predictor(_net(mx).tojson(), _params(), SHAPES)
    Xf = np.random.RandomState(7).randn(80, IN_DIM).astype(np.float32)
    router = mt.serve.ServeRouter(
        _factory(mt, deadline_ms=60000.0), replicas=3, name="flood")
    try:
        res = _flood(router, lambda t, j: router.predict(
            Xf[t * 20 + j], timeout=FLOOD_LIMIT_S), 4, 20,
            lambda: router.restart(1, timeout=FLOOD_LIMIT_S), 80)
        for (t, j), y in res.items():
            _close(pred.predict(Xf[t * 20 + j][None])[0], y)
        r = router.stats.report()
        assert sum(row["restarts"] for row in r["per_replica"].values()) \
            == 1
        assert r["failed"] == 0
    finally:
        router.close()


def test_paged_replicas_rolling_restart_under_flood():
    """Two PagedDecodeEngine replicas behind the router: streams equal a
    standalone engine's token for token, and a rolling restart mid-flood
    drops nothing."""
    cfg = mt.serve.LMConfig(vocab=48, dim=16, heads=2, layers=2,
                            max_context=64)
    params = mt.serve.init_lm_params(cfg, seed=1)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 48, 1 + rng.randint(0, 12)) for _ in range(12)]

    def factory(i):
        return mt.serve.PagedDecodeEngine(params, cfg, num_slots=3,
                                          max_new_tokens=6, ctx=mt.cpu(),
                                          name="lm-rep%d" % i)
    solo = factory(9)
    try:
        refs = [solo.generate(p, timeout=60) for p in prompts]
    finally:
        solo.close()
    router = mt.serve.ServeRouter(factory, replicas=2, name="lm-router")
    try:
        res = _flood(router, lambda t, j: router.predict(
            prompts[(t * 3 + j) % 12], timeout=FLOOD_LIMIT_S), 4, 6,
            lambda: router.rolling_restart(timeout=FLOOD_LIMIT_S), 24)
        for (t, j), y in res.items():
            np.testing.assert_array_equal(y, refs[(t * 3 + j) % 12])
        r = router.stats.report()
        assert [row["restarts"] for row in r["per_replica"].values()] == \
            [1, 1]
        assert r["failed"] == 0 and router.replica_states() == \
            ["live", "live"]
    finally:
        router.close()
