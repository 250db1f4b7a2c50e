"""The port's dense DecodeEngine against the JAX package's, on the CPU.

Both packages serve the same seeded recurrent decode step (VOCAB 17,
EMB 12, HID 16: token -> embedding, h' = tanh(W_ih e + W_hh h), logits)
through their DecodeEngines, and the port's streams must equal the JAX
package's and a serial numpy decode token for token (exact: integer
tokens), through continuous admission, EOS, overload, deadlines,
cancellation, the drain-barrier reload, ``close(drain=)``, the
``decode.step`` injected fault and a checkpoint pair written by the JAX
package.  The engine runs on the card unless asked for the CPU.
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.faults
import mxnet_tpu.profiler
import mxnet_tpu.serve
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import (DecodeEngine, ServeClosedError,
                                   ServeDeadlineError, ServeError,
                                   ServeOverloadError, ServeRequestError)
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

VOCAB, EMB, HID = 17, 12, 16


def _decode_net(pkg):
    tok = pkg.sym.Variable("data")
    h = pkg.sym.Variable("h")
    emb = pkg.sym.Embedding(tok, input_dim=VOCAB, output_dim=EMB,
                            name="emb")
    emb = pkg.sym.Flatten(emb)
    z = pkg.sym.FullyConnected(emb, num_hidden=HID, name="ih") + \
        pkg.sym.FullyConnected(h, num_hidden=HID, name="hh")
    h_next = pkg.sym.Activation(z, act_type="tanh")
    logits = pkg.sym.FullyConnected(h_next, num_hidden=VOCAB, name="out")
    return pkg.sym.Group([logits, h_next])


def _params(seed=0):
    rng = np.random.RandomState(seed)

    def g(*s):
        return (rng.randn(*s) * 0.5).astype(np.float32)

    return {"emb_weight": g(VOCAB, EMB),
            "ih_weight": g(HID, EMB), "ih_bias": np.zeros(HID, np.float32),
            "hh_weight": g(HID, HID), "hh_bias": np.zeros(HID, np.float32),
            "out_weight": g(VOCAB, HID),
            "out_bias": np.zeros(VOCAB, np.float32)}


def _ref_decode(params, prompt, max_new, eos_id=None):
    """Serial numpy greedy decode."""
    h = np.zeros(HID, np.float32)
    out = []
    toks = [int(t) for t in prompt]
    i = 0
    tok = toks[0]
    while True:
        e = params["emb_weight"][tok]
        h = np.tanh(params["ih_weight"] @ e + params["ih_bias"]
                    + params["hh_weight"] @ h + params["hh_bias"])
        logits = params["out_weight"] @ h + params["out_bias"]
        if i + 1 < len(toks):
            i += 1
            tok = toks[i]
            continue
        tok = int(np.argmax(logits))
        out.append(tok)
        if len(out) >= max_new or (eos_id is not None and tok == eos_id):
            return np.asarray(out, np.int32)


def _engine(params=None, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("name", "test-decode")
    kw.setdefault("state_shapes", {"h": (HID,)})
    kw.setdefault("dev_type", "cpu")
    return DecodeEngine(_decode_net(mt),
                        dict(params if params is not None else _params()),
                        **kw)


def _jax_engine(params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("state_shapes", {"h": (HID,)})
    return mx.serve.DecodeEngine(_decode_net(mx), dict(params), **kw)


def _prompts(n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, 1 + rng.randint(0, 3)) for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    params = _params()
    prompts = _prompts(12)
    refs = [_ref_decode(params, p, 8) for p in prompts]
    return params, prompts, refs


def _wait_admitted(eng):
    t0 = time.perf_counter()
    while eng.pending_requests() > 0:
        assert time.perf_counter() - t0 < 10, "stream never admitted"
        time.sleep(0.005)


def test_parity_with_jax_and_continuous_admission(model):
    """12 streams through 4 slots in both packages: every port stream
    equals the JAX engine's and the numpy decode, streams join freed
    slots, the report rows agree on every count."""
    params, prompts, refs = model
    jeng = _jax_engine(params, name="jax-decode")
    try:
        jgot = [f.result(timeout=60) for f in
                [jeng.submit(p, max_new_tokens=8) for p in prompts]]
        jrep = jeng.stats.report()
    finally:
        jeng.close()
    eng = _engine(params)
    try:
        got = [f.result(timeout=60) for f in
               [eng.submit(p, max_new_tokens=8) for p in prompts]]
        rep = eng.stats.report()
    finally:
        eng.close()
    for i in range(len(prompts)):
        assert got[i].dtype == np.int32
        assert np.array_equal(got[i], jgot[i]), i
        assert np.array_equal(got[i], refs[i]), i
    assert rep["kind"] == "decode" and rep["num_slots"] == 4
    for k in ("submitted", "admitted", "completed", "failed", "expired",
              "tokens_out", "queue_depth", "captured"):
        assert rep[k] == jrep[k], k
    assert rep["slot_occupancy"] > 0.5 and rep["tokens_out"] >= 96


def test_eos_and_eos_at_max_new_tokens(model):
    params, prompts, _ = model
    full = [int(t) for t in _ref_decode(params, prompts[0], 8)]
    eos = full[3]
    k = max(i for i, t in enumerate(full) if t not in full[:i])
    eng = _engine(params)
    jeng = _jax_engine(params, name="jax-eos")
    try:
        for e, mn in ((eos, 8), (full[k], k + 1)):
            got = eng.generate(prompts[0], timeout=60, max_new_tokens=mn,
                               eos_id=e)
            want = jeng.generate(prompts[0], timeout=60, max_new_tokens=mn,
                                 eos_id=e)
            assert np.array_equal(got, want)
            assert np.array_equal(got, _ref_decode(params, prompts[0], mn,
                                                   eos_id=e))
        rep = eng.stats.report()
        assert rep["completed"] == 2 and rep["outstanding"] == 0
    finally:
        eng.close()
        jeng.close()


def test_admission_validation_overload_and_same_slot_join(model):
    params, prompts, _ = model
    eng = _engine(params, num_slots=1, queue_depth=2, max_new_tokens=64)
    try:
        for bad, kw in (([], {}), (np.zeros((2, 3), np.int32), {}),
                        ([0.5], {}), ([1], {"max_new_tokens": 0})):
            with pytest.raises(ServeRequestError):
                eng.submit(bad, **kw)
        futs = [eng.submit([1], max_new_tokens=64)]
        _wait_admitted(eng)
        futs += [eng.submit([1], max_new_tokens=64) for _ in range(2)]
        t0 = time.perf_counter()
        with pytest.raises(ServeOverloadError):
            for _ in range(8):
                futs.append(eng.submit([2], max_new_tokens=64))
        assert time.perf_counter() - t0 < 1.0
        assert eng.stats.report()["overloaded"] >= 1
        for f in futs:
            f.result(timeout=120)
    finally:
        eng.close()
    eng = _engine(params, num_slots=1, queue_depth=32)
    try:
        futs = [eng.submit(prompts[i % 12], max_new_tokens=1)
                for i in range(16)]
        for i, f in enumerate(futs):
            want = _ref_decode(params, prompts[i % 12], 1)
            assert np.array_equal(f.result(timeout=120), want), i
    finally:
        eng.close()


def test_deadline_and_cancel(model):
    params, prompts, refs = model
    eng = _engine(params, num_slots=1)
    try:
        slow = eng.submit([1], max_new_tokens=200)
        doomed = eng.submit([2], max_new_tokens=4, deadline_ms=5.0)
        with pytest.raises(ServeDeadlineError):
            doomed.result(timeout=60)
        assert eng.stats.report()["expired"] == 1
        slow.result(timeout=120)
        hog = eng.submit(prompts[0], max_new_tokens=100)
        queued = [eng.submit(prompts[i], max_new_tokens=4)
                  for i in range(1, 4)]
        cancelled = [f for f in queued if f.cancel()]
        assert cancelled
        hog.result(timeout=120)
        for f in queued:
            if not f.cancelled():
                f.result(timeout=60)
        got = eng.generate(prompts[0], timeout=60, max_new_tokens=8)
        assert np.array_equal(got, refs[0])
        assert eng.stats.report()["cancelled"] == len(cancelled)
    finally:
        eng.close()


def test_hot_reload_drain_barrier_no_mixed_weights(model):
    """Under a 4-thread flood a mid-flight reload drains the in-flight
    streams under the old weights, swaps, and resumes: every stream
    equals exactly one version's decode from end to end."""
    params, prompts, _ = model
    params2 = _params(seed=99)
    refs1 = [_ref_decode(params, p, 6) for p in prompts]
    refs2 = [_ref_decode(params2, p, 6) for p in prompts]
    assert any(not np.array_equal(a, b) for a, b in zip(refs1, refs2))
    eng = _engine(params)
    results, errors = {}, []

    def client(t):
        try:
            for j in range(6):
                i = (t * 6 + j) % len(prompts)
                results[(t, j)] = (i, eng.generate(
                    prompts[i], timeout=120, max_new_tokens=6))
        except Exception as e:          # pragma: no cover - fail loud below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        version = eng.reload(dict(params2), timeout=120)
        for t in threads:
            t.join()
        assert not errors, errors
        assert version == 1 and eng.weights_version == 1
        for i, got in results.values():
            assert np.array_equal(got, refs1[i]) or \
                np.array_equal(got, refs2[i]), i
        got = eng.generate(prompts[0], timeout=60, max_new_tokens=6)
        assert np.array_equal(got, refs2[0])
        assert eng.reload(dict(params), timeout=60) == 2    # idle reload
        got = eng.generate(prompts[0], timeout=60, max_new_tokens=6)
        assert np.array_equal(got, refs1[0])
        assert eng.stats.report()["reloads"] == 2
    finally:
        eng.close()


def test_close_drain_and_no_drain(model):
    params, prompts, _ = model
    eng = _engine(params)
    futs = [eng.submit(p, max_new_tokens=6) for p in prompts[:6]]
    eng.close()
    for i, f in enumerate(futs):
        assert np.array_equal(f.result(timeout=60),
                              _ref_decode(params, prompts[i], 6))
    with pytest.raises(ServeClosedError):
        eng.submit([1])
    eng.close()

    eng2 = _engine(params, num_slots=1, queue_depth=2)
    hog = eng2.submit([1], max_new_tokens=500)
    _wait_admitted(eng2)
    queued = [eng2.submit([2], max_new_tokens=4) for _ in range(2)]
    eng2.close(drain=False)
    with pytest.raises(ServeClosedError):
        eng2.submit(prompts[0], max_new_tokens=4)
    for f in [hog] + queued:
        with pytest.raises(ServeClosedError):
            f.result(timeout=60)
    with pytest.raises(ServeError):
        eng2.reload(dict(params))


def test_symbol_contract_and_unported_options(model):
    params = model[0]
    for kw, match in (({"state_shapes": {"nope": (HID,)},
                        "state_outputs": {"nope": 1}}, "state"),
                      ({"state_outputs": {"h": 7}}, "out of range"),
                      ({"state_outputs": {"h": 0}}, "distinct")):
        with pytest.raises(ServeError, match=match):
            _engine(params, **kw)
        with pytest.raises(mx.serve.ServeError, match=match):
            _jax_engine(params, **kw)
    with pytest.raises(ServeError, match="not a declared state"):
        _engine(params, moe_hits_state="nope")
    with pytest.raises(mt.MXNetError, match="no committed checkpoint"):
        DecodeEngine.from_checkpoint_dir("/nonexistent", _decode_net(mt),
                                         state_shapes={"h": (HID,)})


def test_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        DecodeEngine(_decode_net(mt), _params(),
                     state_shapes={"h": (HID,)})


def test_from_checkpoint_written_by_jax(model, tmp_path):
    params, prompts, refs = model
    prefix = str(tmp_path / "dec")
    mx.model.save_checkpoint(prefix, 3, _decode_net(mx),
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    eng = DecodeEngine.from_checkpoint(prefix, 3, state_shapes={"h": (HID,)},
                                       num_slots=3, dev_type="cpu",
                                       name="ckpt-decode")
    try:
        for p, want in zip(prompts[:5], refs[:5]):
            assert np.array_equal(eng.generate(p, timeout=60,
                                               max_new_tokens=8), want)
        assert eng.reload_from_checkpoint(prefix, 3, timeout=60) == 1
        assert eng.device_bytes() == 4 * (
            sum(v.size for v in params.values()) + 3 * HID + 3)
    finally:
        eng.close()


def test_report_row_weak_registry_and_env_knobs(model, monkeypatch):
    params, prompts, _ = model
    eng = _engine(params, name="report-decode")
    try:
        for f in [eng.submit(p, max_new_tokens=4) for p in prompts[:4]]:
            f.result(timeout=60)
        rep = mt.profiler.serve_report()
        keys = [k for k in rep if k.startswith("report-decode#")]
        assert keys
        r = rep[keys[-1]]
        assert r["kind"] == "decode" and r["completed"] == 4
        assert r["latency_p99_ms"] >= r["latency_p50_ms"] > 0
        s = mt.profiler.serve_report_str()
        assert "decode engine 'report-decode'" in s and \
            "slot occupancy" in s
    finally:
        eng.close()
    del eng
    gc.collect()
    assert not any(k.startswith("report-decode#")
                   for k in mt.profiler.serve_report())
    monkeypatch.setenv("MXNET_SERVE_SLOTS", "2")
    monkeypatch.setenv("MXNET_SERVE_DECODE_QUEUE", "5")
    monkeypatch.setenv("MXNET_SERVE_MAX_TOKENS", "3")
    eng = DecodeEngine(_decode_net(mt), dict(params),
                       state_shapes={"h": (HID,)}, name="env-decode",
                       dev_type="cpu")
    try:
        assert (eng.num_slots, eng.queue_depth, eng.max_new_tokens) == \
            (2, 5, 3)
        assert len(eng.generate([1], timeout=60)) == 3
    finally:
        eng.close()


def test_injected_step_fault_kills_loop_like_jax(model):
    """An injected ``decode.step`` error kills the decode loop in both
    packages: the stream in flight fails and later submits fast-fail
    with ServeClosedError."""
    params, prompts, _ = model

    def run(pkg, eng):
        eng.submit(prompts[0], max_new_tokens=4).result(timeout=60)
        pkg.faults.install(pkg.faults.Rule(points="decode.step",
                                           kinds="error", max_faults=1))
        try:
            doomed = eng.submit(prompts[1], max_new_tokens=4)
            with pytest.raises(pkg.serve.ServeError):
                doomed.result(timeout=60)
        finally:
            pkg.faults.clear()
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            try:
                eng.submit(prompts[2], max_new_tokens=2)
            except pkg.serve.ServeClosedError:
                break
            time.sleep(0.02)
        else:
            pytest.fail("dead decode engine still accepting submits")
        eng.close(drain=False)
        return eng.stats.report()["failed"]
    assert run(mx, _jax_engine(params, name="jfault")) == \
        run(mt, _engine(params, name="fault-decode")) == 1
