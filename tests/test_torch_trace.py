"""mxnet_tpu_torch.trace and the rest of mx.profiler against the JAX
package's (CPU, small sizes).

The 22 tests of ``tests/test_trace.py`` carried to the port: the event
schema, ring overflow and dead-thread pruning, the bounded spill file,
the reader workers' spills that survive a SIGKILL, journal rotation and
``tail``, the serve request flow, and the fit, superstep and checkpoint
spans.  Added: the two recorders' dumps event for event, journals and
fleet reports read across packages, ``unified_report``'s sections in the
reference's order, ``profiler_set_state``'s device trace, the fused
step's spans, and a fused trajectory bitwise equal with tracing on and
off.  Parity is ``==`` throughout (names, formats, integer counts).
"""
import json
import multiprocessing as mp
import os
import signal
import statistics
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import feed, recordio, trace
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

IN_DIM = 6
VALID_PH = {"X", "B", "E", "i", "I", "b", "n", "e", "s", "t", "f", "M",
            "C", "M"}


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    with mx.cpu():
        yield
    trace.reset()


def _events(path, meta=False):
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    return evs if meta else [e for e in evs if e["ph"] != "M"]


def _mlp(pkg=mx):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data, num_hidden=8,
                                                  name="fc1"),
                           act_type="relu")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(h, num_hidden=3,
                                                        name="fc2"),
                                 name="softmax")


def _data_iter(n=64, batch=16):
    rng = np.random.RandomState(0)
    X = rng.randn(n, IN_DIM).astype(np.float32)
    y = rng.randint(0, 3, n).astype(np.float32)
    return mx.io.NDArrayIter(X, y, batch_size=batch)


def _fit_module(**fit_kw):
    mx.random.seed(7)
    mod = mx.mod.Module(_mlp(), context=[mx.current_context()])
    mod.fit(_data_iter(), num_epoch=1,
            optimizer_params=(("learning_rate", 0.5),), **fit_kw)
    return mod


def _raw_rec(path, n, shape=(3, 8, 8)):
    rng = np.random.RandomState(0)
    w = recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        arr = rng.randint(0, 255, shape).astype(np.uint8)
        w.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                              arr.tobytes()))
    w.close()
    return str(path)


# -- span API + export schema ------------------------------------------------

def test_trace_event_json_schema(tmp_path):
    with trace.span("outer", cat="t", k=1):
        with trace.span("inner"):
            time.sleep(0.001)
    trace.instant("mark", cat="t")
    aid = trace.next_async_id()
    trace.async_begin("req", aid, cat="serve")
    trace.async_instant("req", aid, cat="serve")
    trace.async_end("req", aid, cat="serve")
    path = trace.dump_trace(str(tmp_path / "t.json"))
    evs = _events(path, meta=True)
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    pid = os.getpid()
    for e in evs:
        assert e["ph"] in VALID_PH
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] != "M":
            assert e["pid"] == pid
            assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"k": 1}
    reqs = [e for e in evs if e["name"] == "req"]
    assert [e["ph"] for e in reqs] == ["b", "n", "e"]
    assert len({e["id"] for e in reqs}) == 1
    assert json.load(open(trace.dump_trace(str(tmp_path / "t2.json"))))


def test_span_decorator_and_disable():
    @trace.span("worker_fn", cat="t")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert trace.event_count() == 1
    trace.set_enabled(False)
    with trace.span("not_recorded"):
        pass
    assert f(2) == 3
    assert trace.event_count() == 1

    @trace.span("late_bound")
    def g():
        return 7

    assert g() == 7
    assert trace.event_count() == 1
    trace.set_enabled(True)
    assert g() == 7
    assert trace.event_count() == 2


def test_counter_events(tmp_path):
    for n in (1, 3, 2):
        trace.counter("serve:decode_slots", cat="serve", active=n)
    trace.set_enabled(False)
    trace.counter("serve:decode_slots", cat="serve", active=9)
    trace.set_enabled(True)
    path = trace.dump_trace(str(tmp_path / "c.json"))
    evs = [e for e in _events(path)
           if e["name"] == "serve:decode_slots"]
    assert [e["ph"] for e in evs] == ["C"] * 3
    assert [e["args"]["active"] for e in evs] == [1, 3, 2]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)


def test_nonserializable_attrs_survive_dump(tmp_path):
    with trace.span("np-attrs", val=np.float32(0.5), arr=np.arange(2)):
        pass
    evs = _events(trace.dump_trace(str(tmp_path / "np.json")))
    ev = next(e for e in evs if e["name"] == "np-attrs")
    assert "0.5" in str(ev["args"]["val"])


def test_dead_thread_rings_are_pruned():
    from mxnet_tpu_torch.trace import recorder as rec_mod

    def one_span(i):
        trace.instant("thread-%d" % i)

    for i in range(rec_mod.MAX_DEAD_BUFS + 40):
        t = threading.Thread(target=one_span, args=(i,))
        t.start()
        t.join()
    t = threading.Thread(target=one_span, args=(-1,))
    t.start()
    t.join()
    r = trace._recorder
    with r._lock:
        nbufs = len(r._bufs)
    assert nbufs <= rec_mod.MAX_DEAD_BUFS + 8
    assert trace.drop_count() > 0
    assert trace.event_count() >= 1


def test_ring_overflow_drops_counted_not_crashed(tmp_path):
    trace.reset(buf_events=64)
    for i in range(300):
        trace.instant("e%d" % i)
    assert trace.event_count() == 300
    assert trace.drop_count() == 300 - 64
    evs = _events(trace.dump_trace(str(tmp_path / "o.json")))
    names = [e["name"] for e in evs if e["name"].startswith("e")]
    assert len(names) == 64 and names[-1] == "e299"
    assert any(e["name"] == "trace:dropped_events" and
               e["args"]["dropped"] == 236 for e in evs)


def test_spill_file_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_SPILL_EVERY", "10")
    monkeypatch.setenv("MXNET_TRACE_SPILL_MAX_EVENTS", "25")
    spill = str(tmp_path / "spill.jsonl")
    trace.configure_spill(spill)
    for i in range(200):
        trace.instant("s%d" % i)
    trace.flush_spill()
    lines = [json.loads(ln) for ln in open(spill)]
    names = [ln["name"] for ln in lines]
    assert len([n for n in names if n.startswith("s")]) <= 25
    assert "trace:spill_truncated" in names
    size = os.path.getsize(spill)
    for i in range(200):
        trace.instant("t%d" % i)
    trace.flush_spill()
    assert os.path.getsize(spill) == size


def test_registry_thread_safety():
    stop = threading.Event()
    errs = []

    def reader():
        try:
            while not stop.is_set():
                mx.profiler.unified_report()
                mx.profiler.feed_report_str()
        except Exception as e:      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(200):
            stats = feed.PipelineStats("racer%d" % i).register()
            stats.stage("s")
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not errs


# -- profiler surface --------------------------------------------------------

def test_scope_emits_real_span(tmp_path):
    with mx.profiler.scope("my-region"):
        pass
    evs = _events(trace.dump_trace(str(tmp_path / "s.json")))
    assert any(e["name"] == "my-region" and e["cat"] == "scope"
               for e in evs)


def test_dump_profile_writes_loadable_chrome_json(tmp_path):
    mx.profiler.profiler_set_config(filename=str(tmp_path / "prof"))
    with mx.profiler.scope("seeded-workflow"):
        pass
    out = mx.profiler.dump_profile()
    assert out.endswith(".json") and os.path.exists(out)
    evs = [e for e in json.load(open(out))["traceEvents"]
           if e["ph"] != "M"]
    assert any(e["name"] == "seeded-workflow" for e in evs)


def test_unified_report_sections():
    r = mx.profiler.unified_report()
    for key in ("feed", "superstep", "multichip", "checkpoint", "serve",
                "compile", "trace"):
        assert key in r, key
    assert r["trace"]["enabled"] is True
    s = mx.profiler.unified_report_str()
    for key in ("feed", "superstep", "multichip", "checkpoint", "serve",
                "compile", "trace"):
        assert "== %s " % key in s


# -- training-path spans -----------------------------------------------------

def test_fit_records_fused_dispatch_and_epoch(tmp_path):
    _fit_module()
    evs = _events(trace.dump_trace(str(tmp_path / "f.json")))
    names = {e["name"] for e in evs}
    assert "fused:dispatch" in names
    assert "fit:epoch" in names
    durs = [e["dur"] for e in evs if e["name"] == "fused:dispatch"]
    assert len(durs) >= 3 and all(d >= 0 for d in durs)


def test_superstep_spans(tmp_path):
    _fit_module(superstep=4)
    evs = _events(trace.dump_trace(str(tmp_path / "ss.json")))
    names = {e["name"] for e in evs}
    assert "superstep:dispatch" in names
    disp = next(e for e in evs if e["name"] == "superstep:dispatch")
    assert disp["args"]["k"] == 4


def test_journal_lines(tmp_path, monkeypatch):
    jpath = str(tmp_path / "journal.jsonl")
    monkeypatch.setenv("MXNET_TRACE_JOURNAL", jpath)
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_EVERY", "2")
    trace.reset_journal()
    _fit_module()          # 4 batches -> steps 2 and 4 journal
    lines = [json.loads(ln) for ln in open(jpath)]
    assert len(lines) == 2
    assert [ln["step"] for ln in lines] == [2, 4]
    for ln in lines:
        assert set(("feed", "superstep", "multichip", "checkpoint",
                    "serve", "compile", "trace")) <= set(ln["reports"])
        assert ln["ts"] > 0
    monos = [ln["mono"] for ln in lines]
    assert all(m > 0 for m in monos) and monos == sorted(monos)


def _one_line(journal, path):
    journal.write_journal_line(path, 0)
    one = os.path.getsize(path)
    os.unlink(path)
    return one


def test_journal_rotation_size_based_keep_last_n(tmp_path, monkeypatch):
    from mxnet_tpu_torch.trace import journal
    jpath = str(tmp_path / "rot.jsonl")
    one = _one_line(journal, jpath)
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_MAX_BYTES", str(3 * one + 16))
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_KEEP", "2")
    for step in range(12):
        journal.write_journal_line(jpath, step)
    gens = journal.journal_files(jpath)
    assert [os.path.basename(g) for g in gens] == [
        "rot.jsonl", "rot.jsonl.1", "rot.jsonl.2"]
    steps = []
    for gen in reversed(gens):
        for ln in open(gen):
            steps.append(json.loads(ln)["step"])
    assert steps == sorted(steps)
    assert steps[-1] == 11
    assert len(steps) < 12
    assert 0 not in steps
    assert os.path.getsize(jpath) <= 3 * one + 16


def test_journal_tail_reads_across_generations(tmp_path, monkeypatch):
    from mxnet_tpu_torch.trace import journal
    jpath = str(tmp_path / "tail.jsonl")
    journal.write_journal_line(jpath, 0)
    one = os.path.getsize(jpath)
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_MAX_BYTES", str(2 * one + 8))
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_KEEP", "3")
    for step in range(1, 7):
        journal.write_journal_line(jpath, step)
    last4 = journal.tail(jpath, 4)
    assert [ln["step"] for ln in last4] == [3, 4, 5, 6]
    assert journal.tail(jpath, 1)[0]["step"] == 6
    assert journal.tail(str(tmp_path / "absent.jsonl"), 3) == []
    assert journal.tail(jpath, 0) == []


def test_journal_rotation_off_by_default(tmp_path, monkeypatch):
    from mxnet_tpu_torch.trace import journal
    monkeypatch.delenv("MXNET_TRACE_JOURNAL_MAX_BYTES", raising=False)
    jpath = str(tmp_path / "nocap.jsonl")
    for step in range(8):
        journal.write_journal_line(jpath, step)
    assert journal.journal_files(jpath) == [jpath]
    assert len(open(jpath).readlines()) == 8


def test_checkpoint_spans(tmp_path):
    from mxnet_tpu_torch import checkpoint
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"),
                                       async_save=False)
    mgr.save(1, {"w": np.arange(4.0)})
    mgr.restore()
    mgr.close()
    evs = _events(trace.dump_trace(str(tmp_path / "c.json")))
    names = {e["name"] for e in evs}
    assert "ckpt:write_commit" in names and "ckpt:restore" in names
    assert "ckpt:save(blocking)" in names


# -- serve request flow ------------------------------------------------------

def test_serve_request_async_flow(tmp_path):
    it = _data_iter(8, 8)
    mod = mx.mod.Module(_mlp(), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Uniform(0.05))
    arg, aux = mod.get_params()
    prefix = str(tmp_path / "m")
    mx.model.save_checkpoint(prefix, 0, _mlp(), arg, aux)
    eng = mx.serve.ServeEngine.from_checkpoint(
        prefix, 0, {"data": (1, IN_DIM), "softmax_label": (1,)},
        batch_buckets=(1, 2, 4), max_delay_ms=2.0, name="trace-test",
        dev_type="cpu")
    try:
        X = np.random.RandomState(3).randn(12, IN_DIM).astype(np.float32)
        futs = [eng.submit(x) for x in X]
        for f in futs:
            f.result(timeout=30)
    finally:
        eng.close()
    evs = _events(trace.dump_trace(str(tmp_path / "srv.json")))
    by_ph = {}
    for e in evs:
        if e["name"] == "serve:request":
            by_ph.setdefault(e["ph"], []).append(e)
    assert len(by_ph.get("b", [])) == 12
    assert len(by_ph.get("e", [])) == 12
    assert {e["id"] for e in by_ph["b"]} == {e["id"] for e in by_ph["e"]}
    assert all(e["args"]["outcome"] == "resolved" for e in by_ph["e"])
    names = {e["name"] for e in evs}
    assert "serve:run_batch" in names and "serve:d2h_finish" in names
    tids = {e["tid"] for e in evs if e["name"] in
            ("serve:request", "serve:run_batch", "serve:d2h_finish")}
    assert len(tids) >= 3


# -- cross-process reader spans ----------------------------------------------

def _reader_iter(rec, batch, workers, decode=None, **kw):
    shape = (3, 6, 6)

    def f32_decode(item):
        label, payload = item
        img = np.frombuffer(payload, np.uint8).astype(
            np.float32).reshape(shape)
        return img, np.float32(label)

    p = feed.Pipeline([
        feed.ParallelReader(rec, decode or f32_decode, workers=workers,
                            sample_shape=shape, sample_dtype=np.float32,
                            shuffle_window=kw.pop("window", 4),
                            seed=kw.pop("seed", 1),
                            max_epochs=kw.pop("max_epochs", 2),
                            slots_per_worker=kw.pop("slots", 4)),
        feed.BatchStage(batch)], name="trace-reader")
    return feed.FeedDataIter(p, shape, batch)


@pytest.mark.skipif("fork" not in mp.get_all_start_methods(),
                    reason="ParallelReader needs fork")
def test_worker_spans_survive_sigkill_and_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_SPILL_EVERY", "8")
    rec = _raw_rec(tmp_path / "k.rec", 60, shape=(3, 6, 6))

    def slow_decode(item):
        label, payload = item
        time.sleep(0.002)
        img = np.frombuffer(payload, np.uint8).astype(
            np.float32).reshape(3, 6, 6)
        return img, np.float32(label)

    it = _reader_iter(rec, 5, workers=2, decode=slow_decode)
    for _ in range(3):
        it.next()
    reader = it.pipeline.stages[0]
    killed_pid = reader.worker_pids()[0]
    os.kill(killed_pid, signal.SIGKILL)
    for _ in range(2):
        try:
            while True:
                it.next()
        except StopIteration:
            pass
    assert sum(reader.restarts) >= 1
    restarted_pid = reader.worker_pids()[0]
    it.close()

    evs = _events(trace.dump_trace(str(tmp_path / "kill.json")))
    decode_pids = {e["pid"] for e in evs
                   if e["name"].startswith("feed:decode[")}
    assert killed_pid in decode_pids
    assert restarted_pid in decode_pids and restarted_pid != killed_pid
    assert len(decode_pids) >= 3
    assert os.getpid() not in decode_pids
    w0 = sorted(e["ts"] for e in evs
                if e["pid"] == killed_pid and
                e["name"] == "feed:decode[w0]")
    assert w0 == sorted(w0) and len(w0) >= 8


@pytest.mark.skipif("fork" not in mp.get_all_start_methods(),
                    reason="ParallelReader needs fork")
def test_fit_dump_shows_reader_feed_and_dispatch_lanes(tmp_path):
    rec = _raw_rec(tmp_path / "fit.rec", 48)
    it = feed.record_pipeline(rec, 8, (3, 8, 8), reader_procs=2,
                              shuffle_window=4, seed=0, scale=1.0 / 255,
                              max_epochs=3, to_device=False,
                              device_augment=False)
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Flatten(data), num_hidden=3,
                              name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu(0))
    mod.fit(it, num_epoch=1, prefetch_to_device=True,
            optimizer_params=(("learning_rate", 0.05),))
    it.close()
    path = mx.profiler.dump_trace(str(tmp_path / "fit.trace.json"))
    evs = _events(path, meta=True)
    body = [e for e in evs if e["ph"] != "M"]
    main_pid = os.getpid()
    reader_pids = {e["pid"] for e in body if e["pid"] != main_pid}
    assert len(reader_pids) >= 2
    names = {e["name"] for e in body}
    assert "fused:dispatch" in names
    assert any(n.startswith("feed:") for n in names)
    assert "feed:h2d_stage" in names or "feed:batch" in names
    labels = [e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"
              and e["pid"] in reader_pids]
    assert any("feed-reader" in lb for lb in labels)


# -- overhead budget ---------------------------------------------------------

def _bound_module(batch=16):
    it = _data_iter(32, batch)
    mod = mx.mod.Module(_mlp(), context=[mx.current_context()])
    mod.bind(it.provide_data, it.provide_label, for_training=True)
    mod.init_params(mx.init.Uniform(0.05))
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
    return mod, it.next()


def test_tracing_overhead_and_zero_recompiles():
    """The steady fused loop with tracing on: no new program builds (the
    port's captures and the compile cache's steady rebuilds, where the
    reference counts XLA compiles) and a per-step cost within 1.5x + 1 ms
    of the MXNET_TRACE=0 loop (CPU step times are tens of microseconds
    with scheduler noise far above the issue's 2%).  Traced and
    untraced steps alternate, so both medians see the same load from
    whatever else shares the host."""
    from mxnet_tpu_torch.compile_cache import get_stats
    mod, batch = _bound_module()

    def step():
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        return time.perf_counter() - t0

    for _ in range(10):
        step()
    caps = mod._fused.stats.captures
    rebuilds = get_stats().report()["totals"]["steady_rebuilds"]
    on, off = [], []
    for i in range(300):
        traced = i % 2 == 0
        trace.set_enabled(traced)
        (on if traced else off).append(step())
    trace.set_enabled(True)
    assert mod._fused.stats.captures == caps
    assert get_stats().report()["totals"]["steady_rebuilds"] == rebuilds
    on, off = statistics.median(on), statistics.median(off)
    assert on <= off * 1.5 + 1e-3, \
        "tracing overhead: on=%.6fs off=%.6fs" % (on, off)
    assert trace.event_count() >= 150


# -- added: parity with the JAX package, the port's own paths ----------------

def _jax_trace():
    from mxnet_tpu import trace as jtrace
    return jtrace


def _drive(tr):
    """One sequence of recording calls, the same for either package."""
    with tr.span("outer", cat="t", k=1, s="x"):
        with tr.span("inner"):
            pass
    tr.complete("done", time.perf_counter(), 0.001, cat="c", n=3)
    tr.instant("mark", cat="t", a=1)
    tr.counter("slots", cat="serve", active=2, free=6)
    aid = tr.next_async_id()
    tr.async_begin("req", aid, cat="serve", prompt_len=4)
    tr.async_instant("req", aid, cat="serve", at="dispatch", batch=2)
    tr.async_end("req", aid, cat="serve", outcome="resolved")

    @tr.span("decorated", cat="d", z=0)
    def f():
        return 1
    f()


def test_recorders_dump_the_same_events(tmp_path):
    jtrace = _jax_trace()
    jtrace.reset()
    try:
        _drive(jtrace)
        _drive(trace)
        ref = _events(jtrace.dump_trace(str(tmp_path / "j.json")))
        got = _events(trace.dump_trace(str(tmp_path / "t.json")))
    finally:
        jtrace.reset()

    def shape(evs):
        return [(e["ph"], e["name"], e["cat"],
                 sorted((e.get("args") or {}).keys()),
                 sorted(k for k in e if k not in ("args",)))
                for e in evs]
    assert shape(got) == shape(ref)
    assert shape(got)[0][1] == "outer"
    assert jtrace.trace_report().keys() == trace.trace_report().keys()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journals_read_across_packages(tmp_path, monkeypatch, writer):
    from mxnet_tpu.trace import journal as jj
    from mxnet_tpu_torch.trace import journal as tj
    w, r = (jj, tj) if writer == "jax" else (tj, jj)
    jpath = str(tmp_path / "run.jsonl")
    one = _one_line(w, jpath)
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_MAX_BYTES", str(2 * one + 8))
    monkeypatch.setenv("MXNET_TRACE_JOURNAL_KEEP", "3")
    for step in range(7):
        w.write_journal_line(jpath, step, epoch=1)
    assert r.journal_files(jpath) == w.journal_files(jpath)
    assert len(r.journal_files(jpath)) > 1
    got, want = r.tail(jpath, 4), w.tail(jpath, 4)
    assert [ln["step"] for ln in got] == [3, 4, 5, 6]
    assert [sorted(ln) for ln in got] == [sorted(ln) for ln in want]
    assert [ln["epoch"] for ln in got] == [1] * 4


def _multichip_line(step, steps, dispatch, device, sampled, count, nbytes):
    return {"ts": 1.0, "mono": 1.0, "step": step, "reports": {
        "multichip": {"fused#000001": {
            "mesh": {"dp": 1, "tp": 2}, "devices": 2, "steps": steps,
            "dispatch_s": dispatch, "sampled_steps": sampled,
            "sampled_device_s": device,
            "collectives": {"total_count": count, "total_bytes": nbytes}}}}}


def test_fleet_multichip_report_equals_the_references(tmp_path):
    from mxnet_tpu.dist.report import (
        fleet_multichip_report as jfleet,
        fleet_multichip_report_str as jfleet_str)
    rng = np.random.RandomState(0)
    paths = []
    for rank in range(3):
        p = str(tmp_path / ("rank%d.jsonl" % rank))
        with open(p, "w") as f:
            for step in (10, 20):
                f.write(json.dumps(_multichip_line(
                    step, step, float(rng.uniform(0.5, 2.0)),
                    float(rng.uniform(0.1, 1.0)), step // 4,
                    int(rng.randint(2, 9)),
                    int(rng.randint(1000, 9000)))) + "\n")
        paths.append(p)
    paths.append(str(tmp_path / "missing.jsonl"))
    assert mx.dist.fleet_multichip_report(paths) == jfleet(paths)
    named = {"h%d" % i: p for i, p in enumerate(paths)}
    assert mx.dist.fleet_multichip_report(named) == jfleet(named)
    assert mx.dist.fleet_multichip_report_str(paths) == jfleet_str(paths)


def test_unified_report_has_the_references_sections_in_order():
    import mxnet_tpu as jmx
    assert list(mx.profiler.unified_report()) == \
        list(jmx.profiler.unified_report())

    def heads(s):
        return [ln.split()[1] for ln in s.splitlines()
                if ln.startswith("== ")]
    assert heads(mx.profiler.unified_report_str()) == \
        heads(jmx.profiler.unified_report_str())
    names = set(jmx.profiler.__all__) - {"parse_hlo_collectives"}
    assert names <= set(mx.profiler.__all__)
    for n in names:
        assert callable(getattr(mx.profiler, n)), n
    assert set(_jax_trace().__all__) == set(trace.__all__)


def test_profiler_set_state_writes_a_device_trace(tmp_path):
    import torch
    mx.profiler.profiler_set_config(filename=str(tmp_path / "dev"))
    assert mx.profiler.state() == "stop"
    mx.profiler.profiler_set_state("run")
    assert mx.profiler.state() == "run"
    with mx.profiler.scope("on-the-timeline"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    mx.profiler.profiler_set_state("stop")
    assert mx.profiler.state() == "stop"
    path = str(tmp_path / "dev" / ("device.%d.trace.json" % os.getpid()))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "on-the-timeline" in names
    with pytest.raises(ValueError):
        mx.profiler.profiler_set_state("pause")


def test_fused_step_spans_one_build_then_one_dispatch_a_step(tmp_path):
    """On the CPU the fused step's capture is a no-op: its first step is
    the program's build (``fused:first_step(compile)``), every later one
    a ``fused:dispatch``."""
    mod, batch = _bound_module()
    for _ in range(5):
        mod.forward_backward(batch)
        mod.update()
    mod.get_outputs()
    evs = _events(trace.dump_trace(str(tmp_path / "fs.json")))
    names = [e["name"] for e in evs if e["name"].startswith("fused:")]
    assert names == ["fused:first_step(compile)"] + ["fused:dispatch"] * 4
    assert mod._fused.stats.eager_steps == 5


def _trajectory(traced):
    from mxnet_tpu_torch.compile_cache import get_stats
    trace.set_enabled(traced)
    rebuilds = get_stats().report()["totals"]["steady_rebuilds"]
    mx.random.seed(3)
    mod, _ = _bound_module()
    params0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    it = _data_iter(64, 16)
    outs = []
    for _ in range(2):
        it.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return (params0, params, outs, mod._fused.stats.report(),
            get_stats().report()["totals"]["steady_rebuilds"] - rebuilds)


def test_tracing_changes_nothing_in_the_trajectory():
    off = _trajectory(False)
    on = _trajectory(True)
    for k in off[0]:
        np.testing.assert_array_equal(on[0][k], off[0][k])
        np.testing.assert_array_equal(on[1][k], off[1][k])
    assert len(on[2]) == len(off[2]) == 8
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)
    assert on[3] == off[3]
    assert on[4] == off[4]
    assert trace.event_count() > 0
