"""The port's ``feed/`` pipeline, device staging, cursors and padded ids
against the JAX package's, on the CPU.

The cases of the reference's ``test_feed.py`` (ordering, backpressure,
in-band sentinels, exceptions, shutdown, exact counters, the profiler's
feed report, the device prefetcher, ``fit(prefetch_to_device=True)``,
``record_pipeline`` end to end, ``FeedDataIter.reset`` mid-epoch), the
megabatch cases of ``test_superstep.py``, the feed-cursor cases of
``test_checkpoint.py`` and the padded-id cases of ``test_embed.py``.
Where both packages can run the case, the port's items, batches,
counters and cursors equal the JAX package's exactly; trained params
are bitwise within the port and within rtol 1e-4, atol 1e-5 across the
packages (float32 sums in other orders).  A checkpoint directory written
mid-epoch by either package, with its feed cursor in ``meta["feed"]``,
resumes in the other at the same next batch.

Nothing here waits on a sleep or a wall-clock threshold: the tests
synchronize on events and queue depths.  Each test that starts threads
carries a deadline (SIGALRM), so a hang fails one test and not the suite.
"""
import functools
import gc
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import feed as jfeed
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch import feed, recordio
from mxnet_tpu_torch.feed.pipeline import BoundedQueue, QueueClosed

RTOL, ATOL = 1e-4, 1e-5


def deadline(seconds):
    """Fail the wrapped test with TimeoutError after ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            def on_alarm(signum, frame):
                raise TimeoutError("%s exceeded its %d s deadline"
                                   % (fn.__name__, seconds))
            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*a, **k)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


@pytest.fixture(autouse=True)
def _on_the_host():
    # the port's entry points stage onto the card unless asked for the
    # host: these tests ask
    with mx.cpu():
        yield


_live = []


@pytest.fixture(autouse=True)
def _close_live():
    yield
    while _live:
        _live.pop().close()


def _ints(n):
    return lambda: iter(range(n))


def _close(p):
    p.close()
    assert p.alive_threads() == []


def _both(build):
    """``build(pkg_feed)`` for both packages -> {tag: result}."""
    return {"jax": build(jfeed), "torch": build(feed)}


# -- composition -------------------------------------------------------------

@deadline(30)
def test_stage_composition_ordered():
    def run(f):
        p = f.Pipeline([
            f.SourceStage(_ints(23), max_epochs=1),
            f.MapStage(lambda x: (np.full((2,), x, np.float32),
                                  np.float32(x)), workers=4, name="decode"),
            f.BatchStage(5)], buffer_size=2, name="compose")
        out = [tuple(np.asarray(a) for a in b[:2]) + (b[2],) for b in p]
        _close(p)
        return out
    got = _both(run)
    assert len(got["torch"]) == 5
    for a, b in zip(got["jax"], got["torch"]):
        assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
        assert a[2] == b[2]
    vals = np.concatenate([b[0][:, 0] for b in got["torch"]])
    assert vals[:23].tolist() == [float(i) for i in range(23)]
    assert [b[2] for b in got["torch"]] == [0, 0, 0, 0, 2]
    assert got["torch"][-1][0][:, 0].tolist() == [20.0, 21.0, 22.0, 0.0, 1.0]


@deadline(30)
def test_batch_stage_drop_partial():
    p = feed.Pipeline([feed.SourceStage(_ints(13), max_epochs=1),
                       feed.BatchStage(5, partial="drop")], name="drop")
    batches = list(p)
    assert len(batches) == 2 and all(b[-1] == 0 for b in batches)
    _close(p)


@deadline(30)
def test_multi_epoch_items_exact():
    p = feed.Pipeline([feed.SourceStage(_ints(7), max_epochs=3),
                       feed.MapStage(lambda x: x * 10, workers=2)],
                      buffer_size=2, name="epochs")
    for _ in range(3):
        assert list(p) == [i * 10 for i in range(7)]
    assert list(p) == [] and list(p) == []     # EndOfStream, forever
    assert p.epochs_consumed == 3
    _close(p)


# -- backpressure and the sentinel --------------------------------------------

@deadline(30)
def test_bounded_queue_backpressure():
    """A fast producer blocks on the bounded queue: with the consumer
    idle the queue fills to exactly its capacity, and at every get the
    producer is at most capacity + 1 items ahead (the one in its hand)."""
    cap = 3
    produced = []
    ahead = threading.Event()

    def source():
        for i in range(50):
            produced.append(i)
            if i == cap:
                ahead.set()        # items 0..cap-1 are in the queue
            yield i

    p = feed.Pipeline([feed.SourceStage(source, max_epochs=1)],
                      buffer_size=cap, name="bp")
    assert ahead.wait(10)
    assert p._queues[-1].depth() == cap
    got = []
    for _ in range(50):
        assert len(produced) <= len(got) + cap + 1
        got.append(p.get())
    assert got == list(range(50))
    snap = p.stats.report()["source"]
    assert snap["items"] == 50 and snap["stall_out_s"] >= 0.0
    assert snap["queue_capacity"] == cap
    _close(p)


@deadline(30)
def test_epoch_sentinel_survives_slow_consumer():
    """Capacity-1 queues, the consumer behind the producer at every get:
    each epoch boundary arrives exactly after its items, three times."""
    made = threading.Semaphore(0)

    def source():
        for i in range(6):
            made.release()
            yield i

    p = feed.Pipeline([feed.SourceStage(source, max_epochs=3),
                       feed.MapStage(lambda x: x, workers=2, name="m")],
                      buffer_size=1, name="slow")
    for epoch in range(3):
        seen = []
        while True:
            if len(seen) < 6:
                assert made.acquire(timeout=10)   # produced before taken
            try:
                seen.append(p.get())
            except StopIteration:
                break
        assert seen == list(range(6)), "epoch %d" % epoch
    _close(p)


def test_bounded_queue_close_drains_then_raises():
    q = BoundedQueue(4)
    q.put(1)
    q.put(2)
    q.close()
    assert q.get() == 1 and q.get() == 2
    with pytest.raises(QueueClosed):
        q.get()
    with pytest.raises(QueueClosed):
        q.put(3)


# -- errors and shutdown ------------------------------------------------------

@deadline(30)
def test_worker_exception_propagates():
    def decode(x):
        if x == 5:
            raise ValueError("bad record 5")
        return x

    p = feed.Pipeline([feed.SourceStage(_ints(20), max_epochs=1),
                       feed.MapStage(decode, workers=3, name="decode")],
                      buffer_size=2, name="err")
    got = []
    with pytest.raises(ValueError, match="bad record 5"):
        for item in p:
            got.append(item)
    assert got == [0, 1, 2, 3, 4]
    assert p.alive_threads() == []      # the failure closed and joined
    with pytest.raises(ValueError):
        p.get()                         # the error sticks


@deadline(30)
def test_source_exception_propagates():
    def boom():
        yield 1
        raise RuntimeError("source died")

    p = feed.Pipeline([feed.SourceStage(boom, max_epochs=1)], name="srcerr")
    assert p.get() == 1
    with pytest.raises(RuntimeError, match="source died"):
        while True:
            p.get()
    _close(p)


@deadline(30)
def test_shutdown_no_dangling_threads():
    p = feed.Pipeline([feed.SourceStage(_ints(10_000)),
                       feed.MapStage(lambda x: x, workers=3, name="m"),
                       feed.BatchStage(4)], buffer_size=2, name="shut")
    for _ in range(3):
        p.get()
    p.close()
    assert p.alive_threads() == []
    with pytest.raises(StopIteration):
        p.get()


@deadline(30)
def test_context_manager_closes():
    with feed.Pipeline([feed.SourceStage(_ints(100))], name="cm") as p:
        assert p.get() == 0
    assert p.alive_threads() == []
    with pytest.raises(StopIteration):
        p.get()


# -- stats --------------------------------------------------------------------

@deadline(30)
def test_stats_counters_exact():
    def run(f):
        p = f.Pipeline([
            f.SourceStage(_ints(12), max_epochs=1),
            f.MapStage(lambda x: (np.zeros(1, np.float32), np.float32(x)),
                       workers=2, name="decode"),
            f.BatchStage(4)], name="stats")
        assert len(list(p)) == 3
        rep = p.stats.report()
        _close(p)
        return {k: (v["items"], v.get("queue_capacity"))
                for k, v in rep.items()}
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"]["source"][0] == 12
    assert got["torch"]["decode"][0] == 12
    assert got["torch"]["batch"][0] == 12
    assert got["torch"]["consume"][0] == 3


@deadline(30)
def test_profiler_feed_report_surfaces_pipelines():
    p = feed.Pipeline([feed.SourceStage(_ints(5), max_epochs=1)],
                      name="reportme")
    list(p)
    rep = mx.profiler.feed_report()
    keys = [k for k in rep if k.startswith("reportme#")]
    assert keys and "source" in rep[keys[0]]
    assert "reportme" in mx.profiler.feed_report_str()
    assert p.stats.bottleneck() in ("source", "consume")
    _close(p)
    del p
    gc.collect()
    assert not any(k.startswith("reportme#") for k in mx.profiler.feed_report())


# -- the host ring and the h2d stage -----------------------------------------

@deadline(30)
def test_staging_ring_reuses_slots_and_h2d_copies():
    """Without an h2d stage the consumer gets ring slots (the reference's
    contract, so FeedDataIter copies them); the h2d stage hands out new
    tensors on the target device, each batch its own."""
    p = feed.Pipeline([feed.SourceStage(lambda: iter(
        (np.full((2,), i, np.float32), np.float32(i)) for i in range(20)),
        max_epochs=1), feed.BatchStage(2), feed.StagingStage(ring_size=3,
                                                             pin=False)],
        buffer_size=1, name="ring")
    items = list(p)
    _close(p)
    assert len({id(b[0]) for b in items}) == 3     # three slots reused
    staged = feed.staging_stages(1, True, mx.cpu())
    assert [type(s).__name__ for s in staged] == ["StagingStage",
                                                  "DevicePutStage"]
    p = feed.Pipeline([feed.SourceStage(lambda: iter(
        (np.full((2,), i, np.float32), np.float32(i)) for i in range(20)),
        max_epochs=1), feed.BatchStage(2)] + staged, buffer_size=1,
        name="h2d")
    items = list(p)
    _close(p)
    assert all(isinstance(b[0], torch.Tensor) for b in items)
    assert [b[1].tolist() for b in items] == [[2.0 * i, 2.0 * i + 1]
                                              for i in range(10)]


def test_device_put_defaults_to_the_card():
    """Outside ``with mx.cpu()`` an h2d stage resolves gpu(0): on a host
    without a card it raises instead of handing out host tensors."""
    mx.context.Context._default_ctx.value = None
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(mx.MXNetError):
            feed.DevicePutStage()
        with pytest.raises(mx.MXNetError):
            feed.staging_stages(2, True)
    finally:
        mx.context.Context._default_ctx.value = mx.cpu()


# -- the device prefetcher, fit ------------------------------------------------

@deadline(60)
def test_device_prefetch_iter_parity():
    X = np.arange(40, dtype=np.float32).reshape(40, 1)
    y = np.arange(40, dtype=np.float32)
    raw = list(mx.io.NDArrayIter(X, y, batch_size=12))
    it = feed.device_feed(mx.io.NDArrayIter(X, y, batch_size=12), depth=2)
    staged = list(it)
    assert len(staged) == len(raw) == 4
    for a, b in zip(staged, raw):
        assert np.array_equal(a.data[0].asnumpy(), b.data[0].asnumpy())
        assert np.array_equal(a.label[0].asnumpy(), b.label[0].asnumpy())
        assert a.pad == b.pad
    assert staged[-1].pad == 8
    it.reset()
    assert len(list(it)) == 4
    assert it.stats.report()["h2d"]["items"] == 2 * 4 * 12


def _classifier_data(seed=0, n=120):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6).astype(np.float32)
    w = rng.rand(6, 3).astype(np.float32)
    return X, np.argmax(X @ w, axis=1).astype(np.float32)


def _softmax_net(pkg=mx):
    data = pkg.sym.Variable("data")
    return pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(data, num_hidden=3, name="fc"),
        name="softmax")


@deadline(120)
def test_fit_prefetch_to_device_trains_and_matches():
    """fit(prefetch_to_device=True) trains, stages onto the fused step's
    device, and equals the unprefetched fit bitwise."""
    X, y = _classifier_data()
    res = {}
    for pf in (False, True, 1):
        mx.random.seed(3)
        np.random.seed(3)
        it = mx.io.NDArrayIter(X, y, batch_size=24, shuffle=True)
        mod = mx.mod.Module(_softmax_net(), context=mx.cpu())
        mod.fit(it, num_epoch=12, prefetch_to_device=pf,
                optimizer_params=(("learning_rate", 0.5),))
        res[pf] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in res[False]:
        assert np.array_equal(res[False][k], res[True][k])
        assert np.array_equal(res[False][k], res[1][k])
    assert mod._fused is not None
    assert mod._fused.batched_sharding() == torch.device("cpu")
    staged = mod.prefetch_to_device(
        mx.io.NDArrayIter(X, y, batch_size=24), depth=1).next()
    assert staged.data[0]._get().device == mod._fused.batched_sharding()
    preds = mod.predict(mx.io.NDArrayIter(X, y, batch_size=24)).asnumpy()
    assert (np.argmax(preds, 1) == y).mean() > 0.8


def test_fit_no_longer_refuses_prefetch():
    from mxnet_tpu_torch.module import base_module
    assert "prefetch_to_device" not in getattr(base_module, "_NOT_PORTED",
                                               {})


def _jpeg_rec(rec, path, n=22):
    from PIL import Image
    import io as _io
    w = rec.MXRecordIO(path, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = Image.fromarray(rng.randint(0, 255, (14, 14, 3),
                                          dtype=np.uint8))
        buf = _io.BytesIO()
        img.save(buf, format="JPEG", quality=92)
        w.write(rec.pack(rec.IRHeader(0, float(i % 7), i, 0),
                         buf.getvalue()))
    w.close()
    return path


@deadline(60)
def test_record_pipeline_end_to_end_matches(tmp_path):
    """.rec -> parallel decode -> batch -> ring -> h2d, JPEG records, no
    random augmentation: the reference's batches, epochs and pads."""
    pytest.importorskip("PIL")
    rec = _jpeg_rec(recordio, str(tmp_path / "t.rec"))
    got = {}
    for tag, f in (("jax", jfeed), ("torch", feed)):
        it = f.record_pipeline(rec, batch_size=5, data_shape=(3, 12, 12),
                               workers=3, scale=1 / 255.0, max_epochs=3,
                               mean_rgb=(10.0, 20.0, 30.0), resize=13,
                               to_device=tag == "torch")
        out = []
        for _ in range(2):
            out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it])
            it.reset()
        it.close()
        got[tag] = out
        assert it.pipeline.alive_threads() == []
    for ea, eb in zip(got["jax"], got["torch"]):
        assert len(ea) == len(eb) == 5
        for a, b in zip(ea, eb):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            assert a[2] == b[2]
    assert got["torch"][0][-1][2] == 3


@deadline(30)
def test_feed_data_iter_reset_mid_epoch():
    p2 = feed.Pipeline([
        feed.SourceStage(_ints(9), max_epochs=4),
        feed.MapStage(lambda x: (np.full((1,), x, np.float32),
                                 np.float32(x)), workers=2),
        feed.BatchStage(3)], name="midreset")
    it = feed.FeedDataIter(p2, data_shape=(1,), batch_size=3)
    _live.append(it)
    it.next()
    it.reset()
    vals = np.concatenate([b.data[0].asnumpy()[:, 0] for b in it])
    assert vals.tolist() == [float(i) for i in range(9)]
    it.reset()
    vals = np.concatenate([b.data[0].asnumpy()[:, 0] for b in it])
    assert vals.tolist() == [float(i) for i in range(9)]


# -- megabatches (test_superstep.py) ---------------------------------------------

def _mlp(pkg=mx):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data, num_hidden=8,
                                                  name="fc1"),
                           act_type="relu")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(h, num_hidden=3,
                                                        name="fc2"),
                                 name="softmax")


def _data(n=64, batch=16, pkg=mx):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 6).astype(np.float32)
    y = rng.randint(0, 3, n).astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=batch)


def _mlp_init(pkg):
    rng = np.random.RandomState(17)
    return {"fc1_weight": pkg.nd.array(rng.uniform(-0.3, 0.3, (8, 6))),
            "fc1_bias": pkg.nd.zeros((8,)),
            "fc2_weight": pkg.nd.array(rng.uniform(-0.3, 0.3, (3, 8))),
            "fc2_bias": pkg.nd.zeros((3,))}


def _fit(k, n=80, num_epoch=2, prefetch=False, store=None, resume=False,
         every=None, seed=7, pkg=mx):
    pkg.random.seed(seed)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    kw = {}
    if store is not None:
        mgr = pkg.checkpoint.CheckpointManager(store, keep_last_n=None)
        _live.append(mgr)
        kw = dict(checkpoint=mgr, checkpoint_every=every, resume=resume)
    mod.fit(_data(n=n, pkg=pkg), num_epoch=num_epoch, eval_metric="acc",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            superstep=k, prefetch_to_device=prefetch,
            arg_params=_mlp_init(pkg), **kw)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@deadline(120)
def test_prefetch_megabatch_parity():
    """K=4 from prefetch-staged megabatches (plus a K=1 tail) equals
    K=1, bitwise; the port's run agrees with the JAX package's."""
    m1 = _fit(1, prefetch=True)
    m4 = _fit(4, prefetch=True)
    _bitwise(_params(m1), _params(m4))
    assert m4._superstep_runs == 2          # 5 batches an epoch: 1 + tail
    j4 = _fit(4, prefetch=True, pkg=jmx)
    for k, v in _params(j4).items():
        np.testing.assert_allclose(_params(m4)[k], v, rtol=RTOL, atol=ATOL)


def test_device_prefetch_iter_megabatch_assembly():
    it = feed.DevicePrefetchIter(_data(n=80, batch=16), megabatch=4)
    first = it.next()
    assert isinstance(first, feed.MegaBatch) and first.megabatch == 4
    assert first.data[0].shape == (4, 16, 6)
    assert first.label[0].shape == (4, 16)
    singles = first.unstack()
    assert len(singles) == 4 and singles[0].data[0].shape == (16, 6)
    raw = list(_data(n=80, batch=16))
    for i, s in enumerate(singles):
        assert np.array_equal(s.data[0].asnumpy(), raw[i].data[0].asnumpy())
    tail = it.next()
    assert getattr(tail, "megabatch", 1) == 1
    assert np.array_equal(tail.data[0].asnumpy(), raw[4].data[0].asnumpy())
    with pytest.raises(StopIteration):
        it.next()


def test_device_prefetch_iter_megabatch_cursor():
    it = feed.DevicePrefetchIter(_data(n=160, batch=16), megabatch=4)
    it.next()
    st = it.state()
    assert st == {"batch": 4}
    second = it.next()
    it2 = feed.DevicePrefetchIter(_data(n=160, batch=16), megabatch=4)
    it2.restore(st)
    again = it2.next()
    for a, b in zip(second.data + second.label, again.data + again.label):
        assert np.array_equal(a.asnumpy(), b.asnumpy())


def test_stack_batch_arrays_one_layout():
    arrs = [mx.nd.array(np.full((2, 3), i, np.float32), ctx=mx.cpu())
            for i in range(4)]
    out = feed.stack_batch_arrays(arrs, mx.cpu())
    assert tuple(out.shape) == (4, 2, 3)
    assert out[:, 0, 0].tolist() == [0.0, 1.0, 2.0, 3.0]


@deadline(120)
def test_resume_cursorless_checkpoint_into_prefetch_superstep(tmp_path):
    """A checkpoint saved without a feed cursor (plain NDArrayIter) and
    resumed into fit(prefetch_to_device=True, superstep=2): the skip
    counts UNDERLYING batches, not megabatches."""
    store = str(tmp_path / "store")
    _fit(2, num_epoch=1, store=store, every=4)
    shutil.rmtree(os.path.join(store, ck.step_dir_name(5)))
    assert ck.latest_step(store) == 4
    m2 = _fit(2, num_epoch=2, store=store, resume=True, prefetch=True,
              seed=999)
    _bitwise(_params(_fit(2)), _params(m2))


@deadline(120)
def test_superstep_checkpoint_cursor_resume_with_prefetch(tmp_path):
    """fit(prefetch_to_device=True, superstep=2) saves the prefetcher's
    cursor (underlying batches, staged ones excluded); a fresh fit
    resumes from it bitwise."""
    store = str(tmp_path / "store")
    _fit(2, num_epoch=1, store=store, every=2, prefetch=True)
    with ck.CheckpointManager(store) as mgr:
        meta = mgr.restore(step=2)[1]
    assert meta["feed"] == {"batch": 2}
    for s in ck.all_steps(store):
        if s > 2:
            shutil.rmtree(os.path.join(store, ck.step_dir_name(s)))
    m2 = _fit(2, num_epoch=2, store=store, resume=True, prefetch=True,
              seed=999)
    _bitwise(_params(_fit(2)), _params(m2))


# -- feed cursors (test_checkpoint.py) ---------------------------------------------

def _cursor_pipe(f, name, n=12, epochs=4):
    src = lambda: iter(  # noqa: E731
        (np.full((2,), i, np.float32), np.float32(i)) for i in range(n))
    return f.Pipeline([f.SourceStage(src, max_epochs=epochs),
                       f.BatchStage(4)], name=name)


@deadline(60)
def test_feed_iter_cursor_state_restore_matches():
    def run(f):
        it = f.FeedDataIter(_cursor_pipe(f, "ckpt_cursor"), (2,), 4)
        for _ in range(2):
            for _b in it:
                pass
            it.reset()
        it.next()
        st = it.state()
        expected = it.next().data[0].asnumpy()
        it.close()
        return st, expected
    got = _both(run)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][0]["epoch"] == 2 and got["torch"][0]["batch"] == 1
    it2 = feed.FeedDataIter(_cursor_pipe(feed, "ckpt_cursor2"), (2,), 4)
    it2.restore(got["jax"][0])
    assert np.array_equal(it2.next().data[0].asnumpy(), got["jax"][1])
    it2.close()


@deadline(60)
def test_device_prefetch_over_feed_cursor_excludes_staged():
    def make(name):
        return feed.device_feed(feed.FeedDataIter(
            _cursor_pipe(feed, name, n=24, epochs=3), (2,), 4), depth=2)
    it = make("pf_cursor")
    for _ in range(3):
        it.next()
    st = it.state()
    expected = it.next().data[0].asnumpy()
    it._iter.close()
    it2 = make("pf_cursor2")
    it2.restore(st)
    assert np.array_equal(it2.next().data[0].asnumpy(), expected)
    it2._iter.close()


@deadline(60)
def test_feed_cursor_survives_prefetch_toggle():
    it = feed.FeedDataIter(_cursor_pipe(feed, "t1"), (2,), 4)
    for _b in it:
        pass
    it.reset()
    it.next()
    st_bare = it.state()
    expected = it.next().data[0].asnumpy()
    it.close()
    w = feed.device_feed(feed.FeedDataIter(_cursor_pipe(feed, "t2"), (2,),
                                           4), depth=2)
    w.restore(st_bare)
    assert np.array_equal(w.next().data[0].asnumpy(), expected)
    w._iter.close()

    w2 = feed.device_feed(feed.FeedDataIter(_cursor_pipe(feed, "t3"), (2,),
                                            4), depth=2)
    for _ in range(3):
        w2.next()
    w2.reset()
    w2.next()
    st_wrapped = w2.state()
    expected2 = w2.next().data[0].asnumpy()
    w2._iter.close()
    it3 = feed.FeedDataIter(_cursor_pipe(feed, "t4"), (2,), 4)
    it3.restore(st_wrapped)
    assert np.array_equal(it3.next().data[0].asnumpy(), expected2)
    it3.close()


def _raw_rec(path, n=32, shape=(3, 8, 8), label_mod=4, seed=0):
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        w.write(recordio.pack(recordio.IRHeader(0, float(i % label_mod), i,
                                                0),
                              rng.randint(0, 255, shape).astype(np.uint8)
                              .tobytes()))
    w.close()
    return path


def _flat_net(pkg):
    d = pkg.sym.Variable("data")
    n = pkg.sym.FullyConnected(pkg.sym.Flatten(d), num_hidden=4, name="fc")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


@deadline(240)
@pytest.mark.parametrize("writer,procs", [("jax", 3), ("torch", 0)])
def test_cross_package_mid_epoch_resume(tmp_path, writer, procs):
    """A mid-epoch checkpoint with a feed cursor, written by one package,
    resumes in the other at the same next batch: the resumed run trains
    exactly the uninterrupted run's remaining batches, to params within
    rtol 1e-4, atol 1e-5 of it."""
    rec = _raw_rec(str(tmp_path / "h.rec"))
    reader = "torch" if writer == "jax" else "jax"
    pkgs = {"jax": jmx, "torch": mx}
    init = np.random.RandomState(7).uniform(-0.05, 0.05, (4, 192)) \
        .astype(np.float32)

    def fit(tag, store, resume, cb=None, epochs=2):
        pkg = pkgs[tag]
        f = jfeed if tag == "jax" else feed
        it = f.record_pipeline(rec, 8, (3, 8, 8), reader_procs=procs,
                               shuffle_window=5, seed=5, scale=1.0 / 255,
                               max_epochs=8, to_device=False,
                               device_augment=False)
        seen = []

        def log(p):
            seen.append(p.locals["data_batch"].label[0].asnumpy().tolist())
            if cb is not None:
                cb(p)
        mod = pkg.mod.Module(_flat_net(pkg), context=pkg.cpu())
        mgr = pkg.checkpoint.CheckpointManager(store, keep_last_n=None)
        try:
            mod.fit(it, num_epoch=epochs,
                    arg_params={"fc_weight": pkg.nd.array(init),
                                "fc_bias": pkg.nd.zeros((4,))},
                    optimizer_params=(("learning_rate", 0.05),),
                    checkpoint=mgr, checkpoint_every=3, resume=resume,
                    batch_end_callback=log)
        finally:
            mgr.close()
            it.close()
        return seen, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    class Interrupt(Exception):
        pass

    def bomb(p):
        if p.epoch == 1 and p.nbatch == 2:     # step 6 saved, mid-epoch
            raise Interrupt()

    want_seen, want = fit(reader, str(tmp_path / "ref"), False)
    with pytest.raises(Interrupt):
        fit(writer, str(tmp_path / "ck"), False, cb=bomb)
    with ck.CheckpointManager(str(tmp_path / "ck")) as mgr:
        meta = mgr.restore()[1]
    assert meta["global_step"] == 6 and meta["feed"]["batch"] == 2
    got_seen, got = fit(reader, str(tmp_path / "ck"), True)
    assert got_seen == want_seen[6:]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


# -- padded ids (test_embed.py) -----------------------------------------------------

VOCAB = 50


def test_pad_ids_matches():
    for ids, n in (([3, 1, 4], 6), (range(10), 4), ([], 3)):
        a, b = feed.pad_ids(ids, n), jfeed.pad_ids(ids, n)
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert feed.PAD_ID == jfeed.PAD_ID == -1
    assert feed.pad_ids([3, 1, 4], 6).tolist() == [3, 1, 4, -1, -1, -1]


@deadline(120)
@pytest.mark.parametrize("procs", [0, 2])
def test_ids_pipeline_topologies_match(tmp_path, procs):
    rng = np.random.RandomState(7)
    samples = [(i % 2, rng.randint(0, VOCAB, size=rng.randint(1, 7)))
               for i in range(40)]
    path = str(tmp_path / "ids.rec")
    assert feed.write_ids_record(path, samples) == 40
    jpath = str(tmp_path / "ids_j.rec")
    jfeed.write_ids_record(jpath, samples)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = {}
    for tag, f in (("jax", jfeed), ("torch", feed)):
        it = f.ids_pipeline(path, batch_size=8, max_len=6,
                            reader_procs=procs, to_device=False,
                            max_epochs=1, hold=False, shuffle_window=4)
        out = []
        try:
            while True:
                b = it.next()
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        except StopIteration:
            pass
        it.close()
        got[tag] = out
    assert len(got["torch"]) == 5
    for a, b in zip(got["jax"], got["torch"]):
        assert b[0].dtype == np.int32 and b[0].shape == (8, 6)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]


def _rec_symbol(pkg=mx):
    w = pkg.sym.Variable("embed_weight")
    net = pkg.sym.Embedding(pkg.sym.Variable("ids"), weight=w,
                            input_dim=VOCAB, output_dim=4, name="embed")
    net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=2,
                                 name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@deadline(120)
def test_ids_pipeline_fit_equals_host_batches(tmp_path):
    """Padded id batches through ids_pipeline +
    fit(prefetch_to_device=True) train exactly as the same batches from
    an NDArrayIter: the lazy update drops the pads, the table's last row
    and every unnamed row keep their values bitwise."""
    rng = np.random.RandomState(8)
    samples = [(i % 2, rng.randint(0, VOCAB - 1, size=rng.randint(1, 5)))
               for i in range(32)]
    path = str(tmp_path / "ids.rec")
    feed.write_ids_record(path, samples)
    ids = np.stack([feed.pad_ids(s, 4) for _, s in samples])
    labels = np.array([lab for lab, _ in samples], np.float32)
    w0 = np.random.RandomState(9).uniform(-0.1, 0.1, (VOCAB, 4)) \
        .astype(np.float32)
    fc = np.random.RandomState(10).uniform(-0.1, 0.1, (2, 16)) \
        .astype(np.float32)
    res = {}
    for tag in ("feed", "host"):
        if tag == "feed":
            it = feed.ids_pipeline(path, batch_size=8, max_len=4,
                                   max_epochs=4, data_name="ids")
            _live.append(it)
        else:
            it = mx.io.NDArrayIter({"ids": ids}, labels, batch_size=8)
        mod = mx.mod.Module(_rec_symbol(), data_names=("ids",),
                            context=mx.cpu())
        mod.fit(it, num_epoch=2, prefetch_to_device=tag == "feed",
                arg_params={"embed_weight": mx.nd.array(w0),
                            "fc_weight": mx.nd.array(fc),
                            "fc_bias": mx.nd.zeros((2,))},
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert mod._fused.sparse_embeds
        res[tag] = _params(mod)
    _bitwise(res["feed"], res["host"])
    named = np.unique(ids[ids >= 0])
    unnamed = np.setdiff1d(np.arange(VOCAB), named)
    assert VOCAB - 1 in unnamed
    table = res["feed"]["embed_weight"]
    assert np.array_equal(table[unnamed], w0[unnamed])
    assert not np.array_equal(table[named], w0[named])


# -- a rank stages only its rows under a mesh --------------------------------

MULTICHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_multichip.py")


@pytest.fixture(scope="module")
def feed_ranks():
    """test_torch_multichip.feed_rank on two gloo ranks (dp=2)."""
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(MULTICHIP + ":feed_rank", 2, args=(2,), timeout=120)


def _feed_fit(*a, **kw):
    from mxnet_tpu_torch.dist.spawn import load_target
    return load_target(MULTICHIP + ":_feed_fit")(*a, **kw)


def _same(a, b, what):
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg="%s %s"
                                      % (what, k))


def test_mesh_feed_stages_a_ranks_rows(feed_ranks):
    """Under dp=2 the step's batched_sharding() is a RowShard: the h2d
    stage copies half the global batch's bytes a rank, the prefetcher
    stages half the rows (batches and megabatches), and make_batch takes
    the cut batches as they are."""
    _, whole_bytes, _ = _feed_fit(None, False, pipeline="stage")
    _, _, one_rows = _feed_fit(None, True)
    assert whole_bytes == 4 * (16 * 6 * 4 + 16 * 4)
    for rank in feed_ranks:
        assert rank["stage"][1] * 2 == whole_bytes
        assert rank["prefetch"][2] * 2 == one_rows
        assert rank["mega"][2] * 2 == one_rows


def test_mesh_feed_trajectory_is_the_unsharded_feeds(feed_ranks):
    """The trajectory is bitwise the one of the feed that hands every
    rank the global batch: fit with and without prefetch_to_device, K=2
    megabatches with and without, and batches cut by the h2d stage
    against the same batches whole; both ranks hold one state."""
    for rank in feed_ranks:
        _same(rank["prefetch"][0], rank["plain"][0], "prefetch")
        _same(rank["mega"][0], rank["mega_plain"][0], "megabatch")
        _same(rank["stage"][0], rank["whole"][0], "h2d stage")
    _same(feed_ranks[0]["prefetch"][0], feed_ranks[1]["prefetch"][0],
          "ranks")


def test_row_shard_cuts_the_batch_rows_only():
    """RowShard.cut keeps a rank's rows of the arrays with the batch's
    size and passes the others whole; an indivisible batch is refused
    with make_batch's message."""
    shard = feed.RowShard(mx.cpu(), 1, 2)
    x, y, z = np.arange(24).reshape(8, 3), np.arange(8), np.arange(5)
    (cx, cy, cz), flags = shard.cut([x, y, z])
    assert flags == (True, True, False)
    np.testing.assert_array_equal(cx, x[4:])
    np.testing.assert_array_equal(cy, y[4:])
    assert cz is z
    assert feed.resolve_device(shard) == torch.device("cpu")
    with pytest.raises(mx.base.MXNetError, match="not divisible"):
        feed.RowShard(mx.cpu(), 0, 3).cut([x])


def test_mesh_augmentation_draws_one_devices_crops(feed_ranks):
    """The augmentation prologue on a batch cut over dp=2 draws the
    global batch's crops and flips and keeps this rank's rows: the
    ranks' draws are one device's, and so is the trajectory (1e-6)."""
    one, want = _augment_one()
    assert len(want) == 8
    for r, rank in enumerate(feed_ranks):
        params, draws = rank["augment"]
        assert len(draws) == 8
        for got, full in zip(draws, want):
            for g, f in zip(got, full):
                np.testing.assert_array_equal(g, f[r * 8:(r + 1) * 8])
        for k in one:
            np.testing.assert_allclose(params[k], one[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def _augment_one():
    from mxnet_tpu_torch.dist.spawn import load_target
    return load_target(MULTICHIP + ":augment_fit")()
