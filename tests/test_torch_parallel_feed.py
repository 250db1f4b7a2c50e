"""The port's multi-process ``ParallelReader`` and on-device
augmentation against the JAX package's, on the CPU.

The cases of the reference's ``test_parallel_feed.py``: the sharded,
shuffled stream of the port's reader equals the reference's for the same
seed, workers and window, sample for sample (the shuffle is numpy's in
both); a worker killed mid-epoch (SIGKILL, or the ``feed.worker_decode``
fault point's ``crash``) is reforked with nothing lost or duplicated; a
decode error fails loud; ``state``/``fast_restore`` resume mid-epoch
exactly with 4 workers, and the port's reader restores the reference's
cursor; host augmentation draws are positional; the per-worker counters
reach ``mx.profiler.feed_report()``; the env knobs; shutdown leaves no
process.

Augmentation: ``feed.augment_batch`` (torch, the fused step's prologue)
fed the reference's own threefry draws equals the reference's
``augment_batch_host`` bitwise; ``fit`` over the uint8 wire equals
``fit`` over host-augmented float32 batches with the same draws bitwise;
the two wire formats key apart in the fused step; a uint8 superstep
K=4 equals K=1 bitwise.  Every test that starts threads or processes
carries a deadline (SIGALRM).
"""
import functools
import multiprocessing as mp
import os
import signal

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import feed as jfeed
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import feed, recordio
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

pytestmark = pytest.mark.skipif(
    "fork" not in mp.get_all_start_methods(),
    reason="ParallelReader needs the fork start method")


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
    with mx.cpu():
        yield
    mx.faults.clear()


def _raw_rec(path, n, shape=(3, 6, 6), label_mod=None, seed=0):
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        arr = rng.randint(0, 255, shape).astype(np.uint8)
        label = float(i if label_mod is None else i % label_mod)
        w.write(recordio.pack(recordio.IRHeader(0, label, i, 0),
                              arr.tobytes()))
    w.close()
    return str(path)


def _f32_decode(shape):
    def decode(item):
        label, payload = item
        img = np.frombuffer(payload, np.uint8).astype(
            np.float32).reshape(shape)
        return img, np.float32(label)
    return decode


def _reader_iter(rec, batch_size, workers, window, seed=0, max_epochs=2,
                 hold=False, slots=8, shape=(3, 6, 6), decode=None, f=feed):
    p = f.Pipeline([
        f.ParallelReader(rec, decode or _f32_decode(shape),
                         workers=workers, sample_shape=shape,
                         sample_dtype=np.float32, shuffle_window=window,
                         seed=seed, max_epochs=max_epochs, hold=hold,
                         slots_per_worker=slots),
        f.BatchStage(batch_size)], name="ptest")
    return f.FeedDataIter(p, shape, batch_size)


def _labels(it, epochs):
    out = []
    for _ in range(epochs):
        for b in it:
            out.extend(b.label[0].asnumpy().tolist())
        it.reset()
    return out


# -- deterministic sharded delivery ------------------------------------------

@deadline(60)
@pytest.mark.parametrize("workers,window,seed", [(3, 7, 1), (4, 0, 0),
                                                 (2, 256, 9)])
def test_reader_order_equals_reference(tmp_path, workers, window, seed):
    rec = _raw_rec(tmp_path / "a.rec", 53)
    got = {}
    for tag, f in (("jax", jfeed), ("torch", feed)):
        it = _reader_iter(rec, 53, workers=workers, window=window,
                          seed=seed, f=f)
        got[tag] = _labels(it, 2)
        it.close()
    assert got["torch"] == got["jax"]
    assert sorted(got["torch"][:53]) == [float(i) for i in range(53)]
    if window:
        assert got["torch"][:53] != got["torch"][53:]     # per-epoch seed


@deadline(60)
def test_reader_multiset_and_determinism(tmp_path):
    rec = _raw_rec(tmp_path / "a.rec", 53)
    it = _reader_iter(rec, 53, workers=3, window=7, seed=1)
    e0 = _labels(it, 1)
    it.close()
    assert sorted(e0) == [float(i) for i in range(53)]
    assert e0 != [float(i) for i in range(53)]
    it2 = _reader_iter(rec, 53, workers=3, window=7, seed=1)
    assert _labels(it2, 1) == e0
    it2.close()
    it3 = _reader_iter(rec, 53, workers=3, window=7, seed=2)
    assert _labels(it3, 1) != e0
    it3.close()


@deadline(60)
def test_window_zero_and_empty_shards(tmp_path):
    rec = _raw_rec(tmp_path / "b.rec", 12)
    it = _reader_iter(rec, 4, workers=3, window=0, max_epochs=1)
    assert _labels(it, 1) == [float(i) for i in range(12)]
    it.close()
    rec = _raw_rec(tmp_path / "c.rec", 3)
    it = _reader_iter(rec, 3, workers=4, window=2, max_epochs=2)
    assert sorted(_labels(it, 1)) == [0.0, 1.0, 2.0]
    assert sorted(_labels(it, 1)) == [0.0, 1.0, 2.0]
    it.close()


# -- crash recovery ----------------------------------------------------------

def _decode_366(item):
    label, payload = item
    img = np.frombuffer(payload, np.uint8).astype(np.float32) \
        .reshape(3, 6, 6)
    return img, np.float32(label)


@deadline(120)
def test_worker_crash_restart_no_lost_or_duplicated(tmp_path):
    rec = _raw_rec(tmp_path / "d.rec", 60)

    def make():
        return _reader_iter(rec, 5, workers=2, window=5, seed=1,
                            max_epochs=2, slots=2, decode=_decode_366)

    ref = make()
    want = _labels(ref, 2)
    ref.close()
    it = make()
    got = []
    for _ in range(2):
        got.extend(it.next().label[0].asnumpy().tolist())
    reader = it.pipeline.stages[0]
    os.kill(reader.worker_pids()[0], signal.SIGKILL)
    for _ in range(2):
        try:
            while True:
                got.extend(it.next().label[0].asnumpy().tolist())
        except StopIteration:
            pass
    assert got == want
    assert sum(reader.restarts) >= 1
    it.close()


@deadline(120)
def test_worker_decode_fault_point_crash(tmp_path):
    """The ``feed.worker_decode`` point's ``crash`` (SIGKILL inside the
    worker, before it publishes the sample) restarts the worker at that
    sample: the stream equals the crash-free one."""
    rec = _raw_rec(tmp_path / "e.rec", 40)
    ref = _reader_iter(rec, 5, workers=2, window=3, seed=2, max_epochs=1)
    want = _labels(ref, 1)
    ref.close()
    marker = str(tmp_path / "killed")

    def once(ctx):
        if ctx["shard"] != 1 or ctx["seq"] != 4:
            return False
        try:
            os.close(os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False
    mx.faults.install(mx.faults.FaultPlan([mx.faults.Rule(
        points="feed.worker_decode", kinds="crash", when=once)], seed=1))
    it = _reader_iter(rec, 5, workers=2, window=3, seed=2, max_epochs=1)
    got = _labels(it, 1)
    reader = it.pipeline.stages[0]
    it.close()
    assert got == want
    assert reader.restarts == [0, 1] and os.path.exists(marker)


@deadline(60)
def test_decode_error_fails_loud(tmp_path):
    rec = _raw_rec(tmp_path / "e.rec", 8)

    def bad_decode(item):
        label, payload = item
        if label >= 4:
            raise ValueError("rotten record %d" % int(label))
        return _decode_366(item)

    it = _reader_iter(rec, 4, workers=2, window=0, max_epochs=1,
                      decode=bad_decode)
    with pytest.raises(mx.MXNetError, match="rotten record"):
        _labels(it, 1)
    it.close()


# -- cursors --------------------------------------------------------------------

@deadline(120)
def test_mid_epoch_fast_restore_exact_4_workers(tmp_path):
    rec = _raw_rec(tmp_path / "f.rec", 48)

    def make(hold, f=feed, **kw):
        return _reader_iter(rec, 6, workers=kw.get("workers", 4), window=9,
                            seed=3, max_epochs=3, hold=hold, f=f)

    ref = make(False)
    stream = _labels(ref, 2)
    ref.close()
    cursors = {}
    for tag, f in (("jax", jfeed), ("torch", feed)):
        a = make(False, f=f)
        _labels(a, 1)
        for _ in range(3):
            a.next()
        cursors[tag] = a.state()
        a.close()
    st = cursors["torch"]
    assert st == cursors["jax"]
    assert st["epoch"] == 1 and st["batch"] == 3 and st["samples"] == 18
    workers = st["reader"]["workers"]
    assert set(workers) == {"0", "1", "2", "3"}
    assert sum(w["offset"] for w in workers.values()) == 18 + 9
    wrong = make(True, workers=2)
    with pytest.raises(mx.MXNetError, match="reader config changed"):
        wrong.restore(st)
    wrong.close()
    for tag in ("torch", "jax"):          # the reference's cursor too
        b = make(True)
        assert b.pipeline.stages[0].can_fast_restore()
        b.restore(cursors[tag])
        rest = []
        try:
            while True:
                rest.extend(b.next().label[0].asnumpy().tolist())
        except StopIteration:
            pass
        assert rest == stream[66:96]
        b.close()


@deadline(60)
def test_restore_at_epoch_boundary(tmp_path):
    rec = _raw_rec(tmp_path / "g.rec", 24)
    ref = _reader_iter(rec, 6, workers=3, window=5, seed=2, max_epochs=3)
    stream = _labels(ref, 2)
    ref.close()
    it = _reader_iter(rec, 6, workers=3, window=5, seed=2, max_epochs=3,
                      hold=True)
    it.restore({"epoch": 1, "batch": 0, "samples": 0})
    assert _labels(it, 1) == stream[24:]
    it.close()


def _flat_net(pkg=mx):
    d = pkg.sym.Variable("data")
    n = pkg.sym.FullyConnected(pkg.sym.Flatten(d), num_hidden=4, name="fc")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


@deadline(240)
def test_fit_checkpoint_resume_mid_epoch(tmp_path):
    """fit + a checkpoint over a 4-process reader, interrupted mid-epoch;
    a fresh module and pipeline resume from the feed cursor and land on
    the uninterrupted run's params bitwise."""
    rec = _raw_rec(tmp_path / "h.rec", 32, shape=(3, 8, 8), label_mod=4)

    def make_it():
        return feed.record_pipeline(
            rec, 8, (3, 8, 8), reader_procs=4, shuffle_window=6, seed=5,
            scale=1.0 / 255, max_epochs=8, device_augment=False)

    init = np.random.RandomState(7).uniform(-0.05, 0.05, (4, 192)) \
        .astype(np.float32)

    def fit(it, resume, ckpt_dir, cb=None):
        m = mx.mod.Module(_flat_net(), context=mx.cpu())
        m.fit(it, num_epoch=2, arg_params={"fc_weight": mx.nd.array(init),
                                           "fc_bias": mx.nd.zeros((4,))},
              optimizer_params=(("learning_rate", 0.05),),
              checkpoint=str(ckpt_dir), checkpoint_every=3,
              resume=resume, batch_end_callback=cb)
        return {k: v.asnumpy() for k, v in m.get_params()[0].items()}

    ref_it = make_it()
    want = fit(ref_it, False, tmp_path / "ck_ref")
    ref_it.close()

    class Interrupt(Exception):
        pass

    def bomb(param):
        if param.epoch == 1 and param.nbatch == 2:
            raise Interrupt()

    it1 = make_it()
    with pytest.raises(Interrupt):
        fit(it1, False, tmp_path / "ck", cb=bomb)
    it1.close()
    it2 = make_it()
    got = fit(it2, True, tmp_path / "ck")
    it2.close()
    for k in want:
        assert np.array_equal(got[k], want[k])


@deadline(120)
def test_host_augment_draws_are_positional(tmp_path):
    _raw_rec(tmp_path / "rng.rec", 40, shape=(3, 8, 8))

    def make(f=feed):
        return f.record_pipeline(str(tmp_path / "rng.rec"), 5, (3, 8, 8),
                                 reader_procs=2, shuffle_window=5, seed=4,
                                 rand_mirror=True, scale=1.0 / 255,
                                 max_epochs=2, to_device=False,
                                 device_augment=False)

    def collect(it, n=None):
        out = []
        try:
            while True:
                out.append(it.next().data[0].asnumpy().copy())
                if n and len(out) >= n:
                    return out
        except StopIteration:
            pass
        return out

    ita, itj = make(), make(jfeed)
    a, j = collect(ita), collect(itj)
    ita.close()
    itj.close()
    assert len(a) == len(j) == 8
    assert all(np.array_equal(x, y) for x, y in zip(a, j))
    rows = np.concatenate([x.reshape(5, -1) for x in a[:4]])
    assert len({tuple(r[:6]) for r in rows}) > 10
    it2 = make()
    collect(it2, 3)
    st = it2.state()
    it2.close()
    it3 = make()
    it3.restore(st)
    rest = collect(it3)
    assert all(np.array_equal(x, y) for x, y in zip(rest, a[3:8]))
    it3.close()


# -- on-device augmentation -------------------------------------------------------

def _specs(**kw):
    args = dict(data_shape=(3, 8, 8), pre_shape=(12, 14, 3), rand_crop=True,
                rand_mirror=True, mean_rgb=(120.0, 100.0, 90.0),
                scale=1.0 / 255)
    args.update(kw)
    return feed.AugmentSpec(**args), jfeed.AugmentSpec(**args)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_augment_batch_matches_reference_draws(train, flags):
    """The port's prologue fed the reference's own draws (its threefry
    ``_draw``) equals the reference's numpy twin bitwise."""
    import jax
    from mxnet_tpu.feed.augment import _draw
    spec, jspec = _specs(rand_crop=flags[0], rand_mirror=flags[1])
    assert spec.signature() == jspec.signature()
    x = np.random.RandomState(0).randint(0, 256, (6, 12, 14, 3)) \
        .astype(np.uint8)
    key = jax.random.key(42)
    draws = [np.array(d) for d in _draw(key, 6, jspec, train, np)]
    want = jfeed.augment_batch_host(x, key, jspec, train)
    got = feed.augment_batch(torch.from_numpy(x), draws, spec, train)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 3, 8, 8)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(feed.augment_batch_host(x, draws, spec, train),
                          want)


def test_augment_draws_from_the_generator():
    """Draws come from the generator: one state, one set of pixels, in
    the torch prologue and its numpy twin; eval mode draws nothing."""
    spec, _ = _specs()
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (5, 12, 14, 3)).astype(np.uint8))
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    out = []
    a = feed.augment_batch(x, g, spec, True, out_draws=out)
    g.set_state(state)
    b = feed.augment_batch_host(x.numpy(), g, spec, True)
    assert np.array_equal(a.numpy(), b)
    dy, dx, flip = out[0]
    assert int(dy.max()) <= 4 and int(dx.max()) <= 6
    before = g.get_state()
    e1 = feed.augment_batch(x, g, spec, False)
    assert torch.equal(g.get_state(), before)
    assert np.array_equal(e1.numpy(), feed.augment_batch_host(
        x.numpy(), feed.draw(5, spec, False), spec, False))


def _parity_net(pkg=mx):
    d = pkg.sym.Variable("data")
    n = pkg.sym.Convolution(d, num_filter=4, kernel=(3, 3), name="c0")
    n = pkg.sym.Flatten(n)
    n = pkg.sym.FullyConnected(n, num_hidden=4, name="fc")
    return pkg.sym.SoftmaxOutput(n, name="softmax")


def _parity_init():
    rng = np.random.RandomState(11)
    return {"c0_weight": rng.uniform(-0.1, 0.1, (4, 3, 3, 3)),
            "c0_bias": np.zeros(4),
            "fc_weight": rng.uniform(-0.1, 0.1, (4, 144)),
            "fc_bias": np.zeros(4)}


@deadline(240)
def test_uint8_fit_equals_host_augmented_path(tmp_path):
    """fit over the uint8 wire (random crop and mirror in the fused
    step's prologue) equals fit over float32 batches augmented on the
    host with the same draws, to the last bit of every parameter; the
    uint8 batch is a quarter of the float32 one's bytes."""
    rec = _raw_rec(tmp_path / "u8.rec", 32, shape=(3, 10, 10), label_mod=4,
                   seed=1)
    it = feed.record_pipeline(rec, 8, (3, 8, 8), resize=10, rand_crop=True,
                              rand_mirror=True, mean_rgb=(100., 110., 120.),
                              scale=1 / 255., max_epochs=2, reader_procs=2,
                              shuffle_window=4, device_augment=True)
    spec = it.augment_spec
    assert spec.pre_shape == (10, 10, 3)
    u8 = []
    for _ in range(2):
        u8 += [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        it.reset()
    it.close()
    assert u8[0][0].dtype == np.uint8 and u8[0][0].shape == (8, 10, 10, 3)

    def u8_iter():
        return feed.record_pipeline(
            rec, 8, (3, 8, 8), resize=10, rand_crop=True, rand_mirror=True,
            mean_rgb=(100., 110., 120.), scale=1 / 255., max_epochs=2,
            reader_procs=2, shuffle_window=4, device_augment=True)

    # the draws the fused step makes: the host generator, seeded
    mx.random.seed(21)
    g = mx.random.generator(mx.cpu())
    state = g.get_state()
    host = [(feed.augment_batch_host(x, feed.draw(8, spec, True, g), spec,
                                     True), y) for x, y in u8]
    g.set_state(state)
    init = _parity_init()
    res = {}
    for tag in ("host", "dev"):
        mx.random.seed(21)
        if tag == "host":
            X = np.concatenate([h[0] for h in host[:4]])
            Y = np.concatenate([h[1] for h in host[:4]])
            # epoch 2's batches differ from epoch 1's: one iterator over
            # both epochs' batches, one pass
            X = np.concatenate([X] + [h[0] for h in host[4:]])
            Y = np.concatenate([Y] + [h[1] for h in host[4:]])
            data = mx.io.NDArrayIter(X, Y, batch_size=8)
            epochs = 1
        else:
            data = u8_iter()
            epochs = 2
        m = mx.mod.Module(_parity_net(), context=mx.cpu())
        m.fit(data, num_epoch=epochs, prefetch_to_device=tag == "dev",
              arg_params={k: mx.nd.array(v) for k, v in init.items()},
              optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        res[tag] = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
        if tag == "dev":
            data.close()
            keys = {k for k in m._fused._buffers}
            assert any(dict((n, d) for n, _, d in k)["data"] ==
                       torch.uint8 for k in keys)
    for k in res["host"]:
        assert np.array_equal(res["dev"][k], res["host"][k]), k
    assert host[0][0].nbytes == 4 * u8[0][0].nbytes * 64 // 100


@deadline(120)
def test_wire_formats_key_apart_and_eval_passes_f32(tmp_path):
    """One graph key per wire format: the uint8 train batch and a float32
    (host-augmented) eval batch take separate static buffers, and the
    float32 batch passes the prologue untouched."""
    rec = _raw_rec(tmp_path / "k.rec", 16, shape=(3, 8, 8), label_mod=4)
    it = feed.record_pipeline(rec, 8, (3, 8, 8), max_epochs=2,
                              device_augment=True)
    m = mx.mod.Module(_parity_net(), context=mx.cpu())
    m.fit(it, num_epoch=1,
          arg_params={k: mx.nd.array(v) for k, v in _parity_init().items()},
          optimizer_params={"learning_rate": 0.05})
    it.close()
    x = np.random.RandomState(2).rand(8, 3, 8, 8).astype(np.float32)
    ev = mx.io.NDArrayIter(x, np.zeros(8, np.float32), batch_size=8)
    p_f32 = m.predict(ev).asnumpy()
    m2 = mx.mod.Module(_parity_net(), context=mx.cpu())
    m2.bind([("data", (8, 3, 8, 8))], [("softmax_label", (8,))],
            for_training=False)
    m2.set_params(*m.get_params())
    assert np.array_equal(p_f32, m2.predict(ev).asnumpy())
    assert m._fused.device_augment is not None
    # a float32 train batch keys its own buffers beside the uint8 one's
    m.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                              label=[mx.nd.zeros((8,), ctx=mx.cpu())]),
              is_train=True)
    m.update()
    keys = [k for k in m._fused._buffers]
    dtypes = sorted(str(dict((n, d) for n, _, d in k)["data"]) for k in keys)
    assert dtypes == ["torch.float32", "torch.uint8"]
    # a uint8 eval batch center-crops through the prologue
    b = mx.io.DataBatch(data=[mx.nd.array(
        np.random.RandomState(3).randint(0, 256, (8, 8, 8, 3)),
        dtype=np.uint8, ctx=mx.cpu())], label=None)
    m.forward(b, is_train=False)
    assert m.get_outputs()[0].shape == (8, 4)


@deadline(240)
def test_uint8_superstep_bitwise_matches_k1(tmp_path):
    """The prologue's draws come from each step in order: a uint8
    superstep K=4 with random crop and mirror, fed prefetch-staged
    megabatches, equals K=1 bitwise."""
    rec = _raw_rec(tmp_path / "ss.rec", 64, shape=(3, 10, 10), label_mod=4,
                   seed=1)
    init = np.random.RandomState(3).uniform(-0.05, 0.05, (4, 192)) \
        .astype(np.float32)
    res = {}
    for k in (1, 4):
        mx.random.seed(123)
        it = feed.record_pipeline(rec, 8, (3, 8, 8), resize=10,
                                  reader_procs=2, seed=0, shuffle_window=4,
                                  rand_crop=True, rand_mirror=True,
                                  scale=1.0 / 255, max_epochs=4,
                                  device_augment=True)
        m = mx.mod.Module(_flat_net(), context=mx.cpu())
        m.fit(it, num_epoch=2, superstep=k, prefetch_to_device=True,
              arg_params={"fc_weight": mx.nd.array(init),
                          "fc_bias": mx.nd.zeros((4,))},
              optimizer_params={"learning_rate": 0.05})
        it.close()
        res[k] = {n: v.asnumpy() for n, v in m.get_params()[0].items()}
        if k == 4:
            assert m._superstep_runs == 4
    for n in res[1]:
        assert np.array_equal(res[1][n], res[4][n])


@deadline(60)
def test_device_augment_without_fused_raises(tmp_path, monkeypatch):
    rec = _raw_rec(tmp_path / "u8f.rec", 16, shape=(3, 8, 8), label_mod=4)
    it = feed.record_pipeline(rec, 8, (3, 8, 8), reader_procs=1,
                              shuffle_window=0, max_epochs=2,
                              device_augment=True)
    m = mx.mod.Module(_parity_net(), context=mx.cpu())
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    with pytest.raises(mx.MXNetError, match="device_augment=False"):
        m.fit(it, num_epoch=1)
    it.close()


# -- observability / knobs / shutdown ------------------------------------------

@deadline(60)
def test_feed_report_aggregates_worker_processes(tmp_path):
    rec = _raw_rec(tmp_path / "s.rec", 24)
    it = _reader_iter(rec, 6, workers=2, window=3, max_epochs=1)
    _labels(it, 1)
    rep = it.pipeline.stats.report()["reader"]
    assert rep["worker_items"] == 24
    assert set(rep["workers"]) == {"w0", "w1"}
    assert rep["workers"]["w0"]["items"] + rep["workers"]["w1"]["items"] \
        == 24
    assert rep["restarts"] == 0 and rep["items"] == 24
    txt = mx.profiler.feed_report_str()
    assert "reader[w0]" in txt and "reader[w1]" in txt
    it.close()


@deadline(60)
def test_env_knobs(tmp_path, monkeypatch):
    rec = _raw_rec(tmp_path / "k.rec", 12, shape=(3, 6, 6))
    monkeypatch.setenv("MXNET_FEED_WORKERS", "2")
    monkeypatch.setenv("MXNET_FEED_SHUFFLE_WINDOW", "4")
    monkeypatch.setenv("MXNET_FEED_DEVICE_AUGMENT", "1")
    monkeypatch.setenv("MXNET_FEED_MAX_RESTARTS", "5")
    it = feed.record_pipeline(rec, 4, (3, 6, 6), max_epochs=1)
    head = it.pipeline.stages[0]
    assert isinstance(head, feed.ParallelReader)
    assert head._nworkers == 2 and head._window == 4
    assert head._max_restarts == 5
    assert it.augment_spec.pre_shape == (6, 6, 3)
    b = it.next()
    assert b.data[0].dtype == np.uint8 and b.data[0].shape == (4, 6, 6, 3)
    it.close()
    for name in ("MXNET_FEED_WORKERS", "MXNET_FEED_SHUFFLE_WINDOW",
                 "MXNET_FEED_DEVICE_AUGMENT"):
        monkeypatch.delenv(name)
    it = feed.record_pipeline(rec, 4, (3, 6, 6), max_epochs=1)
    assert isinstance(it.pipeline.stages[0], feed.SourceStage)
    assert it.augment_spec is None
    it.close()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


@deadline(60)
def test_shutdown_no_leaked_processes(tmp_path):
    rec = _raw_rec(tmp_path / "z.rec", 40)
    it = _reader_iter(rec, 5, workers=3, window=5, max_epochs=None)
    it.next()
    reader = it.pipeline.stages[0]
    pids = [p for p in reader.worker_pids() if p]
    assert len(pids) == 3
    it.close()
    assert it.pipeline.alive_threads() == []
    for proc in reader._procs:
        proc.join(5)
    assert all(not _alive(p) for p in pids)
