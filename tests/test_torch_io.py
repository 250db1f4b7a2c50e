"""The port's ``recordio.py`` and the rest of ``io.py`` against the JAX
package's, on the CPU.

RecordIO files (plain, indexed with their ``.idx``, packed image
records) written by either package are byte for byte those of the other
and read back in both.  ``ImageRecordIter`` (the JAX package's Python
path, ``MXNET_NATIVE_IO=0``), ``ResizeIter``, ``PrefetchingIter``,
``CSVIter`` and ``MNISTIter`` deliver the reference's batches bitwise
under one numpy seed: the same decode, the same augmenter draws from
numpy's global stream.  ``PrefetchingIter.dispose`` mid-fetch returns
and joins its threads.  ``mx.nd.imdecode`` raises, as the reference's
does; ``DataIter.feed()`` stages the batches unchanged.  Tests that start
threads carry a deadline of their own (SIGALRM), so a hang fails one test.
"""
import functools
import io as _io
import signal
import struct
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio as trec

PKGS = {"jax": (jmx, jrec), "torch": (mx, trec)}


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
def _python_image_path(monkeypatch):
    # the JAX package's ImageRecordIter on its Python path, the one the
    # port has (its native loader waits for a later slice)
    monkeypatch.setenv("MXNET_NATIVE_IO", "0")


def _records(n=10):
    return [bytes(str(i), "utf-8") * (i + 1) for i in range(n)]


# -- recordio: one format ---------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_recordio_files_identical(tmp_path, writer, reader):
    wrec, rrec = PKGS[writer][1], PKGS[reader][1]
    paths = {}
    for tag, rec in (("w", wrec), ("r", rrec)):
        p = str(tmp_path / ("%s.rec" % tag))
        w = rec.MXRecordIO(p, "w")
        for r in _records():
            w.write(r)
        w.close()
        paths[tag] = p
    assert open(paths["w"], "rb").read() == open(paths["r"], "rb").read()
    rd = rrec.MXRecordIO(paths["w"], "r")
    assert [rd.read() for _ in range(10)] == _records()
    assert rd.read() is None
    rd.close()
    assert rrec.count_records(paths["w"]) == 10
    assert list(rrec.stream_records(paths["w"], want=lambda i: i % 3 == 1,
                                    chunk_bytes=16)) == \
        list(wrec.stream_records(paths["w"], want=lambda i: i % 3 == 1,
                                 chunk_bytes=16))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_indexed_recordio_identical(tmp_path, writer, reader):
    wrec, rrec = PKGS[writer][1], PKGS[reader][1]
    out = {}
    for tag, rec in (("w", wrec), ("r", rrec)):
        idx, path = str(tmp_path / (tag + ".idx")), \
            str(tmp_path / (tag + ".rec"))
        w = rec.MXIndexedRecordIO(idx, path, "w")
        for i, r in enumerate(_records()):
            w.write_idx(i, r)
        w.close()
        out[tag] = (idx, path)
    for k in (0, 1):
        assert open(out["w"][k], "rb").read() == \
            open(out["r"][k], "rb").read()
    rd = rrec.MXIndexedRecordIO(out["w"][0], out["w"][1], "r")
    for i in reversed(range(10)):
        assert rd.read_idx(i) == _records()[i]
    rd.close()


def test_pack_unpack_identical():
    s = b"\x01\x02\x03\x04\x05"
    for label in (4.0, np.array([1.0, 2.0, 3.0], np.float32)):
        hdr = (0, label, 7, 3)
        pj = jrec.pack(jrec.IRHeader(*hdr), s)
        pt = trec.pack(trec.IRHeader(*hdr), s)
        assert pj == pt
        hj, sj = jrec.unpack(pt)
        ht, st = trec.unpack(pj)
        assert sj == st == s and hj.id == ht.id == 7 and hj.id2 == 3
        assert np.array_equal(np.asarray(hj.label), np.asarray(ht.label))


def test_pack_img_identical():
    pytest.importorskip("PIL")
    img = np.random.RandomState(0).randint(0, 256, (9, 7, 3)) \
        .astype(np.uint8)
    for fmt in (".png", ".jpg"):
        pj = jrec.pack_img(jrec.IRHeader(0, 2.0, 1, 0), img, img_fmt=fmt)
        pt = trec.pack_img(trec.IRHeader(0, 2.0, 1, 0), img, img_fmt=fmt)
        assert pj == pt
        _, dj = jrec.unpack_img(pt)
        _, dt = trec.unpack_img(pj)
        assert np.array_equal(dj, dt)


# -- the iterators: the reference's batches -----------------------------------

def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert da.dtype == db.dtype and np.array_equal(da, db)
        assert np.array_equal(la, lb) and pa == pb


def _png_rec(rec, path, n, shape, seed, label_mod=3):
    w = rec.MXRecordIO(path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = (rng.rand(shape[0], shape[1], 3) * 255).astype(np.uint8)
        w.write(rec.pack_img(rec.IRHeader(0, float(i % label_mod), i, 0),
                             img, img_fmt=".png"))
    w.close()
    return path


def _raw_rec(rec, path, n, shape, seed=0):
    w = rec.MXRecordIO(path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        w.write(rec.pack(rec.IRHeader(0, float(i % 3), i, 0),
                         rng.randint(0, 256, shape).astype(np.uint8)
                         .tobytes()))
    w.close()
    return path


def _jpeg_rec(path, n=10, seed=7):
    from PIL import Image
    w = trec.MXRecordIO(path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, wd = rng.randint(40, 80, 2)
        img = Image.fromarray(rng.randint(0, 255, (h, wd, 3),
                                          dtype=np.uint8))
        buf = _io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        w.write(trec.pack(trec.IRHeader(0, float(i % 5), i, 0),
                          buf.getvalue()))
    w.close()
    return path


@deadline(60)
@pytest.mark.parametrize("threads", [1, 4])
def test_image_record_iter_png_matches(tmp_path, threads):
    """Deterministic decode, serial and on a thread pool, two epochs."""
    pytest.importorskip("PIL")
    rec = _png_rec(trec, str(tmp_path / "p.rec"), 12, (8, 8), 0)
    got = {}
    for tag, (pkg, _) in PKGS.items():
        it = pkg.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                    batch_size=5,
                                    preprocess_threads=threads)
        assert type(it).__name__ == "ImageRecordIter"
        got[tag] = _batches(it)
        it.reset()
        got[tag] += _batches(it)
    _same_batches(got["jax"], got["torch"])
    assert got["torch"][2][2] == 3      # 12 rows / batch 5: 3 wrapped


@deadline(60)
def test_image_record_iter_augmenters_match(tmp_path):
    """The default augmenters (shorter-edge resize, rotation, HSL,
    contrast, illumination, pad, random crop and mirror, mean, scale)
    draw from numpy's global stream: one seed, one set of pixels."""
    pytest.importorskip("PIL")
    rec = _png_rec(trec, str(tmp_path / "a.rec"), 8, (16, 16), 1, 2)
    kw = dict(path_imgrec=rec, data_shape=(3, 10, 10), batch_size=4,
              resize=12, max_rotate_angle=15, rand_crop=True,
              rand_mirror=True, random_h=20, random_s=20, random_l=20,
              max_random_contrast=0.2, max_random_illumination=10, pad=1,
              mean_r=120, mean_g=110, mean_b=100, scale=1 / 64.0,
              preprocess_threads=1, shuffle=True)
    got = {}
    for tag, (pkg, _) in PKGS.items():
        np.random.seed(5)
        it = pkg.io.ImageRecordIter(**kw)
        got[tag] = _batches(it) + (it.reset() or _batches(it))
    _same_batches(got["jax"], got["torch"])
    assert not np.array_equal(got["torch"][0][0], got["torch"][2][0])


def test_image_record_iter_raw_records(tmp_path):
    """Raw CHW-packed payloads decode without PIL, into the reference's
    pixels (written as the reference's raw pack_img fallback does)."""
    rec = _raw_rec(trec, str(tmp_path / "r.rec"), 10, (3, 6, 6))
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 6, 6),
                               batch_size=4, scale=0.5)
    got = _batches(it)
    rng = np.random.RandomState(0)
    want = np.stack([rng.randint(0, 256, (3, 6, 6)).astype(np.uint8)
                     for _ in range(10)]).astype(np.float32) * 0.5
    assert np.array_equal(np.concatenate([g[0] for g in got])[:10], want)
    assert [g[2] for g in got] == [0, 0, 2]


@pytest.mark.parametrize("round_batch", [False, True])
def test_image_record_iter_round_batch(tmp_path, round_batch):
    pytest.importorskip("PIL")
    rec = _jpeg_rec(str(tmp_path / "j.rec"))
    got = {}
    for tag, (pkg, _) in PKGS.items():
        it = pkg.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                    batch_size=4, resize=36,
                                    round_batch=round_batch,
                                    preprocess_threads=2)
        assert len(it._index) == 10 and not hasattr(it, "_records")
        got[tag] = _batches(it)
    _same_batches(got["jax"], got["torch"])
    assert [g[2] for g in got["torch"]] == ([0, 0, 2] if round_batch
                                            else [0, 0])


def test_resize_iter_matches():
    got = {}
    for tag, (pkg, _) in PKGS.items():
        X = np.arange(60, dtype=np.float32).reshape(30, 2)
        it = pkg.io.NDArrayIter(X, np.arange(30, dtype=np.float32),
                                batch_size=10)
        r = pkg.io.ResizeIter(it, 7)
        got[tag] = _batches(r)
        r.reset()
        got[tag] += _batches(r)
        assert r.provide_data == [("data", (10, 2))]
    _same_batches(got["jax"], got["torch"])
    assert len(got["torch"]) == 14


@deadline(60)
def test_prefetching_iter_matches():
    got = {}
    for tag, (pkg, _) in PKGS.items():
        its = [pkg.io.NDArrayIter(np.arange(40, dtype=np.float32)
                                  .reshape(40, 1) + k,
                                  np.arange(40, dtype=np.float32),
                                  batch_size=12) for k in (0, 100)]
        p = pkg.io.PrefetchingIter(its, rename_data=[{"data": "a"},
                                                     {"data": "b"}])
        assert [n for n, _ in p.provide_data] == ["a", "b"]
        rows = []
        for _ in range(2):
            for b in p:
                rows.append([d.asnumpy() for d in b.data] + [b.pad])
            p.reset()
        p.dispose()
        assert not any(t.is_alive() for t in p.prefetch_threads)
        got[tag] = rows
    assert len(got["torch"]) == 8
    for a, b in zip(got["jax"], got["torch"]):
        assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
        assert a[2] == b[2]


@deadline(30)
def test_prefetching_iter_dispose_mid_fetch():
    class SlowIter(mx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = 2
            self.provide_data = [mx.io.DataDesc("data", (2, 2))]
            self.provide_label = [mx.io.DataDesc("label", (2,))]

        def next(self):
            time.sleep(0.3)        # dispose lands while we're in here
            return mx.io.DataBatch(data=[mx.nd.ones((2, 2), ctx=mx.cpu())],
                                   label=[mx.nd.zeros((2,), ctx=mx.cpu())],
                                   pad=0, index=None)

    p = mx.io.PrefetchingIter(SlowIter())
    p.next()
    time.sleep(0.05)               # the thread is now mid-next()
    t0 = time.perf_counter()
    p.dispose()
    assert time.perf_counter() - t0 < 2.0
    assert not any(t.is_alive() for t in p.prefetch_threads)


def test_csv_iter_matches(tmp_path):
    rng = np.random.RandomState(3)
    data = rng.rand(25, 6).astype(np.float32)
    dfile, lfile = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dfile, data, delimiter=",")
    np.savetxt(lfile, np.arange(25, dtype=np.float32), delimiter=",")
    for round_batch in (True, False):
        got = {}
        for tag, (pkg, _) in PKGS.items():
            got[tag] = _batches(pkg.io.CSVIter(
                data_csv=dfile, data_shape=(2, 3), label_csv=lfile,
                batch_size=10, round_batch=round_batch))
        _same_batches(got["jax"], got["torch"])
        assert len(got["torch"]) == (3 if round_batch else 2)
        assert got["torch"][0][0].shape == (10, 2, 3)


def test_mnist_iter_matches(tmp_path):
    rng = np.random.RandomState(4)
    imgs = (rng.rand(50, 28, 28) * 255).astype(np.uint8)
    labels = (np.arange(50) % 10).astype(np.uint8)
    img_path = str(tmp_path / "train-images-idx3-ubyte")
    lbl_path = str(tmp_path / "train-labels-idx1-ubyte")
    with open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 50, 28, 28))
        f.write(imgs.tobytes())
    with open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, 50))
        f.write(labels.tobytes())
    for kw in ({"shuffle": True}, {"shuffle": False, "flat": True},
               {"shuffle": False, "num_parts": 2, "part_index": 1}):
        got = {}
        for tag, (pkg, _) in PKGS.items():
            np.random.seed(11)
            got[tag] = _batches(pkg.io.MNISTIter(
                image=img_path, label=lbl_path, batch_size=10, **kw))
        _same_batches(got["jax"], got["torch"])
    assert got["torch"][0][0].shape == (10, 1, 28, 28)


def test_decode_helpers_match():
    """decode_to_hwc_u8 (raw and PNG) and crop_mirror_normalize under one
    numpy seed."""
    pytest.importorskip("PIL")
    raw = np.random.RandomState(1).randint(0, 256, (3, 9, 7)) \
        .astype(np.uint8)
    assert np.array_equal(
        mx.io.decode_to_hwc_u8(raw.tobytes(), (9, 7, 3)),
        jmx.io.decode_to_hwc_u8(raw.tobytes(), (9, 7, 3)))
    png = trec.pack_img(trec.IRHeader(0, 0.0, 0, 0), raw.transpose(1, 2, 0),
                        img_fmt=".png")
    _, payload = trec.unpack(png)
    for resize in (0, 12):
        assert np.array_equal(
            mx.io.decode_to_hwc_u8(payload, (8, 8, 3), resize=resize),
            jmx.io.decode_to_hwc_u8(payload, (8, 8, 3), resize=resize))
    img = raw.astype(np.float32)
    mean = np.array([1.0, 2.0, 3.0], np.float32).reshape(3, 1, 1)
    outs = []
    for pkg in (jmx, mx):
        np.random.seed(2)
        outs.append([pkg.io.crop_mirror_normalize(
            img, (3, 6, 5), rand_crop=True, rand_mirror=True, mean=mean,
            scale=0.25) for _ in range(6)])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_imdecode_raises():
    for pkg in (jmx, mx):
        with pytest.raises(pkg.MXNetError, match="opencv"):
            pkg.nd.imdecode(b"\xff\xd8\xff")


def test_data_iter_feed_stages_unchanged():
    X = np.arange(40, dtype=np.float32).reshape(40, 1)
    y = np.arange(40, dtype=np.float32)
    raw = _batches(mx.io.NDArrayIter(X, y, batch_size=12))
    with mx.cpu():
        it = mx.io.NDArrayIter(X, y, batch_size=12).feed(depth=2)
    staged = _batches(it)
    _same_batches(raw, staged)
    it.reset()
    assert len(_batches(it)) == 4
    assert it.stats.report()["h2d"]["items"] == 2 * 4 * 12


def test_jpeg_decode_without_pil_raises(monkeypatch):
    """A JPEG payload without PIL is a clear error, never a misread."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(mx.MXNetError, match="needs PIL"):
        mx.io.decode_to_hwc_u8(b"\xff\xd8\xff" + b"\0" * 20, (4, 4, 3))
    dec = mx.feed.make_jpeg_decode((3, 4, 4))
    with pytest.raises(mx.MXNetError, match="needs PIL"):
        dec((0.0, b"\xff\xd8\xff" + b"\0" * 20))
    # a raw payload still decodes
    raw = np.arange(48, dtype=np.uint8).tobytes()
    assert mx.io.decode_to_hwc_u8(raw, (4, 4, 3)).shape == (4, 4, 3)
