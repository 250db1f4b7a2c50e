"""The port's native I/O core (``mxnet_tpu_torch/native_io.py`` over
``csrc/native/recordio.cc``, ``image_decode.cc`` and ``data_loader.cc``,
built with g++ at first use), held against the JAX package's
``native_io`` on the same records.

* The port's ``NativeRecordWriter`` writes the JAX writer's bytes, and
  both packages' Python readers parse them.
* The port's ``NativeBatchLoader`` is bitwise the JAX loader's at one
  thread: raw CHW payloads (exact size and the larger prefix form) and
  JPEG payloads (``tests/data/native_jpegs``) with ``resize``,
  ``rand_crop``, ``rand_mirror``, mean and scale, ``shuffle`` under a
  seed and a second epoch, and sharding by ``part_index``/``num_parts``.
  At four threads it is bitwise its own one-thread batches (the crop and
  mirror draws come from one stream an epoch), and the JAX loader's
  where that one's order is itself deterministic (no random draws).
* ``mx.io.ImageRecordIter(...)`` returns ``NativeImageRecordIter`` in
  both packages for the same keyword sets, and the Python path for a
  knob the native loader lacks or for ``round_batch=False``.
* The port's ``im2rec`` packs a list as ``bin/im2rec`` does, byte for
  byte, with and without ``--resize``.
* An I/O library built without libjpeg (as on a machine without
  ``jpeglib.h``) raises on a JPEG record with a message naming libjpeg.
"""
import ctypes
import glob
import os
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import native_io as jio
from mxnet_tpu_torch import native_build, native_io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "native_jpegs",
                                      "*.jpg")))
MEAN = (123.68, 116.78, 103.94)

needs_jax_lib = pytest.mark.skipif(
    not jio.lib_available(), reason="the JAX package's libmxtpu.so does not "
                                    "load here")


def _raw_rec(path, n=22, c=3, h=12, w=10, prefix=False, writer=tio):
    """n raw CHW uint8 records; with ``prefix`` each is larger than the
    (c, h - 2, w - 2) target and carries the uint16 (h, w) prefix."""
    rs = np.random.RandomState(0)
    imgs = (rs.rand(n, c, h, w) * 255).astype(np.uint8)
    wr = writer.NativeRecordWriter(path)
    for i in range(n):
        body = imgs[i].tobytes()
        if prefix:
            body = bytes([h & 255, h >> 8, w & 255, w >> 8]) + body
        wr.write_image(float(i % 7), i, body)
    wr.close()
    return imgs


def _jpeg_rec(path, n=20, writer=tio):
    wr = writer.NativeRecordWriter(path)
    for i in range(n):
        with open(JPEGS[i % len(JPEGS)], "rb") as f:
            wr.write_image(float(i % 5), i, f.read())
    wr.close()


def _epoch(loader):
    out = []
    while True:
        b = loader.next()
        if b is None:
            return out
        out.append(b)


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(da, db)


@needs_jax_lib
def test_writer_bytes_equal_jax_writer(tmp_path):
    pj, pt = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    _raw_rec(pj, writer=jio)
    imgs = _raw_rec(pt, writer=tio)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    for pkg in (jmx, tmx):
        rec = pkg.recordio.MXRecordIO(pt, "r")
        for i in range(len(imgs)):
            header, payload = pkg.recordio.unpack(rec.read())
            assert header.label == float(i % 7) and header.id == i
            assert payload == imgs[i].tobytes()
        assert rec.read() is None
        rec.close()


LOADER_CASES = {
    "raw-exact": dict(kind="raw", shape=(3, 12, 10), kw=dict(
        mean_rgb=MEAN, scale=0.017)),
    "raw-prefix-crop-mirror-shuffle": dict(kind="raw-prefix",
                                           shape=(3, 10, 8), kw=dict(
        rand_crop=True, rand_mirror=True, shuffle=True, seed=5,
        mean_rgb=MEAN, scale=0.5)),
    "raw-shard": dict(kind="raw", shape=(3, 12, 10), kw=dict(
        part_index=1, num_parts=3)),
    "jpeg-center": dict(kind="jpeg", shape=(3, 224, 224), kw=dict(
        resize=256, mean_rgb=MEAN)),
    "jpeg-resize-crop-mirror-shuffle": dict(kind="jpeg",
                                            shape=(3, 224, 224), kw=dict(
        resize=256, rand_crop=True, rand_mirror=True, shuffle=True, seed=9,
        mean_rgb=MEAN, scale=1 / 58.0)),
    "jpeg-noresize-shard": dict(kind="jpeg", shape=(3, 200, 200), kw=dict(
        rand_crop=True, part_index=0, num_parts=2, seed=1)),
}


def _rec_for(case, tmp_path):
    path = str(tmp_path / "in.rec")
    if case["kind"] == "jpeg":
        _jpeg_rec(path)
    else:
        _raw_rec(path, prefix=case["kind"] == "raw-prefix")
    return path


@needs_jax_lib
@pytest.mark.parametrize("name", sorted(LOADER_CASES))
def test_loader_bitwise_jax_loader_one_thread(tmp_path, name):
    """Two epochs at one thread: every batch, label and pad bitwise the
    JAX loader's."""
    case = LOADER_CASES[name]
    path = _rec_for(case, tmp_path)
    runs = []
    for mod in (jio, tio):
        ld = mod.NativeBatchLoader(path, 4, case["shape"], threads=1,
                                   **case["kw"])
        first = _epoch(ld)
        ld.reset()
        runs.append(first + _epoch(ld))
    _same(runs[1], runs[0])


@pytest.mark.parametrize("name", sorted(LOADER_CASES))
def test_loader_same_batches_at_every_thread_count(tmp_path, name):
    """The port's loader at 4 threads gives its one-thread batches, random
    crops and mirrors included, for two epochs."""
    case = LOADER_CASES[name]
    path = _rec_for(case, tmp_path)
    runs = []
    for threads in (1, 4):
        ld = tio.NativeBatchLoader(path, 4, case["shape"], threads=threads,
                                   **case["kw"])
        first = _epoch(ld)
        ld.reset()
        runs.append(first + _epoch(ld))
    _same(runs[1], runs[0])


@needs_jax_lib
def test_loader_four_threads_equal_jax_without_draws(tmp_path):
    """Where the JAX loader's order is deterministic at four threads (no
    random crop or mirror; the shuffle comes before its workers start),
    the first epoch is bitwise the port's."""
    path = _rec_for(LOADER_CASES["jpeg-center"], tmp_path)
    runs = [_epoch(mod.NativeBatchLoader(path, 4, (3, 224, 224), threads=4,
                                         resize=256, shuffle=True, seed=3,
                                         mean_rgb=MEAN))
            for mod in (jio, tio)]
    _same(runs[1], runs[0])


def test_loader_values_and_pad(tmp_path):
    path = str(tmp_path / "v.rec")
    imgs = _raw_rec(path, n=6)
    ld = tio.NativeBatchLoader(path, 4, (3, 12, 10), threads=2,
                               mean_rgb=(10.0, 20.0, 30.0), scale=0.5)
    assert ld.num_records == 6
    (d0, l0, p0), (d1, l1, p1) = _epoch(ld)
    want = (imgs.astype(np.float32) - np.array(
        [10, 20, 30], np.float32).reshape(1, 3, 1, 1)) * 0.5
    np.testing.assert_array_equal(d0, want[:4])
    assert p0 == 0 and p1 == 2
    np.testing.assert_array_equal(d1[:2], want[4:])
    np.testing.assert_array_equal(d1[2:], want[:2])   # wrapped rows
    np.testing.assert_array_equal(l1[:, 0], [4.0, 5.0, 0.0, 1.0])


ROUTING = {
    "jpeg-native": (dict(data_shape=(3, 224, 224), batch_size=4, resize=256,
                         rand_crop=True, rand_mirror=True, mean_r=MEAN[0],
                         mean_g=MEAN[1], mean_b=MEAN[2],
                         preprocess_threads=2), "jpeg", True),
    "raw-native": (dict(data_shape=(3, 12, 10), batch_size=4), "raw", True),
    "rotate-python": (dict(data_shape=(3, 12, 10), batch_size=4,
                           max_rotate_angle=10), "raw", False),
    "discard-python": (dict(data_shape=(3, 12, 10), batch_size=4,
                            round_batch=False), "raw", False),
    "gray-jpeg-python": (dict(data_shape=(1, 224, 224), batch_size=4,
                              resize=256), "jpeg", False),
}


@needs_jax_lib
@pytest.mark.parametrize("name", sorted(ROUTING))
def test_image_record_iter_routes_as_jax(tmp_path, name, monkeypatch):
    kw, kind, native = ROUTING[name]
    path = str(tmp_path / "r.rec")
    if kind == "jpeg":
        _jpeg_rec(path, n=8)
    else:
        _raw_rec(path, n=8)
    got = []
    for pkg in (jmx, tmx):
        it = pkg.io.ImageRecordIter(path_imgrec=path, **kw)
        got.append(type(it).__name__)
    assert got[0] == got[1]
    assert (got[1] == "NativeImageRecordIter") == native
    monkeypatch.setenv("MXNET_NATIVE_IO", "0")
    assert type(tmx.io.ImageRecordIter(path_imgrec=path, **kw)) is \
        tmx.io.ImageRecordIter


@needs_jax_lib
def test_native_image_record_iter_batches_equal_jax(tmp_path):
    path = str(tmp_path / "i.rec")
    _jpeg_rec(path, n=10)
    kw = dict(path_imgrec=path, data_shape=(3, 224, 224), batch_size=4,
              resize=256, rand_crop=True, rand_mirror=True, shuffle=True,
              mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2], scale=0.02,
              preprocess_threads=1, seed=4)
    its = [pkg.io.ImageRecordIter(**kw) for pkg in (jmx, tmx)]
    assert its[1].provide_data == [("data", (4, 3, 224, 224))]
    assert its[1].provide_label == [("softmax_label", (4,))]
    for _ in range(2):
        for it in its:
            it.reset()
        bj, bt = list(its[0]), list(its[1])
        assert len(bj) == len(bt) == 3
        for a, b in zip(bj, bt):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            assert b.data[0].context == tmx.cpu()


def _lst(tmp_path, files):
    lst = tmp_path / "img.lst"
    lst.write_text("".join("%d\t%d\t%s\n" % (i, i * 2, f)
                           for i, f in enumerate(files)))
    return str(lst)


@pytest.mark.parametrize("resize", [0, 240])
def test_im2rec_packs_as_jax_im2rec(tmp_path, resize):
    """Pass-through bytes and JPEGs; with --resize the JPEGs are decoded,
    resized and re-encoded, byte for byte as bin/im2rec does."""
    root = tmp_path / "imgs"
    root.mkdir()
    files = []
    for i in range(3):
        p = root / ("f%d.bin" % i)
        p.write_bytes(bytes([i]) * (10 + i))
        files.append(p.name)
    for j in JPEGS[:3]:
        name = os.path.basename(j)
        (root / name).write_bytes(open(j, "rb").read())
        files.append(name)
    lst = _lst(tmp_path, files)
    flags = ["--resize", str(resize)] if resize else []
    out = str(tmp_path / "port.rec")
    subprocess.check_call([native_build.path("im2rec")] + flags
                          + [lst, str(root), out])
    rec = tmx.recordio.MXRecordIO(out, "r")
    for i in range(3):
        header, payload = tmx.recordio.unpack(rec.read())
        assert header.label == i * 2 and payload == bytes([i]) * (10 + i)
    for i, name in enumerate(files[3:], 3):
        header, payload = tmx.recordio.unpack(rec.read())
        assert header.label == i * 2 and payload[:3] == b"\xff\xd8\xff"
        raw = open(str(root / name), "rb").read()
        assert (payload == raw) == (not resize)
    rec.close()
    jax_bin = os.path.join(ROOT, "bin", "im2rec")
    if os.path.exists(jax_bin):
        ref = str(tmp_path / "jax.rec")
        subprocess.check_call([jax_bin] + flags + [lst, str(root), ref])
        assert open(out, "rb").read() == open(ref, "rb").read()


def test_jpeg_record_without_libjpeg_raises_naming_it(tmp_path):
    """The I/O library built as on a machine without jpeglib.h: raw
    records still load, a JPEG record raises naming libjpeg."""
    so = str(tmp_path / "libio_nojpeg.so")
    src = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "native")
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared",
                    "-pthread", "-o", so]
                   + [os.path.join(src, f) for f in
                      ("recordio.cc", "image_decode.cc", "data_loader.cc")],
                   check=True)
    lib = tio.declare(ctypes.CDLL(so))
    saved = tio._LIB
    tio._LIB = lib
    try:
        raw = str(tmp_path / "raw.rec")
        _raw_rec(raw, n=4)
        assert len(_epoch(tio.NativeBatchLoader(raw, 2, (3, 12, 10)))) == 2
        jpg = str(tmp_path / "jpg.rec")
        _jpeg_rec(jpg, n=4)
        ld = tio.NativeBatchLoader(jpg, 2, (3, 224, 224), resize=256)
        with pytest.raises(RuntimeError, match="libjpeg"):
            ld.next()
    finally:
        tio._LIB = saved
