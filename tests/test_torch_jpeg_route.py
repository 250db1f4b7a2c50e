"""The JPEG records route of the port (``feed.staging.JpegDeviceRoute``:
the plan loader of ``csrc/native/data_loader.cc`` with ``JpegDims``,
nvjpeg's decode to components and the ``jpeg_color`` kernel of
``csrc/jpeg_decode.cu``, the ``image_augment`` kernel of
``csrc/image_augment.cu``), held on the CPU against the JAX package's
native loader and the port's host loader.

On the CPU the route decodes to components with the port's libjpeg (the
host loader's decode, stopped before its upsampling) and both kernels
take their plain versions, so what is held here is everything but nvjpeg
and the kernels: the plan (frame headers, resized sizes, crop and mirror
draws, errors), the geometry handed to the kernels, and the plain
versions' arithmetic, bitwise libjpeg's and the host loader's.
``chip_smoke.py`` holds the kernels to their plain versions and nvjpeg's
decode to ``tests/data/native_jpegs/decoded.npz`` on the card.
"""
import ctypes
import glob
import io
import os
import subprocess

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import native_io as jio
from mxnet_tpu_torch import native_io as tio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.feed.staging import DevicePrefetchIter, JpegDeviceRoute
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(ROOT, "tests", "data", "native_jpegs")
JPEGS = sorted(glob.glob(os.path.join(JPEG_DIR, "*.jpg")))
SAMPLINGS = sorted(glob.glob(os.path.join(JPEG_DIR, "samplings", "*.jpg")))
MEAN = (123.68, 116.78, 103.94)

needs_jax_lib = pytest.mark.skipif(
    not jio.lib_available(), reason="the JAX package's libmxtpu.so does not "
                                    "load here")

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small tensor operations an image; under
    several test workers on one machine, PyTorch's intra-op threads spin
    against each other (a case ran 60x slower), so these tests take one
    thread and give the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JPEG cases of test_torch_native_io.LOADER_CASES, in ImageRecordIter's
# keywords, and a mean/scale case; each runs shuffled
CASES = {
    "jpeg-center": dict(shape=(3, 224, 224), kw=dict(
        resize=256, mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2])),
    "jpeg-resize-crop-mirror-shuffle": dict(shape=(3, 224, 224), kw=dict(
        resize=256, rand_crop=True, rand_mirror=True, seed=9,
        mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2], scale=1 / 58.0)),
    "jpeg-noresize-shard": dict(shape=(3, 200, 200), kw=dict(
        rand_crop=True, part_index=0, num_parts=2, seed=1)),
    "jpeg-mean-scale-mirror": dict(shape=(3, 224, 224), kw=dict(
        resize=240, rand_mirror=True, seed=3, mean_r=10.5, mean_g=200.25,
        mean_b=0.125, scale=0.0171)),
}


def _rec(path, blobs, n=20):
    wr = tio.NativeRecordWriter(path)
    for i in range(n):
        wr.write_image(float(i % 5), i, blobs[i % len(blobs)])
    wr.close()
    return path


def _blobs():
    out = []
    for p in JPEGS:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _iter_kw(path, case, threads, batch=4):
    return dict(path_imgrec=path, data_shape=case["shape"], batch_size=batch,
                shuffle=True, preprocess_threads=threads, **case["kw"])


def _route_epochs(it, epochs=2):
    route = JpegDeviceRoute(it, "cpu")
    out = []
    for _ in range(epochs):
        route.reset()
        while True:
            try:
                out.append(route.next())
            except StopIteration:
                break
    return out, route


def _iter_epochs(it, epochs=2):
    out = []
    for _ in range(epochs):
        it.reset()
        out += list(it)
    return out


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.pad == y.pad
        np.testing.assert_array_equal(x.data[0].asnumpy(),
                                      y.data[0].asnumpy())
        np.testing.assert_array_equal(x.label[0].asnumpy(),
                                      y.label[0].asnumpy())


@needs_jax_lib
@pytest.mark.parametrize("name", sorted(CASES))
def test_route_bitwise_jax_native_iter_one_thread(tmp_path, name):
    """The plan's draws, the port's libjpeg decode and image_augment's
    plain version give the JAX package's NativeImageRecordIter batches
    bitwise, over two shuffled epochs at one thread."""
    path = _rec(str(tmp_path / "r.rec"), _blobs())
    kw = _iter_kw(path, CASES[name], threads=1)
    want = _iter_epochs(jmx.io.NativeImageRecordIter(**kw))
    ck.reset_launches()
    got, route = _route_epochs(tmx.io.NativeImageRecordIter(**kw))
    _same(got, want)
    assert ck.LAUNCHES == {n: 0 for n in ck.SOURCES}    # plain version
    assert route.batches == len(got) and route.images == 4 * len(got)
    assert all(b.data[0].context == tmx.cpu() for b in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_draws_equal_host_route_at_one_and_four_threads(tmp_path,
                                                             name):
    """The plan's rows are the same at 1 and 4 threads, and the route's
    batches at 4 threads are the host loader's at 1 and at 4."""
    path = _rec(str(tmp_path / "r.rec"), _blobs())
    case = CASES[name]
    plans = []
    for threads in (1, 4):
        it = tmx.io.NativeImageRecordIter(**_iter_kw(path, case, threads))
        ld = it.make_loader(plan=True)
        rows = []
        for _ in range(2):
            while True:
                p = ld.next_plan(lambda n: np.empty(n, np.uint8))
                if p is None:
                    break
                rows.append((p.geom, p.label, p.pad,
                             p.payload[:p.nbytes].tobytes()))
            ld.reset()
        plans.append(rows)
    assert len(plans[0]) == len(plans[1]) > 0
    for (g1, l1, p1, b1), (g4, l4, p4, b4) in zip(*plans):
        np.testing.assert_array_equal(g1, g4)
        np.testing.assert_array_equal(l1, l4)
        assert p1 == p4 and b1 == b4
    got, _ = _route_epochs(tmx.io.NativeImageRecordIter(
        **_iter_kw(path, case, threads=4)))
    for threads in (1, 4):
        _same(got, _iter_epochs(tmx.io.NativeImageRecordIter(
            **_iter_kw(path, case, threads))))


def test_plan_rows_name_payloads_sizes_and_draws(tmp_path):
    """A plan row points at its record's JPEG bytes, with its frame
    header's size and the shorter-edge size of the resize."""
    blobs = _blobs()
    path = _rec(str(tmp_path / "r.rec"), blobs, n=8)
    ld = tio.NativeBatchLoader(path, 8, (3, 224, 224), resize=256,
                               rand_crop=True, seed=2, plan=True)
    p = ld.next_plan(lambda n: np.empty(n + 7, np.uint8))
    f = {k: i for i, k in enumerate(tio.PLAN_FIELDS)}
    assert p.nbytes == sum(len(b) for b in blobs) and p.pad == 0
    for row in p.geom:
        rec = int(row[f["record"]])
        o, n = int(row[f["offset"]]), int(row[f["length"]])
        assert p.payload[o:o + n].tobytes() == blobs[rec]
        h, w, _ = tio.jpeg_dims(blobs[rec])
        assert (row[f["src_h"]], row[f["src_w"]]) == (h, w)
        short = min(h, w)
        rh, rw = (h, w) if short == 256 else (
            (256, w * 256 // h) if h < w else (h * 256 // w, 256))
        assert (row[f["res_h"]], row[f["res_w"]]) == (rh, rw)
        assert 0 <= row[f["dy"]] <= rh - 224 and 0 <= row[f["dx"]] <= rw - 224
        assert row[f["ok"]] == 1 and row[f["mirror"]] == 0
    with pytest.raises(RuntimeError, match="next_plan"):
        ld.next()
    ld.reset()
    with pytest.raises(RuntimeError, match="plan buffer"):
        ld.next_plan(lambda n: np.empty(max(n - 1, 0), np.uint8))


def _pil_jpeg(mode, **save):
    pil = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(26)
    shape = (231, 257) if mode == "L" else (231, 257, 3)
    img = pil.fromarray((rs.rand(*shape) * 255).astype(np.uint8), mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=85, **save)
    return buf.getvalue()


def test_jpeg_dims_equal_libjpeg_sizes_on_fixtures():
    for blob in _blobs():
        h, w, c = tio.jpeg_dims(blob)
        assert tio.decode_jpeg(blob).shape == (h, w, 3) and c == 3


@pytest.mark.parametrize("kind", ["progressive", "grayscale"])
def test_jpeg_dims_progressive_and_grayscale(kind):
    blob = _pil_jpeg("L") if kind == "grayscale" else \
        _pil_jpeg("RGB", progressive=True)
    h, w, c = tio.jpeg_dims(blob)
    assert (h, w) == (231, 257) and c == (1 if kind == "grayscale" else 3)
    px = tio.decode_jpeg(blob)
    assert px.shape == (h, w, 3)
    if kind == "grayscale":        # JCS_RGB: the luma in all three
        assert (px[..., 0] == px[..., 1]).all()
        assert (px[..., 0] == px[..., 2]).all()


@pytest.mark.parametrize("kind", ["progressive", "grayscale"])
def test_route_bitwise_host_loader_on_progressive_and_grayscale(tmp_path,
                                                                kind):
    blob = _pil_jpeg("L") if kind == "grayscale" else \
        _pil_jpeg("RGB", progressive=True)
    path = _rec(str(tmp_path / "g.rec"), [blob] + _blobs()[:2], n=6)
    kw = dict(path_imgrec=path, data_shape=(3, 224, 224), batch_size=3,
              resize=230, rand_crop=True, rand_mirror=True, seed=4,
              preprocess_threads=2, mean_r=MEAN[0], mean_g=MEAN[1],
              mean_b=MEAN[2])
    got, _ = _route_epochs(tmx.io.NativeImageRecordIter(**kw))
    _same(got, _iter_epochs(tmx.io.NativeImageRecordIter(**kw)))


def _samplings():
    """The committed JPEGs of every sampling the route takes, odd and tiny
    sizes included (``native_jpegs/samplings``, made by make_jpegs.py):
    {name: bytes}."""
    out = {}
    for p in SAMPLINGS:
        with open(p, "rb") as f:
            out[os.path.splitext(os.path.basename(p))[0]] = f.read()
    return out


def _jobs(blobs):
    """A decode's payload and job rows over ``blobs``, packed in order."""
    dims = [tio.jpeg_dims(b) for b in blobs]
    sizes = [3 * h * w for h, w, _ in dims]
    offs = np.cumsum([0] + [len(b) for b in blobs])[:-1]
    slots = np.cumsum([0] + sizes)[:-1]
    jobs = np.array([[offs[i], len(b), slots[i], dims[i][0], dims[i][1], 1]
                     for i, b in enumerate(blobs)], np.int64)
    payload = torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8)
                               .copy())
    return payload, jobs, slots, sizes


def test_jpeg_color_reference_is_libjpeg():
    """Upsampling and colour conversion of libjpeg's own components give
    libjpeg's RGB, bitwise, at every sampling the route takes; the CPU
    decoder (components, then jpeg_color) gives each image at its slot."""
    blobs = dict(zip((os.path.basename(p) for p in JPEGS), _blobs()))
    blobs.update(_samplings())
    names = sorted(blobs)
    payload, jobs, slots, sizes = _jobs([blobs[n] for n in names])
    ck.reset_launches()
    rgb = ck.JpegDecoder("cpu").decode(payload, jobs, list(range(len(jobs))))
    assert ck.LAUNCHES == {n: 0 for n in ck.SOURCES}    # plain versions
    kinds = set()
    for i, n in enumerate(names):
        want = tio.decode_jpeg(blobs[n])
        got = rgb[slots[i]:slots[i] + sizes[i]].numpy().reshape(want.shape)
        np.testing.assert_array_equal(got, want, err_msg=n)
        kinds.add(tio.decode_jpeg_planes(blobs[n])[1][4])
    assert kinds == {0, 1, 2, 3}


def test_jpeg_color_wrapper_and_skipped_jobs():
    blobs = _blobs()[:3]
    payload, jobs, slots, sizes = _jobs(blobs)
    jobs[1, 5] = 0                             # a record that was not read
    planes, color = ck.JpegDecoder("cpu").decode_planes(payload, jobs,
                                                        [7, 8, 9])
    assert color.shape == (3, len(ck.COLOR_FIELDS))
    assert color[1, 5] == -1 and list(color[0, 3:]) == [128, 128, 3]
    rows = torch.from_numpy(color)
    out = ck.jpeg_color(planes, rows)
    assert torch.equal(out, ck.jpeg_color_reference(planes, rows))
    assert out.numel() == slots[2] + sizes[2]
    with pytest.raises(MXNetError):
        ck.jpeg_color(planes.to(torch.int32), rows)
    with pytest.raises(MXNetError):
        ck.jpeg_color(planes, rows[:, :5])
    with pytest.raises(MXNetError):
        ck.jpeg_color(planes.to("meta"), rows.to("meta"))
    bad = payload.clone()
    bad[jobs[2, 0] + 200:jobs[2, 0] + 400] = 0xFF
    with pytest.raises(RuntimeError, match="at record 9"):
        ck.JpegDecoder("cpu").decode_planes(bad, jobs, [7, 8, 9])


def test_jpeg_dims_refuses_what_it_cannot_read():
    blob = _blobs()[0]
    for bad in (blob[:40], b"\xff\xd8\xff\xd9", b"not a jpeg at all"):
        with pytest.raises(RuntimeError, match="cannot be read"):
            tio.jpeg_dims(bad)
    # an arithmetic-coded frame (SOF9) is another coding process
    i = blob.index(b"\xff\xc0")
    with pytest.raises(RuntimeError, match="SOF0/1/2"):
        tio.jpeg_dims(blob[:i] + b"\xff\xc9" + blob[i + 2:])


def _errors(path, shape, **kw):
    """The messages of the host loader and of the plan loader."""
    out = []
    for plan in (False, True):
        ld = tio.NativeBatchLoader(path, 2, shape, plan=plan, **kw)
        with pytest.raises(RuntimeError) as e:
            ld.next_plan(lambda n: np.empty(n, np.uint8)) if plan \
                else ld.next()
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("fault", ["corrupt", "small", "channels"])
def test_plan_errors_are_the_host_routes(tmp_path, fault):
    blobs = _blobs()
    path = str(tmp_path / "e.rec")
    shape, kw = (3, 224, 224), dict(resize=256)
    if fault == "corrupt":
        _rec(path, [blobs[0], b"\xff\xd8\xff\xe0\x00\x10JFIF"], n=2)
        want = "corrupt JPEG at record 1"
    elif fault == "small":
        _rec(path, blobs, n=2)
        shape, kw, want = (3, 300, 300), dict(resize=256), \
            "smaller than the 300x300 crop"
    else:
        _rec(path, blobs, n=2)
        shape, want = (1, 224, 224), "3 channels"
    host, plan = _errors(path, shape, **kw)
    assert want in host and host == plan


def test_plan_refuses_raw_records(tmp_path):
    path = str(tmp_path / "raw.rec")
    wr = tio.NativeRecordWriter(path)
    for i in range(2):
        wr.write_image(0.0, i, bytes(3 * 12 * 10))
    wr.close()
    it = tmx.io.NativeImageRecordIter(path, (3, 12, 10), 2)
    assert it.records == "raw"
    with pytest.raises(RuntimeError, match="not a JPEG"):
        it.make_loader(plan=True).next_plan(lambda n: np.empty(n, np.uint8))


def test_library_without_libjpeg_plans_the_same_batches(tmp_path):
    """The I/O library built as on a machine without jpeglib.h (the card's):
    the plan is the one the library with libjpeg gives, while decoding on
    the host raises naming libjpeg."""
    path = _rec(str(tmp_path / "r.rec"), _blobs())
    kw = dict(resize=256, rand_crop=True, rand_mirror=True, shuffle=True,
              seed=7, threads=2, plan=True)

    def plans():
        ld = tio.NativeBatchLoader(path, 4, (3, 224, 224), **kw)
        out = []
        while True:
            p = ld.next_plan(lambda n: np.empty(n, np.uint8))
            if p is None:
                return out
            out.append((p.geom, p.label, p.payload[:p.nbytes].tobytes()))
    want = plans()
    so = str(tmp_path / "libio_nojpeg.so")
    src = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "native")
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared",
                    "-pthread", "-o", so]
                   + [os.path.join(src, f) for f in
                      ("recordio.cc", "image_decode.cc", "data_loader.cc")],
                   check=True)
    saved = tio._LIB
    tio._LIB = tio.declare(ctypes.CDLL(so))
    try:
        got = plans()
        with pytest.raises(RuntimeError, match="libjpeg"):
            tio.decode_jpeg(_blobs()[0])
        with pytest.raises(RuntimeError, match="libjpeg"):
            tio.NativeBatchLoader(path, 4, (3, 224, 224), resize=256).next()
        with pytest.raises(RuntimeError, match="libjpeg"):
            next(iter(tmx.io.NativeImageRecordIter(path, (3, 224, 224), 4,
                                                    resize=256)))
    finally:
        tio._LIB = saved
    assert len(got) == len(want) == 5
    for (g, l, b), (g2, l2, b2) in zip(got, want):
        np.testing.assert_array_equal(g, g2)
        np.testing.assert_array_equal(l, l2)
        assert b == b2


def test_decoded_fixtures_are_the_host_decode():
    """tests/data/native_jpegs/decoded.npz, the card's reference for
    nvjpeg, holds the port's libjpeg decode of every fixture, the
    samplings' included, bitwise."""
    ref = np.load(os.path.join(JPEG_DIR, "decoded.npz"))
    blobs = dict(zip((os.path.splitext(os.path.basename(p))[0]
                      for p in JPEGS), _blobs()))
    blobs.update(_samplings())
    assert len(SAMPLINGS) == 7 and sorted(ref.files) == sorted(blobs)
    for stem, blob in blobs.items():
        got = tio.decode_jpeg(blob)
        want = ref[stem]
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=stem)


def _aug_inputs(mirror=1, ok=1):
    rs = np.random.RandomState(0)
    imgs = [(rs.rand(h, w, 3) * 255).astype(np.uint8)
            for h, w in ((20, 30), (24, 24), (33, 21))]
    pix = np.concatenate([im.reshape(-1) for im in imgs])
    offs = np.cumsum([0] + [im.size for im in imgs])[:-1]
    rows = [[offs[0], ok, 20, 30, 16, 24, 1, 3, mirror],
            [offs[1], 1, 24, 24, 24, 24, 2, 5, 0],      # no resize
            [offs[2], 1, 33, 21, 26, 16, 4, 0, 1]]
    return imgs, torch.from_numpy(pix), torch.tensor(rows, dtype=torch.int64)


def test_wrapper_on_cpu_tensors_takes_the_plain_version():
    imgs, pix, geom = _aug_inputs()
    ck.reset_launches()
    out = ck.image_augment(pix, geom, (12, 10), MEAN, 0.5)
    assert torch.equal(out, ck.image_augment_reference(pix, geom, (12, 10),
                                                       MEAN, 0.5))
    assert ck.LAUNCHES == {n: 0 for n in ck.SOURCES}
    # the no-resize image is the crop itself, mirrored per its row
    want = (imgs[1][2:14, 5:15].astype(np.float32).transpose(2, 0, 1)
            - np.float32(MEAN).reshape(3, 1, 1)) * np.float32(0.5)
    np.testing.assert_array_equal(out[1].numpy(), want)
    flipped = ck.image_augment(pix, torch.tensor(
        [[int(geom[1, 0]), 1, 24, 24, 24, 24, 2, 5, 1]]), (12, 10))
    np.testing.assert_array_equal(
        flipped[0].numpy(),
        imgs[1][2:14, 5:15][:, ::-1].astype(np.float32).transpose(2, 0, 1))
    # a record that was not read gives zeros
    _, pix, geom = _aug_inputs(ok=0)
    assert not ck.image_augment(pix, geom, (12, 10), MEAN)[0].any()


def test_plain_version_resizes_as_the_host_resize(tmp_path):
    """Where the crop is the whole resized image, the plain version gives
    the host loader's ResizeBilinear output: the port's loader's batch of
    that size on the same JPEG."""
    blob = _blobs()[1]                                  # 256 x 320
    path = _rec(str(tmp_path / "one.rec"), [blob], n=1)
    want, _, _ = tio.NativeBatchLoader(path, 1, (3, 200, 250), resize=200,
                                       threads=1).next()
    px = tio.decode_jpeg(blob)
    geom = torch.tensor([[0, 1, 256, 320, 200, 250, 0, 0, 0]])
    got = ck.image_augment(torch.from_numpy(px.reshape(-1)), geom,
                           (200, 250))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["pixels-dtype", "geom-shape", "size",
                                 "device"])
def test_wrapper_refuses_bad_arguments(bad):
    _, pix, geom = _aug_inputs()
    args = [pix, geom, (12, 10)]
    if bad == "pixels-dtype":
        args[0] = pix.to(torch.int32)
    elif bad == "geom-shape":
        args[1] = geom[:, :8]
    elif bad == "size":
        args[2] = (0, 10)
    else:
        args[0], args[1] = pix.to("meta"), geom.to("meta")
    with pytest.raises(MXNetError):
        ck.image_augment(*args)


def test_cuda_request_without_a_card_raises(tmp_path, monkeypatch):
    """A CUDA device asks for nvjpeg and the kernel's library: without a
    card (and nvcc) the wrap raises; nothing falls back to the host."""
    monkeypatch.setattr(ck, "_nvcc", lambda: (_ for _ in ()).throw(
        MXNetError("nvcc not found")))
    with pytest.raises(MXNetError):
        ck.JpegDecoder("cuda:0")
    path = _rec(str(tmp_path / "r.rec"), _blobs(), n=4)
    it = tmx.io.NativeImageRecordIter(path, (3, 224, 224), 2, resize=256)
    with pytest.raises(MXNetError):
        DevicePrefetchIter(it, sharding=tmx.gpu(0))
    with pytest.raises(MXNetError, match="no decoder"):
        ck.JpegDecoder("meta")


def test_device_prefetch_on_host_is_plain_lookahead(tmp_path):
    """Wrapped for the host, a JPEG iterator keeps the host route: the
    batches are its own, bitwise."""
    path = _rec(str(tmp_path / "r.rec"), _blobs(), n=10)
    kw = dict(path_imgrec=path, data_shape=(3, 224, 224), batch_size=4,
              resize=256, rand_crop=True, rand_mirror=True, shuffle=True,
              seed=5, preprocess_threads=2)
    w = DevicePrefetchIter(tmx.io.ImageRecordIter(**kw),
                           sharding=tmx.cpu())
    assert w.route == "host" and w.route_report() == {"route": "host"}
    got = []
    for _ in range(2):
        w.reset()
        got += list(w)
    _same(got, _iter_epochs(tmx.io.ImageRecordIter(**kw)))


def test_route_reports_images_and_bytes(tmp_path):
    blobs = _blobs()
    path = _rec(str(tmp_path / "r.rec"), blobs, n=8)
    it = tmx.io.NativeImageRecordIter(path, (3, 224, 224), 4, resize=256)
    got, route = _route_epochs(it, epochs=1)
    assert len(got) == 2 and route.images == 8 and route.batches == 2
    payload = sum(len(b) for b in blobs)
    # the payloads, a geometry row of 9 int64 and a float32 label a record
    assert route.bytes == payload + 8 * (9 * 8 + 4)
    assert got[0].crossed_bytes + got[1].crossed_bytes == route.bytes


def test_build_links_nvjpeg_and_the_digest_covers_it(monkeypatch):
    src = os.path.join(ck._CSRC, ck.SOURCES["image_augment"])
    with open(src) as f:
        text = f.read()
    with open(os.path.join(ck._CSRC, ck.SOURCES["jpeg_color"])) as f:
        dec = f.read()
    assert 'extern "C" int mxtt_image_augment(' in text
    assert 'extern "C" int mxtt_jpeg_color(' in dec
    assert "replaces no TPU kernel" in text and "replaces no TPU" in dec
    assert "nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT" in dec
    assert "NVJPEG_OUTPUT_YUV" in dec and "NVJPEG_OUTPUT_Y " in dec
    for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn"):
        assert op in text
    cmd = ck.nvcc_command(src, "x.so", "nvcc",
                          ck.EXTRA_FLAGS["image_augment"])
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == "--fmad=false"
    assert ck.EXTRA_FLAGS["jpeg_color"] == ("-lnvjpeg",)
    assert ck._toolkit_rpath("/toolkit/bin/nvcc", ("-lnvjpeg",)) == [
        "-Xlinker", "-rpath=/toolkit/lib64"]
    assert ck._toolkit_rpath("/toolkit/bin/nvcc", ("--fmad=false",)) == []
    for name in ("image_augment", "jpeg_color"):
        base = ck._lib_digest(name)
        monkeypatch.setitem(ck.EXTRA_FLAGS, name, ("-lfoo",))
        assert ck._lib_digest(name) != base
    assert ck.COLOR_FIELDS == ("slot", "h", "w", "cw", "ch", "kind")
    # plan_jobs hands image_augment the plan's columns from "ok" on
    assert ck.AUG_FIELDS == ("offset",) + tio.PLAN_FIELDS[3:]
    assert ck.JPEG_JOB_FIELDS == ("payload_offset", "payload_length", "slot",
                                  "h", "w", "ok")
    assert ck.AUG_FIELDS == ("offset", "ok", "src_h", "src_w", "res_h",
                             "res_w", "dy", "dx", "mirror")
    # the kernel's field order is the wrapper's
    enum = text[text.index("enum AugField"):]
    enum = enum[:enum.index("};")]
    names = [t.strip() for t in enum[enum.index("{") + 1:].split(",")]
    assert names[:-1] == ["kAug" + "".join(p.capitalize() for p in
                                            f.split("_"))
                          for f in ck.AUG_FIELDS]


def test_route_batches_stack_into_megabatches(tmp_path):
    """The route's batches through DevicePrefetchIter's megabatch staging
    (fit(superstep=K)): K of them stacked in order, their bytes counted,
    equal to the host loader's batches (the route set by hand, as a CUDA
    device would set it)."""
    path = _rec(str(tmp_path / "r.rec"), _blobs(), n=16)
    kw = dict(path_imgrec=path, data_shape=(3, 224, 224), batch_size=4,
              resize=256, rand_crop=True, rand_mirror=True, seed=8,
              preprocess_threads=2)
    w = DevicePrefetchIter(tmx.io.NativeImageRecordIter(**kw),
                           sharding=tmx.cpu(), megabatch=2)
    w._route = w._source = JpegDeviceRoute(
        tmx.io.NativeImageRecordIter(**kw), "cpu")
    assert w.route == "device"
    mega = list(w)
    host = _iter_epochs(tmx.io.NativeImageRecordIter(**kw), epochs=1)
    assert [m.megabatch for m in mega] == [2, 2]
    for i, m in enumerate(mega):
        for k in range(2):
            np.testing.assert_array_equal(m.data[0].asnumpy()[k],
                                          host[2 * i + k].data[0].asnumpy())
            np.testing.assert_array_equal(m.label[0].asnumpy()[k],
                                          host[2 * i + k].label[0].asnumpy())
    rep = w.route_report()
    assert rep["batches"] == 4 and rep["images"] == 16
    assert w.stats.report()["h2d"]["bytes"] == w._route.bytes
