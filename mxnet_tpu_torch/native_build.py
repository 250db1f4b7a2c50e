"""Build of the port's native objects: the host library (dependency
engine, pooled storage), the I/O library (RecordIO, the threaded batch
loader, JPEG decode), the ``im2rec`` tool, and the C ABI and predict-only
libraries that C, C++, R and Scala programs link.

The counterpart of the JAX package's ``Makefile`` targets
(``libmxtpu.so``, ``libmxtpu_capi.so``, ``libmxtpu_predict.so``,
``bin/im2rec``), built from the port's own sources under
``mxnet_tpu_torch/csrc/native`` and ``csrc/capi`` against the
repository's ``include/c_api.h`` and ``include/c_predict_api.h``.

Each object is built with ``g++`` at first use, one ``g++`` per object,
all started together, into ``mxnet_tpu_torch/_build/native/<name>-<digest>/``
under its own file name; the digest covers the compile line, the sources
and every header they include, so an edit always rebuilds.  A build
writes under a temporary name and is published with ``os.replace``, so
processes that build the same object at once do not race.  With
``MXNET_COMPILE_CACHE=<dir>`` each object is also published into the
compile cache's store and a later process copies it from there without
running ``g++`` (:data:`GXX_RUNS` counts the runs, beside
``ops.cuda_kernels.NVCC_RUNS``).  A failed build raises with the
compiler's output; nothing falls back.

* The I/O library and ``im2rec`` link libjpeg where ``jpeglib.h`` is
  found (:func:`have_jpeg`); without it their JPEG path is compiled out
  and a JPEG record raises an error that names libjpeg.
* ``capi`` and ``predict`` link ``libpython`` (flags from ``sysconfig``)
  for programs that embed the interpreter.  ``capi_inproc`` and
  ``predict_inproc`` are the same sources without ``-lpython``, for
  loading into a running Python process with ``ctypes``: their Python
  symbols resolve from the process, which works whether the interpreter
  is linked statically (as on some distributions) or against
  ``libpython``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sysconfig
import time
from typing import Dict, List, Optional

from .base import MXNetError, get_env, make_lock

__all__ = ["OBJECTS", "build", "available", "path", "load", "embed_env",
           "have_jpeg", "python_flags", "GXX_RUNS", "BUILD_WALLS",
           "INCLUDE_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
INCLUDE_DIR = os.path.join(os.path.dirname(_PKG), "include")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

_IO_SOURCES = ["native/recordio.cc", "native/image_decode.cc"]

# name -> (file name, sources under csrc/, kind, needs)
#   kind: "shared" or "exe"; needs: "jpeg" (libjpeg where found),
#   "python" (the C ABI, linked to libpython), "python-symbols" (the C ABI
#   resolving Python from the loading process)
OBJECTS = {
    "host": ("libmxtpu_torch_host.so",
             ["native/engine.cc", "native/storage.cc"], "shared", ()),
    "io": ("libmxtpu_torch_io.so",
           _IO_SOURCES + ["native/data_loader.cc"], "shared", ("jpeg",)),
    "im2rec": ("im2rec", ["native/im2rec.cc"] + _IO_SOURCES, "exe",
               ("jpeg",)),
    "capi": ("libmxtpu_torch_capi.so",
             ["capi/c_api.cc", "capi/c_predict_api.cc"], "shared",
             ("python",)),
    "predict": ("libmxtpu_torch_predict.so", ["capi/c_predict_api.cc"],
                "shared", ("python", "standalone")),
    "capi_inproc": ("libmxtpu_torch_capi_inproc.so",
                    ["capi/c_api.cc", "capi/c_predict_api.cc"], "shared",
                    ("python-symbols",)),
    "predict_inproc": ("libmxtpu_torch_predict_inproc.so",
                       ["capi/c_predict_api.cc"], "shared",
                       ("python-symbols", "standalone")),
}

# g++ invocations this process made, and each object's last build wall in
# seconds
GXX_RUNS = 0
BUILD_WALLS: Dict[str, float] = {}

_lock = make_lock("native.build")
_libs: Dict[str, ctypes.CDLL] = {}
_jpeg: Optional[bool] = None


def _gxx() -> str:
    gxx = get_env("CXX", None) or shutil.which("g++")
    if not gxx:
        raise MXNetError("g++ not found on PATH; the port's native objects "
                         "are built from mxnet_tpu_torch/csrc at first use")
    return gxx


def have_jpeg() -> bool:
    """Whether ``jpeglib.h`` is found by the compiler (asked once a
    process)."""
    global _jpeg
    if _jpeg is None:
        proc = subprocess.run([_gxx(), "-E", "-x", "c++", "-"],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True)
        _jpeg = proc.returncode == 0
    return _jpeg


def python_flags(link: bool) -> List[str]:
    """Compile flags (``link=False``) or link flags (``link=True``) for a
    library that embeds this interpreter, from ``sysconfig``.  Raises
    where the interpreter has no shared ``libpython`` to link."""
    if not link:
        inc = {sysconfig.get_paths()["include"],
               sysconfig.get_paths()["platinclude"]}
        return ["-I" + d for d in sorted(inc)]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldver = sysconfig.get_config_var("LDVERSION") or ""
    so = os.path.join(libdir, "libpython%s.so" % ldver)
    if not os.path.exists(so):
        raise MXNetError(
            "no shared libpython to link the C ABI against (looked for %s; "
            "Py_ENABLE_SHARED=%s)" % (so, sysconfig.get_config_var(
                "Py_ENABLE_SHARED")))
    extra = (sysconfig.get_config_var("LIBS") or "").split() + \
        (sysconfig.get_config_var("SYSLIBS") or "").split()
    return ["-L" + libdir, "-lpython" + ldver, "-Wl,-rpath," + libdir] + \
        extra


def _command(name: str, output: str) -> List[str]:
    fname, sources, kind, needs = OBJECTS[name]
    cmd = [_gxx(), "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]
    if kind == "shared":
        cmd += ["-shared", "-Wl,-soname," + fname]
    if "python" in needs or "python-symbols" in needs:
        cmd += ["-I" + INCLUDE_DIR] + python_flags(link=False)
    if "standalone" in needs:
        cmd.append("-DMXTPU_PREDICT_STANDALONE")
    jpeg = "jpeg" in needs and have_jpeg()
    if jpeg:
        cmd.append("-DMXTT_HAVE_JPEG")
    cmd += ["-o", output] + [os.path.join(_CSRC, s) for s in sources]
    if jpeg:
        cmd.append("-ljpeg")
    if "python" in needs:
        cmd += python_flags(link=True)
    return cmd


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)
_digests: Dict[str, str] = {}


def _digest(name: str) -> str:
    """sha256 of the object's compile line, its sources and every header
    they include from ``csrc`` or the repository's ``include`` (read once
    a process)."""
    if name not in _digests:
        _digests[name] = _compute_digest(name)
    return _digests[name]


def _compute_digest(name: str) -> str:
    line = " ".join(_command(name, "")).replace(_CSRC, "<csrc>").replace(
        INCLUDE_DIR, "<include>")
    h = hashlib.sha256(line.encode())
    todo = [os.path.join(_CSRC, s) for s in OBJECTS[name][1]]
    seen = set()
    while todo:
        p = os.path.normpath(todo.pop(0))
        if p in seen:
            continue
        seen.add(p)
        with open(p, "rb") as f:
            text = f.read()
        h.update(os.path.relpath(p, _PKG).encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text):
            for base in (os.path.dirname(p), INCLUDE_DIR):
                cand = os.path.join(base, inc.decode())
                if os.path.exists(cand):
                    todo.append(cand)
                    break
    return h.hexdigest()


def _target(name: str) -> str:
    return os.path.join(BUILD_DIR, "%s-%s" % (name, _digest(name)[:16]),
                        OBJECTS[name][0])


def _publish(src: str, dst: str, kind: str) -> None:
    tmp = "%s.tmp-%d" % (dst, os.getpid())
    shutil.copyfile(src, tmp)
    if kind == "exe":
        os.chmod(tmp, 0o755)
    os.replace(tmp, dst)


def _from_cache(name: str, cache, out: str) -> bool:
    from .compile_cache.fingerprint import fast_key
    digest = _digest(name)
    fkey, key = fast_key("native:" + name, digest), cache.library_key(digest)
    blob = cache.load_fast(fkey, "native:" + name)
    if blob is None:
        blob = cache.load_library("native:" + name, key)
        if blob is None:
            return False
        cache.store.save_index(fkey, key)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    _publish(blob, out, OBJECTS[name][2])
    return True


def _to_cache(name: str, cache, out: str) -> None:
    from .compile_cache.fingerprint import fast_key
    digest = _digest(name)
    fkey, key = fast_key("native:" + name, digest), cache.library_key(digest)
    if cache.store_library("native:" + name, key, out) > 0:
        cache.store.save_index(fkey, key)


def build(names=None) -> Dict[str, str]:
    """Build the named objects (default: all) that are not built yet, one
    ``g++`` each, all started together.  Returns each built object's
    compiler output; raises with it when a build fails."""
    global GXX_RUNS
    from .compile_cache import get_cache, get_stats
    names = list(OBJECTS) if names is None else list(names)
    unknown = [n for n in names if n not in OBJECTS]
    if unknown:
        raise MXNetError("unknown native object %r (have %s)"
                         % (unknown[0], sorted(OBJECTS)))
    logs: Dict[str, str] = {}
    cache = get_cache()
    with _lock:
        procs = {}
        t0 = time.perf_counter()
        for n in names:
            out = _target(n)
            if os.path.exists(out) or (cache is not None
                                       and _from_cache(n, cache, out)):
                continue
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = "%s.tmp-%d" % (out, os.getpid())
            GXX_RUNS += 1
            procs[n] = (subprocess.Popen(
                _command(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[n] = log
            BUILD_WALLS[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append("%s (g++ exit %d):\n%s"
                              % (n, proc.returncode, log))
                continue
            os.replace(tmp, out)
            get_stats().note_build("native:" + n, BUILD_WALLS[n])
            if cache is not None:
                _to_cache(n, cache, out)
        if failed:
            raise MXNetError("native build failed: " + "\n".join(failed))
    return logs


def embed_env(env=None) -> Dict[str, str]:
    """The environment for a program that links the C ABI library: its
    embedded interpreter imports ``mxnet_tpu_torch`` from the repository
    root and ``torch`` from this interpreter's site-packages (which a
    virtual environment keeps apart from ``libpython``'s prefix)."""
    import site
    env = dict(os.environ if env is None else env)
    paths = [os.path.dirname(_PKG)] + site.getsitepackages()
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def available(name: str) -> bool:
    """Whether object ``name`` is loaded or can be built here (``g++`` is
    on PATH).  Building it may still fail, and then raises."""
    return name in _libs or bool(get_env("CXX", None)
                                 or shutil.which("g++"))


def path(name: str) -> str:
    """The path of object ``name``, built first if needed."""
    build([name])
    return _target(name)


def load(name: str) -> ctypes.CDLL:
    """Object ``name`` (a shared library) loaded with ``ctypes``, built
    first if needed; one load a process."""
    lib = _libs.get(name)
    if lib is None:
        if OBJECTS[name][2] != "shared":
            raise MXNetError("%s is not a library" % name)
        p = path(name)
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                try:
                    lib = ctypes.CDLL(p)
                except OSError as e:
                    raise MXNetError("cannot load the native %s library %s: "
                                     "%s" % (name, p, e))
                _libs[name] = lib
    return lib
