"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
their build.

The counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  Each kernel has:

* a wrapper that checks its inputs, allocates the output with
  ``torch.empty``, launches on the current stream and raises if the
  launch fails.  A CUDA tensor always reaches the kernel; only a tensor
  that lies on the CPU takes the plain version;
* the plain PyTorch version beside it (``*_reference``), used on the CPU
  and by ``chip_smoke.py`` to check the kernel on the card;
* a launch count (:data:`LAUNCHES`), raised by one where the wrapper
  launches the kernel and nowhere else (once per call, also where a call
  launches two CUDA kernels, as split-K ``paged_attention`` does).

Every kernel takes float32, float16 and bfloat16 operands
(:data:`KERNEL_DTYPES`), as the TPU kernels do, and rounds its output
once to the operands' dtype (``csrc/elem.cuh``).  The TPU kernels
convert each element to float32 as they load it; so do correlation's
``|a - b|``, paged_attention's one-row path and any float32 q, at the
read from their 16-bit stages.  A 16-bit q, k and v in flash_attention,
a 16-bit q over pools of its dtype in paged_attention's row tiles,
16-bit a and b in correlation's products, and x and w of one 16-bit
dtype in fused_fc_epilogue (where :func:`fc_workspace_bytes` is not 0)
are multiplied on the tensor cores as they are (``csrc/attention.cuh``:
q·k, a·b and x·wᵀ in one 16-bit product, exact in float32; p·v in two, p
split into two 16-bit parts; float32 sums): the output lies within one
unit in its last place of the float32 arithmetic's, rounded.  The
attention and correlation wrappers run the instance of their operands'
dtype; operands of mixed float dtypes are upcast to float32 (exact) and
run the float32 instance, the output cast to q's (or a's) dtype, which
is the value the TPU kernels' load-time upcast gives.  ``paged_attention``
upcasts only q over a 16-bit pool: its kernel reads a float32 q over
pools of any of the three dtypes, so the pools are never copied.

Sources live in ``mxnet_tpu_torch/csrc`` (``*.cu``, and the ``*.cuh``
headers they include).  Each ``.cu`` is compiled on first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under ``mxnet_tpu_torch/_build`` and loaded with ``ctypes``.  With
``MXNET_COMPILE_CACHE=<dir>`` the libraries go to that persistent store
instead (``compile_cache``): each ``nvcc`` output is published there
under its digest and the environment fingerprint, and a later process
loads it from there without running ``nvcc``; an entry that fails its
digest is dropped and built again.

Two kernels take a tile parameter the kernel search
(``autotune.kernelsearch``) chooses among, each resolved at call time
as flash's tile is: an explicit argument wins, then the searched winner
under ``MXNET_KERNEL_SEARCH=1``, then the default.  ``fused_fc_epilogue``
has ``block_n`` (:data:`FC_TILES`), ``paged_attention`` its split-K
partition length (:data:`PAGED_PART_KEYS`, 0 for one pass).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import tempfile
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError, get_env, make_lock
from .nn import ACTIVATIONS

__all__ = ["KERNEL_DTYPES", "HALF_ULP",
           "fused_fc_epilogue", "fused_fc_epilogue_reference", "requantize",
           "reciprocal_f32", "FC_TILES", "FC_DEFAULT_TILE",
           "fc_workspace_bytes",
           "paged_attention", "paged_attention_reference", "paged_partitions",
           "PAGED_PART_KEYS", "PAGED_PARTITION_KEYS",
           "flash_attention", "flash_attention_reference", "FLASH_TILES",
           "correlation", "correlation_reference",
           "LAUNCHES", "reset_launches", "build", "nvcc_command", "SOURCES",
           "NVCC_RUNS", "BUILD_WALLS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source file under csrc/
SOURCES = {"fused_fc_epilogue": "fc_epilogue.cu",
           "paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "correlation": "correlation.cu"}

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_launch_lock = make_lock("kernels.launches")


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# build

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = make_lock("kernels.build")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = get_env("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (looked on PATH and in $CUDA_HOME/"
                         "bin); the CUDA kernels are built from "
                         "mxnet_tpu_torch/csrc at first use")
    return path


def nvcc_command(source: str, output: str, nvcc: str = "nvcc") -> list:
    """The compile line for one kernel source: Hopper (``sm_90a``) code,
    a shared library with a plain C interface.  ``--split-compile``
    optimizes a source's kernel instances (one a tile, head-dim bucket
    and operand dtype) on 4 threads, so the libraries built at once
    share the machine's cores instead of waiting on the largest."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "--split-compile=4", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", output, source]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _lib_digest(name: str, csrc: str = _CSRC) -> str:
    """sha256 of the library's compile line, its source and every header
    under ``csrc`` that the source includes (directly or through another
    header)."""
    h = hashlib.sha256(" ".join(nvcc_command("", "")).encode())
    todo, seen = [SOURCES[name]], set()
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.add(rel)
        with open(os.path.join(csrc, rel), "rb") as f:
            text = f.read()
        h.update(rel.encode() + b"\0" + text)
        todo += [inc.decode() for inc in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(csrc, inc.decode()))]
    return h.hexdigest()


def _lib_path(name: str, csrc: str = _CSRC) -> str:
    """The library's path carries its digest (:func:`_lib_digest`), so an
    edit to its source, a header or the compile line always rebuilds."""
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (
        name, _lib_digest(name, csrc)[:16]))


# nvcc invocations this process made, and each library's last nvcc wall
# in seconds
NVCC_RUNS = 0
BUILD_WALLS: Dict[str, float] = {}
# name -> the path a built or stored library is loaded from, and the
# store key it came from (None: mxnet_tpu_torch/_build)
_resolved: Dict[str, tuple] = {}


def _store_keys(name: str, cache):
    """-> (fast key, entry key) of a library in the compile cache: the
    fast key indexes it by name and digest alone, the entry key adds the
    environment fingerprint."""
    from ..compile_cache.fingerprint import fast_key
    digest = _lib_digest(name)
    return fast_key("library:" + name, digest), cache.library_key(digest)


def _find(name: str, cache):
    """-> (path, store key) of a library that needs no nvcc run, or
    None."""
    if cache is None:
        path = _lib_path(name)
        return (path, None) if os.path.exists(path) else None
    fkey, key = _store_keys(name, cache)
    path = cache.load_fast(fkey, name)
    if path is None:
        path = cache.load_library(name, key)
        if path is None:
            return None
        cache.store.save_index(fkey, key)
    return path, key


def build(names=None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  With a compile cache
    (``MXNET_COMPILE_CACHE``) a library already in its store is taken
    from there and each new one is published there.  Returns each built
    kernel's compiler output (``-Xptxas -v``: registers, shared memory,
    spills)."""
    from ..compile_cache import get_cache
    names = list(SOURCES) if names is None else list(names)
    logs: Dict[str, str] = {}
    cache = get_cache()
    with _build_lock:
        todo = []
        for n in names:
            if n in _libs:
                continue
            found = _find(n, cache)
            if found is not None:
                _resolved[n] = found
            else:
                todo.append(n)
        if not todo:
            return logs
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # with a cache nvcc writes into a directory of its own, removed
        # once the libraries are in the store
        outdir = None if cache is None else tempfile.mkdtemp(
            prefix="mxtt-build-")
        try:
            _run_nvcc(todo, nvcc, cache, outdir, logs)
        finally:
            if outdir is not None:
                shutil.rmtree(outdir, ignore_errors=True)
    return logs


def _run_nvcc(todo, nvcc, cache, outdir, logs) -> None:
    """One nvcc a library of ``todo``, all started together; each output
    is published into the store when there is a cache (and loaded from
    there), else kept in BUILD_DIR, as is one the store could not take."""
    global NVCC_RUNS
    from ..compile_cache import get_stats
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n) if outdir is None else os.path.join(
            outdir, "lib%s.so" % n)
        tmp = "%s.tmp-%d" % (out, os.getpid())
        cmd = nvcc_command(os.path.join(_CSRC, SOURCES[n]), tmp, nvcc)
        NVCC_RUNS += 1
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    stats = get_stats()
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[n] = log
        BUILD_WALLS[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (n, proc.returncode, log))
            continue
        os.replace(tmp, out)
        stats.note_build("kernel:" + n, BUILD_WALLS[n])
        from .. import trace as _trace
        _trace.complete("compile:backend_compile", t0, BUILD_WALLS[n],
                        cat="compile", program="kernel:" + n)
        key = None
        if cache is not None:
            fkey, key = _store_keys(n, cache)
            if cache.store_library(n, key, out) > 0:
                cache.store.save_index(fkey, key)
                out = cache.store.blob_path(key)
            else:
                key = None
                shutil.move(out, _lib_path(n))
                out = _lib_path(n)
        _resolved[n] = (out, key)
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    for attempt in (0, 1):
        build([name])
        with _build_lock:
            lib = _libs.get(name)
            if lib is not None:
                return lib
            path, key = _resolved.pop(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                if key is None or attempt:
                    raise MXNetError("cannot load the %s kernel library %s: "
                                     "%s" % (name, path, e))
                # a stored entry that passed its digest but will not load
                # (evicted under us, or written by an incompatible
                # toolchain): drop it and build it again
                from ..compile_cache import get_cache
                from ..compile_cache.store import warn_once
                warn_once("library-load",
                          "stored %s library %s would not load (%s); "
                          "rebuilding" % (name, key[:12], e))
                get_cache().drop(key)
                continue
            _declare(name, lib)
            _libs[name] = lib
            return lib
    raise MXNetError("cannot load the %s kernel library" % name)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxtt_error_string.argtypes = [i]
    lib.mxtt_error_string.restype = ctypes.c_char_p
    if name == "fused_fc_epilogue":
        lib.mxtt_fc_epilogue.argtypes = [p] * 4 + [i] * 7 + [
            ctypes.c_float, i, p, i, p]
        lib.mxtt_fc_epilogue.restype = i
        lib.mxtt_fc_workspace_bytes.argtypes = [p, p] + [i] * 5
        lib.mxtt_fc_workspace_bytes.restype = ctypes.c_longlong
    elif name == "paged_attention":
        lib.mxtt_paged_attention.argtypes = [p] * 9 + [i] * 8 + [
            ctypes.c_float, i, i, i, i, i, p]
        lib.mxtt_paged_attention.restype = i
    elif name == "flash_attention":
        lib.mxtt_flash_attention.argtypes = [p] * 4 + [i] * 5 + [
            ctypes.c_float, i, i, i, i, p]
        lib.mxtt_flash_attention.restype = i
    elif name == "correlation":
        lib.mxtt_correlation.argtypes = [p] * 3 + [i] * 9 + [p]
        lib.mxtt_correlation.restype = i


def _check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        raise MXNetError("%s kernel launch failed: CUDA error %d (%s)"
                         % (name, rc, lib.mxtt_error_string(rc).decode()))


# ---------------------------------------------------------------------------
# fused_fc_epilogue

ACT_CODES = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "softrelu": 4}
# the operand dtypes every kernel is compiled for, by the dtype code of
# their C interfaces
_FLOAT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
KERNEL_DTYPES = tuple(_FLOAT_CODES)
# one unit in the last place at magnitude 1: a 16-bit output, rounded once
# from float32 sums that differ from the plain version's by a few float32
# ulps, lies within HALF_ULP[dtype] * max(1, max|plain|) of it
HALF_ULP = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}
INT8_QMAX = 127


def _float_operands(name: str, tensors):
    """Check a kernel's float operands (``(tensor, what)`` pairs): each
    of :data:`KERNEL_DTYPES` and contiguous.  -> (the tensors to launch
    on, their dtype code): operands of one dtype as they are; mixed ones
    upcast to float32, which is exact, for the float32 instance."""
    for t, what in tensors:
        if t.dtype not in _FLOAT_CODES:
            raise MXNetError("%s: %s dtype %s, the kernel takes %s" % (
                name, what, t.dtype,
                " or ".join(str(d) for d in KERNEL_DTYPES)))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (name, what))
    ts = [t for t, _ in tensors]
    if len({t.dtype for t in ts}) == 1:
        return ts, _FLOAT_CODES[ts[0].dtype]
    return [t.float() for t in ts], 0


def reciprocal_f32(scale: float) -> float:
    """``1 / scale`` as XLA folds it: both rounded to float32."""
    return float(np.float32(1.0) / np.float32(scale))


def requantize(y: torch.Tensor, out_scale: float) -> torch.Tensor:
    """float -> int8 codes ``clamp(round_half_even(y / out_scale), ±127)``
    as the reference computes them: XLA rewrites the division by the
    constant scale into a multiplication by its float32 reciprocal
    (:func:`reciprocal_f32`), which rounds differently at some ties, so
    the port multiplies by the same reciprocal."""
    if not float(out_scale) > 0:
        raise MXNetError("out_scale must be > 0, got %r" % (out_scale,))
    # a float32 tensor times a Python float multiplies by the float32
    # value of that float, which reciprocal_f32 already is
    q = torch.round(y.to(torch.float32) * reciprocal_f32(out_scale))
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def fused_fc_epilogue_reference(x: torch.Tensor, w: torch.Tensor,
                                b: Optional[torch.Tensor], act_type: str,
                                out_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_fc_epilogue`: the same
    arithmetic (float32 products and sums, the same activation formulas,
    multiplication by the float32 reciprocal of ``out_scale`` and
    round-half-to-even) in library calls."""
    acc = torch.matmul(x.float(), w.float().t())
    if b is not None:
        acc = acc + b.float()
    if act_type != "none":
        acc = ACTIVATIONS[act_type](acc)
    return acc.to(x.dtype) if out_scale is None else \
        requantize(acc, out_scale)


# the kernel's compiled column tiles (csrc/fc_epilogue.cu launch_tile):
# 4 warps of 2, 4 or 8 W rows each, for float32 x and W (float32 or int8
# out); every other dtype pair has the default tile only
FC_TILES = (8, 16, 32)
FC_DEFAULT_TILE = 16


def fc_tiles_for(x_dtype, w_dtype) -> tuple:
    """The compiled ``block_n`` instances for these operand dtypes."""
    if x_dtype == torch.float32 and w_dtype == torch.float32:
        return FC_TILES
    return (FC_DEFAULT_TILE,)


def fc_workspace_bytes(x: torch.Tensor, w: torch.Tensor) -> int:
    """The float32 scratch a call of :func:`fused_fc_epilogue` on these
    CUDA operands takes, as csrc/fc_epilogue.cu's launcher plans it: its
    tensor-core route's partial sums (x and w both float16 or both
    bfloat16, K > 0, K % 8 == 0, both 16-byte aligned: ``tc_route``), 0
    on a SIMT route."""
    if x.device.type != "cuda" or w.device != x.device:
        raise MXNetError("fc_workspace_bytes: needs x and w on one CUDA "
                         "device, got %s and %s" % (x.device, w.device))
    if x.dtype not in _FLOAT_CODES or w.dtype not in _FLOAT_CODES:
        return 0
    lib = _library("fused_fc_epilogue")
    return int(lib.mxtt_fc_workspace_bytes(
        x.data_ptr(), w.data_ptr(), int(x.shape[0]), int(w.shape[0]),
        int(x.shape[1]), _FLOAT_CODES[x.dtype], _FLOAT_CODES[w.dtype]))


def _searched_fc(n, k, act_type, int8, dtype, device, tiles):
    """The kernel search's persisted ``block_n`` for this call's shape
    class on this device, or None; only under ``MXNET_KERNEL_SEARCH=1``
    and load-only.  A winner that is not a compiled instance for the
    call's dtypes counts as no winner."""
    if not get_env("MXNET_KERNEL_SEARCH", False, bool):
        return None
    from ..autotune import kernelsearch as ks
    win = ks.best_config(ks.fc_class(n, k, act_type, int8, dtype),
                         device=device)
    bn = None if win is None else win.get("block_n")
    return int(bn) if bn in tiles else None


def fc_tile(x: torch.Tensor, w: torch.Tensor, act_type: str, int8: bool,
            block_n: Optional[int] = None) -> int:
    """The ``block_n`` a call runs: an explicit argument wins, then the
    searched winner under ``MXNET_KERNEL_SEARCH=1``, then
    :data:`FC_DEFAULT_TILE`.  A tile that is not a compiled instance for
    the operands' dtypes raises."""
    tiles = fc_tiles_for(x.dtype, w.dtype)
    if block_n is None:
        block_n = _searched_fc(int(w.shape[0]), int(w.shape[1]), act_type,
                               int8, x.dtype, x.device, tiles) \
            or FC_DEFAULT_TILE
    if int(block_n) not in tiles:
        raise MXNetError("fused_fc_epilogue: block_n %r is not a compiled "
                         "instance for %s x %s (have %s)"
                         % (block_n, x.dtype, w.dtype, tiles))
    return int(block_n)


def fused_fc_epilogue(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], act_type: str,
                      out_scale: Optional[float] = None,
                      block_n: Optional[int] = None) -> torch.Tensor:
    """``act(x · wᵀ + b)`` for x (M, K), w (N, K), b (N,) or None, summed
    in float32; the result is (M, N) in x's dtype, or int8 codes
    ``clamp(rint(y * reciprocal_f32(out_scale)), ±127)`` when
    ``out_scale`` is set (see :func:`requantize`).  ``block_n``: the
    output columns a block owns, as :func:`fc_tile` resolves it; every
    tile sums each output in the same order, so the result does not
    depend on it.

    CUDA tensors launch the hand-written kernel (csrc/fc_epilogue.cu):
    x and w of one 16-bit dtype on the tensor cores where
    :func:`fc_workspace_bytes` is not 0, split over warps into that
    float32 workspace, taken from the caching allocator, and summed in a
    fixed order by a second kernel (one launch counted); every other call
    a SIMT instance.  CPU tensors take
    :func:`fused_fc_epilogue_reference`."""
    if act_type not in ACT_CODES:
        raise MXNetError("fused_fc_epilogue: unknown act_type %r (have %s)"
                         % (act_type, sorted(ACT_CODES)))
    if out_scale is not None and not float(out_scale) > 0:
        raise MXNetError("fused_fc_epilogue: out_scale must be > 0, got %r"
                         % (out_scale,))
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise MXNetError("fused_fc_epilogue: need x (M, K) and w (N, K), got "
                         "%s and %s" % (tuple(x.shape), tuple(w.shape)))
    m, k = x.shape
    n = w.shape[0]
    if b is not None and tuple(b.shape) != (n,):
        raise MXNetError("fused_fc_epilogue: bias shape %s != (%d,)"
                         % (tuple(b.shape), n))
    tensors = [x, w] + ([b] if b is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        if block_n is not None:
            fc_tile(x, w, act_type, out_scale is not None, block_n)
        return fused_fc_epilogue_reference(x, w, b, act_type, out_scale)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise MXNetError("fused_fc_epilogue: inputs must all be on one CUDA "
                         "device, got %s" % [str(t.device) for t in tensors])
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype not in _FLOAT_CODES:
            raise MXNetError("fused_fc_epilogue: %s dtype %s not in %s"
                             % (what, t.dtype, list(_FLOAT_CODES)))
        if not t.is_contiguous():
            raise MXNetError("fused_fc_epilogue: %s must be contiguous" % what)
    if m > 65535 * 8 or n > 2 ** 31 - 1:
        raise MXNetError("fused_fc_epilogue: shape (%d, %d) exceeds the "
                         "kernel's grid" % (m, n))
    tile = fc_tile(x, w, act_type, out_scale is not None, block_n)
    out = torch.empty((m, n), device=x.device,
                      dtype=torch.int8 if out_scale is not None else x.dtype)
    if m == 0 or n == 0:
        return out
    b32 = b.to(torch.float32).contiguous() if b is not None else None
    ws_bytes = fc_workspace_bytes(x, w)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device=x.device) \
        if ws_bytes else None
    lib = _library("fused_fc_epilogue")
    rc = lib.mxtt_fc_epilogue(
        x.data_ptr(), w.data_ptr(), b32.data_ptr() if b32 is not None else None,
        out.data_ptr(), m, n, k, _FLOAT_CODES[x.dtype], _FLOAT_CODES[w.dtype],
        ACT_CODES[act_type], int(out_scale is not None),
        reciprocal_f32(out_scale) if out_scale is not None else 1.0, tile,
        ws.data_ptr() if ws is not None else None, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, "fused_fc_epilogue", rc)
    _count("fused_fc_epilogue")
    return out


# ---------------------------------------------------------------------------
# paged_attention

PAGED_MAX_HEAD_DIM = 128
# logical keys per split-K partition (csrc/paged_attention.cu part_keys):
# the default, and the candidates the kernel search measures (0: one pass)
PAGED_PARTITION_KEYS = 256
PAGED_PART_KEYS = (128, 256, 512, 1024, 0)


# query rows per block of the kernel at C > 1 (csrc/paged_attention.cu kTileQ)
PAGED_TILE_Q = 16


def paged_partitions(c: int, cap: int, part_keys: Optional[int] = None) -> int:
    """The split-K partitions a ``paged_attention`` call runs for C query
    rows per slot over a page table of ``cap = B * bt`` keys.  With one
    row tile per (slot, head) (C <= 16: decode and speculative verify)
    the keys are cut into ``part_keys``-key partitions (default
    :data:`PAGED_PARTITION_KEYS`; 0 means one pass) that blocks take in
    parallel, merged by a second kernel; with two or more row tiles
    (chunked prefill) the tiles already spread the work and one pass is
    faster (on an H100, at 16 slots x 12 heads, C = 32; PERF.md).
    Depends on shapes and the partition length only, never on lengths or
    page contents, so every layout of one logical cache takes the same
    partitions."""
    if part_keys is None:
        part_keys = PAGED_PARTITION_KEYS
    if int(c) > PAGED_TILE_Q or not part_keys:
        return 1
    return max(1, -(-int(cap) // int(part_keys)))


def _searched_paged(bt, d, causal, dtype, cap, device):
    """The kernel search's persisted partition length for this call's
    class (``paged_cap_class``: the shapes and the page table's capacity
    ``cap``) on this device, or None; only under
    ``MXNET_KERNEL_SEARCH=1`` and load-only.  The class holds no C and no
    length, so a decode and a verify call of one engine, and every layout
    of one cache, take the same partitions.  A winner that is not one of
    :data:`PAGED_PART_KEYS` counts as no winner."""
    if not get_env("MXNET_KERNEL_SEARCH", False, bool):
        return None
    from ..autotune import kernelsearch as ks
    win = ks.best_config(ks.paged_cap_class(bt, d, causal, dtype, cap),
                         device=device)
    pk = None if win is None else win.get("part_keys")
    return int(pk) if pk in PAGED_PART_KEYS else None


def paged_part_keys(bt: int, d: int, causal: bool, dtype, cap: int, device,
                    part_keys: Optional[int] = None) -> int:
    """The partition length a call runs: an explicit argument wins, then
    the searched winner under ``MXNET_KERNEL_SEARCH=1``, then
    :data:`PAGED_PARTITION_KEYS`; a value not in :data:`PAGED_PART_KEYS`
    raises."""
    if part_keys is None:
        part_keys = _searched_paged(bt, d, causal, dtype, cap, device)
        if part_keys is None:
            part_keys = PAGED_PARTITION_KEYS
    if int(part_keys) not in PAGED_PART_KEYS:
        raise MXNetError("paged_attention: part_keys %r is not one of %s"
                         % (part_keys, PAGED_PART_KEYS))
    return int(part_keys)


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, pages: torch.Tensor,
                              lengths: torch.Tensor, q_pos: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_attention` (the counterpart
    of ``_paged_attention_dense``): gather each slot's blocks through the
    clamped page table into logical order, one masked softmax over the
    whole (S, B * bt) context, in float32.  The gather makes the result
    bitwise independent of where the blocks lie in the pool."""
    n, bt = k_pool.shape[0], k_pool.shape[1]
    s_, c, h, d = q.shape
    b = pages.shape[1]
    scale = 1.0 / math.sqrt(d)
    safe = pages.long().clamp(0, n - 1)
    kg = k_pool[safe].reshape(s_, b * bt, h, d).float()
    vg = v_pool[safe].reshape(s_, b * bt, h, d).float()
    s = torch.einsum("schd,skhd->shck", q.float(), kg) * scale
    k_idx = torch.arange(b * bt, dtype=torch.int64, device=q.device)
    mask = (k_idx[None, :] < lengths.long()[:, None])[:, None, None, :]
    if causal:
        mask = mask & (k_idx[None, None, :]
                       <= q_pos.long()[:, :, None])[:, None, :, :]
    s = torch.where(mask, s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(torch.isinf(s), 0.0, torch.exp(s - m_safe))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("shck,skhd->schd", p / l, vg)
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, pages: torch.Tensor,
                    lengths: torch.Tensor,
                    q_pos: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    part_keys: Optional[int] = None) -> torch.Tensor:
    """Attention through a paged KV cache.  q (S, C, H, D) is a window of
    C queries per slot; k_pool / v_pool (N, bt, H, D) are the block pools
    (a sentinel scratch block may sit at N - 1: page entries clamp to
    it, and its keys lie past ``lengths``); pages (S, B) holds each
    slot's physical block per logical block; lengths (S,) the valid
    context per slot; q_pos (S, C) each query's position (default: the
    last C positions).  Returns (S, C, H, D) in q's dtype.

    CUDA tensors launch the hand-written kernel (csrc/paged_attention.cu,
    q and pools in float32, float16 or bfloat16: a q of another dtype
    than the pools is upcast to float32 and read over the pools as they
    are, pools of two dtypes are both upcast to float32; int32 indices,
    D <= 128; split-K as :func:`paged_partitions` says for the partition
    length :func:`paged_part_keys` resolves under the pools' dtype, one
    launch counted per call); CPU tensors take
    :func:`paged_attention_reference`."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[2:] != q.shape[2:]:
        raise MXNetError("paged_attention: need q (S, C, H, D) and pools "
                         "(N, bt, H, D), got %s, %s, %s" % (
                             tuple(q.shape), tuple(k_pool.shape),
                             tuple(v_pool.shape)))
    s_, c, h, d = q.shape
    if pages.dim() != 2 or pages.shape[0] != s_ \
            or tuple(lengths.shape) != (s_,):
        raise MXNetError("paged_attention: need pages (%d, B) and lengths "
                         "(%d,), got %s and %s" % (s_, s_, tuple(pages.shape),
                                                   tuple(lengths.shape)))
    if q_pos is None:                  # the last c positions of each slot
        q_pos = (lengths.to(torch.int32)[:, None] - c + torch.arange(
            c, dtype=torch.int32, device=lengths.device)[None])
    if tuple(q_pos.shape) != (s_, c):
        raise MXNetError("paged_attention: q_pos shape %s != (%d, %d)"
                         % (tuple(q_pos.shape), s_, c))
    tensors = (q, k_pool, v_pool, pages, lengths, q_pos)
    if all(t.device.type == "cpu" for t in tensors):
        if part_keys is not None:
            paged_part_keys(k_pool.shape[1], d, causal, q.dtype,
                            pages.shape[1] * k_pool.shape[1], q.device,
                            part_keys)
        return paged_attention_reference(q, k_pool, v_pool, pages, lengths,
                                         q_pos, causal)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise MXNetError("paged_attention: inputs must all be on one CUDA "
                         "device, got %s" % [str(t.device) for t in tensors])
    (qk,), _ = _float_operands("paged_attention", ((q, "q"),))
    (kk, vk), _ = _float_operands(
        "paged_attention", ((k_pool, "k_pool"), (v_pool, "v_pool")))
    if qk.dtype != kk.dtype:           # q (small) upcast, never the pools
        qk = qk.float()
    for t, what in ((pages, "pages"), (lengths, "lengths"), (q_pos, "q_pos")):
        if t.dtype != torch.int32:
            raise MXNetError("paged_attention: %s dtype %s, the kernel "
                             "takes torch.int32" % (what, t.dtype))
        if not t.is_contiguous():
            raise MXNetError("paged_attention: %s must be contiguous" % what)
    if d > PAGED_MAX_HEAD_DIM:
        raise MXNetError("paged_attention: head dim %d > %d" % (
            d, PAGED_MAX_HEAD_DIM))
    if q.numel() == 0:
        return torch.empty_like(q)
    if k_pool.shape[0] == 0 or pages.shape[1] == 0:
        raise MXNetError("paged_attention: empty pool or page table")
    pk = paged_part_keys(k_pool.shape[1], d, causal, kk.dtype,
                         pages.shape[1] * k_pool.shape[1], q.device,
                         part_keys)
    out = _launch_paged(qk, kk, vk, pages, lengths, q_pos, causal,
                        paged_partitions(c, pages.shape[1] * k_pool.shape[1],
                                         pk), pk or PAGED_PARTITION_KEYS)
    return out.to(q.dtype)


def _launch_paged(q, k_pool, v_pool, pages, lengths, q_pos, causal,
                  n_part: int,
                  part_keys: int = PAGED_PARTITION_KEYS) -> torch.Tensor:
    """The kernel on checked CUDA tensors, q of the pools' dtype or
    float32, with ``n_part`` partitions of ``part_keys`` keys (1: one pass writes
    the output; more: partials into scratch, then the merge kernel),
    counted once."""
    s_, c, h, d = q.shape
    n, bt = k_pool.shape[0], k_pool.shape[1]
    b = pages.shape[1]
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if n_part > 1:
        part_ml = torch.empty((s_ * c * h, n_part, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((s_ * c * h, n_part, d), dtype=torch.float32,
                               device=q.device)
    lib = _library("paged_attention")
    rc = lib.mxtt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
        lengths.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        part_ml.data_ptr() if part_ml is not None else None,
        part_acc.data_ptr() if part_acc is not None else None, s_, c, h, d,
        n, bt, b, int(bool(causal)), 1.0 / math.sqrt(d),
        _FLOAT_CODES[k_pool.dtype], _FLOAT_CODES[q.dtype], int(part_keys),
        int(n_part), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, "paged_attention", rc)
    _count("paged_attention")
    return out


# ---------------------------------------------------------------------------
# flash_attention

# the kernel's compiled tile instances (csrc/flash_attention.cu FLASH_TILE),
# each for D <= 32, <= 64 and <= 128 and each dtype: block_q rows, 16 per
# warp, and a ring of block_k-key stages of K and V: in float32 two plus
# the TF32 remainders of one, 198 KB of shared memory at (block_k 64, D
# 128); in float16 and bfloat16 three, 102 KB there
FLASH_BLOCK_Q = (64, 128)
FLASH_BLOCK_K = (32, 64)
FLASH_TILES = tuple((bq, bk) for bq in FLASH_BLOCK_Q for bk in FLASH_BLOCK_K)
FLASH_DEFAULT_TILE = (64, 32)       # the best tile at the search shape
FLASH_MAX_HEAD_DIM = 128


def clamp_tile(block: int, t: int, sizes) -> int:
    """``block`` cut to the smallest compiled size that covers ``t``
    tokens: a larger tile holds the same one tile of work."""
    cover = next((s for s in sizes if s >= t), sizes[-1])
    return min(int(block), cover)


def _searched_flash(t, d, causal, dtype, device):
    """The kernel search's persisted winner for this call's shape class
    on this device, or None.  Consulted only under
    ``MXNET_KERNEL_SEARCH=1`` and load-only (never a search on the call
    path); see ``autotune.kernelsearch.best_config``.  A winner that is no
    longer a compiled tile (a store written for an older tile set) counts
    as no winner; the next ``search_flash`` of its class overwrites it."""
    if not get_env("MXNET_KERNEL_SEARCH", False, bool):
        return None
    from ..autotune import kernelsearch as ks
    win = ks.best_config(ks.flash_class(t, d, causal, dtype), device=device)
    if win is None or (win.get("block_q"), win.get("block_k")) \
            not in FLASH_TILES:
        return None
    return win


def flash_tiles(t: int, d: int, causal: bool, dtype, device,
                block_q: Optional[int] = None,
                block_k: Optional[int] = None):
    """The (block_q, block_k) a call runs: an explicit argument wins, then
    the searched winner under ``MXNET_KERNEL_SEARCH=1``, then
    :data:`FLASH_DEFAULT_TILE`; each cut to the sequence length
    (:func:`clamp_tile`).  A tile that is not a compiled instance raises."""
    if block_q is None or block_k is None:
        win = _searched_flash(t, d, causal, dtype, device) or {}
        block_q = int(win.get("block_q", FLASH_DEFAULT_TILE[0])) \
            if block_q is None else block_q
        block_k = int(win.get("block_k", FLASH_DEFAULT_TILE[1])) \
            if block_k is None else block_k
    if block_q not in FLASH_BLOCK_Q or block_k not in FLASH_BLOCK_K:
        raise MXNetError("flash_attention: tile (%s, %s) is not a compiled "
                         "instance (block_q in %s, block_k in %s)"
                         % (block_q, block_k, FLASH_BLOCK_Q, FLASH_BLOCK_K))
    return clamp_tile(block_q, t, FLASH_BLOCK_Q), \
        clamp_tile(block_k, t, FLASH_BLOCK_K)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`:
    ``parallel.ring.attention_reference`` in float32, one softmax over
    the whole (T, T) score matrix, cast back to q's dtype."""
    from ..parallel.ring import attention_reference
    return attention_reference(q.float(), k.float(), v.float(),
                               causal=causal).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention, q, k, v (B, T, H, D) -> (B, T, H, D), scale
    1/sqrt(D), causal optional.  The tile resolves as :func:`flash_tiles`
    says.

    CUDA tensors launch the hand-written kernel (csrc/flash_attention.cu,
    float32, float16 or bfloat16, mixed dtypes upcast to float32,
    contiguous, D <= 128; the output in q's dtype); CPU tensors take
    :func:`flash_attention_reference`."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError("flash_attention: need q, k, v of one shape (B, T, "
                         "H, D), got %s, %s, %s" % (tuple(q.shape),
                                                    tuple(k.shape),
                                                    tuple(v.shape)))
    b, t, h, d = q.shape
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        flash_tiles(t, d, causal, q.dtype, q.device, block_q, block_k)
        return flash_attention_reference(q, k, v, causal)
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise MXNetError("flash_attention: inputs must all be on one CUDA "
                         "device, got %s" % [str(x.device) for x in tensors])
    (qk, kk, vk), code = _float_operands(
        "flash_attention", ((q, "q"), (k, "k"), (v, "v")))
    # the tile of the instance that runs: mixed dtypes run float32's
    bq, bk = flash_tiles(t, d, causal, qk.dtype, q.device, block_q, block_k)
    if d > FLASH_MAX_HEAD_DIM:
        raise MXNetError("flash_attention: head dim %d > %d"
                         % (d, FLASH_MAX_HEAD_DIM))
    out = torch.empty_like(qk)
    if out.numel() == 0:
        return out.to(q.dtype)
    lib = _library("flash_attention")
    rc = lib.mxtt_flash_attention(
        qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), out.data_ptr(), b, t, h,
        d, int(bool(causal)), 1.0 / math.sqrt(d), bq, bk, code,
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    _check(lib, "flash_attention", rc)
    _count("flash_attention")
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# correlation


def correlation_geometry(max_displacement: int, stride2: int):
    """(ng, D2) of a displacement window: ng = m // stride2 steps each
    way, D2 = 2 * ng + 1 per axis."""
    ng = int(max_displacement) // int(stride2)
    return ng, 2 * ng + 1


def correlation_reference(a: torch.Tensor, b: torch.Tensor,
                          max_displacement: int, stride2: int = 1,
                          is_multiply: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`correlation`: b zero-padded by m,
    then for each displacement (row-major over (dy, dx)) the product (or
    absolute difference) with a, summed over channels and divided by C,
    in float32."""
    n, c, h, w = a.shape
    m = int(max_displacement)
    ng, d2 = correlation_geometry(m, stride2)
    af = a.float()
    bp = torch.nn.functional.pad(b.float(), (m, m, m, m))
    outs = []
    for i in range(d2):
        oy = m + (i - ng) * stride2
        for j in range(d2):
            ox = m + (j - ng) * stride2
            tile = bp[:, :, oy:oy + h, ox:ox + w]
            val = af * tile if is_multiply else (af - tile).abs()
            outs.append(val.sum(dim=1) / c)
    return torch.stack(outs, dim=1).to(a.dtype)


def correlation(a: torch.Tensor, b: torch.Tensor, max_displacement: int,
                stride2: int = 1, is_multiply: bool = True) -> torch.Tensor:
    """FlowNet correlation for kernel_size 1, stride1 1, pad = m:
    a, b (N, C, H, W) -> (N, D2 * D2, H, W), D2 = 2 * (m // stride2) + 1,
    ``out[n, i * D2 + j, y, x] = sum_c a[n, c, y, x] * b[n, c, y + dy_i,
    x + dx_j] / C`` with dy_i = (i - ng) * stride2 (likewise dx_j) and b
    zero outside the image; ``|a - b|`` when ``is_multiply`` is False.

    CUDA tensors launch the hand-written kernel (csrc/correlation.cu,
    float32, float16 or bfloat16, mixed dtypes upcast to float32,
    contiguous, any D2; 16-bit products on the tensor cores; the output
    in a's dtype); CPU tensors take :func:`correlation_reference`."""
    if a.dim() != 4 or b.shape != a.shape:
        raise MXNetError("correlation: need a and b of one shape (N, C, H, "
                         "W), got %s and %s" % (tuple(a.shape),
                                                tuple(b.shape)))
    if int(max_displacement) < 0 or int(stride2) < 1:
        raise MXNetError("correlation: need max_displacement >= 0 and "
                         "stride2 >= 1, got %r, %r" % (max_displacement,
                                                       stride2))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return correlation_reference(a, b, max_displacement, stride2,
                                     is_multiply)
    if b.device != a.device or a.device.type != "cuda":
        raise MXNetError("correlation: inputs must both be on one CUDA "
                         "device, got %s and %s" % (a.device, b.device))
    (ak, bk), code = _float_operands("correlation", ((a, "a"), (b, "b")))
    n, c, h, w = a.shape
    _ng, d2 = correlation_geometry(max_displacement, stride2)
    out = torch.empty((n, d2 * d2, h, w), dtype=ak.dtype, device=a.device)
    if out.numel() == 0:
        return out.to(a.dtype)
    if c == 0:
        raise MXNetError("correlation: zero channels")
    lib = _library("correlation")
    rc = lib.mxtt_correlation(
        ak.data_ptr(), bk.data_ptr(), out.data_ptr(), n, c, h, w,
        int(max_displacement), int(stride2), int(bool(is_multiply)), code,
        a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream)
    _check(lib, "correlation", rc)
    _count("correlation")
    return out.to(a.dtype)
