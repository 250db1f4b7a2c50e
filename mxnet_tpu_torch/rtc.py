"""Runtime kernels from Python: users' CUDA source, compiled with nvcc.

The counterpart of ``mxnet_tpu/rtc.py``.  The JAX package takes Pallas
or jnp callables; the port takes CUDA source, as the original
``rtc.py`` + ``mxrtc.cc`` did (NVRTC there, ``nvcc`` here).

``Rtc(name, inputs, outputs, kernel)``: ``kernel`` is a string, the body
of a ``__global__`` function.  The wrapper generates the signature from
the names given, ``extern "C" __global__ void <name>(const float* <in>,
..., float* <out>, ...)`` (other dtypes get their C type), and bakes
each array's ``<name>_ndim`` and ``<name>_dims[]`` into the body as
constants from the prototypes, as ``mxrtc.cc``'s decorate step did.  A
callable ``kernel`` runs as a function of tensors instead (the reference's
jnp-function path).

``pallas_call(kernel, out_shape, grid=, block=)`` keeps its name: it
takes a whole CUDA source holding one ``__global__`` function and
returns a function of tensors that allocates ``out_shape`` and launches.

Each source becomes a small library: the kernel plus a generated
``extern "C"`` launcher taking the argument pointers, the grid, the
block and the stream (``cudaLaunchKernel``), then ``cudaGetLastError``.
It is built with the port's own nvcc line (``ops.cuda_kernels.
nvcc_command``, ``sm_90a``), keyed by the digest of the generated source
into ``mxnet_tpu_torch/_build`` or, with ``MXNET_COMPILE_CACHE`` set,
the persistent store, and loaded with ``ctypes``.  A second kernel of the
same source runs ``nvcc`` 0 times (:data:`NVCC_RUNS`).  Launches count
in :data:`LAUNCHES` by kernel name.  A build failure raises with nvcc's
log, a launch failure with CUDA's error string; a CUDA-source kernel
given CPU tensors raises: there is no plain version of a user's CUDA.
Triton user kernels are not carried.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError, get_env, make_lock
from .ndarray import NDArray

__all__ = ["Rtc", "pallas_call", "HAS_PALLAS", "LAUNCHES", "NVCC_RUNS",
           "reset_launches", "nvcc_command", "decorate"]


def _find_nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = get_env("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else None


# whether users' CUDA kernels can be built here (nvcc was found); the
# name is the JAX package's
HAS_PALLAS = _find_nvcc() is not None

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {}
# nvcc invocations this process made for users' kernels
NVCC_RUNS = 0
# digest -> the loaded library
_libs: Dict[str, ctypes.CDLL] = {}
_lock = make_lock("rtc.build")
_launch_lock = make_lock("rtc.launches")

_C_TYPES = {"float32": "float", "float64": "double", "float16": "__half",
            "bfloat16": "__nv_bfloat16", "int32": "int", "int64": "long long",
            "int8": "signed char", "uint8": "unsigned char",
            "int16": "short", "bool": "bool"}


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def nvcc_command(source: str, output: str, nvcc: str = "nvcc") -> list:
    """The compile line of a user's kernel: the port's kernel line
    (``sm_90a``, a shared library with a plain C interface)."""
    from .ops.cuda_kernels import nvcc_command as kernel_line
    return kernel_line(source, output, nvcc)


def _c_type(dtype) -> str:
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _C_TYPES:
        raise MXNetError("rtc: no C type for dtype %r" % (name,))
    return _C_TYPES[name]


def decorate(name: str, inputs, outputs, kernel: str) -> str:
    """The ``__global__`` function ``mxrtc.cc``'s decorate step made of a
    body: the signature from the names and dtypes, then each array's
    ``_ndim`` and ``_dims[]`` from its prototype shape, then the body.
    ``inputs``/``outputs`` are ``[(name, shape, dtype)]``."""
    params = ["const %s* %s" % (_c_type(d), n) for n, _s, d in inputs]
    params += ["%s* %s" % (_c_type(d), n) for n, _s, d in outputs]
    src = '\nextern "C" __global__ void %s(%s) {\n' % (name, ", ".join(params))
    for n, shape, _d in list(inputs) + list(outputs):
        src += "const int %s_ndim = %d;\n" % (n, len(shape))
        src += "const int %s_dims[] = {%s};\n" % (
            n, ", ".join(str(int(x)) for x in shape) or "1")
    return src + kernel + "\n}\n"


_GLOBAL_RE = re.compile(
    r'(?:extern\s+"C"\s+)?__global__\s+void\s+'
    r'(?:__launch_bounds__\s*\([^)]*\)\s+)?([A-Za-z_]\w*)\s*\(')

_PRELUDE = ("#include <cuda_runtime.h>\n#include <cuda_fp16.h>\n"
            "#include <cuda_bf16.h>\n")


def _library_source(kernel_source: str, fn: str) -> str:
    """The kernel's source with the generated C launcher after it."""
    return (_PRELUDE + kernel_source + """
extern "C" int mxtt_rtc_launch(void** args, unsigned gx, unsigned gy,
                               unsigned gz, unsigned bx, unsigned by,
                               unsigned bz, void* stream) {
  cudaError_t rc = cudaLaunchKernel((const void*)%s, dim3(gx, gy, gz),
                                    dim3(bx, by, bz), args, 0,
                                    (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_rtc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
""" % fn)


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(nvcc_command("", "")).encode())
    h.update(source.encode())
    return h.hexdigest()


def _build(name: str, source: str) -> ctypes.CDLL:
    """Load the library of ``source`` (the generated text with its
    launcher), running nvcc only when neither this process, the build
    directory nor the compile cache has it."""
    global NVCC_RUNS
    from .compile_cache import get_cache, get_stats
    from .ops.cuda_kernels import BUILD_DIR
    digest = _digest(source)
    with _lock:
        lib = _libs.get(digest)
        if lib is not None:
            return lib
        cache = get_cache()
        key = cache.library_key(digest) if cache is not None else None
        path = cache.load_library("rtc:" + name, key) \
            if cache is not None else None
        if path is None:
            local = os.path.join(BUILD_DIR, "librtc_%s_%s.so"
                                 % (name, digest[:16]))
            if cache is None and os.path.exists(local):
                path = local
        if path is None:
            nvcc = _find_nvcc()
            if nvcc is None:
                raise MXNetError("rtc: nvcc not found (looked on PATH and "
                                 "in $CUDA_HOME/bin); users' CUDA kernels "
                                 "are built at first launch")
            os.makedirs(BUILD_DIR, exist_ok=True)
            work = tempfile.mkdtemp(prefix="mxtt-rtc-")
            try:
                cu = os.path.join(work, "%s.cu" % name)
                with open(cu, "w") as f:
                    f.write(source)
                out = os.path.join(work, "lib%s.so" % name)
                t0 = time.perf_counter()
                NVCC_RUNS += 1
                # lint: allow(raw-pallas-call) — the rtc API surface IS
                # the user-kernel passthrough: users' kernels are one-offs
                # built from their own source; they cannot ride the
                # searched, parity-checked ops/cuda_kernels module
                proc = subprocess.run(nvcc_command(cu, out, nvcc),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise MXNetError("rtc: nvcc failed to build %r (exit "
                                     "%d):\n%s" % (name, proc.returncode,
                                                   proc.stdout))
                get_stats().note_build("rtc:" + name,
                                       time.perf_counter() - t0)
                if cache is not None and \
                        cache.store_library("rtc:" + name, key, out) > 0:
                    path = cache.store.blob_path(key)
                else:
                    shutil.move(out, local)
                    path = local
            finally:
                shutil.rmtree(work, ignore_errors=True)
        try:
            # lint: allow(raw-pallas-call) — loads the user's kernel
            # library just built (or stored) from its own source
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise MXNetError("rtc: cannot load %r's library %s: %s"
                             % (name, path, e))
        p, u = ctypes.c_void_p, ctypes.c_uint
        lib.mxtt_rtc_launch.argtypes = [ctypes.POINTER(p)] + [u] * 6 + [p]
        lib.mxtt_rtc_launch.restype = ctypes.c_int
        lib.mxtt_rtc_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_rtc_error_string.restype = ctypes.c_char_p
        _libs[digest] = lib
        return lib


def _dims3(d) -> Tuple[int, int, int]:
    d = tuple(int(x) for x in (d or (1,)))
    if not 1 <= len(d) <= 3 or min(d) < 1:
        raise MXNetError("rtc: grid/block dims must be 1 to 3 positive "
                         "ints, got %r" % (d,))
    return d + (1,) * (3 - len(d))


def _require_cuda(name: str, tensors: List[torch.Tensor]) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise MXNetError(
            "rtc: kernel %r is CUDA source and needs every array on one "
            "CUDA device (got %s); a user's kernel has no plain version "
            "to run elsewhere" % (name, sorted({str(t.device)
                                               for t in tensors})))
    for t in tensors:
        if not t.is_contiguous():
            raise MXNetError("rtc: kernel %r needs contiguous arrays" % name)


def _launch(name: str, lib: ctypes.CDLL, tensors: List[torch.Tensor],
            grid, block) -> None:
    dev = tensors[0].device
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    args = (ctypes.c_void_p * len(ptrs))(
        *[ctypes.cast(ctypes.pointer(x), ctypes.c_void_p) for x in ptrs])
    g, b = _dims3(grid), _dims3(block)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mxtt_rtc_launch(args, *g, *b, ctypes.c_void_p(stream))
    if rc != 0:
        raise MXNetError("rtc: launch of %r failed: CUDA error %d (%s)"
                         % (name, rc, lib.mxtt_rtc_error_string(rc).decode()))
    _count(name)


class Rtc:
    """A user's device kernel (reference rtc.py:9-61).

    Parameters
    ----------
    name : str
        the kernel's name (its ``__global__`` function's).
    inputs : list of (name, NDArray)
        prototype inputs fixing shapes and dtypes.
    outputs : list of (name, NDArray)
        prototype outputs fixing shapes and dtypes.
    kernel : str or callable
        the body of the ``__global__`` function (CUDA source), or a
        function ``kernel(*inputs) -> outputs`` of tensors.
    """

    def __init__(self, name: str, inputs, outputs, kernel,
                 use_pallas: bool = False):
        self.name = name
        self._in_proto = [(n, tuple(a.shape), np.dtype(a.dtype))
                          for n, a in inputs]
        self._out_proto = [(n, tuple(a.shape), np.dtype(a.dtype))
                           for n, a in outputs]
        self._use_pallas = use_pallas
        if callable(kernel):
            if use_pallas:
                raise MXNetError("rtc: Pallas kernels are not carried; "
                                 "pass the kernel body as CUDA source")
            self._fn = kernel
            self.source = None
        elif isinstance(kernel, str):
            self._fn = None
            self.source = decorate(name, self._in_proto, self._out_proto,
                                   kernel)
        else:
            raise MXNetError("rtc: kernel must be CUDA source (str) or a "
                             "callable, got %s" % type(kernel).__name__)

    def _check(self, arrays, proto, what: str) -> None:
        if len(arrays) != len(proto):
            raise MXNetError("rtc %s: %d %s given, the prototype has %d"
                             % (self.name, len(arrays), what, len(proto)))
        for a, (n, shape, dtype) in zip(arrays, proto):
            if tuple(a.shape) != shape or np.dtype(a.dtype) != dtype:
                raise MXNetError(
                    "rtc %s: %s %r is %s %s, the prototype %s %s"
                    % (self.name, what[:-1], n, tuple(a.shape),
                       np.dtype(a.dtype), shape, dtype))

    def push(self, ins: Sequence[NDArray], outs: Sequence[NDArray],
             grid_dims: Tuple[int, ...] = None,
             block_dims: Tuple[int, ...] = None):
        """Run the kernel (reference rtc.py push).  A CUDA-source kernel
        launches with the grid and block given; a callable ignores
        them."""
        if self._fn is not None:
            res = self._fn(*[a._get() for a in ins])
            if not isinstance(res, (tuple, list)):
                res = [res]
            if len(res) != len(outs):
                raise MXNetError("kernel produced %d outputs, expected %d"
                                 % (len(res), len(outs)))
            for o, r in zip(outs, res):
                o[:] = r
            return
        self._check(ins, self._in_proto, "inputs")
        self._check(outs, self._out_proto, "outputs")
        tensors = [a._get() for a in ins] + [o._get() for o in outs]
        _require_cuda(self.name, tensors)
        lib = _build(self.name, _library_source(self.source, self.name))
        _launch(self.name, lib, tensors, grid_dims or (1,),
                block_dims or (1,))


def _out_specs(out_shape) -> Tuple[List[Tuple[tuple, torch.dtype]], bool]:
    """``out_shape`` as ``[(shape, torch dtype)]`` and whether it was one
    spec: a ``(shape, dtype)`` pair, anything with ``.shape`` and
    ``.dtype`` (a tensor or an NDArray), or a list of those."""
    from .ndarray import torch_dtype

    def one(s):
        if hasattr(s, "shape") and hasattr(s, "dtype"):
            return tuple(s.shape), torch_dtype(s.dtype)
        shape, dtype = s
        return tuple(int(x) for x in shape), torch_dtype(dtype)
    if hasattr(out_shape, "shape") or (
            isinstance(out_shape, tuple) and len(out_shape) == 2
            and isinstance(out_shape[0], (tuple, list))
            and not isinstance(out_shape[1], (tuple, list))):
        return [one(out_shape)], True
    return [one(s) for s in out_shape], False


def pallas_call(kernel: str, out_shape, grid=(1,), block=(1,),
                **kwargs) -> Callable:
    """A whole CUDA source holding one ``__global__`` function ->
    ``fn(*tensors)`` that allocates ``out_shape`` on the inputs' device,
    launches the kernel with the inputs' then the outputs' pointers as
    its arguments, and returns the output(s)."""
    if kwargs:
        raise MXNetError("rtc.pallas_call: unsupported arguments %s (takes "
                         "grid= and block=)" % sorted(kwargs))
    if not isinstance(kernel, str):
        raise MXNetError("rtc.pallas_call takes CUDA source; Pallas kernels "
                         "are not carried")
    names = _GLOBAL_RE.findall(kernel)
    if len(names) != 1:
        raise MXNetError("rtc.pallas_call: the source must hold exactly one "
                         "__global__ function, found %d" % len(names))
    fn_name = names[0]
    specs, single = _out_specs(out_shape)
    source = _library_source(kernel, fn_name)

    def call(*tensors):
        tensors = [t._get() if isinstance(t, NDArray) else t
                   for t in tensors]
        if not tensors:
            raise MXNetError("rtc.pallas_call: no input arrays")
        dev = tensors[0].device
        tensors = [t.contiguous() for t in tensors]
        outs = [torch.empty(s, dtype=d, device=dev) for s, d in specs]
        _require_cuda(fn_name, tensors + outs)
        lib = _build(fn_name, source)
        _launch(fn_name, lib, tensors + outs, grid, block)
        return outs[0] if single else outs
    return call
