"""Cache keying: what makes two builds interchangeable (counterpart of
``mxnet_tpu/compile_cache/fingerprint.py``).

What the port persists across processes are the hand-written kernels'
libraries (``ops/cuda_kernels.py``).  A library built by ``nvcc`` may be
loaded by another process only when everything that went into it is
identical; its key is a sha256 over:

* the library's digest (``cuda_kernels._lib_path``): its compile line,
  its source and every header it includes;
* :func:`environment_fingerprint`: the torch version, the CUDA runtime
  version, the device's name and compute capability, the ``nvcc
  --version`` line and the kernels' compile line.

Anything that does not match hashes to another key, which reads as a
clean miss: the failure mode is always "build again", never "load the
wrong library".  The ``MXNET_*`` knobs that steer how the in-process
programs (the fused step's graphs, an executor's walk) are built join
their descriptions (:func:`fast_key`), not the libraries' keys: a knob
changes no kernel binary.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Iterable, Optional

# MXNET knobs that steer how the in-process programs are built
COMPILE_RELEVANT_ENV = (
    "MXNET_BACKWARD_DO_MIRROR",
    "MXNET_EMBED_SPARSE",
    "MXNET_FUSED_TRAIN",
    "MXNET_KERNEL_SEARCH",
    "MXNET_SHARD_WEIGHT_UPDATE",
    "MXNET_SUPERSTEP",
)

_env_fp_cache: Optional[str] = None
_nvcc_line: Optional[str] = None


def nvcc_version_line() -> str:
    """The last line of ``nvcc --version`` (its release and build), or
    ``"absent"`` where there is no nvcc (a CPU-only host)."""
    global _nvcc_line
    if _nvcc_line is not None:
        return _nvcc_line
    from ..ops import cuda_kernels as ck
    try:
        out = subprocess.run([ck._nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        _nvcc_line = lines[-1] if lines else "unknown"
    except Exception:
        _nvcc_line = "absent"
    return _nvcc_line


def environment_fingerprint(refresh: bool = False) -> str:
    """One string describing everything key-relevant outside a library's
    own digest: versions, the device, the toolchain and the compile line.
    Computed once per process (``refresh=True`` recomputes it, for tests
    that change the environment)."""
    global _env_fp_cache, _nvcc_line
    if _env_fp_cache is not None and not refresh:
        return _env_fp_cache
    import torch
    from ..ops import cuda_kernels as ck
    if refresh:
        _nvcc_line = None
    parts = ["torch=%s" % torch.__version__,
             "cuda=%s" % torch.version.cuda]
    if torch.cuda.is_available():
        idx = torch.cuda.current_device()
        parts += ["device=%s" % torch.cuda.get_device_name(idx),
                  "capability=%d.%d" % torch.cuda.get_device_capability(idx)]
    else:
        parts.append("device=cpu")
    parts += ["nvcc=%s" % nvcc_version_line(),
              "compile=%s" % " ".join(ck.nvcc_command("", ""))]
    _env_fp_cache = ";".join(parts)
    return _env_fp_cache


def knob_fingerprint() -> str:
    """The ``MXNET_*`` knobs that steer program construction, raw values
    (unset and empty alike)."""
    return ";".join("%s=%s" % (n, os.environ.get(n, ""))
                    for n in COMPILE_RELEVANT_ENV)


_code_fp_cache: Optional[str] = None


def code_fingerprint(refresh: bool = False) -> str:
    """Hash over every python file and kernel source of the package
    (path, size, mtime): the staleness guard of the fast-key index.  A
    fast key describes a program by what built it, which is sound only
    while the building code is unchanged."""
    global _code_fp_cache
    if _code_fp_cache is not None and not refresh:
        return _code_fp_cache
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            h.update(("%s:%d:%d;" % (os.path.relpath(p, root), st.st_size,
                                     st.st_mtime_ns)).encode())
    _code_fp_cache = h.hexdigest()
    return _code_fp_cache


def fast_key(description: str, signature: str,
             env_fp: Optional[str] = None,
             code_fp: Optional[str] = None) -> str:
    """Key of one program by what built it: the caller's description
    (symbol json digest, dtypes, optimizer values), the input signature,
    the environment, the knobs and the code fingerprint."""
    h = hashlib.sha256()
    for part in ((env_fp if env_fp is not None
                  else environment_fingerprint()), knob_fingerprint(),
                 (code_fp if code_fp is not None else code_fingerprint()),
                 description, signature):
        h.update(part.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


def program_key(text: str, extras: Iterable[str] = (),
                env_fp: Optional[str] = None) -> str:
    """Key of one build (a library's digest, ``text``) under the current
    environment."""
    h = hashlib.sha256()
    h.update((env_fp if env_fp is not None
              else environment_fingerprint()).encode("utf-8"))
    h.update(b"\x00")
    for e in extras:
        h.update(str(e).encode("utf-8"))
        h.update(b"\x00")
    h.update(text.encode("utf-8"))
    return h.hexdigest()


def blob_digest(blob: bytes) -> str:
    """Content checksum kept in the sidecar: a truncated or bit-flipped
    blob is caught before it is loaded."""
    return hashlib.sha256(blob).hexdigest()
