"""Library discovery (counterpart of ``mxnet_tpu/libinfo.py``): where the
port's native objects are.  Those are the hand-written kernels, built
from ``csrc/*.cu`` into ``mxnet_tpu_torch/_build/`` at first use on the
card, and the native layer (:mod:`native_build`: the host and I/O
libraries, ``im2rec``, the C ABI and predict-only libraries), built with
``g++`` from ``csrc/native`` and ``csrc/capi`` into
``mxnet_tpu_torch/_build/native/`` at first use."""
from __future__ import annotations

import os

__all__ = ["find_lib_path", "__version__"]

# the JAX package's names for its native objects -> the port's objects
# (its one libmxtpu.so is the port's host and I/O libraries)
JAX_NAMES = {"libmxtpu.so": ("host", "io"),
             "libmxtpu_capi.so": ("capi",),
             "libmxtpu_predict.so": ("predict",),
             "im2rec": ("im2rec",)}


def _native_objects(name):
    """The native objects ``name`` stands for (a JAX package name, one of
    the port's file names, or an object key), or None."""
    from . import native_build as nb
    if name in JAX_NAMES:
        return JAX_NAMES[name]
    for key, (fname, _, _, _) in nb.OBJECTS.items():
        if name in (key, fname):
            return (key,)
    return None


def find_lib_path(name=None):
    """Paths of the built kernel libraries: the one for kernel ``name``
    (a key of ``ops.cuda_kernels.SOURCES``), or every built one; or the
    paths of the native objects ``name`` names — by the JAX package's
    names (``libmxtpu.so``, ``libmxtpu_capi.so``, ``libmxtpu_predict.so``,
    ``im2rec``) or the port's own — built first where needed.  Raises
    when no kernel library is built yet (``ops.cuda_kernels.build()``
    builds them on a machine with ``nvcc``), or for an unknown name."""
    from .ops import cuda_kernels as ck
    if name is not None and name not in ck.SOURCES:
        objs = _native_objects(name)
        if objs is None:
            raise RuntimeError("unknown library %r (kernels %s, native "
                               "objects %s)" % (name, sorted(ck.SOURCES),
                                                sorted(JAX_NAMES)))
        from . import native_build as nb
        return [nb.path(o) for o in objs]
    names = list(ck.SOURCES) if name is None else [name]
    candidates = [ck._lib_path(n) for n in names]
    paths = [p for p in candidates if os.path.isfile(p)]
    if not paths:
        raise RuntimeError(
            "Cannot find the kernel library for %s: build it with "
            "mxnet_tpu_torch.ops.cuda_kernels.build() where nvcc is "
            "installed. Searched:\n%s"
            % (name or "any kernel", "\n".join(candidates)))
    return paths


# kept in sync with mxnet_tpu_torch.__version__
__version__ = "0.7.0-tpu.1"
