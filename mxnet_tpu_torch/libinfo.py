"""Library discovery (counterpart of ``mxnet_tpu/libinfo.py``): where the
port's native objects are, which are the hand-written kernels built from
``csrc/`` into ``mxnet_tpu_torch/_build/`` at first use on the card."""
from __future__ import annotations

import os

__all__ = ["find_lib_path", "__version__"]


def find_lib_path(name=None):
    """Paths of the built kernel libraries: the one for kernel ``name``
    (a key of ``ops.cuda_kernels.SOURCES``), or every built one.  Raises
    when none is built yet (``ops.cuda_kernels.build()`` builds them on a
    machine with ``nvcc``)."""
    from .ops import cuda_kernels as ck
    names = list(ck.SOURCES) if name is None else [name]
    unknown = [n for n in names if n not in ck.SOURCES]
    if unknown:
        raise RuntimeError("unknown kernel library %r (have %s)"
                           % (unknown[0], sorted(ck.SOURCES)))
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
