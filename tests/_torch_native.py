"""Build-and-run helper for the port's native harness tests: compile a
program from ``tests/cpp`` unchanged and run it in a clean subprocess
against the port's C ABI library (``mxnet_tpu_torch.native_build``,
object ``capi``), with the embedded interpreter's environment
(``native_build.embed_env``: the repository root and this interpreter's
site-packages on ``PYTHONPATH``).  ``tests/common/native.py`` is the JAX
package's helper and names its library."""
import os
import subprocess

from mxnet_tpu_torch import native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(ROOT, "tests", "cpp")


def capi_lib() -> str:
    return native_build.path("capi")


def compile_harness(src, binary, link_lib=True, cc="g++", std="c++17",
                    includes=()):
    """Compile ``tests/cpp/<src>``; with ``link_lib`` link the port's C
    ABI library by path (with its directory as rpath), else ``-ldl`` (the
    glue harnesses open the library named on their command line)."""
    cmd = [cc, "-O1", "-std=" + std] + ["-I" + i for i in includes] + \
        [os.path.join(CPP, src), "-o", binary]
    if link_lib:
        lib = capi_lib()
        cmd += [lib, "-Wl,-rpath," + os.path.dirname(lib)]
    else:
        cmd.append("-ldl")
    subprocess.run(cmd, check=True)
    return binary


def run(binary, argv=(), timeout=600):
    return subprocess.run([binary] + [str(a) for a in argv],
                          env=native_build.embed_env(), capture_output=True,
                          text=True, timeout=timeout)
