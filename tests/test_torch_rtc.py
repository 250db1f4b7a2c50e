"""The port's ``rtc.py``: users' kernels, on the CPU.

* The callable path runs ``tests/test_pallas.py::test_rtc_pallas_kernel``'s
  ``lambda x: x * 2.0 + 1.0`` unchanged, as the JAX package's does.
* A CUDA-source ``Rtc`` generates ``mxrtc.cc``'s decorated function: the
  signature from the names and dtypes, then each array's ``_ndim`` and
  ``_dims[]`` from the prototypes (``tests/data/rtc_softmax_grad.cu``
  holds the expected text for a two-input, one-output body).
* The user-kernel ``nvcc`` line targets ``sm_90a``.
* A CUDA-source kernel on CPU tensors raises ``MXNetError``: there is no
  plain version of a user's CUDA.  A prototype mismatch in ``push``
  raises.  (Building and launching need nvcc and a card:
  ``chip_smoke.py`` phase 26 (a).)
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc

HERE = os.path.dirname(os.path.abspath(__file__))

GRAD_BODY = """  int i = blockIdx.x, j = threadIdx.x;
  for (; j < y_dims[1]; j += blockDim.x)
    dx[i * y_dims[1] + j] = y[i * y_dims[1] + j] - (j == (int)l[i]);"""


@pytest.fixture(autouse=True)
def _on_the_host():
    with tmx.cpu():
        yield


def test_rtc_callable_kernel_equals_jax():
    outs = {}
    for mx in (jmx, tmx):
        a = mx.nd.ones((8, 128)) * 3
        out = mx.nd.zeros((8, 128))
        k = mx.rtc.Rtc("axpy", [("a", a)], [("out", out)],
                       lambda x: x * 2.0 + 1.0)
        k.push([a], [out])
        outs[mx] = out.asnumpy()
    assert np.allclose(outs[tmx], 7.0)
    np.testing.assert_array_equal(outs[tmx], outs[jmx])


def test_generated_source_equals_the_checked_in_text():
    y = tmx.nd.zeros((37, 1000))
    lab = tmx.nd.zeros((37,))
    k = tmx.rtc.Rtc("softmax_grad", [("y", y), ("l", lab)], [("dx", y)],
                    GRAD_BODY)
    with open(os.path.join(HERE, "data", "rtc_softmax_grad.cu")) as f:
        assert k.source == f.read()


def test_other_dtypes_get_their_c_type():
    src = rtc.decorate("k", [("ids", (4,), "int32"), ("h", (2, 2), "float16")],
                       [("o", (4,), "uint8")], "")
    assert "void k(const int* ids, const __half* h, unsigned char* o)" in src
    assert "const int h_dims[] = {2, 2};" in src
    with pytest.raises(tmx.MXNetError, match="no C type"):
        rtc.decorate("k", [("c", (1,), "complex64")], [], "")


def test_user_kernel_nvcc_line_targets_sm90a():
    cmd = rtc.nvcc_command("k.cu", "libk.so", "/usr/local/cuda/bin/nvcc")
    assert cmd[0] == "/usr/local/cuda/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1] == "k.cu"
    assert cmd[cmd.index("-o") + 1] == "libk.so"


def test_cuda_source_on_cpu_tensors_raises():
    x = tmx.nd.zeros((4, 10))
    k = tmx.rtc.Rtc("softmax", [("x", x)], [("y", x)], "y[0] = x[0];")
    runs = rtc.NVCC_RUNS
    with pytest.raises(tmx.MXNetError, match="needs every array on one CUDA"):
        k.push([x], [tmx.nd.zeros((4, 10))], (4, 1, 1), (10, 1, 1))
    assert rtc.NVCC_RUNS == runs
    call = tmx.rtc.pallas_call(
        'extern "C" __global__ void twice(const float* a, float* o) '
        '{ o[threadIdx.x] = 2 * a[threadIdx.x]; }', ((4,), np.float32),
        grid=(1,), block=(4,))
    with pytest.raises(tmx.MXNetError, match="needs every array on one CUDA"):
        call(tmx.nd.ones((4,)))


def test_push_checks_the_prototypes():
    x = tmx.nd.zeros((4, 10))
    k = tmx.rtc.Rtc("softmax", [("x", x)], [("y", x)], "y[0] = x[0];")
    with pytest.raises(tmx.MXNetError, match="input 'x' is \\(4, 11\\)"):
        k.push([tmx.nd.zeros((4, 11))], [tmx.nd.zeros((4, 10))])
    with pytest.raises(tmx.MXNetError, match="output 'y' is \\(4, 10\\) int32"):
        k.push([x], [tmx.nd.zeros((4, 10), dtype=np.int32)])
    with pytest.raises(tmx.MXNetError, match="2 inputs given"):
        k.push([x, x], [x])


def test_pallas_call_takes_one_global_function():
    with pytest.raises(tmx.MXNetError, match="exactly one __global__"):
        tmx.rtc.pallas_call("__global__ void a(float* x) {}\n"
                            "__global__ void b(float* x) {}", ((1,), "float32"))
    with pytest.raises(tmx.MXNetError, match="Pallas kernels are not"):
        tmx.rtc.Rtc("k", [], [], lambda: 0, use_pallas=True)
