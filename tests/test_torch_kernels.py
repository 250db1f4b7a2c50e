"""The port's fused_fc_epilogue against the JAX package's.

On the CPU the port's wrapper takes its plain version
(``fused_fc_epilogue_reference``); here that plain version is held to the
JAX package's Pallas kernel run in interpret mode, and to the JAX
``_fused_FullyConnected`` body at a shape the TPU kernel does not take.
The CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py``.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_get_op
from mxnet_tpu.ops.pallas_kernels import fused_fc_epilogue as pallas_fc
from mxnet_tpu.ops.registry import OpContext as JaxOpContext
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck

ACTS = ["none", "relu", "sigmoid", "tanh", "softrelu"]


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = (rng.uniform(-1, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (n,)).astype(np.float32)
    return x, w, b


def _port(x, w, b, act, out_scale=None):
    out = ck.fused_fc_epilogue(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), act, out_scale)
    return out.numpy()


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_pallas_interpret(act, bias):
    # float32 sums of 256 products, in XLA's order and in torch's: they
    # differ by a few ulps of O(1) values, well inside 1e-5
    x, w, b = _inputs(8, 256, 256, seed=ACTS.index(act))
    b = b if bias else None
    ref = np.asarray(pallas_fc(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b), act,
                               interpret=True))
    out = _port(x, w, b, act)
    assert out.dtype == np.float32 and out.shape == (8, 256)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_int8_codes_equal_pallas_interpret(act):
    # integer x and W keep every float32 sum exact; out_scale 2 puts the
    # odd sums on .5 ties, which both round half to even: codes are equal
    rng = np.random.RandomState(3)
    x = rng.randint(-3, 4, (8, 256)).astype(np.float32)
    w = rng.randint(-2, 3, (128, 256)).astype(np.float32)
    b = rng.randint(-5, 6, (128,)).astype(np.float32)
    ref = np.asarray(pallas_fc(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), act, out_scale=2.0,
                               interpret=True))
    out = _port(x, w, b, act, out_scale=2.0)
    sums = x.astype(np.int64) @ w.T.astype(np.int64) + b.astype(np.int64)
    assert (sums % 2 == 1).sum() > 100           # many ties exercised
    assert out.dtype == np.int8 and ref.dtype == np.int8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_fused_op_body_ragged(act):
    # (3, 784, 10): N and K off the TPU kernel's 128 grid, so the JAX op
    # runs its jnp body; float32 sums of 784 products, tolerance 1e-5
    x, w, b = _inputs(3, 784, 10, seed=10 + ACTS.index(act))
    op = jax_get_op("_fused_FullyConnected")
    p = op.parse_params({"num_hidden": 10, "act_type": act})
    ref = np.asarray(op.forward(p, [jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b)], [],
                                JaxOpContext(is_train=False))[0])
    np.testing.assert_allclose(_port(x, w, b, act), ref, rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_plain_version_without_counting():
    x, w, b = _inputs(4, 64, 32, seed=0)
    ck.reset_launches()
    out = ck.fused_fc_epilogue(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), "tanh")
    ref = ck.fused_fc_epilogue_reference(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b), "tanh")
    assert torch.equal(out, ref)
    assert ck.LAUNCHES == {name: 0 for name in ck.SOURCES}


@pytest.mark.parametrize("bad", ["act", "shape", "bias", "scale"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 16, 8, seed=0))
    kwargs = {"x": x, "w": w, "b": b, "act_type": "relu", "out_scale": None}
    if bad == "act":
        kwargs["act_type"] = "gelu"
    elif bad == "shape":
        kwargs["w"] = w[:, :15]
    elif bad == "bias":
        kwargs["b"] = b[:7]
    else:
        kwargs["out_scale"] = 0.0
    with pytest.raises(MXNetError):
        ck.fused_fc_epilogue(**kwargs)


def test_build_targets_hopper_from_repo_source():
    src = os.path.join(ck._CSRC, ck.SOURCES["fused_fc_epilogue"])
    assert os.path.exists(src)
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int mxtt_fc_epilogue(' in text
    assert "pallas_kernels.py:326" in text        # names the TPU kernel
    cmd = ck.nvcc_command(src, "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert ck._lib_path("fused_fc_epilogue").startswith(ck.BUILD_DIR)


# -- the column tile the kernel search chooses among --------------------------

def test_tile_is_a_compiled_instance_in_the_source():
    """block_n is a template parameter with an instance per FC_TILES
    entry for float32 operands, and an argument of the C interface."""
    src = os.path.join(ck._CSRC, ck.SOURCES["fused_fc_epilogue"])
    with open(src) as f:
        text = f.read()
    assert "template <typename TX, typename TW, typename TO, int " \
        "kRowsPerWarp>" in text
    assert "constexpr int kWarps = 4;" in text
    assert "constexpr int kDefaultRows = %d;" % (ck.FC_DEFAULT_TILE // 4) \
        in text
    for bn in ck.FC_TILES:
        if bn != ck.FC_DEFAULT_TILE:
            assert "block_n == kWarps * %d" % (bn // 4) in text
    assert "float inv_scale, int block_n, int device," in text
    assert ck.FC_DEFAULT_TILE in ck.FC_TILES
    assert ck.fc_tiles_for(torch.float32, torch.float32) == ck.FC_TILES
    assert ck.fc_tiles_for(torch.float16, torch.float32) == \
        (ck.FC_DEFAULT_TILE,)


@pytest.mark.parametrize("name,fn", [("fused_fc_epilogue",
                                      "mxtt_fc_epilogue"),
                                     ("paged_attention",
                                      "mxtt_paged_attention")])
def test_ctypes_declaration_matches_c_interface(name, fn):
    """The wrapper declares as many arguments as the C function takes."""
    import re
    with open(os.path.join(ck._CSRC, ck.SOURCES[name])) as f:
        text = f.read()
    sig = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, text).group(1)
    n_args = len([a for a in sig.split(",") if a.strip()])

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        mxtt_error_string = Fn()
    setattr(Lib, fn, Fn())
    lib = Lib()
    ck._declare(name, lib)
    assert len(getattr(lib, fn).argtypes) == n_args


@pytest.mark.parametrize("block_n", list(ck.FC_TILES))
def test_every_tile_gives_the_plain_version_on_host(block_n):
    x, w, b = (torch.from_numpy(a) for a in _inputs(5, 40, 21, seed=3))
    want = ck.fused_fc_epilogue(x, w, b, "relu")
    got = ck.fused_fc_epilogue(x, w, b, "relu", block_n=block_n)
    assert torch.equal(got, want)
    q = ck.fused_fc_epilogue(x, w, b, "relu", out_scale=0.01,
                             block_n=block_n)
    assert torch.equal(q, ck.fused_fc_epilogue(x, w, b, "relu",
                                               out_scale=0.01))
    with pytest.raises(MXNetError, match="compiled instance"):
        ck.fused_fc_epilogue(x, w, b, "relu", block_n=block_n + 1)
