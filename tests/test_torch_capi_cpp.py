"""``tests/cpp/cpp_package_test.cc`` (the C++ frontend, ``cpp-package/``
headers over the C ABI) unchanged against the port's C ABI library: both
legs train the MLP to the harness's accuracy gate, and the C++ Module's
checkpoint loads in the port's Python and in the JAX package's and gives
the same forward."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_native import compile_harness, run


def _forward(pkg, prefix, x):
    with pkg.cpu():
        return _forward_here(pkg, prefix, x)


def _forward_here(pkg, prefix, x):
    net, arg_p, aux_p = pkg.model.load_checkpoint(prefix, 12)
    assert "fc1_weight" in arg_p
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))],
             for_training=False)
    mod.init_params(arg_params=arg_p, aux_params=aux_p, allow_missing=True)
    mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                                 label=[]), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def test_cpp_package_trains_and_checkpoint_loads_in_both(tmp_path):
    prefix = str(tmp_path / "cpp_module_ckpt")
    binary = compile_harness("cpp_package_test.cc",
                             str(tmp_path / "cpp_package_test"))
    res = run(binary, [prefix])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CPP PACKAGE TRAINING PASSED" in res.stdout
    assert "CPP PACKAGE MODULE PASSED" in res.stdout
    x = np.random.RandomState(0).randn(4, 10).astype(np.float32)
    got = _forward(tmx, prefix, x)
    want = _forward(jmx, prefix, x)
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_card_client_first_update_matches_python_executor(tmp_path):
    """``tests/data/capi_card_client.cc`` (phase 27 (d)'s C++ client) on
    the host: it trains the 784-128-64-10 MLP through MXExecutor* and the
    optimizer ABI to its accuracy gate, and its first update equals the
    port's Python Executor's from the same init (chip_smoke's replay)."""
    import os
    import subprocess
    import chip_smoke
    from mxnet_tpu_torch import native_build
    from _torch_native import ROOT
    lib = native_build.path("capi")
    binary = str(tmp_path / "capi_card_client")
    subprocess.run(["g++", "-O1", "-std=c++17",
                    os.path.join(ROOT, "tests", "data",
                                 "capi_card_client.cc"),
                    "-o", binary, lib, "-Wl,-rpath," + os.path.dirname(lib)],
                   check=True)
    res = run(binary, [tmp_path, 1, 40])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CAPI CARD CLIENT PASSED" in res.stdout
    err, n = chip_smoke.client_first_update(tmx, str(tmp_path), tmx.cpu())
    assert n == 784 * 128 + 128 + 128 * 64 + 64 + 64 * 10 + 10
    assert err <= chip_smoke.P27_UPDATE_ATOL
