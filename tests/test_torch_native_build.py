"""The port's build of its native objects (``mxnet_tpu_torch/
native_build.py``): g++ at first use into a digest-keyed directory, the
compile cache's store across processes, builds that race, a failed build
raising with the compiler's output, and ``libinfo`` finding the objects
by the JAX package's names."""
import os
import subprocess
import sys

import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native_build as nb
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r'''
import os, sys
from mxnet_tpu_torch import native_build as nb
nb.BUILD_DIR = sys.argv[1]
lib = nb.load("host")
assert lib.mxtpu_engine_create
print(nb.GXX_RUNS, nb.path("host"))
'''


def _child(build_dir, cache=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_COMPILE_CACHE", None)
    if cache:
        env["MXNET_COMPILE_CACHE"] = cache
    return subprocess.Popen([sys.executable, "-c", _CHILD, build_dir],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out + err
    runs, path = out.split()
    return int(runs), path


def test_second_process_takes_the_object_from_the_cache(tmp_path):
    cache = str(tmp_path / "cache")
    runs1, p1 = _result(_child(str(tmp_path / "b1"), cache))
    runs2, p2 = _result(_child(str(tmp_path / "b2"), cache))
    assert (runs1, runs2) == (1, 0)
    assert os.path.basename(p1) == os.path.basename(p2) == \
        "libmxtpu_torch_host.so"
    assert os.path.basename(os.path.dirname(p1)) == \
        os.path.basename(os.path.dirname(p2))       # the same digest
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_processes_building_at_once_do_not_race(tmp_path):
    procs = [_child(str(tmp_path / "b")) for _ in range(3)]
    paths = {_result(p)[1] for p in procs}
    assert len(paths) == 1
    assert not [f for f in os.listdir(os.path.dirname(paths.pop()))
                if ".tmp-" in f]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "broken.cc").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(nb, "_CSRC", str(tmp_path))
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setitem(nb.OBJECTS, "broken",
                        ("libbroken.so", ["native/broken.cc"], "shared", ()))
    with pytest.raises(MXNetError, match="undeclared_name"):
        nb.build(["broken"])
    assert not os.path.exists(nb._target("broken"))


def test_digest_follows_sources_and_line(monkeypatch):
    d0 = nb._compute_digest("io")
    assert d0 == nb._compute_digest("io")
    monkeypatch.setattr(nb, "_jpeg", not nb.have_jpeg())
    assert nb._compute_digest("io") != d0          # -DMXTT_HAVE_JPEG
    assert nb._compute_digest("host") == nb._digest("host")


def test_libinfo_finds_native_objects_by_both_names():
    find = tmx.libinfo.find_lib_path
    assert find("libmxtpu_capi.so") == [nb.path("capi")] == \
        find("libmxtpu_torch_capi.so")
    assert find("libmxtpu_predict.so") == [nb.path("predict")]
    assert find("im2rec") == [nb.path("im2rec")]
    assert os.access(find("im2rec")[0], os.X_OK)


def test_native_modules_import_no_jax_and_embed_the_port():
    """The native layer's modules import neither jax nor the JAX package,
    and the ABI's embedded interpreter imports the port's bridge."""
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.native_build, "
            "mxnet_tpu_torch.native_engine, mxnet_tpu_torch.native_io, "
            "mxnet_tpu_torch.capi_bridge\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    common = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "capi",
                               "c_api_common.h")).read()
    assert 'PyImport_ImportModule("mxnet_tpu_torch.capi_bridge")' in common
    assert '"mxnet_tpu.capi_bridge"' not in common
