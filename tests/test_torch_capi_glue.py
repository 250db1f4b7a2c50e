"""The R and Scala bindings' C glue against the port's C ABI library:
``tests/cpp/test_r_glue.c`` (``R-package/src/mxnet_glue.c`` under a mocked
R C API) and ``tests/cpp/test_jni_glue.cc`` (the JNI glue under a mocked
``jni.h``), each compiled unchanged and given the port's library as
``argv[1]``.  (The full R and Scala stacks need ``Rscript`` or a JVM.)"""
import os

from _torch_native import CPP, capi_lib, compile_harness, run


def test_r_glue_against_port(tmp_path):
    binary = compile_harness("test_r_glue.c", str(tmp_path / "test_r_glue"),
                             link_lib=False, cc="gcc", std="c11",
                             includes=[os.path.join(CPP, "rheaders")])
    res = run(binary, [capi_lib(), tmp_path])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "R GLUE TESTS PASSED" in res.stdout


def test_jni_glue_against_port(tmp_path):
    binary = compile_harness("test_jni_glue.cc",
                             str(tmp_path / "test_jni_glue"),
                             link_lib=False, std="c++14",
                             includes=[os.path.join(CPP, "jniheaders")])
    res = run(binary, [capi_lib(), tmp_path], timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "JNI GLUE TESTS PASSED" in res.stdout
