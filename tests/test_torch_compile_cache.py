"""The port's compile cache against its contract and the JAX package's.

* The store (``compile_cache.store``) mirrors the reference's contract
  (``tests/test_compile_cache.py``): a truncated, bit-flipped or
  corrupt-meta entry is rebuilt with one warning; the LRU bound holds and
  a hit refreshes recency; two processes publish into one directory
  without corrupting it; a dangling fast-key index heals.  The store is
  generic over bytes; the kernels' builds go through it with an ``nvcc``
  stand-in (a script that writes a digest of its source), since this host
  has no CUDA toolchain: a second fresh process runs it zero times.
* A library's key changes with its source, an included header, the
  compile line and the environment.
* Steady state: after ``prepare``/``precompile`` (or a first epoch) the
  loops build nothing more in both packages: the port's
  ``steady_rebuilds`` and the reference's ``steady_retraces`` stay 0.
* ``parallel_warm``: eight tasks give what one thread gives, and a
  failure names its task.
"""
import os
import pickle
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.compile_cache.stats import _reset_stats as _jreset_stats
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch.compile_cache import fingerprint as fp
from mxnet_tpu_torch.compile_cache.stats import _reset_stats
from mxnet_tpu_torch.compile_cache.store import CacheStore, _reset_warnings
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent('''\
    #!%s
    """A stand-in for nvcc: writes a digest of its source as the library."""
    import hashlib, sys
    args = sys.argv[1:]
    if "--version" in args:
        print("Cuda compilation tools, release 0.0 (stand-in)")
        sys.exit(0)
    out, src = args[args.index("-o") + 1], args[-1]
    with open(src, "rb") as f:
        body = f.read()
    with open(out, "wb") as f:
        f.write(b"LIB" + hashlib.sha256(body).digest() * 64)
    print("ptxas info    : Used 1 registers")
    ''') % sys.executable


@pytest.fixture(autouse=True)
def on_host():
    """The port's arrays default to the card: these tests run on the
    host."""
    with tmx.cpu():
        yield


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """The stand-in nvcc, fresh library tables, the build dir in tmp."""
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(ck, "_nvcc", lambda: str(path))
    monkeypatch.setattr(ck, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(ck, "_libs", {})
    monkeypatch.setattr(ck, "_resolved", {})
    _reset_stats()
    _reset_warnings()
    yield str(path)
    cc.reset()
    _reset_stats()
    _reset_warnings()


@pytest.fixture
def cache_dir(tmp_path, fake_nvcc):
    d = str(tmp_path / "cc")
    cc.configure(d, 64)
    return d


def _fc_entry(cache_dir):
    key = cc.get_cache().library_key(ck._lib_digest("fused_fc_epilogue"))
    return os.path.join(cache_dir, key + ".exe"), \
        os.path.join(cache_dir, key + ".meta")


def _build_fc():
    runs = ck.NVCC_RUNS
    ck._libs.clear()
    ck._resolved.clear()
    ck.build(["fused_fc_epilogue"])
    return ck.NVCC_RUNS - runs


# -- the kernels' builds through the store ------------------------------------

def test_build_publishes_and_reloads_without_nvcc(cache_dir, monkeypatch):
    made = []
    real_mkdtemp = ck.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(real_mkdtemp(**kw))
        return made[-1]
    monkeypatch.setattr(ck.tempfile, "mkdtemp", mkdtemp)
    assert _build_fc() == 1
    # nvcc's directory is gone once the library is in the store
    assert len(made) == 1 and not os.path.exists(made[0])
    exe, meta = _fc_entry(cache_dir)
    assert os.path.exists(exe) and os.path.exists(meta)
    path, key = ck._resolved["fused_fc_epilogue"]
    assert path == exe and key in exe
    assert _build_fc() == 0                      # a store hit
    rep = tmx.profiler.compile_report()
    per = rep["per_program"]["kernel:fused_fc_epilogue"]
    assert per["builds"] == 1 and per["hits"] >= 1 and per["bytes"] > 0
    assert rep["cache"]["directory"] == os.path.abspath(cache_dir)
    assert rep["cache"]["in_process"] == cc.IN_PROCESS_REASON
    # a library the store cannot take is kept in the build directory
    monkeypatch.setattr(cc.CompileCache, "store_library",
                        lambda self, name, key, path: 0)
    ck._libs.clear()
    ck._resolved.clear()
    cc.get_cache().store.invalidate(key)
    ck.build(["fused_fc_epilogue"])
    assert ck._resolved["fused_fc_epilogue"] == (
        ck._lib_path("fused_fc_epilogue"), None)
    assert os.path.exists(ck._lib_path("fused_fc_epilogue"))
    assert len(made) == 2 and not os.path.exists(made[1])
    # without a cache the libraries go to the build directory
    os.remove(ck._lib_path("fused_fc_epilogue"))
    cc.configure(None)
    assert _build_fc() == 1
    assert ck._resolved["fused_fc_epilogue"][0] == \
        ck._lib_path("fused_fc_epilogue")


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "meta"])
def test_damaged_entry_rebuilds_with_one_warning(cache_dir, caplog, damage):
    assert _build_fc() == 1
    exe, meta = _fc_entry(cache_dir)
    if damage == "truncate":
        with open(exe, "r+b") as f:
            f.truncate(os.path.getsize(exe) // 2)
    elif damage == "bitflip":
        blob = bytearray(open(exe, "rb").read())
        blob[len(blob) // 2] ^= 0x40
        open(exe, "wb").write(bytes(blob))
    else:
        open(meta, "wb").write(b"not a pickle")
    with caplog.at_level("WARNING"):
        assert _build_fc() == 1                  # rebuilt by nvcc
        assert _build_fc() == 0                  # and stored again
    warned = [r for r in caplog.records if "unreadable" in r.getMessage()]
    assert len(warned) == 1
    want = open(exe, "rb").read()
    src = os.path.join(ck._CSRC, ck.SOURCES["fused_fc_epilogue"])
    import hashlib
    assert want == b"LIB" + hashlib.sha256(
        open(src, "rb").read()).digest() * 64


def test_second_process_runs_nvcc_zero_times(tmp_path, fake_nvcc):
    """Two fresh processes share one MXNET_COMPILE_CACHE directory: the
    first builds, the second loads."""
    code = textwrap.dedent('''
        import sys
        from mxnet_tpu_torch.ops import cuda_kernels as ck
        ck._nvcc = lambda: %r
        ck.build(["fused_fc_epilogue", "paged_attention"])
        print("RUNS", ck.NVCC_RUNS)
    ''') % fake_nvcc
    env = dict(os.environ, PYTHONPATH=ROOT,
               MXNET_COMPILE_CACHE=str(tmp_path / "shared"))
    runs = []
    for _ in range(2):
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=str(tmp_path))
        assert res.returncode == 0, res.stderr
        runs.append(int(res.stdout.split("RUNS")[1]))
    assert runs == [2, 0]
    names = os.listdir(tmp_path / "shared")
    assert sum(n.endswith(".exe") for n in names) == 2
    assert sum(n.endswith(".idx") for n in names) == 2


def test_dangling_fast_index_heals(cache_dir):
    assert _build_fc() == 1
    fkey, key = ck._store_keys("fused_fc_epilogue", cc.get_cache())
    store = cc.get_cache().store
    assert store.load_index(fkey) == key
    # the index points at an entry that is gone: a miss, then healed
    store.save_index(fkey, "0" * 64)
    assert cc.get_cache().load_fast(fkey, "fused_fc_epilogue") is None
    assert store.load_index(fkey) is None
    assert _build_fc() == 0
    assert store.load_index(fkey) == key


def test_library_key_covers_source_header_line_and_environment(
        tmp_path, monkeypatch, cache_dir):
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(ck._CSRC, csrc)
    base = ck._lib_digest("paged_attention", str(csrc))
    # the source
    src = csrc / ck.SOURCES["paged_attention"]
    src.write_text(src.read_text() + "\n// edit\n")
    assert ck._lib_digest("paged_attention", str(csrc)) != base
    shutil.copy(os.path.join(ck._CSRC, ck.SOURCES["paged_attention"]), src)
    assert ck._lib_digest("paged_attention", str(csrc)) == base
    # a header it includes (and not one it does not)
    (csrc / "unused.cuh").write_text("// not included\n")
    assert ck._lib_digest("paged_attention", str(csrc)) == base
    hdr = csrc / "attention.cuh"
    hdr.write_text(hdr.read_text() + "\n// edit\n")
    assert ck._lib_digest("paged_attention", str(csrc)) != base
    assert ck._lib_digest("fused_fc_epilogue", str(csrc)) != \
        ck._lib_digest("fused_fc_epilogue")     # it includes it for mma_16
    # the compile line
    real = ck.nvcc_command
    monkeypatch.setattr(ck, "nvcc_command",
                        lambda *a: real(*a) + ["-lineinfo"])
    line_digest = ck._lib_digest("fused_fc_epilogue")
    monkeypatch.setattr(ck, "nvcc_command", real)
    assert line_digest != ck._lib_digest("fused_fc_epilogue")
    # the environment (torch, CUDA, device, nvcc, the compile line)
    env = fp.environment_fingerprint()
    assert "torch=%s" % torch.__version__ in env and "nvcc=" in env
    assert "compile=" in env and "device=" in env
    a = fp.program_key("digest", env_fp=env)
    assert fp.program_key("digest", env_fp=env + ";device=other") != a
    assert fp.program_key("digest2", env_fp=env) != a


# -- the store itself (generic over bytes) ------------------------------------

def test_lru_bound_and_hit_refreshes_recency(tmp_path):
    store = CacheStore(str(tmp_path / "s"), size_mb=0.05)   # ~52 KB
    blob = os.urandom(20 * 1024)
    for i, key in enumerate(("a" * 64, "b" * 64)):
        store.save(key, blob, {"i": i})
        os.utime(store.blob_path(key), (1000 + i, 1000 + i))
        os.utime(store._meta_path(key), (1000 + i, 1000 + i))
    assert store.load("a" * 64) is not None      # a hit: a is now newest
    store.save("c" * 64, blob, {"i": 2})         # over the bound
    assert store.disk_bytes() <= store.size_bytes
    assert store.load("b" * 64) is None          # the oldest went
    assert store.load("a" * 64) is not None
    assert store.load("c" * 64) is not None


def test_concurrent_processes_publish_without_corruption(tmp_path):
    d = str(tmp_path / "race")
    code = textwrap.dedent('''
        import os, sys
        from mxnet_tpu_torch.compile_cache.store import CacheStore
        s = CacheStore(%r, 1024)
        me = int(sys.argv[1])
        for i in range(60):
            key = ("%%064x" %% (i %% 7))
            s.save(key, (b"%%d-" %% (i %% 7)) * 4000, {"writer": me})
            got = s.load(key)
            assert got is not None and got[0].startswith(b"%%d-" %% (i %% 7))
        print("OK")
    ''') % d
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(w)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for w in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and "OK" in out, err
    store = CacheStore(d, 1024)
    assert store.entry_count() == 7
    for i in range(7):
        blob, meta = store.load("%064x" % i)
        assert blob == (b"%d-" % i) * 4000 and meta["writer"] in (0, 1)
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


def test_store_meta_versions_and_failed_publish(tmp_path, caplog):
    store = CacheStore(str(tmp_path / "v"), 64)
    store.save("d" * 64, b"x" * 10, {})
    meta = store._meta_path("d" * 64)
    m = pickle.load(open(meta, "rb"))
    m["version"] = 99
    pickle.dump(m, open(meta, "wb"))
    _reset_warnings()
    with caplog.at_level("WARNING"):
        assert store.load("d" * 64) is None
    assert not os.path.exists(store.blob_path("d" * 64))
    # a publish that fails (a full disk) reports 0 and leaves no entry
    from mxnet_tpu_torch.compile_cache import store as store_mod

    def full(path, data):
        raise OSError(28, "No space left on device")
    real = store_mod._publish
    store_mod._publish = full
    try:
        assert store.save("e" * 64, b"y", {}) == 0
    finally:
        store_mod._publish = real
    assert store.load("e" * 64) is None


# -- in-process programs: builds, rebuilds, warm-up ---------------------------

def _jtotals():
    return jmx.compile_cache.get_stats().totals()


def _ttotals():
    return tmx.compile_cache.get_stats().totals()


@pytest.fixture
def fresh_stats():
    _reset_stats()
    _jreset_stats()
    jmx.compile_cache.configure(None)
    cc.configure(None)
    yield
    jmx.compile_cache.reset()
    cc.reset()
    _reset_stats()
    _jreset_stats()


def test_rebuild_counter_in_both_packages(fresh_stats):
    """A program object built for a second signature is a steady-state
    rebuild in the port, as it is a retrace in the reference."""
    import jax.numpy as jnp
    f = jmx.compile_cache.cached_jit(lambda x: x + 1, name="t:retrace")
    f.warm(jnp.ones((2,)))
    g = cc.cached_program(lambda x: (lambda y: y + 1), name="t:rebuild")
    assert g.warm(torch.ones(2)) == "compiled"
    assert g.warm(torch.ones(2)) == "present"
    assert _jtotals()["steady_retraces"] == 0
    assert _ttotals()["steady_rebuilds"] == 0
    f.warm(jnp.ones((3,)))
    g.warm(torch.ones(3))
    assert _jtotals()["steady_retraces"] == 1
    assert _ttotals()["steady_rebuilds"] == 1
    assert torch.equal(g(torch.ones(3)), torch.full((3,), 2.0))
    g.reset()                 # a new program, not a rebuild
    g.warm(torch.ones(4))
    assert _ttotals()["steady_rebuilds"] == 1
    assert tmx.profiler.compile_report()["per_program"]["t:rebuild"][
        "builds"] == 3


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = pkg.sym.Activation(x, act_type="relu", name="relu1")
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _blobs(n=64, d=8):
    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    return X, (X[:, 0] > 0).astype(np.float32) + (X[:, 1] > 0)


def _fit_twice(pkg, prepare=False, **fit_kw):
    X, y = _blobs()
    it = pkg.io.NDArrayIter(X, y, batch_size=16)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(pkg.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    if prepare:
        mod.prepare()
    mod.fit(it, num_epoch=1, eval_metric="acc", **fit_kw)
    mod.score(it, "acc")
    first = dict(_jtotals() if pkg is jmx else _ttotals())
    mod.fit(it, num_epoch=2, begin_epoch=1, eval_metric="acc", **fit_kw)
    mod.score(it, "acc")
    return mod, first


@pytest.mark.parametrize("kw", [{"prepare": True}, {},
                                {"superstep": 2}])
def test_fit_steady_state_builds_nothing_in_both(fresh_stats, kw):
    """After a first epoch and score built their programs, a second
    epoch and score build nothing in either package (the port's fused
    step on the CPU never captures, and builds nothing at all)."""
    for pkg, totals, key in ((jmx, _jtotals, "steady_retraces"),
                             (tmx, _ttotals, "steady_rebuilds")):
        _mod, first = _fit_twice(pkg, **kw)
        assert totals()[key] == first[key], pkg.__name__
    assert _ttotals()["steady_rebuilds"] == 0
    # the port's fused step ran eagerly on the CPU: nothing was captured
    mod, _ = _fit_twice(tmx, **kw)
    assert mod._fused.stats.captures == 0


def test_bucketing_precompile_then_loop(fresh_stats):
    """Every bucket is built by precompile (through the pool), and the
    loop over every bucket builds nothing more."""
    def sym_gen(pkg):
        def gen(key):
            data = pkg.sym.Variable("data")
            x = pkg.sym.FullyConnected(data, num_hidden=6, name="fc")
            x = pkg.sym.SoftmaxOutput(x, name="softmax")
            return x, ("data",), ("softmax_label",)
        return gen

    def batch(pkg, key):
        return pkg.io.DataBatch(
            data=[pkg.nd.array(np.random.RandomState(key).rand(8, key))],
            label=[pkg.nd.array(np.zeros(8))], bucket_key=key,
            provide_data=[("data", (8, key))],
            provide_label=[("softmax_label", (8,))])
    buckets = {k: ([("data", (8, k))], [("softmax_label", (8,))])
               for k in (4, 6, 8)}
    outs = {}
    for pkg, totals, key in ((jmx, _jtotals, "steady_retraces"),
                             (tmx, _ttotals, "steady_rebuilds")):
        mod = pkg.mod.BucketingModule(sym_gen(pkg), default_bucket_key=8,
                                      context=pkg.cpu())
        mod.bind(data_shapes=[("data", (8, 8))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(pkg.init.One())
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        labels = mod.precompile(buckets, threads=2)
        assert len(labels) == 3 and set(mod._buckets) == {4, 6, 8}
        if pkg is tmx:
            built = _ttotals()["builds"]
            assert built == 3
        for k in (4, 6, 8, 4, 6, 8):
            mod.forward(batch(pkg, k), is_train=True)
            mod.backward()
            mod.update()
        mod.forward(batch(pkg, 6), is_train=False)
        outs[pkg.__name__] = mod.get_outputs()[0].asnumpy()
        assert totals()[key] == 0
        if pkg is tmx:
            assert _ttotals()["builds"] == built
    np.testing.assert_allclose(outs["mxnet_tpu_torch"], outs["mxnet_tpu"],
                               rtol=1e-5, atol=1e-6)


def _params(pkg, sym, shapes, seed=3):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n not in shapes:
            out[n] = (rng.randn(*s) * 0.1).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        out[n] = np.ones(s, np.float32)
    return out


def test_predictor_precompile_then_loop_in_both(fresh_stats):
    shapes = [{"data": (b, 8), "softmax_label": (b,)} for b in (1, 2, 8)]
    params = _params(tmx, _mlp(tmx), shapes[-1])
    got = {}
    for pkg, totals, key in ((jmx, _jtotals, "steady_retraces"),
                             (tmx, _ttotals, "steady_rebuilds")):
        from importlib import import_module
        Predictor = import_module(pkg.__name__ + ".predictor").Predictor
        p = Predictor(_mlp(pkg).tojson(),
                      {k: pkg.nd.array(v) for k, v in params.items()},
                      shapes[-1], *(("cpu", 0) if pkg is tmx else ()))
        p.precompile(shapes, threads=2)
        if pkg is tmx:
            ex = p._exec_cache
            assert all(e.has_compiled() for e in ex.values()
                       if e.arg_dict["data"].shape[0] in (1, 2, 8))
            built = _ttotals()["builds"]
        for s in shapes + shapes:
            p.reshape(s)
            p.set_input("data", np.ones(s["data"], np.float32))
            p.forward()
            got.setdefault(pkg.__name__, []).append(p.get_output(0))
        assert totals()[key] == 0
        if pkg is tmx:
            assert _ttotals()["builds"] == built
    for a, b in zip(got["mxnet_tpu_torch"], got["mxnet_tpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_executor_precompile_runs_nothing_visible(fresh_stats):
    net = _mlp(tmx)
    net = tmx.sym.Dropout(net, p=0.5)
    ex = net.simple_bind(tmx.cpu(), data=(4, 8), softmax_label=(4,))
    for a in ex.arg_dict.values():
        a[:] = 0.5
    gen = tmx.random.generator("cpu")
    before = gen.get_state().clone()
    grads = {k: v.asnumpy().copy() for k, v in ex.grad_dict.items()}
    assert not ex.has_compiled()
    assert ex.precompile() == ("fwdbwd_ones",)
    assert ex.precompile(("fwd_eval",)) == ("fwd_eval",)
    assert ex.has_compiled()
    with pytest.raises(tmx.MXNetError):
        ex.outputs                                # nothing handed out
    with pytest.raises(tmx.MXNetError, match="fwdbwd_ones"):
        ex.precompile(("fwdbwd",))
    assert torch.equal(gen.get_state(), before)   # no draw
    for k, v in ex.grad_dict.items():
        assert np.array_equal(v.asnumpy(), grads[k])
    per = tmx.profiler.compile_report()["per_program"]
    assert per["executor:fwdbwd_ones"]["builds"] == 1
    assert per["executor:fwd_eval"]["builds"] == 1


def _save_pair(pkg, tmp_path):
    net = _mlp(pkg)
    params = _params(pkg, net, {"data": (1, 8), "softmax_label": (1,)})
    prefix = str(tmp_path / ("mlp-" + pkg.__name__))
    pkg.model.save_checkpoint(prefix, 0, net,
                              {k: pkg.nd.array(v) for k, v in params.items()},
                              {})
    return prefix


def test_serve_engine_warm_restart(fresh_stats, tmp_path, monkeypatch):
    """A second ("restarted") engine on one cache directory builds its
    grid with no nvcc run and no rebuild, and answers as the first did
    and as the JAX package's engine does."""
    monkeypatch.setenv("MXNET_COMPILE_CACHE", str(tmp_path / "cc"))
    cc.reset()
    prefix = _save_pair(tmx, tmp_path)
    x = np.random.RandomState(1).randn(8).astype(np.float32)
    kw = {"batch_buckets": (1, 2, 4)}
    answers = []
    runs = ck.NVCC_RUNS
    for _ in range(2):
        eng = tmx.serve.ServeEngine.from_checkpoint(
            prefix, 0, {"data": (1, 8), "softmax_label": (1,)},
            dev_type="cpu", **kw)
        try:
            answers.append(eng.predict(x, timeout=30))
        finally:
            eng.close()
    assert ck.NVCC_RUNS == runs
    t = _ttotals()
    assert t["steady_rebuilds"] == 0 and t["builds"] == 6
    per = tmx.profiler.compile_report()["per_program"]["executor:fwd_eval"]
    assert per["bypass_reasons"] == {cc.IN_PROCESS_REASON: 6}
    jeng = jmx.serve.ServeEngine.from_checkpoint(
        prefix, 0, {"data": (1, 8), "softmax_label": (1,)}, **kw)
    try:
        want = jeng.predict(x, timeout=30)
    finally:
        jeng.close()
    assert np.array_equal(answers[0], answers[1])
    np.testing.assert_allclose(answers[0], want, rtol=1e-5, atol=1e-6)


def test_serve_warmup_failure_names_bucket(fresh_stats, tmp_path,
                                           monkeypatch):
    prefix = _save_pair(tmx, tmp_path)
    from mxnet_tpu_torch.executor import Executor
    real = Executor.forward

    def boom(self, is_train=False, **kwargs):
        if self.arg_dict["data"].shape[0] == 2:
            raise RuntimeError("walk exploded mid-grid")
        return real(self, is_train, **kwargs)
    monkeypatch.setattr(Executor, "forward", boom)
    with pytest.raises(tmx.serve.ServeError) as ei:
        eng = tmx.serve.ServeEngine.from_checkpoint(
            prefix, 0, {"data": (1, 8), "softmax_label": (1,)},
            dev_type="cpu", batch_buckets=(1, 2, 4))
        try:
            eng.predict(np.zeros(8, np.float32), timeout=30)
        finally:
            eng.close()
    msg = str(ei.value)
    assert "bucket 2" in msg and "first run" in msg and "exploded" in msg


def test_parallel_warm_eight_threads_as_one(fresh_stats):
    """Eight warm tasks sharing one device give the same programs and
    outputs as one thread; a failure names its label."""
    def run(threads):
        sym = _mlp(tmx)
        params = _params(tmx, sym, {"data": (8, 8), "softmax_label": (8,)})
        p = tmx.Predictor(sym.tojson(),
                          {k: tmx.nd.array(v) for k, v in params.items()},
                          {"data": (8, 8), "softmax_label": (8,)}, "cpu", 0)
        shapes = [{"data": (b, 8), "softmax_label": (b,)}
                  for b in range(1, 9)]
        assert p.precompile(shapes, threads=threads) == 8
        outs = []
        for s in shapes:
            p.reshape(s)
            p.set_input("data", np.full(s["data"], 0.25, np.float32))
            p.forward()
            outs.append(p.get_output(0))
        return outs
    for a, b in zip(run(8), run(1)):
        assert np.array_equal(a, b)
    assert _ttotals()["builds"] == 16 and _ttotals()["steady_rebuilds"] == 0
    done = []

    def bad():
        raise ValueError("no")
    with pytest.raises(cc.WarmupError) as ei:
        cc.parallel_warm([("ok", lambda: done.append(1)), ("broken", bad),
                          ("ok2", lambda: done.append(2))], threads=3)
    assert ei.value.label == "broken" and sorted(done) == [1, 2]
    assert cc.default_warmup_threads(3) >= 1
