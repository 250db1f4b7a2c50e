"""The port's tuning against the JAX package's, on the CPU.

* ``Module.prepare()``, the autotune trials (``fit(autotune=True)`` and
  ``"joint"``) and rematerialization (``MXNET_BACKWARD_DO_MIRROR=1``, a
  ``force_mirroring`` attribute) leave the fit trajectory bitwise equal to
  the port's own run without them: parameters, optimizer slots, the step
  count, BatchNorm's moving statistics and the generator's state.  With
  the mirror variable set the port stays within rtol 1e-4, atol 1e-5 of
  the JAX package's run with it set, from one set of starting weights
  (the tolerance of ``test_torch_module.py``'s trajectories; Dropout at
  p=0 there, since the packages draw different streams).
* The tuning spaces (``_bucket_grids``, ``_grid_pad_waste``,
  ``_quantize_candidates``, ``_fit_space`` less ``unroll``) and the
  kernel-search classes equal the JAX package's.
* With ``measure_candidate`` patched to one cost table in both packages,
  the serve tuners (``Autotuner`` and ``JointTuner``) pick the same
  winners and write the same audit logs.
* A stored winner reloads in a fresh process with zero measurements.
* ``ServeEngine(autotune=True)`` and ``("joint")`` answer as the untuned
  engine does and as the JAX package's does.
* Kernel searches: on the CPU without ``ctx`` they raise (no fallback);
  a gate failure never wins; call-time resolution is opt-in and a stored
  winner that names no compiled instance counts as none.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.autotune import joint as jjoint
from mxnet_tpu.autotune import kernelsearch as jks
from mxnet_tpu_torch.autotune import joint as tjoint
from mxnet_tpu_torch.autotune import kernelsearch as tks
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def tune_dir(tmp_path, monkeypatch):
    """A private autotune store, the host context, no knobs set."""
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "at"))
    for k in ("MXNET_AUTOTUNE", "MXNET_SUPERSTEP", "MXNET_KERNEL_SEARCH",
              "MXNET_BACKWARD_DO_MIRROR"):
        monkeypatch.delenv(k, raising=False)
    tks._best_cache.clear()
    with tmx.cpu():
        yield str(tmp_path / "at")
    tks._best_cache.clear()


# -- trajectories ------------------------------------------------------------

def _net(pkg, p=0.3, mirror_attr=False):
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = pkg.sym.BatchNorm(x, name="bn1", fix_gamma=False)
    attr = {"force_mirroring": "true"} if mirror_attr else None
    x = pkg.sym.Activation(x, act_type="tanh", name="act1", attr=attr)
    x = pkg.sym.Dropout(x, p=p, name="drop1")
    x = pkg.sym.FullyConnected(x, num_hidden=4, name="fc2", attr=attr)
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _data(n=32):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 10).astype(np.float32)
    return X, rng.randint(0, 4, n).astype(np.float32)


def _init(pkg, sym):
    """One set of starting weights for both packages (numpy seed 5)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(8, 10),
                                                softmax_label=(8,))
    rng = np.random.RandomState(5)
    args = {n: pkg.nd.array((rng.randn(*s) * 0.3).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: pkg.nd.array(np.full(s, 0.5 if "var" in n else 0.1,
                                   np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _fit(pkg, sym, monkeypatch, mirror=False, prepare=False, autotune=None,
         epochs=2, seed=7):
    if mirror:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    pkg.random.seed(seed)
    X, y = _data()
    it = pkg.io.NDArrayIter(X, y, batch_size=8)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    args, aux = _init(pkg, sym)
    mod.init_params(arg_params=args, aux_params=aux)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    mod.init_optimizer(optimizer_params=opt)
    if prepare:
        mod.prepare()
    mod.fit(it, num_epoch=epochs, autotune=autotune, optimizer_params=opt)
    return mod


def _state(mod):
    a, x = mod.get_params()
    out = {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}
    if mod._fused is not None:
        for n, slot in mod._fused.state["opt"].items():
            from mxnet_tpu_torch.module.fused import flatten_tensors
            for i, t in enumerate(flatten_tensors(slot)):
                if isinstance(t, torch.Tensor):
                    out["opt:%s:%d" % (n, i)] = t.detach().numpy().copy()
        out["t"] = mod._fused.state["t"].numpy().copy()
    out["rng"] = tmx.random.generator("cpu").get_state().numpy().copy()
    return out


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", [
    {"mirror": True}, {"prepare": True}, {"autotune": True},
    {"autotune": "joint"}, {"mirror_attr": True}])
def test_trajectory_bitwise_with_and_without(variant, monkeypatch):
    base = _state(_fit(tmx, _net(tmx), monkeypatch))
    mirror_attr = variant.pop("mirror_attr", False)
    mod = _fit(tmx, _net(tmx, mirror_attr=mirror_attr), monkeypatch,
               **variant)
    got = _state(mod)
    _assert_bitwise(base, got)
    assert mod._fused is not None
    if variant.get("mirror"):
        assert mod._fused._remat
    if variant.get("autotune"):
        runs = tmx.autotune.recent_stats()
        assert runs[-1].source == "measured"


def test_classic_mirror_bitwise(monkeypatch):
    """The classic executors mirror node by node under the variable."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    base = _state(_fit(tmx, _net(tmx), monkeypatch))
    mod = _fit(tmx, _net(tmx), monkeypatch, mirror=True)
    assert mod._fused is None
    assert mod._exec_group.execs[0]._prog.do_mirror
    _assert_bitwise(base, _state(mod))


def _noisy_net(pkg):
    """A sampler in the graph (noise added, as a VAE draws its eps) and a
    Dropout marked ``force_mirroring``."""
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = pkg.sym.BatchNorm(x, name="bn1", fix_gamma=False)
    x = x + pkg.sym._sample_normal(shape=(8, 16), name="eps")
    x = pkg.sym.Dropout(x, p=0.3, name="drop1",
                        attr={"force_mirroring": "true"})
    x = pkg.sym.FullyConnected(x, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("fused", ["1", "0"])
def test_mirror_replays_samplers_and_nested_draws(monkeypatch, fused):
    """Under the variable the recompute takes the first run's numbers: a
    sampler's and those of a ``force_mirroring`` Dropout inside the fused
    step's checkpointed walk.  Parameters, slots, moving statistics and
    the generator's state are bitwise those of the run without it."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN", fused)
    base = _state(_fit(tmx, _noisy_net(tmx), monkeypatch))
    mod = _fit(tmx, _noisy_net(tmx), monkeypatch, mirror=True)
    assert (mod._fused is not None) == (fused == "1")
    _assert_bitwise(base, _state(mod))


@pytest.mark.parametrize("mirror_attr", [False, True])
def test_mirror_matches_jax_package(monkeypatch, mirror_attr):
    """With the variable set (and force_mirroring on two nodes) the port
    stays within the trajectory tolerance of the JAX package's run, the
    moving statistics included."""
    got = _fit(tmx, _net(tmx, p=0.0, mirror_attr=mirror_attr), monkeypatch,
               mirror=True)
    want = _fit(jmx, _net(jmx, p=0.0, mirror_attr=mirror_attr), monkeypatch,
                mirror=True)
    ga, gx = got.get_params()
    wa, wx = want.get_params()
    for d_got, d_want in ((ga, wa), (gx, wx)):
        assert set(d_got) == set(d_want)
        for k in d_got:
            np.testing.assert_allclose(d_got[k].asnumpy(),
                                       d_want[k].asnumpy(),
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                       err_msg=k)
    assert "bn1_moving_mean" in gx and not np.allclose(
        gx["bn1_moving_mean"].asnumpy(), 0.1)


def test_trials_leave_state_bitwise(monkeypatch):
    """tune_superstep and tune_fit_joint measure between snapshots: the
    state after tuning is bitwise the state before it."""
    mod = _fit(tmx, _net(tmx), monkeypatch, epochs=1)
    before = _state(mod)
    num_update = mod._optimizer.num_update
    k = tmx.autotune.tune_superstep(mod, persist=False)
    cfg = tmx.autotune.tune_fit_joint(mod, persist=False, shortlist=4)
    assert k in (1, 2, 4, 8) and cfg["unroll"] == 1
    assert mod._fused._remat is False
    _assert_bitwise(before, _state(mod))
    assert mod._optimizer.num_update == num_update


# -- tuning spaces -----------------------------------------------------------

def test_spaces_equal_the_jax_package(monkeypatch):
    for m in (1, 3, 8, 16, 12):
        assert tjoint._bucket_grids(m) == jjoint._bucket_grids(m)
        for g in tjoint._bucket_grids(m):
            assert tjoint._grid_pad_waste(g) == jjoint._grid_pad_waste(g)
    for q in (None, "", {"dtype": "int8", "ops": ("FullyConnected",)}):
        assert tjoint._quantize_candidates(q, tmx.cpu()) == \
            jjoint._quantize_candidates(q)
    assert tjoint._quantize_candidates("int8", tmx.cpu()) == \
        jjoint._quantize_candidates("int8")
    monkeypatch.setenv("MXNET_QUANTIZE_OPS", "FullyConnected,Convolution")
    assert tjoint._quantize_candidates("int8", tmx.cpu()) == \
        jjoint._quantize_candidates("int8")
    ks = list(tjoint._FIT_KS)
    assert ks == list(jjoint._FIT_KS)
    assert tjoint._fit_space(ks) == [c for c in jjoint._fit_space(ks)
                                     if c["unroll"] == 1]
    for args in ((4096, 25088, "relu", False, np.float32),
                 (10, 7, "none", True, np.float32)):
        assert tks.fc_class(*args) == jks.fc_class(*args)
    assert tks.paged_class(16, 64, True, np.float32) == \
        jks.paged_class(16, 64, True, np.float32)
    assert tks.fc_class(8, 8, "relu", False, torch.float32) == \
        jks.fc_class(8, 8, "relu", False, np.float32)


def _serve_setup(pkg):
    sym = _mlp(pkg)
    rng = np.random.RandomState(2)
    params = {"fc1_weight": rng.randn(16, 8), "fc1_bias": rng.randn(16),
              "fc2_weight": rng.randn(3, 16), "fc2_bias": rng.randn(3)}
    return sym, {k: pkg.nd.array(v.astype(np.float32))
                 for k, v in params.items()}


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = pkg.sym.Activation(x, act_type="relu", name="relu1")
    x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _cost_table(label):
    """One cost per candidate label, from its text alone."""
    fuse = "fuse=True" in label
    b = int(label.split("b=")[1]) if "b=" in label else 8
    return (1.0 + 0.37 * b + (0.0 if fuse else 0.05)) * 1e-3 + \
        (0.002 if b == 4 else 0.0)


def _patched(monkeypatch):
    import mxnet_tpu.autotune as jat
    import mxnet_tpu_torch.autotune as tat

    def fake(fn, label="", trials=3, warmup=1, setup=None, span=None):
        return _cost_table(label)
    monkeypatch.setattr(jat, "measure_candidate", fake)
    monkeypatch.setattr(jjoint, "measure_candidate", fake)
    monkeypatch.setattr(tat, "measure_candidate", fake)


def _clean_log(log):
    return [(dict((k, v) for k, v in c.items() if k != "_feat"), s)
            for c, s in log]


def test_serve_tuners_agree_on_one_cost_table(monkeypatch):
    _patched(monkeypatch)
    shapes = {"data": (8, 8), "softmax_label": (8,)}
    out = {}
    for pkg in (jmx, tmx):
        sym, params = _serve_setup(pkg)
        from importlib import import_module
        at = import_module(pkg.__name__ + ".autotune")
        dev = ("cpu", 0)
        fuse, _pipe = at.tune_serve_pipeline(sym.tojson(), params, shapes,
                                             dev=dev, persist=False)
        pipe_stats = at.recent_stats()[-1] if pkg is tmx \
            else at._kept_stats[-1]
        res = at.tune_serve_joint(sym.tojson(), params, shapes, (1, 2, 4, 8),
                                  dev=dev, persist=False)
        joint_stats = at.recent_stats()[-1] if pkg is tmx \
            else at._kept_stats[-1]
        out[pkg.__name__] = (fuse, res[:3], pipe_stats.best,
                             _clean_log(pipe_stats.trials),
                             joint_stats.best,
                             _clean_log(joint_stats.trials))
    j, t = out["mxnet_tpu"], out["mxnet_tpu_torch"]
    assert j[0] == t[0] and j[1] == t[1]
    assert j[2] == t[2] and j[3] == t[3]
    assert j[4] == t[4] and j[5] == t[5]


def test_winner_reloads_in_fresh_process(tune_dir):
    """A search's winner reloads in a fresh process with 0 measurements."""
    best = tks.search_fc(4, 24, 20, ctx=tmx.cpu())
    assert best["block_n"] in ck.FC_TILES
    code = textwrap.dedent('''
        import json
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.autotune import kernelsearch as ks
        best = ks.search_fc(4, 24, 20, ctx=mx.cpu())
        r = mx.autotune.recent_stats()[-1].report()
        print("R" + json.dumps({"best": best, "source": r["source"],
                                "calls": r["calls"]}))
    ''')
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_AUTOTUNE_DIR=tune_dir)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    rep = json.loads(res.stdout.split("R", 1)[1])
    assert rep["best"] == best and rep["source"] == "cache"
    assert rep["calls"] == {"gate": 0, "featurize": 0, "measure": 0}


# -- engines -----------------------------------------------------------------

@pytest.mark.parametrize("mode", [True, "joint"])
def test_serve_engine_autotune_answers_as_untuned(tmp_path, mode):
    sym, params = _serve_setup(tmx)
    jsym, jparams = _serve_setup(jmx)
    x = np.random.RandomState(4).randn(8).astype(np.float32)
    shapes = {"data": (1, 8), "softmax_label": (1,)}
    got = []
    for autotune in (mode, None):
        eng = tmx.serve.ServeEngine(sym, params, shapes, dev_type="cpu",
                                    batch_buckets=(1, 2, 4),
                                    autotune=autotune)
        try:
            got.append(eng.predict(x, timeout=30))
        finally:
            eng.close()
    jeng = jmx.serve.ServeEngine(jsym, jparams, shapes,
                                 batch_buckets=(1, 2, 4), autotune=mode)
    try:
        want = jeng.predict(x, timeout=30)
    finally:
        jeng.close()
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)
    runs = [s.name for s in tmx.autotune.recent_stats()]
    assert ("serve:joint" if mode == "joint" else "serve:pipeline") in runs
    assert tmx.profiler.autotune_report()
    assert "serve:" in tmx.profiler.autotune_report_str()


def test_kernel_search_without_card_raises():
    for search, args in ((tks.search_fc, (4, 24, 20)),
                         (tks.search_paged, (2, 1, 2, 8)),
                         (tks.search_flash, (1, 8, 1, 8))):
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            search(*args)


def test_gate_failure_never_wins(monkeypatch):
    real = ck.fused_fc_epilogue

    def wrong_at_32(x, w, b, act, out_scale=None, block_n=None):
        out = real(x, w, b, act, out_scale, block_n=block_n)
        return out + 1.0 if block_n == 32 else out
    monkeypatch.setattr(ck, "fused_fc_epilogue", wrong_at_32)
    before = tks.parity_fail_total()
    tks.search_fc(4, 24, 20, ctx=tmx.cpu(), shortlist=3)
    r = tmx.autotune.recent_stats()[-1].report()
    assert r["best"]["block_n"] != 32
    failed = [c for c, _s in r["trials"] if c.get("parity") is False]
    assert [c["block_n"] for c in failed] == [32]
    assert tks.parity_fail_total() == before + 1


def test_paged_search_on_host_and_call_time_resolution(monkeypatch):
    best = tks.search_paged(2, 1, 2, 8, n_blocks=9, bt=4, ctx=tmx.cpu(),
                            shortlist=5)
    assert best["part_keys"] in ck.PAGED_PART_KEYS
    r = tmx.autotune.recent_stats()[-1].report()
    assert len([c for c, s in r["trials"] if s >= 0]) == 5
    dev = torch.device("cpu")
    # stored for the probe's capacity: (9 - 1) // 2 pages of 4 keys
    assert tks.best_config(tks.paged_cap_class(4, 8, True, np.float32, 16),
                           dev) == best
    assert tks.best_config(tks.paged_cap_class(4, 8, True, np.float32, 32),
                           dev) is None
    from mxnet_tpu_torch.autotune.store import save_config
    from mxnet_tpu_torch.autotune.costmodel import COSTMODEL_VERSION
    key = tks._class_key(tks.paged_cap_class(4, 8, True, np.float32, 64),
                         dev)
    save_config(key, {"part_keys": 512}, 1e-3,
                model_version=COSTMODEL_VERSION)
    tks._best_cache.clear()
    # opt-in: without the variable the default holds
    assert ck.paged_part_keys(4, 8, True, torch.float32, 64, dev) == \
        ck.PAGED_PARTITION_KEYS
    monkeypatch.setenv("MXNET_KERNEL_SEARCH", "1")
    assert ck.paged_part_keys(4, 8, True, torch.float32, 64, dev) == 512
    # a capacity in the same pow2 bucket shares the winner; another not
    assert ck.paged_part_keys(4, 8, True, torch.float32, 48, dev) == 512
    assert ck.paged_part_keys(4, 8, True, torch.float32, 128, dev) == \
        ck.PAGED_PARTITION_KEYS
    assert ck.paged_part_keys(4, 8, True, torch.float32, 64, dev, 0) == 0
    # a stored winner that is no instance counts as none
    save_config(key, {"part_keys": 96}, 1e-3,
                model_version=COSTMODEL_VERSION)
    tks._best_cache.clear()
    assert ck.paged_part_keys(4, 8, True, torch.float32, 64, dev) == \
        ck.PAGED_PARTITION_KEYS
    with pytest.raises(tmx.MXNetError, match="part_keys"):
        ck.paged_part_keys(4, 8, True, torch.float32, 64, dev, 96)


def test_fc_call_time_resolution(monkeypatch):
    from mxnet_tpu_torch.autotune.store import save_config
    from mxnet_tpu_torch.autotune.costmodel import COSTMODEL_VERSION
    x, w = torch.zeros(2, 24), torch.zeros(20, 24)
    key = tks._class_key(tks.fc_class(20, 24, "relu", False, np.float32),
                         x.device)
    save_config(key, {"block_n": 32}, 1e-3, model_version=COSTMODEL_VERSION)
    tks._best_cache.clear()
    assert ck.fc_tile(x, w, "relu", False) == ck.FC_DEFAULT_TILE
    monkeypatch.setenv("MXNET_KERNEL_SEARCH", "1")
    assert ck.fc_tile(x, w, "relu", False) == 32
    assert ck.fc_tile(x, w, "relu", False, block_n=8) == 8
    # float16 operands have the default tile only
    xh, wh = x.half(), w.half()
    assert ck.fc_tile(xh, wh, "relu", False) == ck.FC_DEFAULT_TILE
    with pytest.raises(tmx.MXNetError, match="compiled instance"):
        ck.fc_tile(xh, wh, "relu", False, block_n=32)
    save_config(key, {"block_n": 64}, 1e-3, model_version=COSTMODEL_VERSION)
    tks._best_cache.clear()
    assert ck.fc_tile(x, w, "relu", False) == ck.FC_DEFAULT_TILE


def test_program_descriptions_cover_remat_and_mirroring(monkeypatch):
    """The fused step's description (its programs' ``fast_key``) includes
    remat, and an executor's includes mirroring: ``compile_report()``
    counts programs built both ways as two variants of one name."""
    mod = _fit(tmx, _net(tmx), monkeypatch, epochs=1)
    fused = mod._fused
    plain = fused._captures().fast_key
    assert plain.startswith("fused|")
    assert fused.set_remat(True) and not fused.set_remat(True)
    assert fused._captures().fast_key != plain
    fused.set_remat(False)
    assert fused._captures().fast_key == plain
    from mxnet_tpu_torch.compile_cache.stats import _reset_stats
    _reset_stats()
    descs = []
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        ex = _net(tmx).simple_bind(tmx.cpu(), data=(8, 10),
                                   softmax_label=(8,))
        descs.append(ex._program_desc())
        ex.precompile()
    assert descs[0] != descs[1]
    per = tmx.profiler.compile_report()["per_program"]
    assert per["executor:fwdbwd_ones"]["variants"] == 2
    _reset_stats()
