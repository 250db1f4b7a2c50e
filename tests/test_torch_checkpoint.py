"""The port's ``checkpoint/`` against the JAX package's, on the CPU.

The cases of the reference's ``test_checkpoint.py`` outside ``feed/``
and the mesh: the commit protocol and discovery (torn and uncommitted
saves skipped), the async writer's error, retention, the stale-tmp
sweep, a bfloat16 round trip, bitwise resume on the fused and the
classic path, mid-epoch resume, the lr schedule's position, a switched
optimizer rejected, ``kill -9`` and SIGTERM in subprocesses,
``do_checkpoint(module=)``, ``Module.save_checkpoint`` and
``ServeEngine.from_checkpoint_dir``.  Inside the port resumes are bitwise.

Across the packages: a directory the JAX package writes restores in the
port with params, momentum, ``num_update``, the schedule and the cursor
equal to what was saved, and the port's continued training agrees with
the JAX package's continuing within rtol 1e-4, atol 1e-5 (float32 sums
in other orders); the same the other way round.  The models have no
random ops: the two packages' random streams differ.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.checkpoint  # noqa: F401
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch.checkpoint import layout
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    yield
    mx.faults.clear()


def _mlp(pkg=mx):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(n=80, batch=16, pkg=mx):
    rng = np.random.RandomState(0)
    X = rng.rand(n, 10).astype(np.float32)
    y = rng.randint(0, 3, n).astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=batch)


def _module(optimizer="sgd", seed=123, **opt_params):
    mx.random.seed(seed)
    it = _data()
    mod = mx.mod.Module(_mlp(), context=mx.cpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Uniform(0.1))
    opt_params.setdefault("learning_rate", 0.05)
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=list(opt_params.items()))
    return mod, it


def _step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def _params_equal(a, b):
    return all(np.array_equal(a[n].asnumpy(), b[n].asnumpy()) for n in a)


# -- commit protocol and discovery ---------------------------------------------

def test_latest_step_skips_torn_and_uncommitted(tmp_path):
    root = str(tmp_path)
    mgr = ck.CheckpointManager(root, async_save=False, keep_last_n=None)
    mgr.save(3, {"w": np.arange(4.0)}, {"epoch": 0})
    mgr.save(7, {"w": np.arange(4.0) * 2}, {"epoch": 1})
    assert ck.latest_step(root) == 7 and ck.all_steps(root) == [3, 7]
    d = os.path.join(root, ck.step_dir_name(9))
    os.makedirs(d)
    with open(os.path.join(d, layout.INDEX_FILE), "w") as f:
        f.write("{}")
    assert ck.latest_step(root) == 7
    os.makedirs(os.path.join(root, ck.step_dir_name(11) + ".tmp-999"))
    assert ck.latest_step(root) == 7
    d13 = os.path.join(root, ck.step_dir_name(13))
    os.makedirs(d13)
    with open(os.path.join(d13, layout.COMMIT_MARKER), "w") as f:
        f.write("{}")
    with open(os.path.join(d13, layout.INDEX_FILE), "w") as f:
        f.write("{ not json")
    assert ck.latest_step(root) == 7
    # the JAX package's discovery reads the same layout
    assert jmx.checkpoint.latest_step(root) == 7
    tree, meta = mgr.restore()
    assert meta["step"] == 7 and np.array_equal(tree["w"], np.arange(4.0) * 2)
    mgr.close()


def test_fault_after_rename_leaves_uncommitted_and_skipped(tmp_path):
    root = str(tmp_path)
    mgr = ck.CheckpointManager(root, async_save=False, keep_last_n=None)
    mgr.save(1, {"w": np.ones(3)}, {})
    mx.faults.install(mx.faults.Rule(
        points="checkpoint.commit@after_rename", kinds="error",
        when=lambda ctx: ctx["step"] == 2))
    with pytest.raises(mx.faults.InjectedFault, match="injected"):
        mgr.save(2, {"w": np.ones(3) * 2}, {})
    mx.faults.clear()
    assert os.path.isdir(os.path.join(root, ck.step_dir_name(2)))
    assert ck.latest_step(root) == 1
    assert mgr.stats.report()["save_failures"] == 1
    tree, _ = mgr.restore()
    assert np.array_equal(tree["w"], np.ones(3))
    mgr.close()


def test_async_writer_error_reraises_on_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), async_save=True,
                               keep_last_n=None)
    mx.faults.install(mx.faults.Rule(
        points="checkpoint.commit@shards_written", kinds="error"))
    mgr.save(1, {"w": np.ones(2)}, {})
    with pytest.raises(mx.faults.InjectedFault, match="injected"):
        mgr.wait()
    mx.faults.clear()
    mgr.save(2, {"w": torch.ones(2)}, {})
    mgr.wait()
    assert mgr.latest_step() == 2
    mgr.close()


def test_retention_keep_last_n_and_every_k(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False,
                               keep_last_n=2, keep_every_k=10)
    for step in (5, 10, 15, 20, 25):
        mgr.save(step, {"w": np.zeros(2)}, {})
    assert mgr.all_steps() == [10, 20, 25]
    mgr.close()


def test_manager_init_sweeps_stale_tmp(tmp_path):
    root = str(tmp_path)
    stale = os.path.join(root, ck.step_dir_name(4) + ".tmp-123")
    os.makedirs(stale)
    ck.CheckpointManager(root, async_save=False).close()
    assert not os.path.exists(stale)


def test_bfloat16_and_structure_roundtrip(tmp_path):
    bf = torch.arange(6.0).to(torch.bfloat16) / 3
    tree = {"a": bf, "nested": [np.float32(2.5), None, (np.arange(3),)]}
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree, {"note": "x"})
    out, meta = mgr.restore()
    assert meta["note"] == "x"
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], bf)
    assert out["nested"][1] is None
    assert isinstance(out["nested"][2], tuple)
    assert np.array_equal(out["nested"][2][0], np.arange(3))
    # the JAX package reads the port's bfloat16 bits (and its dtype tag)
    jtree, _ = jmx.checkpoint.CheckpointManager(
        str(tmp_path), async_save=False).restore()
    assert str(jtree["a"].dtype) == "bfloat16"
    np.testing.assert_array_equal(jtree["a"].astype(np.float32),
                                  bf.float().numpy())
    # a template puts leaves on its device, in its dtype
    like = {"a": torch.zeros(6, dtype=torch.float32), "nested": None}
    out2, _ = mgr.restore(like=like)
    assert out2["a"].dtype == torch.float32
    mgr.close()


# -- bitwise resume -------------------------------------------------------------

@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"momentum": 0.9}), ("adam", {})])
def test_bitwise_resume_parity_fused(tmp_path, optimizer, opt_params):
    modA, it = _module(optimizer=optimizer, **opt_params)
    assert modA._fused is not None
    batches = list(it)
    for b in batches[:2]:
        _step(modA, b)
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    ck.save_module(mgr, modA, 2)
    for b in batches[2:4]:
        _step(modA, b)
    ref, _ = modA.get_params()
    modB, _ = _module(optimizer=optimizer, seed=999, **opt_params)
    ck.restore_module(mgr, modB)
    tree, _ = mgr.restore()
    pB, _ = modB.get_params()
    for n in pB:
        assert np.array_equal(pB[n].asnumpy(), tree["params"][n]), n
    for b in batches[2:4]:
        _step(modB, b)
    assert _params_equal(ref, modB.get_params()[0])
    treeA, _ = ck.capture_train_state(modA)
    treeB, _ = ck.capture_train_state(modB)
    for n, stA in treeA["opt"].items():
        flatA = stA if isinstance(stA, tuple) else (stA,)
        stB = treeB["opt"][n]
        flatB = stB if isinstance(stB, tuple) else (stB,)
        for xa, xb in zip(flatA, flatB):
            assert torch.equal(xa, xb), n
    mgr.close()


def test_bitwise_resume_parity_classic(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_TRAIN", "0")
    modA, it = _module(momentum=0.9)
    assert modA._fused is None
    batches = list(it)
    for b in batches[:2]:
        _step(modA, b)
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    ck.save_module(mgr, modA, 2)
    for b in batches[2:4]:
        _step(modA, b)
    ref, _ = modA.get_params()
    modB, _ = _module(momentum=0.9, seed=999)
    ck.restore_module(mgr, modB)
    for b in batches[2:4]:
        _step(modB, b)
    assert _params_equal(ref, modB.get_params()[0])
    # a classic save restores into a fused module, bitwise too
    monkeypatch.delenv("MXNET_FUSED_TRAIN")
    modC, _ = _module(momentum=0.9, seed=5)
    assert modC._fused is not None
    ck.restore_module(mgr, modC)
    for b in batches[2:4]:
        _step(modC, b)
    assert _params_equal(ref, modC.get_params()[0])
    mgr.close()


def test_switched_optimizer_rejected_cleanly(tmp_path):
    modA, it = _module(optimizer="sgd", momentum=0.0)
    _step(modA, next(iter(it)))
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    ck.save_module(mgr, modA, 1)
    modB, _ = _module(optimizer="adam", seed=999)
    with pytest.raises(mx.MXNetError, match="no optimizer state"):
        ck.restore_module(mgr, modB)
    modC, _ = _module(optimizer="sgd", momentum=0.9)
    _step(modC, next(iter(_data())))
    ck.save_module(mgr, modC, 2)
    with pytest.raises(mx.MXNetError, match="structure mismatch"):
        ck.restore_module(mgr, modB)
    mgr.close()


def test_fit_resume_without_store_raises():
    mod = mx.mod.Module(_mlp(), context=mx.cpu(0))
    with pytest.raises(mx.MXNetError, match="resume"):
        mod.fit(_data(), num_epoch=1, resume=True)


def test_lr_scheduler_position_survives_resume(tmp_path):
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    modA, it = _module(momentum=0.9, lr_scheduler=sched)
    for b in list(it)[:4]:
        _step(modA, b)
    lrA = modA._optimizer.base_lr()
    assert lrA < 0.05
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    ck.save_module(mgr, modA, 4)
    sched2 = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    modB, _ = _module(momentum=0.9, seed=999, lr_scheduler=sched2)
    ck.restore_module(mgr, modB)
    assert modB._optimizer.num_update == modA._optimizer.num_update
    assert modB._optimizer.base_lr() == lrA
    mgr.close()


def test_fit_mid_epoch_resume_bitwise(tmp_path):
    import shutil
    store = str(tmp_path)
    mx.random.seed(7)
    m1 = mx.mod.Module(_mlp(), context=mx.cpu(0))
    with ck.CheckpointManager(store, save_every_steps=4,
                              keep_last_n=None) as mgr1:
        m1.fit(_data(), num_epoch=3, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
               checkpoint=mgr1)
    ref, _ = m1.get_params()
    for s in ck.all_steps(store):
        if s != 12:
            shutil.rmtree(os.path.join(store, ck.step_dir_name(s)))
    seen = []
    mx.random.seed(99)
    m2 = mx.mod.Module(_mlp(), context=mx.cpu(0))
    with ck.CheckpointManager(store, keep_last_n=None) as mgr2:
        m2.fit(_data(), num_epoch=3, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
               checkpoint=mgr2, resume=True,
               batch_end_callback=lambda p: seen.append((p.epoch,
                                                         p.nbatch)))
    assert seen[0] == (2, 2)
    assert _params_equal(ref, m2.get_params()[0])


# -- across the packages ----------------------------------------------------------

def _w0():
    rng = np.random.RandomState(21)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (8, 10)).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.uniform(-0.3, 0.3, (3, 8)).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _cross_fit(pkg, store, num_epoch, resume, every=2):
    """MLP with momentum SGD and a FactorScheduler: fit from _w0, saving
    every ``every`` batches (or resuming from ``store``)."""
    pkg.random.seed(3)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu(0))
    arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in _w0().items()}
    sched = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5)
    mgr = pkg.checkpoint.CheckpointManager(store, keep_last_n=None,
                                           save_every_steps=every)
    try:
        mod.fit(_data(pkg=pkg), num_epoch=num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "lr_scheduler": sched},
                arg_params=arg, checkpoint=mgr, resume=resume)
    finally:
        mgr.close()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _leaf_arrays(x):
    if isinstance(x, (tuple, list)):
        return [a for e in x for a in _leaf_arrays(e)]
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                       else x)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_restores_across_packages(tmp_path, writer):
    wpkg, rpkg = (jmx, mx) if writer == "jax" else (mx, jmx)
    store = str(tmp_path / "store")
    _cross_fit(wpkg, store, num_epoch=1, resume=False)
    # drop the epoch-end save: resume from step 4 (epoch 0, batch 4)
    import shutil
    shutil.rmtree(os.path.join(store, ck.step_dir_name(5)))
    assert ck.latest_step(store) == jmx.checkpoint.latest_step(store) == 4
    saved, meta = ck.CheckpointManager(store, async_save=False).restore()
    assert (meta["global_step"], meta["epoch"], meta["nbatch"]) == (4, 0, 4)
    # the reader restores exactly what was written
    rpkg.random.seed(11)
    mod = rpkg.mod.Module(_mlp(rpkg), context=rpkg.cpu(0))
    it = _data(pkg=rpkg)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(rpkg.init.Uniform(0.1))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9,
        "lr_scheduler": rpkg.lr_scheduler.FactorScheduler(3, 0.5)})
    with rpkg.checkpoint.CheckpointManager(store, keep_last_n=None) as mgr:
        got_meta = rpkg.checkpoint.restore_module(mgr, mod)
    assert got_meta["nbatch"] == 4
    assert mod._optimizer.num_update == meta["num_update"] == 4
    assert mod._optimizer.lr_scheduler.state_dict() == meta["lr_scheduler"]
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), saved["params"][k])
    if rpkg is mx:
        for k, st in mod._fused.state["opt"].items():
            for a, b in zip(_leaf_arrays(st), _leaf_arrays(saved["opt"][k])):
                np.testing.assert_array_equal(a, b)
    # both packages continue from the directory: the same trajectory
    _, got = _cross_fit(mx, store, num_epoch=2, resume=True)
    shutil.rmtree(os.path.join(store, ck.step_dir_name(10)))
    for s in ck.all_steps(store):
        if s > 4:
            shutil.rmtree(os.path.join(store, ck.step_dir_name(s)))
    _, want = _cross_fit(jmx, store, num_epoch=2, resume=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# -- crash and preemption (subprocesses) -------------------------------------------

_CRASH_CHILD = """
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck

store = sys.argv[1]
# SIGKILL mid-save (shards on disk, no rename, no COMMIT)
mx.faults.install(mx.faults.Rule(
    points="checkpoint.commit@shards_written", kinds="crash",
    when=lambda ctx: ctx["step"] >= 5))
rng = np.random.RandomState(0)
X = rng.rand(80, 10).astype(np.float32)
y = rng.randint(0, 3, 80).astype(np.float32)
it = mx.io.NDArrayIter(X, y, batch_size=16)
mx.random.seed(123)
data = mx.sym.Variable("data")
net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
net = mx.sym.Activation(net, act_type="relu")
net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
net = mx.sym.SoftmaxOutput(net, name="softmax")
mod = mx.mod.Module(net, context=mx.cpu(0))
mgr = ck.CheckpointManager(store, save_every_steps=3, keep_last_n=None)
mod.fit(it, num_epoch=2, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        checkpoint=mgr)
sys.exit(3)   # not reached: the epoch-end save at step 5 kills the process
"""


def test_kill9_during_async_save_then_resume_bitwise(tmp_path):
    store = os.path.join(str(tmp_path), "store")
    script = os.path.join(str(tmp_path), "crash_child.py")
    with open(script, "w") as f:
        f.write(_CRASH_CHILD % {"root": ROOT})
    res = subprocess.run([sys.executable, script, store],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert res.returncode == -signal.SIGKILL, (res.returncode, res.stderr)
    assert any(".tmp-" in n for n in os.listdir(store)), os.listdir(store)
    assert ck.latest_step(store) == 3
    mx.random.seed(123)
    m_ref = mx.mod.Module(_mlp(), context=mx.cpu(0))
    m_ref.fit(_data(), num_epoch=2, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    ref, _ = m_ref.get_params()
    seen = []
    mx.random.seed(999)
    m2 = mx.mod.Module(_mlp(), context=mx.cpu(0))
    with ck.CheckpointManager(store, keep_last_n=None) as mgr2:
        m2.fit(_data(), num_epoch=2, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
               checkpoint=mgr2, resume=True,
               batch_end_callback=lambda p: seen.append((p.epoch,
                                                         p.nbatch)))
    assert seen[0] == (0, 3)
    assert _params_equal(ref, m2.get_params()[0])


_SIGTERM_CHILD = """
import sys, time
sys.path.insert(0, %(root)r)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck

store, ready = sys.argv[1], sys.argv[2]
rng = np.random.RandomState(0)
X = rng.rand(160, 10).astype(np.float32)
y = rng.randint(0, 3, 160).astype(np.float32)
it = mx.io.NDArrayIter(X, y, batch_size=16)
data = mx.sym.Variable("data")
net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
net = mx.sym.SoftmaxOutput(net, name="softmax")
mod = mx.mod.Module(net, context=mx.cpu(0))
mgr = ck.CheckpointManager(store, keep_last_n=None)
mgr.install_preemption_handler()

def on_batch(param):
    if param.nbatch == 1:
        open(ready, "w").write("ok")   # the parent sends SIGTERM now
    time.sleep(0.05)

mod.fit(it, num_epoch=10000, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1},
        checkpoint=mgr, batch_end_callback=on_batch)
print("LATEST", mgr.latest_step())
sys.exit(7 if mgr.latest_step() is not None else 8)
"""


def test_sigterm_snapshots_then_exits(tmp_path):
    store = os.path.join(str(tmp_path), "store")
    ready = os.path.join(str(tmp_path), "ready")
    script = os.path.join(str(tmp_path), "sigterm_child.py")
    with open(script, "w") as f:
        f.write(_SIGTERM_CHILD % {"root": ROOT})
    proc = subprocess.Popen([sys.executable, script, store, ready],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)
    try:
        deadline = time.time() + 180
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.communicate()[1]
            assert time.time() < deadline, "child never reached batch 1"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 7, (proc.returncode, out, err)
    step = ck.latest_step(store)
    assert step is not None
    tree, meta = ck.CheckpointManager(store).restore()
    assert meta.get("global_step") == step
    assert "params" in tree and "fc1_weight" in tree["params"]


def test_preemption_handler_needs_the_main_thread(tmp_path):
    import threading
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    errs = []

    def arm():
        try:
            mgr.install_preemption_handler()
        except mx.MXNetError as e:
            errs.append(e)
    t = threading.Thread(target=arm)
    t.start()
    t.join()
    assert errs and "main thread" in str(errs[0])
    mgr.close()


# -- the hooks ----------------------------------------------------------------------

def test_do_checkpoint_routes_through_subsystem(tmp_path):
    prefix = os.path.join(str(tmp_path), "run")
    mx.random.seed(5)
    mod = mx.mod.Module(_mlp(), context=mx.cpu(0))
    mod.fit(_data(), num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            epoch_end_callback=mx.callback.do_checkpoint(prefix, module=mod))
    _, arg, _ = mx.model.load_checkpoint(prefix, 2, ctx=mx.cpu())
    assert "fc1_weight" in arg
    assert ck.all_steps(prefix + "-ckpt") == [1, 2]
    tree, meta = ck.CheckpointManager(prefix + "-ckpt").restore()
    assert np.abs(np.asarray(tree["opt"]["fc1_weight"])).max() > 0
    assert meta["num_update"] == 10
    np.testing.assert_array_equal(tree["params"]["fc1_weight"],
                                  arg["fc1_weight"].asnumpy())


def test_module_save_checkpoint_writes_both(tmp_path):
    prefix = os.path.join(str(tmp_path), "m")
    mod, it = _module(momentum=0.9)
    for b in list(it)[:2]:
        _step(mod, b)
    mod.save_checkpoint(prefix, 2)
    assert os.path.exists("%s-symbol.json" % prefix)
    assert os.path.exists("%s-0002.params" % prefix)
    assert ck.latest_step(prefix + "-ckpt") == 2


def test_serve_engine_from_checkpoint_dir(tmp_path):
    """Answers of a ServeEngine built from the checkpoint directory equal
    a Predictor's on the legacy pair of the same step; a reload from the
    directory swaps the weights."""
    prefix = os.path.join(str(tmp_path), "run")
    mx.random.seed(5)
    mod = mx.mod.Module(_mlp(), context=mx.cpu(0))
    mod.fit(_data(), num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            epoch_end_callback=mx.callback.do_checkpoint(prefix, module=mod))
    x = np.random.RandomState(1).rand(3, 10).astype(np.float32)
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    pred = mx.Predictor(sym_json, prefix + "-0001.params",
                        {"data": (3, 10)}, dev_type="cpu")
    pred.set_input("data", x)
    pred.forward()
    want1 = pred.get_output(0)
    eng = mx.serve.ServeEngine.from_checkpoint_dir(
        prefix + "-ckpt", _mlp(), {"data": (1, 10)}, step=1,
        dev_type="cpu")
    try:
        got1 = np.stack([eng.predict(x[i]) for i in range(3)])
        np.testing.assert_array_equal(got1, want1)
        assert eng.reload_from_checkpoint_dir(prefix + "-ckpt") == 1
        pred2 = mx.Predictor(sym_json, prefix + "-0002.params",
                             {"data": (3, 10)}, dev_type="cpu")
        pred2.set_input("data", x)
        pred2.forward()
        got2 = np.stack([eng.predict(x[i]) for i in range(3)])
        np.testing.assert_array_equal(got2, pred2.get_output(0))
        assert not np.array_equal(got1, got2)
    finally:
        eng.close()


def test_load_checkpoint_missing_vs_corrupt(tmp_path):
    """The reference's test: a missing file is named with the existing
    candidates, a truncated one is reported corrupt (the port raised the
    unpacking's struct.error), in both packages."""
    prefix = os.path.join(str(tmp_path), "model")
    for pkg, kw in ((mx, {"ctx": mx.cpu()}), (jmx, {})):
        arg = {"fc1_weight": pkg.nd.array(np.ones((8, 10)))
               if pkg is jmx else mx.nd.array(np.ones((8, 10)),
                                              ctx=mx.cpu())}
        pkg.model.save_checkpoint(prefix, 3, _mlp(pkg), arg, {})
        with pytest.raises(pkg.base.MXNetError,
                           match="params file missing") as ei:
            pkg.model.load_checkpoint(prefix, 7, **kw)
        assert "0003.params" in str(ei.value)
        with pytest.raises(pkg.base.MXNetError,
                           match="symbol file missing"):
            pkg.model.load_checkpoint(
                os.path.join(str(tmp_path), "nope"), 3, **kw)
        pfile = "%s-0003.params" % prefix
        with open(pfile, "r+b") as f:
            f.truncate(10)
        with pytest.raises(pkg.base.MXNetError,
                           match="params file corrupt"):
            pkg.model.load_checkpoint(prefix, 3, **kw)
        pkg.model.save_checkpoint(prefix, 3, _mlp(pkg), arg, {})
        _, a2, _ = pkg.model.load_checkpoint(prefix, 3, **kw)
        np.testing.assert_array_equal(a2["fc1_weight"].asnumpy(),
                                      np.ones((8, 10)))


def test_profiler_checkpoint_report(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False,
                               name="report_probe")
    mgr.save(1, {"w": np.arange(1000.0)}, {})
    mgr.restore()
    report = mx.profiler.checkpoint_report()
    key = [k for k in report if k.startswith("report_probe#")]
    assert key, report
    r = report[key[0]]
    assert r["saves_committed"] == 1 and r["restores"] == 1
    assert r["last_bytes"] >= 8000 and r["last_bytes_per_s"] > 0
    assert r["last_save_s"] > 0 and r["last_restore_s"] > 0
    assert "report_probe" in mx.profiler.checkpoint_report_str()
    mgr.close()


def test_checkpoint_resume_training(tmp_path):
    """``test_module.py::test_checkpoint_resume_training`` on the port:
    train, checkpoint every epoch, reload with --load-epoch semantics,
    resume to completion."""
    rng = np.random.RandomState(0)
    centers = np.random.RandomState(42).randn(3, 6) * 3
    y = rng.randint(3, size=240)
    X = (centers[y] + rng.randn(240, 6) * 0.4).astype(np.float32)
    it = mx.io.NDArrayIter(X, y.astype(np.float32), batch_size=24,
                           shuffle=True)
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    prefix = str(tmp_path / "resume")
    ff = mx.model.FeedForward(net, ctx=mx.cpu(), num_epoch=2,
                              learning_rate=0.3)
    ff.fit(it, epoch_end_callback=mx.callback.do_checkpoint(prefix))
    assert os.path.exists(prefix + "-0002.params")
    ff2 = mx.model.FeedForward.load(prefix, 2, ctx=mx.cpu(), num_epoch=4,
                                    learning_rate=0.3)
    it.reset()
    ff2.fit(it, epoch_end_callback=mx.callback.do_checkpoint(prefix))
    assert os.path.exists(prefix + "-0004.params")
    eval_it = mx.io.NDArrayIter(X, y.astype(np.float32), batch_size=24)
    preds = ff2.predict(eval_it)
    acc = (preds.argmax(axis=1) == y[:preds.shape[0]]).mean()
    assert acc > 0.9, acc


# -- several processes (rank processes) ---------------------------------------------

MULTICHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_multichip.py")


def test_multiprocess_directory_crosses_packages(tmp_path):
    """Four gloo ranks (dp=2 x tp=2, fc1_weight cut on dim 1, the sharded
    update) save one epoch, each rank its own shards: the index records
    four processes, the JAX package's reader assembles every param
    bitwise, and two ranks of another layout (tp=2, fc1_weight cut on
    dim 0) restore it reading their slices.  The reverse: the JAX
    package's save on its dp=2 x tp=2 mesh restores into the same two
    ranks bitwise."""
    import json
    import jax
    from jax.sharding import PartitionSpec
    from mxnet_tpu_torch.dist.spawn import load_target, run_ranks
    store = str(tmp_path / "port")
    saved = run_ranks(MULTICHIP + ":ckpt_save_rank", 4, args=(store,),
                      timeout=120)
    step = ck.latest_step(store)
    d = os.path.join(store, ck.step_dir_name(step))
    with open(os.path.join(d, "index.json")) as f:
        assert json.load(f)["process_count"] == 4
    writers = {n.split(".")[-3] for n in os.listdir(d) if n.endswith(".npy")}
    assert writers == {"p0", "p1", "p2", "p3"}
    tree, _ = jmx.checkpoint.CheckpointManager(store).restore()
    for k, v in saved[0].items():
        np.testing.assert_array_equal(np.asarray(tree["params"][k]), v)
    for got, shape, t in run_ranks(MULTICHIP + ":ckpt_restore_rank", 2,
                                   args=(store,), timeout=120):
        assert shape == (4, 6) and t == 4
        for k, v in saved[0].items():
            np.testing.assert_array_equal(got[k], v)
    # the JAX package writes, the port's ranks read
    fit = load_target(MULTICHIP + ":fit")
    jstore = str(tmp_path / "jax")
    mesh = jmx.parallel.make_mesh([("dp", 2), ("tp", 2)],
                                  devices=jax.devices()[:4])
    fit(jmx, PartitionSpec, mesh, {"fc1_weight": (None, "tp")},
        num_epoch=1, checkpoint=jstore)
    jtree, _ = jmx.checkpoint.CheckpointManager(jstore).restore()
    for got, shape, t in run_ranks(MULTICHIP + ":ckpt_restore_rank", 2,
                                   args=(jstore,), timeout=120):
        assert shape == (4, 6) and t == 4
        for k in got:
            np.testing.assert_array_equal(got[k],
                                          np.asarray(jtree["params"][k]))
