"""The port's processes that train together (``dist.boot``, the
``dist_sync`` and ``dist_async`` kvstores, ``ps.py``,
``kvstore_server.py``) against the JAX package's, on the CPU.

* The boot: the backend rule on the CPU, a world-1 group on first use
  of a mesh, the names of ROADMAP.md queue 1 item 10c raising.
* ``dist_sync``: the kvstore arithmetic of the reference's
  ``test_dist_sync_arithmetic_single_process`` / nightly
  ``dist_sync_kvstore.py`` at 2 and 4 ranks (exact), and
  ``Module.fit(kvstore="dist_sync")`` at 2 ranks, each fed its half of
  every global batch, against one rank fed the global batches (params
  and moving statistics within 1e-5), also under
  ``MXNET_SHARD_WEIGHT_UPDATE=1``.  The ranks are gloo processes
  (``dist.spawn.run_ranks``, the launcher's envs over a FileStore).
* ``dist_async``: ``tools/launch.py -n 2 -s 2`` runs a port script whose
  workers converge on the nightly MLP (``tests/nightly/dist_async_mlp.py``'s
  width and 0.90 accuracy bound); a worker that dies fails the job fast;
  a worker that never calls ``close()`` exits cleanly; the async store's
  arithmetic (accumulate, striped, server optimizer).  The placement
  arithmetic equals the JAX package's on the same arguments.  Port
  workers against a JAX-package scheduler and server (``import
  mxnet_tpu`` under ``DMLC_ROLE``) pull what JAX-package workers pull:
  the wire is the same.

Every multi-process test has its own timeout and kills its children in
a ``finally``; ports come from ``bind(0)``.  This file's top level
imports neither jax nor the JAX package, so the rank and role processes
load it without them.
"""
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import ps as tps

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
SHAPE = (2, 3)
BIG = (1200, 1200)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the boot -------------------------------------------------------------------

@pytest.fixture
def world1():
    from mxnet_tpu_torch.dist import boot
    yield boot
    boot.shutdown()


def test_backend_rule_on_the_cpu(monkeypatch):
    from mxnet_tpu_torch.dist import boot
    assert boot.choose_backend(4, 4) == ("gloo", "no card: gloo on the CPU")
    monkeypatch.setenv("MXNET_DIST_CPU_COLLECTIVES", "none")
    with pytest.raises(tmx.MXNetError, match="without collectives"):
        boot.choose_backend(2, 2)
    assert boot.choose_backend(1, 1)[0] == "gloo"


@pytest.mark.parametrize("ranks,cards,want", [(2, 2, "nccl"), (4, 8, "nccl"),
                                              (2, 1, "gloo"), (4, 2, "gloo")])
def test_backend_rule_with_cards(monkeypatch, ranks, cards, want):
    """With cards (mocked): NCCL when every rank of the host has its own,
    gloo when ranks share one."""
    from mxnet_tpu_torch.dist import boot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert boot.choose_backend(ranks, ranks)[0] == want


@pytest.mark.parametrize("backend,world,local,asked,want", [
    ("nccl", 2, 1, 0, 1),       # the default gpu(0) is this rank's card
    ("nccl", 2, 1, 1, 1),
    ("nccl", 4, 3, 0, 3),
    ("nccl", 1, 0, 2, 2),       # world 1: the card asked for
    ("gloo", 2, 1, 0, 0),       # ranks sharing a card keep gpu(i)
    ("nccl", 4, 1, 2, None),    # another rank's card raises
])
def test_rank_card_under_a_group(monkeypatch, backend, world, local, asked,
                                 want):
    """Under an NCCL group of several ranks a CUDA context resolves to
    this rank's card (the card ``boot`` set), so the fused step of
    ``fit(mesh=)`` / ``fit(kvstore="dist_sync")`` with the default
    ``gpu(0)`` computes there; the card count is mocked."""
    from mxnet_tpu_torch import context as tctx
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.module.fused import FusedTrainStep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tctx, "_USED_CUDA", set())
    monkeypatch.setitem(boot._state, "backend", backend)
    monkeypatch.setitem(boot._state, "local_rank", local)
    monkeypatch.setattr(boot, "world_size", lambda: world)
    monkeypatch.setattr(boot, "rank", lambda: local)
    if want is None:
        with pytest.raises(tmx.MXNetError, match="whose card is gpu\\(1\\)"):
            tmx.gpu(asked).torch_device()
        return
    assert tmx.gpu(asked).torch_device() == torch.device("cuda", want)
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(data, num_hidden=3,
                                                       name="fc"),
                                name="softmax")
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    step = FusedTrainStep(net, tmx.gpu(asked), ["data"], ["softmax_label"],
                          ["fc_weight", "fc_bias"], [], opt)
    assert step.device == torch.device("cuda", want)
    assert tctx.used_cuda_devices() == [want]


def test_world1_group_on_first_use_of_a_mesh(world1):
    """make_mesh("dp=1") works in a process that never called the
    launcher: the axis boots a world-1 gloo group (a HashStore) whose
    collectives run; the backend line says so."""
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel import collectives as C
    world1.shutdown()       # a group another test of this process left
    mesh = tmx.parallel.make_mesh("dp=1")
    assert not dist.is_initialized()
    ax = mesh.axis("dp")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert (ax.size, ax.index, ax.ranks) == (1, 0, (0,))
    x = torch.arange(4.0)
    assert torch.equal(C.all_reduce(x, ax), x)
    assert torch.equal(C.all_gather(x, ax), x)
    assert torch.equal(C.ring_shift(x, ax), x)
    line = world1.describe()
    assert "rank 0 of 1, backend gloo" in line and "world 1" in line
    kv = tmx.kv.create("dist_sync")
    kv.init(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    kv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()) * 2)
    out = tmx.nd.zeros(SHAPE, ctx=tmx.cpu())
    kv.pull(3, out=out)
    assert (out.asnumpy() == 3).all()   # dist pushes accumulate
    kv.barrier()


@pytest.mark.parametrize("name", ["FleetSupervisor", "RpcReplica",
                                  "search_sharding",
                                  "fleet_multichip_report"])
def test_later_dist_names_raise(name):
    """Every name of the reference's dist package loads lazily and works:
    the fleet and the serve seam, the sharding search and the fleet
    report (none raises any more)."""
    obj = getattr(tmx.dist, name)
    assert obj.__name__ == name
    if name == "fleet_multichip_report":
        assert obj([]) == {"hosts": {}, "fleet": {"hosts": 0,
                                                  "reporting": 0}}
    elif name == "search_sharding":
        assert tmx.dist.resolve_auto.__module__ == \
            "mxnet_tpu_torch.dist.shardsearch"


def test_server_role_without_ps_env_exits_cleanly():
    env = dict(os.environ, DMLC_ROLE="server", PYTHONPATH=ROOT)
    env.pop("DMLC_PS_ROOT_URI", None)
    res = subprocess.run([sys.executable, "-c",
                          "import mxnet_tpu_torch; print('RETURNED')"],
                         env=env, capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "RETURNED" not in res.stdout
    assert "needs no server" in res.stderr


# -- dist_sync --------------------------------------------------------------------

def kv_arithmetic():
    """The nightly dist_sync arithmetic on this rank (small and big
    keys); -> (num_workers, pulled small, pulled big)."""
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        rate, nrepeat = 2, 3
        kv.init(3, tmx.nd.ones(SHAPE))
        kv.init(99, tmx.nd.ones(BIG))
        for _ in range(nrepeat):
            kv.push(3, tmx.nd.ones(SHAPE) * (kv.rank + 1) * rate)
            kv.push(99, tmx.nd.ones(BIG) * (kv.rank + 1) * rate)
        val, val2 = tmx.nd.zeros(SHAPE), tmx.nd.zeros(BIG)
        kv.pull(3, out=val)
        kv.pull(99, out=val2)
        kv.barrier()
        return kv.num_workers, kv.rank, val.asnumpy(), val2.asnumpy()


def fit_net():
    data = tmx.sym.Variable("data")
    c = tmx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                            name="conv")
    b = tmx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    a = tmx.sym.Activation(b, act_type="relu")
    f = tmx.sym.FullyConnected(tmx.sym.Flatten(a), num_hidden=3, name="fc")
    return tmx.sym.SoftmaxOutput(f, name="softmax")


def fit_dist_sync(world, rank):
    """Module.fit over 4 global batches of 16: ``world`` ranks each fed
    its rows of every batch through a ``dist_sync`` kvstore (world 1:
    the global batches, no kvstore); -> (params, rescale_grad, fused
    step stats)."""
    rng = np.random.RandomState(0)
    X = (rng.randn(64, 2, 5, 5) * 2 + 1).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.float32)
    b = 16 // world
    idx = np.concatenate([np.arange(i + rank * b, i + (rank + 1) * b)
                          for i in range(0, 64, 16)])
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X[idx], y[idx], batch_size=b)
        mod = tmx.mod.Module(fit_net(), context=tmx.cpu())
        tmx.random.seed(1)
        mod.fit(it, num_epoch=2,
                kvstore="dist_sync" if world > 1 else "local",
                initializer=tmx.init.Xavier(),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})
        a, x = mod.get_params()
        params = {k: v.asnumpy() for k, v in list(a.items())
                  + list(x.items())}
        return params, mod._optimizer.rescale_grad, \
            mod._fused.stats.report()


def rank_suite(W, shard):
    from mxnet_tpu_torch.dist import boot
    out = {"kv": kv_arithmetic(),
           "fit": fit_dist_sync(W, boot.rank())}
    if shard:
        os.environ["MXNET_SHARD_WEIGHT_UPDATE"] = "1"
        out["fit_shard"] = fit_dist_sync(W, boot.rank())
    return out


@pytest.fixture(scope="module")
def sync2():
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 2, args=(2, True), timeout=150)


@pytest.fixture(scope="module")
def sync4():
    from mxnet_tpu_torch.dist.spawn import run_ranks
    return run_ranks(HERE + ":rank_suite", 4, args=(4, False), timeout=150)


@pytest.mark.parametrize("W", [2, 4])
def test_dist_sync_arithmetic(W, sync2, sync4):
    """Pushes all-reduce over the ranks and accumulate: every rank pulls
    (n+1) n rate / 2 nrepeat + 1 exactly, small and big keys (with n=1
    the reference's test_dist_sync_arithmetic_single_process gives 7)."""
    runs = {2: sync2, 4: sync4}[W]
    num = (W + 1) * W * 2 / 2 * 3 + 1
    for r, run in enumerate(runs):
        n, rank, small, big = run["kv"]
        assert (n, rank) == (W, r)
        assert (small == num).all() and (big == num).all(), (small, num)


@pytest.mark.parametrize("key", ["fit", "fit_shard"])
def test_fit_dist_sync_matches_one_rank(sync2, key):
    """Module.fit(kvstore="dist_sync") on 2 ranks, each fed half of every
    global batch (rescale_grad 1 / (8 * 2)), equals one rank fed the
    global batches: params and BatchNorm moving statistics within 1e-5,
    also under the sharded weight update; the fused step ran (eagerly:
    gloo on the CPU)."""
    ref, rescale, _ = fit_dist_sync(1, 0)
    assert rescale == 1.0 / 16
    for run in sync2:
        params, rescale, stats = run[key]
        assert rescale == 1.0 / 16
        assert stats["eager_steps"] == 8
        for k in ref:
            assert np.abs(params[k] - ref[k]).max() < 1e-5, k


# -- dist_async ---------------------------------------------------------------------

def _port_cmd(fn, *args):
    return ("%s -c \"import mxnet_tpu_torch; from mxnet_tpu_torch.dist.spawn "
            "import load_target; load_target('%s:%s')(%s)\""
            % (sys.executable, HERE, fn, ", ".join(repr(a) for a in args)))


def _launch(cmd, workers, servers, timeout=90):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("MXNET_TPU_COORDINATOR", "DMLC_PS_ROOT_URI", "DMLC_ROLE"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
         "-n", str(workers), "-s", str(servers), "--port",
         str(_free_port()), cmd],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def make_blobs(n, dim=10, classes=4, seed=0):
    centers = np.random.RandomState(1234).randn(classes, dim) * 3
    rng = np.random.RandomState(seed)
    ys = rng.randint(classes, size=n)
    X = centers[ys] + rng.randn(n, dim) * 0.5
    return X.astype(np.float32), ys.astype(np.float32)


def async_mlp():
    """tests/nightly/dist_async_mlp.py on the port."""
    mx = tmx
    with mx.cpu():
        kv = mx.kv.create("dist_async")
        rank, nworker = kv.rank, kv.num_workers
        X, y = make_blobs(800)
        shard = len(X) // nworker
        it = mx.io.NDArrayIter(X[rank * shard:(rank + 1) * shard],
                               y[rank * shard:(rank + 1) * shard],
                               batch_size=50, shuffle=True)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=32,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=6, kvstore=kv,
                optimizer_params={"learning_rate": 0.3})
        assert mod._fused is None   # a host-side service: classic path
        Xv, yv = make_blobs(400, seed=99)
        acc = mod.score(mx.io.NDArrayIter(Xv, yv, batch_size=50),
                        "acc")[0][1]
        print("dist_async_mlp rank %d/%d final accuracy=%.4f"
              % (rank, nworker, acc))
        assert acc >= 0.90, "accuracy gate failed: %f" % acc
        kv.barrier()
        kv.close()
        print("dist_async_mlp rank %d: PASSED" % rank)


def test_dist_async_mlp_converges():
    res = _launch(_port_cmd("async_mlp"), 2, 2, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("PASSED") == 2, res.stdout + res.stderr


def async_arithmetic():
    """tests/nightly/dist_async_kvstore.py on the port."""
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = "1000"
    with tmx.cpu():
        kv = tmx.kv.create("dist_async")
        rank, nworker, nrepeat = kv.rank, kv.num_workers, 3
        shape = (4, 5)
        kv.init(3, tmx.nd.ones(shape))
        for _ in range(nrepeat):
            kv.push(3, tmx.nd.ones(shape) * (rank + 1))
        out = tmx.nd.zeros(shape)
        kv.pull(3, out=out)
        kv.barrier()
        kv.pull(3, out=out)
        expected = 1 + nrepeat * sum(r + 1 for r in range(nworker))
        assert np.allclose(out.asnumpy(), expected)
        big = (50, 60)
        kv.init(99, tmx.nd.ones(big))
        for _ in range(nrepeat):
            kv.push(99, tmx.nd.ones(big) * (rank + 1))
        big_out = tmx.nd.zeros(big)
        kv.pull(99, out=big_out)
        kv.barrier()
        kv.pull(99, out=big_out)
        assert np.allclose(big_out.asnumpy(), expected)
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, wd=0.0,
                                           rescale_grad=1.0))
        kv.init(7, tmx.nd.ones(shape))
        for _ in range(nrepeat):
            kv.push(7, tmx.nd.ones(shape))
        w = tmx.nd.zeros(shape)
        kv.pull(7, out=w)
        kv.barrier()
        kv.pull(7, out=w)
        assert np.allclose(w.asnumpy(), 1.0 - 0.1 * nrepeat * nworker,
                           atol=1e-6)
        kv.close()
        print("dist_async_kvstore rank %d: PASSED" % rank)


def test_dist_async_kvstore_arithmetic():
    res = _launch(_port_cmd("async_arithmetic"), 2, 2)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("PASSED") == 2, res.stdout + res.stderr


def async_death(mode):
    """tests/nightly/dist_async_worker_death.py on the port."""
    with tmx.cpu():
        kv = tmx.kv.create("dist_async")
        rank = kv.rank
        kv.init(7, tmx.nd.ones((4, 5)))
        kv.push(7, tmx.nd.ones((4, 5)))
        kv.pull(7, out=tmx.nd.zeros((4, 5)))
        if rank == 1:
            time.sleep(2.0)
            sys.stdout.flush()
            if mode == "raise":
                raise ValueError("simulated worker crash")
            os._exit(0)
        try:
            kv.barrier()
        except RuntimeError as e:
            print("ABORT-DETECTED rank %d: %s" % (rank, e))
            sys.stdout.flush()
            sys.exit(3)
        print("UNEXPECTED: barrier completed with a dead peer")
        sys.exit(4)


@pytest.mark.parametrize("mode", ["exit", "raise"])
def test_dist_async_worker_death_fails_fast(mode):
    t0 = time.monotonic()
    res = _launch(_port_cmd("async_death", mode), 2, 1)
    assert res.returncode != 0, res.stdout + res.stderr
    assert "aborting ps job" in res.stderr, res.stdout + res.stderr
    assert "ABORT-DETECTED rank 0" in res.stdout, res.stdout + res.stderr
    assert time.monotonic() - t0 < 60


def async_noclose():
    with tmx.cpu():
        kv = tmx.kv.create("dist_async")
        kv.init(5, tmx.nd.ones((3,)))
        kv.push(5, tmx.nd.ones((3,)))
        kv.barrier()
        print("dist_async_noclose rank %d: PASSED" % kv.rank)


def test_dist_async_clean_exit_without_close():
    res = _launch(_port_cmd("async_noclose"), 2, 1)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("PASSED") == 2, res.stdout + res.stderr
    assert "aborting ps job" not in res.stderr, res.stderr


# -- placement arithmetic -------------------------------------------------------------

def _plan(ps_mod, n, key, size):
    c = ps_mod.PSWorkerClient.__new__(ps_mod.PSWorkerClient)
    c.num_servers = n
    return c._plan(key, size)


@pytest.mark.parametrize("size,n", [(10, 3), (9, 3), (1000000, 7), (8, 8),
                                    (3, 8), (0, 4)])
def test_stripe_ranges_match_reference(size, n):
    from mxnet_tpu import ps as jps
    assert tps.stripe_ranges(size, n) == jps.stripe_ranges(size, n)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_key_to_server_matches_reference(n):
    from mxnet_tpu import ps as jps
    for key in (0, 1, 5, 9973, "embed_weight", "fc1_bias", 12345):
        assert tps.key_to_server(key, n) == jps.key_to_server(key, n)


@pytest.mark.parametrize("bound,n,key,size", [
    ("1000", 4, 7, 1000), ("1000", 4, 7, 999), ("10", 1, 3, 10 ** 6),
    ("1000", 4, 11, 0), ("2", 8, 5, 3)])
def test_plan_matches_reference(monkeypatch, bound, n, key, size):
    from mxnet_tpu import ps as jps
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", bound)
    assert _plan(tps, n, key, size) == _plan(jps, n, key, size)


# -- across packages: a port worker, a JAX-package server --------------------------

def wire_worker(pkg, out_path):
    """Init, accumulate pushes of rank-dependent values, barrier, pull:
    one small key and one striped key; saves the pulls."""
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = "1000"
    if pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import mxnet_tpu as mx
    else:
        mx = tmx
    with mx.cpu():
        kv = mx.kv.create("dist_async")
        rank = kv.rank
        # integers: the servers' sums are exact whatever order the two
        # workers' pushes arrive in
        rng = np.random.RandomState(11)
        a0 = rng.randint(-50, 50, (4, 5)).astype(np.float32)
        b0 = rng.randint(-50, 50, (40, 60)).astype(np.float32)
        kv.init(3, mx.nd.array(a0))
        kv.init("big", mx.nd.array(b0))
        for i in range(3):
            kv.push(3, mx.nd.array(a0 * (rank + 1) + i))
            kv.push("big", mx.nd.array(b0 * (rank + 2) - i))
        a, b = mx.nd.zeros((4, 5)), mx.nd.zeros((40, 60))
        # a pull rides behind this worker's pushes on every server it
        # touches: after the barrier every push has been applied
        kv.pull(3, out=a)
        kv.pull("big", out=b)
        kv.barrier()
        kv.pull(3, out=a)
        kv.pull("big", out=b)
        np.savez(out_path + ".%d.npz" % rank, a=a.asnumpy(), b=b.asnumpy())
        kv.close()


def _ps_job(server_pkg, worker_pkg, tmp, workers=2, servers=2, timeout=150):
    """scheduler + servers of ``server_pkg`` and workers of
    ``worker_pkg``, on the DMLC envs; -> the workers' pulls."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(_free_port()),
               DMLC_NUM_WORKER=str(workers), DMLC_NUM_SERVER=str(servers),
               DMLC_PS_AUTHKEY="wire-test-%d" % os.getpid(),
               MXNET_KVSTORE_BIGARRAY_BOUND="1000")
    env.pop("MXNET_TPU_COORDINATOR", None)
    serve = "import %s" % ("mxnet_tpu" if server_pkg == "jax"
                           else "mxnet_tpu_torch")
    out = os.path.join(tmp, "%s-%s" % (server_pkg, worker_pkg))
    procs = []
    try:
        for role, count in (("scheduler", 1), ("server", servers)):
            for _ in range(count):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", serve], cwd=ROOT,
                    env=dict(env, DMLC_ROLE=role),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for r in range(workers):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from mxnet_tpu_torch.dist.spawn import load_target; "
                 "load_target(%r)(%r, %r)" % (HERE + ":wire_worker",
                                              worker_pkg, out)],
                cwd=ROOT, env=dict(env, DMLC_ROLE="worker",
                                   DMLC_WORKER_ID=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1, deadline - time.monotonic()))
        logs = [p.stdout.read().decode(errors="replace")[-2000:]
                for p in procs]
        assert all(p.returncode == 0 for p in procs), logs
        return [dict(np.load(out + ".%d.npz" % r)) for r in range(workers)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()


def test_port_worker_against_reference_server():
    """Port workers pushing to and pulling from a JAX-package scheduler
    and 2 servers (one key hashed, one striped, no server optimizer) get
    the pulls of an all-JAX-package run, bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        ref = _ps_job("jax", "jax", tmp)
        got = _ps_job("jax", "port", tmp)
        mine = _ps_job("port", "port", tmp)
    for r_ref, r_got, r_mine in zip(ref, got, mine):
        for k in ("a", "b"):
            assert np.array_equal(r_got[k], r_ref[k]), k
            assert np.array_equal(r_mine[k], r_ref[k]), k
