"""The training supervisors in the port (``faults.Supervisor``,
``dist.FleetSupervisor``, the ``dist.host`` fault point, the profiler's
faults report) against the JAX package's ``tests/test_faults.py`` and
``tests/test_dist_mesh.py`` cases, on the CPU.

* ``tests/test_faults.py``'s supervisor cases (:226-260, :536, :560) run
  on the port with the same argv children and the same expectations.
* A 2-rank ``FleetSupervisor`` whose workers are this file run as a
  script (``--worker``): the port's ``fit(mesh=[("dp", -1)])`` on gloo
  with a checkpoint every step and ``resume=True``.  Under
  ``MXNET_FAULTS=points=dist.host@rank1,kinds=crash,after=5,max=1,
  attempts=0`` rank 1 is SIGKILL'd mid-run; the fleet is formed again
  from the latest commit and the final params are bitwise those of the
  fault-free fleet (``tests/test_dist_mesh.py:112-133``).  With
  ``on_loss="shrink"`` the second fleet has one rank, restores the
  two-rank commit and ends within 1e-5 of the fault-free params (one
  rank sums the batch's gradients in another order than two).

Each fleet carries its own ``timeout_s``; its ranks finish in seconds.
This file's top level imports neither jax nor the JAX package: the
workers run it as a script.
"""
import hashlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
CHAOS = "points=dist.host@rank1,kinds=crash,after=5,max=1,attempts=0"
FLEET_TIMEOUT_S = 90


# -- tests/test_faults.py's supervisor cases ----------------------------------

_CHILD_RC_BY_ATTEMPT = ("import os, sys; "
                        "a = int(os.environ['MXNET_FAULTS_ATTEMPT']); "
                        "sys.exit(0 if a >= %d else 1)")


def _sup(argv, **kw):
    from mxnet_tpu_torch import faults
    kw.setdefault("backoff", faults.Backoff(base_s=0.01, jitter=0.0))
    return faults.Supervisor(argv, **kw)


def test_supervisor_restarts_until_success():
    sup = _sup([sys.executable, "-c", _CHILD_RC_BY_ATTEMPT % 2],
               max_restarts=5)
    assert sup.run() == 0
    r = sup.stats.report()
    assert r["attempts"] == 3 and r["restarts"] == 2
    assert r["backoff_wait_s"] > 0 and r["last_rc"] == 0
    assert not r["gave_up"]


def test_supervisor_gives_up_after_budget():
    from mxnet_tpu_torch.base import MXNetError
    sup = _sup([sys.executable, "-c", "import sys; sys.exit(3)"],
               max_restarts=1)
    with pytest.raises(MXNetError, match="restart budget"):
        sup.run()
    r = sup.stats.report()
    assert r["gave_up"] and r["attempts"] == 2 and r["last_rc"] == 3


def test_supervisor_watchdog_kills_a_hang():
    from mxnet_tpu_torch.base import MXNetError
    sup = _sup([sys.executable, "-c", "import time; time.sleep(60)"],
               max_restarts=0, timeout_s=0.5)
    t0 = time.perf_counter()
    with pytest.raises(MXNetError, match="restart budget"):
        sup.run()
    assert time.perf_counter() - t0 < 10.0
    assert sup.stats.report()["last_rc"] == -9


def test_fork_mode_child_keeps_programmatic_plan():
    """A callable target (no CUDA in this process) runs forked; the
    child keeps the installed plan with its attempt advanced."""
    from mxnet_tpu_torch import faults
    faults.install(faults.FaultPlan([faults.Rule(
        points="fork.pt", kinds="error", attempts=[1])], seed=5))

    def target():
        try:
            faults.point("fork.pt")
        except faults.InjectedFault:
            return 0 if faults.attempt() == 1 else 9
        return 1

    try:
        sup = faults.Supervisor(target, max_restarts=3,
                                backoff=faults.Backoff(base_s=0.01,
                                                       jitter=0.0),
                                name="fork-plan")
        assert sup.run() == 0
        assert sup.stats.report()["restarts"] == 1
    finally:
        faults.clear()


def test_supervisor_stop_interrupts_backoff_and_child():
    from mxnet_tpu_torch import faults
    sup = _sup([sys.executable, "-c", "import time; time.sleep(60)"],
               max_restarts=5,
               backoff=faults.Backoff(base_s=30.0, jitter=0.0))
    threading.Timer(0.3, sup.stop).start()
    t0 = time.perf_counter()
    rc = sup.run()
    assert time.perf_counter() - t0 < 20.0
    assert rc == -9 and sup.stats.report()["restarts"] == 0


def test_faults_report_lists_plane_supervisor_and_fleet():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import faults
    faults.install("rate=0")
    try:
        sup = _sup([sys.executable, "-c", "pass"], name="rep-sup")
        fleet = mx.dist.FleetSupervisor([sys.executable, "-c", "pass"], 2,
                                        name="rep-fleet")
        kinds = {v["kind"] for v in mx.profiler.faults_report().values()}
        assert {"plane", "supervisor", "fleet"} <= kinds
        text = mx.profiler.faults_report_str()
        assert "fault plane" in text and "supervisor 'rep-sup'" in text \
            and "fleet 'rep-fleet'" in text
        assert sup.run() == 0 and fleet.run() == 0
        assert fleet.stats.report()["last_nworkers"] == 2
    finally:
        faults.clear()


def test_fleet_refusals_match_reference():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="argv list"):
        mx.dist.FleetSupervisor(lambda: 0, 2)
    with pytest.raises(MXNetError, match="on_loss"):
        mx.dist.FleetSupervisor(["x"], 2, on_loss="grow")
    with pytest.raises(MXNetError, match="nworkers"):
        mx.dist.FleetSupervisor(["x"], 0)


# -- the fleet: the port's fit on gloo ranks ----------------------------------

def worker_main(ckpt: str) -> None:
    """One rank: a deterministic MLP over ``dp=-1`` (every rank fed the
    global batch of 16), a checkpoint every step, ``resume=True``; writes
    the sha256 of its final params and exits after a barrier."""
    import mxnet_tpu_torch as mx          # joins the group from the envs
    from mxnet_tpu_torch.dist import boot
    from mxnet_tpu_torch.parallel import collectives, make_mesh
    mx.random.seed(11)
    rng = np.random.RandomState(3)
    X = rng.randn(64, 12).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(net, num_hidden=2, name="fc2"), name="softmax")
    mesh = make_mesh([("dp", -1)])
    with mx.cpu():
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=16, shuffle=False),
                num_epoch=2, kvstore=None,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                mesh=mesh, checkpoint=ckpt, checkpoint_every=1,
                resume=True)
        params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(n.encode())
        h.update(np.ascontiguousarray(params[n]).tobytes())
    r = boot.rank()
    np.savez(os.path.join(ckpt, "final_rank%d.npz" % r), **params)
    with open(os.path.join(ckpt, "final_rank%d.txt" % r), "w") as f:
        f.write(h.hexdigest())
    # no rank tears its sockets down while a peer is in a collective
    collectives.barrier(mesh.axis("dp"))
    boot.shutdown()


def _fleet(ckpt, faults=None, on_loss="rejoin"):
    """-> (the supervisor's report, {rank: sha256}, rank 0's params)."""
    import mxnet_tpu_torch as mx
    os.makedirs(ckpt, exist_ok=True)
    env = {"PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    if faults:
        env["MXNET_FAULTS"] = faults
    sup = mx.dist.FleetSupervisor(
        [sys.executable, HERE, "--worker", "--ckpt", ckpt], nworkers=2,
        on_loss=on_loss, checkpoint_dir=ckpt, timeout_s=FLEET_TIMEOUT_S,
        env=env, backoff=mx.faults.Backoff(base_s=0.05, jitter=0.0))
    assert sup.run() == 0
    finals = {}
    for name in sorted(os.listdir(ckpt)):
        if name.startswith("final_rank") and name.endswith(".txt"):
            with open(os.path.join(ckpt, name)) as f:
                finals[name[6:-4]] = f.read()
    params = dict(np.load(os.path.join(ckpt, "final_rank0.npz")))
    return sup.stats.report(), finals, params


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    return _fleet(str(tmp_path_factory.mktemp("fleet") / "ok"))


def test_fleet_sigkill_rank_bitwise_resume(tmp_path, fault_free):
    """A dist.host crash on rank 1: the fleet is formed again from the
    latest commit and lands bitwise on the fault-free run's params;
    recovery_s is recorded."""
    ok_stats, ok_finals, _ = fault_free
    assert ok_stats["attempts"] == 1 and ok_stats["restarts"] == 0
    assert sorted(ok_finals) == ["rank0", "rank1"]
    assert ok_finals["rank0"] == ok_finals["rank1"]
    stats, finals, _ = _fleet(str(tmp_path / "chaos"), faults=CHAOS)
    assert stats["restarts"] >= 1 and stats["lost_hosts"] >= 1, stats
    assert stats["recovery_s"] > 0, stats
    assert finals["rank0"] == finals["rank1"] == ok_finals["rank0"], \
        (finals, ok_finals)


def test_fleet_shrink_resumes_on_fewer_ranks(tmp_path, fault_free):
    """on_loss="shrink": the second fleet has one rank, restores the
    two-rank commit, and ends at the fault-free params within 1e-5."""
    _, _, want = fault_free
    stats, finals, got = _fleet(str(tmp_path / "shrink"), faults=CHAOS,
                                on_loss="shrink")
    assert stats["restarts"] == 1 and stats["last_nworkers"] == 1, stats
    assert sorted(finals) == ["rank0"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


if __name__ == "__main__" and "--worker" in sys.argv:
    worker_main(sys.argv[sys.argv.index("--ckpt") + 1])
    print(json.dumps({"worker": "done"}), flush=True)
