"""The cross-process serve seam in the port (``mxnet_tpu_torch.dist.rpc``:
``serve_engine``, ``EngineServer``, ``RpcReplica``) against the JAX
package's ``mxnet_tpu.dist.rpc``, on the CPU.

The wire is the reference's, so the two packages interoperate both
ways: the port's ``RpcReplica`` against the JAX package's own
``tests/_rpc_replica_child.py`` (unchanged), and the JAX package's
``RpcReplica`` against a port server (this file run as a script with
``--serve``).  Both serve ``_rpc_replica_child.py``'s MLP from its seed-0
params; the answers are held to the port's in-process ``ServeEngine``
within 1e-5 (float32 products in other orders).  The killed-host and
draining-restart scenarios of ``tests/test_dist_mesh.py:230-345`` run on
the port: the port's ``ServeRouter`` over port servers, 0 dropped.

Every child is killed by its fixture; each scenario carries the
deadlines of its own waits.  This file's top level imports neither jax
nor the JAX package: the port's child processes run it as a script.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from mxnet_tpu_torch.analysis.pytest_plugin import (  # noqa: E402,F401
    _mxnet_analysis_guard)  # the port's leak guard and lock recorder

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
AUTHKEY = "dist-mesh-test-key"
IN_DIM, HID, CLASSES = 6, 8, 3          # tests/_rpc_replica_child.py
TOL = 1e-5


def engine(mx, seed=0, name="local-ref"):
    """``_rpc_replica_child.py``'s engine in the port, on the CPU."""
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=HID, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(seed)
    params = {"fc1_weight": rng.randn(HID, IN_DIM).astype(np.float32),
              "fc1_bias": np.zeros(HID, np.float32),
              "fc2_weight": rng.randn(CLASSES, HID).astype(np.float32),
              "fc2_bias": np.zeros(CLASSES, np.float32)}
    return mx.serve.ServeEngine(
        net, params, {"data": (1, IN_DIM), "softmax_label": (1,)},
        batch_buckets=(1, 2, 4), max_delay_ms=2.0, name=name,
        dev_type="cpu")


def serve_main(seed: int) -> None:
    """The port's child: the engine behind ``serve_engine`` (authkey from
    ``MXNET_DIST_RPC_AUTHKEY``), ``RPC_READY <port>``, then park."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.dist.rpc import serve_engine
    server = serve_engine(engine(mx, seed, name="rpc-child"))
    print("RPC_READY %d" % server.port, flush=True)
    server.join()


def _spawn(script, seed=0):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MXNET_DIST_RPC_AUTHKEY=AUTHKEY)
    env.pop("XLA_FLAGS", None)
    args = [sys.executable, script, "--seed", str(seed)]
    if script == HERE:
        args.append("--serve")
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    deadline = time.time() + 60
    while True:
        line = proc.stdout.readline()
        if line.startswith("RPC_READY"):
            return proc, int(line.split()[1])
        if not line or time.time() > deadline:
            proc.kill()
            raise AssertionError("rpc child never became ready: %r" % line)


@pytest.fixture()
def children():
    """spawn(which) -> (proc, port): ``which`` "port" (this file) or
    "jax" (the JAX package's child); all killed after the test."""
    procs = []

    def spawn(which="port", seed=0):
        script = HERE if which == "port" else os.path.join(
            ROOT, "tests", "_rpc_replica_child.py")
        proc, port = _spawn(script, seed)
        procs.append(proc)
        return proc, port
    yield spawn
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def _inputs():
    return np.random.RandomState(7).randn(4, IN_DIM).astype(np.float32)


def _local_answers():
    import mxnet_tpu_torch as mx
    eng = engine(mx)
    try:
        return [np.asarray(eng.predict(x, timeout=30)) for x in _inputs()]
    finally:
        eng.close()


def test_port_replica_against_the_reference_server(children):
    """The port's RpcReplica to the JAX package's own child: admission,
    answers equal to the port's in-process engine, pending_requests and
    a close over the wire."""
    from mxnet_tpu_torch.dist.rpc import RpcReplica
    _, port = children("jax")
    want = _local_answers()
    rep = RpcReplica(("127.0.0.1", port), authkey=AUTHKEY.encode())
    futs = [rep.submit(x) for x in _inputs()]
    for f, w in zip(futs, want):
        got = f.result(timeout=60)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, w, atol=TOL)
    assert rep.pending_requests() == 0 and rep.outstanding() == 0
    rep.close()


def test_reference_replica_against_a_port_server(children):
    """The JAX package's RpcReplica to a port server: numpy answers,
    typed admission errors crossing back as the reference's classes."""
    from mxnet_tpu.dist.rpc import RpcReplica
    from mxnet_tpu.serve.errors import ServeError
    proc, port = children("port")
    want = _local_answers()
    rep = RpcReplica(("127.0.0.1", port), authkey=AUTHKEY.encode())
    try:
        for x, w in zip(_inputs(), want):
            got = rep.submit(x).result(timeout=60)
            assert isinstance(got, np.ndarray)
            np.testing.assert_allclose(got, w, atol=TOL)
        with pytest.raises(ServeError):
            rep.submit(np.zeros((IN_DIM + 1,), np.float32)).result(
                timeout=60)
    finally:
        rep.close()
    # the close op closed the engine, and the child's join returned
    assert proc.wait(timeout=30) == 0


def test_rpc_killed_host_health_removed_then_restarted(children):
    """tests/test_dist_mesh.py:230 on the port: a SIGKILL'd remote
    replica is health-removed while the local one answers, and
    restart() onto a fresh host brings it back."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.dist.rpc import RpcReplica
    child, port = children("port")

    def factory(i):
        if i == 0:
            return RpcReplica(("127.0.0.1", port), authkey=AUTHKEY.encode())
        return engine(mx)

    X = _inputs()
    router = mx.serve.ServeRouter(factory, replicas=2, name="rpc-crash",
                                  unhealthy_after=2, probe_after_s=0)
    try:
        ref = router.predict(X[0], timeout=30)
        for _ in range(8):
            np.testing.assert_allclose(router.predict(X[0], timeout=30),
                                       ref, atol=TOL)
        child.kill()
        child.wait(timeout=30)
        for _ in range(12):
            np.testing.assert_allclose(router.predict(X[0], timeout=30),
                                       ref, atol=TOL)
        assert router.replica_states()[0] == "down"
        assert router.stats.report()["downs"] == 1
        _, port2 = children("port")
        router.restart(0, factory=lambda i: RpcReplica(
            ("127.0.0.1", port2), authkey=AUTHKEY.encode()), timeout=60)
        assert router.replica_states() == ["live", "live"]
        np.testing.assert_allclose(router.predict(X[0], timeout=30), ref,
                                   atol=TOL)
    finally:
        router.close()


def test_rpc_draining_restart_under_load_zero_drops(children):
    """tests/test_dist_mesh.py:283 on the port: a draining restart of a
    remote replica mid-flood drops nothing, every answer right."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.dist.rpc import RpcReplica
    ports = [children("port")[1], children("port")[1]]
    router = mx.serve.ServeRouter(
        lambda i: RpcReplica(("127.0.0.1", ports[i]),
                             authkey=AUTHKEY.encode()),
        replicas=2, name="rpc-drain")
    X = _inputs()
    results, errors = [], []
    lock = threading.Lock()
    try:
        ref = router.predict(X[0], timeout=30)

        def flood(n):
            for _ in range(n):
                try:
                    out = router.submit(X[0]).result(timeout=60)
                    with lock:
                        results.append(out)
                except Exception as e:          # noqa: BLE001
                    with lock:
                        errors.append(e)

        threads = [threading.Thread(target=flood, args=(15,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        _, port2 = children("port")
        router.restart(0, factory=lambda i: RpcReplica(
            ("127.0.0.1", port2), authkey=AUTHKEY.encode()), timeout=120)
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[:3]
        assert len(results) == 60
        for out in results:
            np.testing.assert_allclose(out, ref, atol=TOL)
        assert router.stats.report()["drains"] == 1
        assert router.replica_states() == ["live", "live"]
    finally:
        router.close()


def test_authkey_is_mandatory(monkeypatch):
    """The wire is pickle: both ends refuse to run without an authkey,
    with the reference's messages."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.dist.rpc import RpcReplica, serve_engine
    from mxnet_tpu_torch.serve.errors import ServeError
    monkeypatch.delenv("MXNET_DIST_RPC_AUTHKEY", raising=False)
    eng = engine(mx)
    try:
        with pytest.raises(ServeError, match="EngineServer needs an "
                                             "authkey"):
            serve_engine(eng)
    finally:
        eng.close()
    with pytest.raises(ServeError, match="RpcReplica needs an authkey"):
        RpcReplica(("127.0.0.1", 1))


def test_unreachable_peer_is_unavailable():
    """Nothing listening: the replica surface raises
    ServeUnavailableError, as the router's breaker expects."""
    from mxnet_tpu_torch.dist.fleet import free_port
    from mxnet_tpu_torch.dist.rpc import RpcReplica
    from mxnet_tpu_torch.serve.errors import ServeUnavailableError
    with pytest.raises(ServeUnavailableError, match="cannot reach"):
        RpcReplica(("127.0.0.1", free_port()), authkey=AUTHKEY.encode())


if __name__ == "__main__" and "--serve" in sys.argv:
    serve_main(int(sys.argv[sys.argv.index("--seed") + 1]))
