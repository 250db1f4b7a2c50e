# lint: allow-file(raw-env) — DMLC_* rendezvous vars are the
# launcher-owned wire protocol (reference ps-lite semantics: set-vs-unset
# matters, missing required vars must KeyError loudly)
"""Host-side parameter server for ``dist_async`` training (counterpart
of ``mxnet_tpu/ps.py``).

Asynchronous SGD (the server applies each worker's push at once,
workers read stale weights; reference kvstore_dist_server.h:194-202) is
a host-side service: scheduler + S servers + W workers on stdlib TCP
(``multiprocessing.connection``), launched by ``tools/launch.py -s N``
with the DMLC_* envs (``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER``,
``DMLC_PS_AUTHKEY``):

* key -> server placement: small keys by ``(key*9973) % num_servers``,
  big arrays striped contiguously across ALL servers above
  MXNET_KVSTORE_BIGARRAY_BOUND (reference kvstore_dist.h:230-268).
* per-worker push-then-pull ordering per key: both ride one FIFO TCP
  connection per (worker, server).
* server-side optimizer shipped pickled through the command channel.
* barrier via the scheduler; a role that disconnects without "stop"
  aborts the job (fail fast).

The wire is the JAX package's, byte for byte: numpy arrays in the same
message tuples under the same authkey rule, so a port worker pushes to
and pulls from a JAX-package server and the other way round.  Servers
hold numpy arrays in host RAM; the card never appears on a server.
"""
from __future__ import annotations

import logging
import os
import pickle
import threading
import zlib
from multiprocessing.connection import Client, Listener

import numpy as np

from .base import get_env, make_lock

__all__ = ["Scheduler", "PSServer", "PSWorkerClient", "run_scheduler",
           "run_server", "bigarray_bound", "key_to_server", "stripe_ranges"]

def _authkey() -> bytes:
    """Per-job connection secret. multiprocessing.connection deserializes
    pickles from any authenticated peer, so a source-code constant would be
    remote code execution for anyone who can reach a non-loopback listener.
    tools/launch.py generates DMLC_PS_AUTHKEY and passes it to every role;
    a job started without the launcher gets a loud single-host default."""
    key = os.environ.get("DMLC_PS_AUTHKEY")
    if key:
        return key.encode()
    local = ("127.0.0.1", "localhost")  # "" binds all interfaces: not local
    # servers bind DMLC_NODE_HOST, the scheduler binds DMLC_PS_ROOT_URI —
    # either being non-loopback exposes a listener
    if (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1") not in local
            or os.environ.get("DMLC_NODE_HOST", "127.0.0.1") not in local):
        logging.getLogger(__name__).warning(
            "DMLC_PS_AUTHKEY is unset on a non-loopback PS job; peers "
            "authenticate with a well-known default key. Use tools/launch.py "
            "or export a per-job secret, and never expose the PS port.")
    return b"mxnet_tpu_ps_insecure_default"


_AUTHKEY = None  # resolved lazily so the env can be set after import


def _get_authkey():
    global _AUTHKEY
    if _AUTHKEY is None:
        _AUTHKEY = _authkey()
    return _AUTHKEY


def _connect_retry(addr, timeout=None):
    """Dial with retries: roles come up in arbitrary order (each process
    pays the torch import before its listener binds), so clients must retry
    until the rendezvous window closes (reference ps-lite van retries)."""
    import time
    if timeout is None:
        timeout = get_env("MXNET_PS_CONNECT_TIMEOUT", 180.0, float)
    addr = tuple(addr) if isinstance(addr, (list, tuple)) else addr
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            return Client(addr, authkey=_get_authkey())
        except (ConnectionRefusedError, ConnectionResetError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


def _root_addr():
    uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9092"))
    return (uri, port)


def bigarray_bound() -> int:
    """Stripe threshold (reference env MXNET_KVSTORE_BIGARRAY_BOUND)."""
    return get_env("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000, int)


def _key_int(key) -> int:
    if isinstance(key, int):
        return key
    try:
        return int(key)
    except (TypeError, ValueError):
        return zlib.crc32(str(key).encode())


def key_to_server(key, num_servers: int) -> int:
    """Deterministic small-key placement (kvstore_dist.h: (key*9973)%n)."""
    return (_key_int(key) * 9973) % num_servers


def stripe_ranges(size: int, num_servers: int):
    """Contiguous near-equal ranges of a flattened big array, one per
    server (reference GetServerKeyRanges striping)."""
    step = size // num_servers
    ranges = []
    for i in range(num_servers):
        lo = i * step
        hi = (i + 1) * step if i + 1 < num_servers else size
        ranges.append((lo, hi))
    return ranges


# ---------------------------------------------------------------------------
# scheduler: rendezvous + barrier (the ps::Postoffice role)
# ---------------------------------------------------------------------------

class Scheduler:
    """Rendezvous point: servers register their listen address, workers
    fetch the server list and ranks; also implements the worker barrier
    and dead-peer detection.  A role that disconnects WITHOUT sending
    "stop" is dead (TCP EOF fires on any process death, incl. kill -9);
    the scheduler then broadcasts ("abort", reason) to every live role so
    the job fails fast with a clear message instead of hanging (the
    reference job simply hung on node death — SURVEY §5.3)."""

    def __init__(self, num_workers: int, num_servers: int, addr=None):
        self.num_workers = num_workers
        self.num_servers = num_servers
        addr = addr or _root_addr()
        self.listener = Listener(addr, authkey=_get_authkey())
        self.server_addrs = [None] * num_servers
        self._lock = make_lock("ps.scheduler_roster")
        self._servers_ready = threading.Event()
        self._barrier_conns = []
        self._worker_ranks = 0
        self._server_ranks = 0
        # conn -> (role, rank, send-lock); abort broadcast needs both the
        # roster and per-conn write serialization (replies race otherwise)
        self._roster = {}
        self._abort_reason = None

    def serve_forever(self):
        threads = []
        # one connection per role-process; scheduler exits once every worker
        # has sent "stop" and every connection closed.
        conns_expected = self.num_workers + self.num_servers
        accepted = 0
        from multiprocessing import AuthenticationError
        while accepted < conns_expected:
            try:
                conn = self.listener.accept()
            except (AuthenticationError, ConnectionResetError,
                    EOFError) as e:
                # a PER-CONNECTION handshake failure (bad authkey, stray
                # probe, peer killed mid-auth) must not consume a
                # rendezvous slot — keep accepting
                logging.getLogger(__name__).warning(
                    "scheduler: dropped a failed connection handshake "
                    "(%s)", e)
                continue
            except OSError:
                # listener-level failure: closed by _abort, fd
                # exhaustion, ... — accepting again cannot succeed
                break
            accepted += 1
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        try:
            self.listener.close()
        except OSError:
            pass
        if self._abort_reason:
            raise RuntimeError("ps job aborted: %s" % self._abort_reason)

    def _send(self, conn, msg):
        entry = self._roster.get(id(conn))
        lock = entry[2] if entry else make_lock("ps.conn_send")
        try:
            with lock:
                conn.send(msg)
        except (BrokenPipeError, OSError):
            pass

    def _abort(self, reason):
        with self._lock:
            if self._abort_reason is not None:
                return
            self._abort_reason = reason
            self._barrier_conns = []   # their conns are in the roster too
            targets = list(self._roster.values())
        logging.getLogger(__name__).error("aborting ps job: %s", reason)
        self._servers_ready.set()   # unpark reg_worker waiters (they
                                    # re-check _abort_reason after the wait)
        for entry in targets:
            self._send(entry[3], ("abort", reason))
        # unblock serve_forever if the rendezvous never completed
        try:
            self.listener.close()
        except OSError:
            pass

    def _handle(self, conn):
        role, rank = "unknown", -1
        clean_exit = False
        try:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                kind = msg[0]
                if kind == "reg_server":
                    with self._lock:
                        if self._abort_reason is not None:
                            self._send(conn, ("abort", self._abort_reason))
                            continue
                        rank = self._server_ranks
                        self._server_ranks += 1
                        self.server_addrs[rank] = msg[1]
                        role = "server"
                        self._roster[id(conn)] = (role, rank,
                                                  make_lock("ps.conn_send"), conn)
                        if all(a is not None for a in self.server_addrs):
                            self._servers_ready.set()
                    self._send(conn, ("rank", rank))
                elif kind == "reg_worker":
                    self._servers_ready.wait()   # set by _abort too
                    with self._lock:
                        if self._abort_reason is not None:
                            self._send(conn, ("abort", self._abort_reason))
                            continue
                        rank = self._worker_ranks
                        self._worker_ranks += 1
                        role = "worker"
                        self._roster[id(conn)] = (role, rank,
                                                  make_lock("ps.conn_send"), conn)
                    self._send(conn, ("servers", list(self.server_addrs),
                                      rank))
                elif kind == "barrier":
                    release = []
                    with self._lock:
                        if self._abort_reason is not None:
                            reason = self._abort_reason
                        else:
                            reason = None
                            self._barrier_conns.append(conn)
                            if len(self._barrier_conns) == self.num_workers:
                                release = self._barrier_conns
                                self._barrier_conns = []
                    if reason is not None:
                        self._send(conn, ("abort", reason))
                        continue
                    for c in release:
                        self._send(c, ("barrier_ok",))
                elif kind == "stop":
                    clean_exit = True
                    self._send(conn, ("bye",))
                    return
        finally:
            with self._lock:
                self._roster.pop(id(conn), None)
            if not clean_exit and self._abort_reason is None:
                self._abort("%s rank %d disconnected without stop "
                            "(process died?)" % (role, rank))
            conn.close()


# ---------------------------------------------------------------------------
# server: holds weights, applies updates (kvstore_dist_server.h role)
# ---------------------------------------------------------------------------

class _MainThreadExec:
    """Synchronous executor: handler threads submit closures, the server's
    MAIN thread runs them (reference kvstore_dist_server.h:28-85 Executor —
    "dedicated Executor thread so python updater runs on the RunServer
    thread").  Essential here beyond reference parity: the server loop runs
    while ``import mxnet_tpu_torch`` is still on the main thread's stack
    (kvstore_server import hijack), so any python-level work that can
    trigger an import — unpickling the optimizer, building NDArrays —
    would DEADLOCK on the package import lock if run from a handler
    thread; the main thread holds that lock reentrantly."""

    def __init__(self):
        import queue
        self._q = queue.Queue()

    def exec(self, fn):
        """Submit fn and block until the main thread has run it."""
        done = threading.Event()
        box = {}

        def task():
            try:
                box["result"] = fn()
            except BaseException as e:   # marshal errors to the caller
                box["error"] = e
            done.set()

        self._q.put(task)
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def run_until(self, stop_event):
        while not stop_event.is_set():
            task = self._q.get()
            if task is None:
                continue
            task()

    def wake(self):
        self._q.put(None)


class PSServer:
    """Async parameter server: ``push`` applies the update IMMEDIATELY per
    worker (stale-weight async SGD, kvstore_dist_server.h:194-202); without
    an updater it accumulates (the default merge ``stored += merged`` that
    the nightly arithmetic test relies on).  All mutations run serialized
    on the main thread via _MainThreadExec; handler threads only do socket
    IO and locked reads."""

    def __init__(self, num_workers: int, root=None):
        self.num_workers = num_workers
        self.store = {}
        self.updater = None
        self._lock = make_lock("ps.server_store")
        self._exec = _MainThreadExec()
        # own listen socket on an ephemeral port
        host = os.environ.get("DMLC_NODE_HOST", "127.0.0.1")
        self.listener = Listener((host, 0), authkey=_get_authkey())
        self.addr = self.listener.address
        # register with the scheduler
        sched = _connect_retry(root or _root_addr())
        sched.send(("reg_server", self.addr))
        msg = sched.recv()
        if isinstance(msg, tuple) and msg and msg[0] == "abort":
            # a peer died while we were registering
            raise RuntimeError("ps job aborted by scheduler: %s" % msg[1])
        self.rank = msg[1]
        self._sched = sched

    def serve_forever(self):
        """Run the executor on this (main) thread; accept one connection
        per worker on a helper thread; exit when all workers stopped.  A
        scheduler abort broadcast (dead peer) tears the server down and
        exits with an error instead of waiting on dead workers."""
        stop = threading.Event()
        abort_reason = []

        def acceptor():
            threads = []
            try:
                for _ in range(self.num_workers):
                    conn = self.listener.accept()
                    t = threading.Thread(target=self._handle, args=(conn,),
                                         daemon=True)
                    t.start()
                    threads.append(t)
            except (OSError, EOFError):
                pass   # listener closed by the abort monitor
            for t in threads:
                t.join()
            stop.set()
            self._exec.wake()

        def abort_monitor():
            while not stop.is_set():
                try:
                    if self._sched.poll(0.5):
                        msg = self._sched.recv()
                        if isinstance(msg, tuple) and msg and \
                                msg[0] == "abort":
                            abort_reason.append(msg[1])
                            logging.getLogger(__name__).error(
                                "server rank %d aborting: %s",
                                self.rank, msg[1])
                            stop.set()
                            self._exec.wake()
                            self.listener.close()
                            return
                except (EOFError, OSError):
                    return   # scheduler gone; acceptor/stop path decides

        accept_thread = threading.Thread(target=acceptor, daemon=True)
        accept_thread.start()
        monitor_thread = threading.Thread(target=abort_monitor, daemon=True)
        monitor_thread.start()
        self._exec.run_until(stop)
        if abort_reason:
            raise RuntimeError("ps server rank %d aborted: %s"
                               % (self.rank, abort_reason[0]))
        accept_thread.join()
        monitor_thread.join()
        self.listener.close()
        try:
            self._sched.send(("stop",))
            self._sched.recv()
            self._sched.close()
        except (EOFError, OSError):
            pass

    # the three mutators below always run on the main thread via _exec ------
    def _do_init(self, key, value):
        with self._lock:
            # rank-0 value wins: first init wins, later ignored
            if key not in self.store:
                self.store[key] = np.array(value, copy=True)

    def _apply_push(self, key, value):
        with self._lock:
            stored = self.store.get(key)
            if stored is None:
                # first push before init: treat as init (reference servers
                # lazily create entries on first push)
                self.store[key] = np.array(value, copy=True)
                return
            if self.updater is not None:
                self.updater(key, value, stored)   # in-place on stored
            else:
                stored += value

    def _command(self, head, body):
        """Command channel (reference kvstore_dist_server.h:91-135):
        head 0 carries the pickled optimizer -> become the updater."""
        if head == 0:
            from . import optimizer as opt_mod
            optimizer = pickle.loads(body)
            updater = opt_mod.get_updater(optimizer)

            def np_updater(key, grad, stored):
                # servers update on the host, whatever the machine has
                from .context import cpu
                from .ndarray import array as nd_array
                w = nd_array(stored, ctx=cpu())
                updater(_key_int(key), nd_array(grad, ctx=cpu()), w)
                stored[...] = w.asnumpy()

            with self._lock:
                self.updater = np_updater

    def _handle(self, conn):
        try:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                kind = msg[0]
                if kind == "init":
                    _, key, value = msg
                    self._exec.exec(lambda: self._do_init(key, value))
                    conn.send(("init_ok",))
                elif kind == "push":
                    # blocking exec keeps this worker's FIFO ordering while
                    # the worker itself never waits (fire-and-forget send)
                    key, value = msg[1], msg[2]
                    self._exec.exec(lambda: self._apply_push(key, value))
                elif kind == "pull":
                    with self._lock:
                        val = np.array(self.store[msg[1]], copy=True)
                    conn.send(("val", val))
                elif kind == "cmd":
                    head, body = msg[1], msg[2]
                    self._exec.exec(lambda: self._command(head, body))
                    conn.send(("cmd_ok",))
                elif kind == "stop":
                    conn.send(("bye",))
                    return
        finally:
            conn.close()


# ---------------------------------------------------------------------------
# worker-side client
# ---------------------------------------------------------------------------

class PSWorkerClient:
    """One per worker process: connections to the scheduler and to every
    server.  Push is fire-and-forget (no reply) — the python thread never
    blocks on the update, mirroring the reference's async ZPush; ordering
    per (worker, server) is the TCP FIFO."""

    def __init__(self, root=None):
        root = root or _root_addr()
        self._sched = _connect_retry(root)
        self._sched.send(("reg_worker",))
        msg = self._recv(self._sched, "scheduler registration")
        self.server_addrs = msg[1]
        self.rank = int(os.environ.get("DMLC_WORKER_ID", msg[2]))
        self.num_servers = len(self.server_addrs)
        self._conns = [_connect_retry(a) for a in self.server_addrs]
        self._locks = [make_lock("ps.worker_conn") for _ in self._conns]
        self._sched_lock = make_lock("ps.worker_sched")
        self._closed = False
        self._fatal = False
        # the stop handshake distinguishes a clean exit from a death (the
        # scheduler aborts the job on EOF-without-stop).  Most training
        # scripts never call kv.close() themselves (reference parity), so
        # make interpreter exit clean automatically.  atexit also runs
        # after an UNHANDLED EXCEPTION though — that is a crash, and must
        # reach the scheduler as one, so the excepthook marks the process
        # fatal and the handler then skips the handshake (raw EOF ->
        # dead-peer abort).  os._exit / signals skip atexit entirely and
        # are likewise detected as deaths.
        import atexit
        import sys as _sys
        prev_hook = _sys.excepthook

        def _mark_fatal(tp, val, tb):
            self._fatal = True
            prev_hook(tp, val, tb)

        _sys.excepthook = _mark_fatal
        atexit.register(self._atexit_close)

    def _atexit_close(self):
        if self._fatal:
            return   # crashed: let the EOF trigger the scheduler abort
        self.close()

    @staticmethod
    def _recv(conn, what):
        """Bounded recv: a dead server/scheduler turns into a clear error
        instead of an indefinite hang (the reference job simply hung on
        node death, SURVEY §5.3 — we can do better than that).  A
        scheduler-broadcast ("abort", reason) surfaces as RuntimeError."""
        timeout = get_env("MXNET_PS_RECV_TIMEOUT", 600.0, float)
        if not conn.poll(timeout):
            raise RuntimeError(
                "parameter-server RPC timed out after %.0fs waiting for %s "
                "(server process dead? raise MXNET_PS_RECV_TIMEOUT if not)"
                % (timeout, what))
        try:
            msg = conn.recv()
        except (EOFError, OSError) as e:
            raise RuntimeError(
                "parameter-server connection lost while waiting for %s: %s"
                % (what, e))
        if isinstance(msg, tuple) and msg and msg[0] == "abort":
            raise RuntimeError("ps job aborted by scheduler: %s" % msg[1])
        return msg

    def check_abort(self):
        """Poll the scheduler connection for a pending abort broadcast;
        raises RuntimeError if the job is being torn down.  Called from
        the data plane so a worker that never reaches another barrier
        still fails fast when a peer dies."""
        with self._sched_lock:
            if self._sched.poll(0):
                msg = self._sched.recv()
                if isinstance(msg, tuple) and msg and msg[0] == "abort":
                    raise RuntimeError(
                        "ps job aborted by scheduler: %s" % msg[1])

    @staticmethod
    def _send(conn, msg, what):
        """Clean error instead of a raw socket exception when the peer
        is gone (server torn down by a scheduler abort)."""
        try:
            conn.send(msg)
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise RuntimeError(
                "parameter-server connection lost while sending %s: %s"
                % (what, e))

    # -- placement ----------------------------------------------------------
    def _plan(self, key, size):
        """Return [(server, lo, hi)] covering the flattened value."""
        if size >= bigarray_bound() and self.num_servers > 1:
            return [(s, lo, hi) for s, (lo, hi)
                    in enumerate(stripe_ranges(size, self.num_servers))]
        return [(key_to_server(key, self.num_servers), 0, size)]

    # -- data plane ---------------------------------------------------------
    def init(self, key, value: np.ndarray):
        flat = np.ascontiguousarray(value).reshape(-1)
        for s, lo, hi in self._plan(key, flat.size):
            with self._locks[s]:
                self._send(self._conns[s], ("init", key, flat[lo:hi]),
                           "init")
                self._recv(self._conns[s], "init ack")

    def push(self, key, value: np.ndarray):
        self.check_abort()
        flat = np.ascontiguousarray(value).reshape(-1)
        for s, lo, hi in self._plan(key, flat.size):
            with self._locks[s]:
                self._send(self._conns[s], ("push", key, flat[lo:hi]),
                           "push")

    def pull(self, key, shape, dtype) -> np.ndarray:
        size = int(np.prod(shape)) if shape else 1
        out = np.empty(size, dtype)
        for s, lo, hi in self._plan(key, size):
            with self._locks[s]:
                self._send(self._conns[s], ("pull", key), "pull request")
                out[lo:hi] = self._recv(self._conns[s], "pull reply")[1]
        return out.reshape(shape)

    # -- control plane ------------------------------------------------------
    def send_command_to_servers(self, head, body):
        for s in range(self.num_servers):
            with self._locks[s]:
                self._send(self._conns[s], ("cmd", head, body), "command")
                self._recv(self._conns[s], "command ack")

    def barrier(self):
        with self._sched_lock:
            self._send(self._sched, ("barrier",), "barrier request")
            self._recv(self._sched, "barrier release")

    def close(self):
        if self._closed:
            return
        self._closed = True
        for s in range(self.num_servers):
            try:
                with self._locks[s]:
                    self._conns[s].send(("stop",))
                    self._conns[s].recv()
                    self._conns[s].close()
            except (EOFError, OSError):
                pass
        try:
            with self._sched_lock:
                self._sched.send(("stop",))
                self._sched.recv()
                self._sched.close()
        except (EOFError, OSError):
            pass


# ---------------------------------------------------------------------------
# role entry points (invoked from kvstore_server on import, launch.py)
# ---------------------------------------------------------------------------

def _require_env(*names):
    missing = [n for n in names if not os.environ.get(n)]
    if missing:
        raise RuntimeError(
            "parameter-server role needs %s in the environment (set by "
            "tools/launch.py -s N; see docs/multi_node.md)"
            % ", ".join(missing))


def run_scheduler():
    _require_env("DMLC_NUM_WORKER", "DMLC_NUM_SERVER")
    num_workers = int(os.environ["DMLC_NUM_WORKER"])
    num_servers = int(os.environ["DMLC_NUM_SERVER"])
    logging.info("ps scheduler: %d workers, %d servers", num_workers,
                 num_servers)
    Scheduler(num_workers, num_servers).serve_forever()


def run_server():
    _require_env("DMLC_NUM_WORKER")
    num_workers = int(os.environ["DMLC_NUM_WORKER"])
    server = PSServer(num_workers)
    logging.info("ps server rank %d listening on %s", server.rank,
                 server.addr)
    server.serve_forever()
