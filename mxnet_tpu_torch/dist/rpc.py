"""Cross-host serve seam (counterpart of ``mxnet_tpu/dist/rpc.py``): the
``ServeRouter`` replica surface over a socket.

:class:`~mxnet_tpu_torch.serve.ServeRouter` balances over objects that
speak the engine surface: ``submit(data, deadline_ms=...) -> Future``,
``pending_requests()``, ``outstanding()``, ``close(drain=)``.  This
module makes a replica in another process (an engine on another card or
host) speak exactly that surface, so the router's health removal,
half-open probing and draining restart hold across processes with no
change to the router:

* :func:`serve_engine` wraps a live engine in a socket server
  (``multiprocessing.connection`` framing with the HMAC authkey
  challenge, the transport and auth of the ``dist_async`` parameter
  server);
* :class:`RpcReplica` is the client proxy a router factory returns.

The semantics the router depends on are the reference's:

* **Synchronous admission.**  ``submit`` blocks for the server's
  admission ack (one round trip): a remote ``ServeOverloadError`` /
  ``ServeRequestError`` raises from ``submit`` itself, typed, as the
  in-process engine's does.
* **Typed failures.**  Server-side exceptions cross the wire as
  ``(class name, message)`` and re-raise as their ``serve.errors`` class
  (unknown names as ``ServeError``; ``InjectedFault`` crosses too, so
  chaos runs exercise the remote path).
* **Connection loss = replica down.**  A dead or unreachable peer turns
  every call into ``ServeUnavailableError`` and fails the in-flight
  futures with it; the router's breaker and half-open probe take it
  from there.

The wire is the reference's, message for message (dicts with ``op``,
``id``, ``ack``, ``done``, ``result``, ``error``, ``msg``), and results
cross as numpy only (a tensor or NDArray result is turned into numpy on
the server), so the port's ``RpcReplica`` talks to the JAX package's
``serve_engine`` and the other way round.  The timeout of a call is
``MXNET_DIST_RPC_TIMEOUT_S`` (default 30).

The authkey is mandatory (``MXNET_DIST_RPC_AUTHKEY`` for spawned
children): the wire format is pickle, so an unauthenticated listener
would run whatever a peer sent.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional, Tuple

from ..base import get_env, make_lock
from ..faults import InjectedFault
from ..serve.errors import (ServeClosedError, ServeError,
                            ServeOverloadError, ServeRequestError,
                            ServeUnavailableError)

__all__ = ["RpcReplica", "serve_engine", "EngineServer"]


def _to_wire(value):
    """A result as the wire carries it: numpy (tensors and NDArrays
    turned into host arrays), in its tuple/list/dict structure."""
    if isinstance(value, (list, tuple)):
        return type(value)(_to_wire(v) for v in value)
    if isinstance(value, dict):
        return {k: _to_wire(v) for k, v in value.items()}
    if hasattr(value, "asnumpy"):
        return value.asnumpy()
    import torch
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value

_ERROR_TYPES = {
    "ServeError": ServeError,
    "ServeClosedError": ServeClosedError,
    "ServeUnavailableError": ServeUnavailableError,
    "ServeOverloadError": ServeOverloadError,
    "ServeRequestError": ServeRequestError,
    "InjectedFault": InjectedFault,
}


def _encode_error(exc: BaseException) -> Tuple[str, str]:
    return type(exc).__name__, str(exc)


def _decode_error(name: str, msg: str) -> BaseException:
    return _ERROR_TYPES.get(name, ServeError)(msg)


def _set_result(fut: Future, value) -> None:
    """Settle tolerantly: a client-cancelled future raises
    InvalidStateError on a raw settle and kills the settling thread."""
    try:
        fut.set_result(value)
    except Exception:
        pass


def _set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except Exception:
        pass


def _rpc_timeout_s() -> float:
    """Per-call ack/reply timeout (``MXNET_DIST_RPC_TIMEOUT_S``, default
    30): a peer that accepts the connection but never answers counts as
    down, it does not wedge the router's dispatch thread forever."""
    return max(0.1, get_env("MXNET_DIST_RPC_TIMEOUT_S", 30.0, float))


# -- server ------------------------------------------------------------------
class EngineServer:
    """Socket front for one live engine (see :func:`serve_engine`)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None):
        from multiprocessing.connection import Listener
        if not authkey:
            raise ServeError(
                "EngineServer needs an authkey (the wire format is "
                "pickle; set MXNET_DIST_RPC_AUTHKEY or pass authkey=)")
        self.engine = engine
        self._listener = Listener((host, port), authkey=bytes(authkey))
        self.address = self._listener.address
        self.port = int(self.address[1])
        self._closed = False
        self._stopped = threading.Event()
        self._conn_threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-engine-accept",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError, Exception):
                if self._closed:
                    return
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="rpc-engine-conn", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn) -> None:
        wlock = make_lock("dist.rpc.server")

        def send(payload) -> None:
            with wlock:
                try:
                    conn.send(payload)
                except (OSError, EOFError, ValueError):
                    pass    # peer gone: its futures fail client-side

        try:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                op = msg.get("op")
                rid = msg.get("id")
                if op == "submit":
                    try:
                        efut = self.engine.submit(
                            msg["data"],
                            deadline_ms=msg.get("deadline_ms"),
                            **msg.get("kwargs", {}))
                    except BaseException as e:
                        name, emsg = _encode_error(e)
                        send({"id": rid, "ack": False, "error": name,
                              "msg": emsg})
                        continue
                    send({"id": rid, "ack": True})
                    efut.add_done_callback(
                        lambda f, rid=rid: self._settle(send, rid, f))
                elif op == "pending":
                    try:
                        send({"id": rid, "ack": True, "done": True,
                              "result": int(self.engine.pending_requests())})
                    except BaseException as e:
                        name, emsg = _encode_error(e)
                        send({"id": rid, "ack": False, "error": name,
                              "msg": emsg})
                elif op == "close":
                    try:
                        self.engine.close(drain=bool(msg.get("drain",
                                                             True)))
                        send({"id": rid, "ack": True, "done": True,
                              "result": None})
                    except BaseException as e:
                        name, emsg = _encode_error(e)
                        send({"id": rid, "ack": False, "error": name,
                              "msg": emsg})
                    self.close()
                    return
        finally:
            try:
                conn.close()
            except Exception:
                pass

    @staticmethod
    def _settle(send, rid, fut) -> None:
        exc = fut.exception()
        if exc is None:
            send({"id": rid, "done": True,
                  "result": _to_wire(fut.result())})
        else:
            name, msg = _encode_error(exc)
            send({"id": rid, "done": True, "error": name, "msg": msg})

    def close(self) -> None:
        """Stop accepting; running connections drain on their own."""
        self._closed = True
        try:
            self._listener.close()
        except Exception:
            pass
        self._stopped.set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until the server stops accepting (a child-process main
        parks here after printing its readiness line): until
        :meth:`close`, or a ``close`` op over the wire, which closes the
        engine first.  (Closing the listener does not wake a thread
        blocked in ``accept`` on every platform, so this waits on the
        close itself, not on the accepting thread.)"""
        self._stopped.wait(timeout)


def serve_engine(engine, host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None) -> EngineServer:
    """Expose ``engine`` on ``host:port`` (0 = OS-assigned; read
    ``server.port``).  ``authkey`` defaults to
    ``MXNET_DIST_RPC_AUTHKEY`` and is mandatory."""
    if authkey is None:
        key = get_env("MXNET_DIST_RPC_AUTHKEY", "", str)
        authkey = key.encode() if key else None
    return EngineServer(engine, host=host, port=port, authkey=authkey)


# -- client ------------------------------------------------------------------
class RpcReplica:
    """Client proxy speaking the replica surface to a remote
    :class:`EngineServer` (see module docstring).  Hand a factory
    returning these to ``ServeRouter`` and every router semantic —
    least-loaded pick, health removal, half-open probe, draining
    restart — applies to the remote host unchanged."""

    def __init__(self, address: Tuple[str, int],
                 authkey: Optional[bytes] = None):
        from multiprocessing.connection import Client
        if authkey is None:
            key = get_env("MXNET_DIST_RPC_AUTHKEY", "", str)
            authkey = key.encode() if key else None
        if not authkey:
            raise ServeError(
                "RpcReplica needs an authkey (set MXNET_DIST_RPC_AUTHKEY "
                "or pass authkey=)")
        self.address = (str(address[0]), int(address[1]))
        try:
            self._conn = Client(self.address, authkey=bytes(authkey))
        except (OSError, EOFError, ValueError) as e:
            raise ServeUnavailableError(
                "cannot reach remote replica at %s:%d (%s)"
                % (self.address[0], self.address[1], e))
        self._lock = make_lock("dist.rpc.client")
        self._acks = {}       # id -> Future settling at admission
        self._results = {}    # id -> Future settling at completion
        self._ops = {}        # id -> op name (submit results settle async)
        self._next_id = 0
        self._dead: Optional[BaseException] = None
        self._closed = False
        # submit-result futures carry ROUTER callbacks (_on_settle needs
        # the router's cv).  Settling them on the reader thread deadlocks:
        # a drain loop holding that cv round-trips pending_requests(),
        # whose reply the reader can never reach while it is blocked
        # inside the callback.  So the reader hands submit results to a
        # dedicated settler thread and only settles internal round-trips
        # (acks, pending, close) inline.
        self._settle_q = []
        self._settle_cv = threading.Condition(make_lock("dist.rpc.settle"))
        self._reader_done = False
        self._settler = threading.Thread(target=self._settle_loop,
                                         name="rpc-replica-settler",
                                         daemon=True)
        self._settler.start()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="rpc-replica-reader",
                                        daemon=True)
        self._reader.start()

    # -- wire ----------------------------------------------------------------
    def _settle_async(self, fut: Future, result=None,
                      exc: Optional[BaseException] = None) -> None:
        with self._settle_cv:
            self._settle_q.append((fut, result, exc))
            self._settle_cv.notify_all()

    def _settle_loop(self) -> None:
        while True:
            with self._settle_cv:
                while not self._settle_q and not self._reader_done:
                    self._settle_cv.wait(0.2)
                if not self._settle_q:
                    return                  # reader gone, queue drained
                fut, result, exc = self._settle_q.pop(0)
            if fut.done():
                continue
            if exc is not None:
                _set_exception(fut, exc)
            else:
                _set_result(fut, result)

    def _read_loop(self) -> None:
        try:
            while True:
                try:
                    msg = self._conn.recv()
                except (EOFError, OSError, ValueError) as e:
                    self._fail_all(ServeUnavailableError(
                        "remote replica %s:%d connection lost (%s)"
                        % (self.address[0], self.address[1],
                           e or "EOF")) if not self._closed
                        else ServeClosedError("replica proxy closed"))
                    return
                rid = msg.get("id")
                with self._lock:
                    ack = self._acks.pop(rid, None)
                if "ack" in msg:
                    if msg["ack"]:
                        if ack is not None:
                            _set_result(ack, True)
                    else:
                        err = _decode_error(msg.get("error", "ServeError"),
                                            msg.get("msg", ""))
                        with self._lock:
                            self._results.pop(rid, None)
                            self._ops.pop(rid, None)
                        if ack is not None:
                            _set_exception(ack, err)
                    if not msg.get("done"):
                        continue
                if msg.get("done"):
                    with self._lock:
                        res = self._results.pop(rid, None)
                        op = self._ops.pop(rid, None)
                    if res is None:
                        continue
                    exc = _decode_error(msg["error"], msg.get("msg", "")) \
                        if "error" in msg else None
                    if op == "submit":
                        self._settle_async(res, msg.get("result"), exc)
                    elif exc is not None:
                        _set_exception(res, exc)
                    else:
                        _set_result(res, msg.get("result"))
        finally:
            with self._settle_cv:
                self._reader_done = True
                self._settle_cv.notify_all()

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            self._dead = self._dead or exc
            acks = list(self._acks.values())
            results = list(self._results.values())
            self._acks.clear()
            self._results.clear()
            self._ops.clear()
        for f in acks:
            if not f.done():
                _set_exception(f, exc)
        for f in results:
            # through the settler: these may carry router callbacks
            self._settle_async(f, exc=exc)

    def _send(self, payload) -> None:
        if self._dead is not None:
            raise _decode_error(type(self._dead).__name__,
                                str(self._dead))
        try:
            with self._lock:
                self._conn.send(payload)
        except (OSError, EOFError, ValueError) as e:
            err = ServeUnavailableError(
                "remote replica %s:%d unreachable (%s)"
                % (self.address[0], self.address[1], e))
            self._fail_all(err)
            raise err

    def _call(self, op: str, **fields):
        """Round-trip op: send, wait for the typed reply."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            ack: Future = Future()
            res: Future = Future()
            self._acks[rid] = ack
            self._results[rid] = res
            self._ops[rid] = op
        self._send(dict(fields, op=op, id=rid))
        return rid, ack, res

    # -- the replica surface -------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None,
               **kwargs) -> Future:
        """Admission-synchronous remote submit: blocks for the server
        ack (remote overload/malformed raise HERE, typed); returns the
        Future of the remote result."""
        rid, ack, res = self._call("submit", data=data,
                                   deadline_ms=deadline_ms,
                                   kwargs=kwargs)
        try:
            ack.result(timeout=_rpc_timeout_s())
        except (TimeoutError, FutureTimeout):
            with self._lock:
                self._acks.pop(rid, None)
                self._results.pop(rid, None)
                self._ops.pop(rid, None)
            raise ServeUnavailableError(
                "remote replica %s:%d did not ack within %.1fs"
                % (self.address[0], self.address[1], _rpc_timeout_s()))
        return res

    def pending_requests(self) -> int:
        if self._dead is not None:
            # a dead peer must look IDLE, not infinitely loaded: the
            # router's least-loaded pick then selects it, the submit
            # raises typed, and the health breaker removes it — the
            # same observable path as an in-process engine closed
            # underneath the router
            return 0
        rid, ack, res = self._call("pending")
        try:
            return int(res.result(timeout=_rpc_timeout_s()))
        except (TimeoutError, FutureTimeout):
            raise ServeUnavailableError(
                "remote replica %s:%d pending_requests timed out"
                % (self.address[0], self.address[1]))

    def outstanding(self) -> int:
        """Locally-tracked in-flight count (admitted, not settled)."""
        with self._lock:
            return len(self._results)

    def close(self, drain: bool = True) -> None:
        """Close the REMOTE engine (drain semantics forwarded), then the
        connection.  Safe on a dead peer (already-down = already
        closed)."""
        if self._closed:
            return
        self._closed = True
        try:
            rid, ack, res = self._call("close", drain=bool(drain))
            res.result(timeout=_rpc_timeout_s())
        except (ServeError, InjectedFault, TimeoutError, FutureTimeout):
            pass
        try:
            self._conn.close()
        except Exception:
            pass
