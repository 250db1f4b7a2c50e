"""ServeEngine: batch buckets + dynamic batching + hot reload on the card
(counterpart of ``mxnet_tpu/serve/engine.py``).

The engine binds one executor per batch bucket over a Predictor (all
buckets share one set of parameter buffers on the device), warms each
bucket by running it once, and serves ``submit()`` calls through a
micro-batcher that coalesces concurrent requests into the smallest
bucket that fits, padding the tail rows.  The dispatcher thread runs a
batch and starts the device-to-host copy into pinned memory; the
completion thread waits for that copy while the next batch runs.

``reload(...)`` swaps weights under the lock the dispatcher holds while
running a batch, so each batch runs entirely under one weights version;
with a quantizing pipeline, fresh float32 weights are re-quantized.

It runs on ``gpu(dev_id)`` unless ``dev_type="cpu"`` is asked for.
``quantize=``, ``u8_wire=`` or ``fuse=`` build the serving pass pipeline
(u8 wire, fold, CSE, DCE, quantize, MoE parity, epilogue and elementwise
fusion; fusion is on unless ``fuse=False``); with none of them the
graph is served as loaded, as the JAX package does::

    eng = ServeEngine.from_checkpoint(
        "vgg16", 0, {"data": (1, 224, 224, 3), "softmax_label": (1,)},
        quantize="int8", calib_data=sample_u8_images,
        u8_wire={"mean": 117.0, "scale": 1 / 58.0, "hwc": True})
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace as _trace
from ..base import get_env, make_rlock
from ..context import Context
from ..faults import point as _fault_point
from ..passes.embed import default_embed_dedup
from ..passes.quantize import build_serving_pipeline
from ..predictor import Predictor, load_checkpoint_pair
from .batcher import MicroBatcher
from .errors import ServeError, ServeRequestError
from .stats import ServeStats

__all__ = ["ServeEngine", "default_buckets", "exec_device_bytes"]


def default_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two batch buckets up to (and including) max_batch_size."""
    if max_batch_size < 1:
        raise ServeError("max_batch_size must be >= 1, got %d"
                         % max_batch_size)
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return tuple(buckets)


class ServeEngine:
    """Dynamic-batching inference server over a Predictor.

    ``input_shapes`` names every input with a leading batch dim (a
    template: the engine rebinds dim 0 to each bucket); a request is one
    item of ``input_shapes[data_name][1:]`` and the other inputs (labels)
    are zero-filled.  ``batch_buckets`` defaults to the power-of-two grid
    up to ``MXNET_SERVE_MAX_BATCH`` (8); ``max_delay_ms``,
    ``queue_depth`` and ``deadline_ms`` default from
    ``MXNET_SERVE_MAX_DELAY_MS`` (2), ``MXNET_SERVE_QUEUE_DEPTH`` (4x max
    batch) and ``MXNET_SERVE_DEADLINE_MS`` (1000; 0 disables).

    ``quantize=`` takes ``"int8"`` (with ``calib_data``: a sample of
    requests in wire format, item-stacked; the engine calibrates on it
    at the largest bucket's shapes, on its own device), ``"float16"``/
    ``"bfloat16"`` (a pure precision rewrite), or a dict of QuantizePass
    kwargs (``{"calib": table, "skip": ("fc6",)}``).  ``u8_wire=`` (True
    or ``{"mean":, "scale":, "hwc":}``) moves the cast/normalize prologue
    into the graph and retypes the data input to uint8.  ``pipeline=``
    overrides with a pre-built PassPipeline.

    ``embed_dedup=`` (True, or an int unique cap; None reads
    ``MXNET_EMBED_DEDUP``) rewrites Embedding lookups to the deduped
    ``_sparse_embedding``, under which padded ids read zero vectors.

    ``mesh`` / ``param_specs`` (reference engine.py:87-96, 150-212,
    279-363): a named mesh (``parallel.make_mesh``, an axes list or
    ``"tp=2"``) and per-parameter PartitionSpecs.  Every bucket's
    executor is placed on the mesh (``Executor.set_mesh``): each rank
    holds its shards of the weights, a padded batch is cut over ``dp``
    when ``dp`` divides the bucket and replicated otherwise, and a
    reload lands each weight back in its shard.  ``param_specs`` without
    ``mesh`` raises.

    A recorded difference from the JAX package, whose engine is one
    process driving every device: in the port every rank of the mesh
    constructs the engine with the same arguments (``tools/launch.py``
    starts the same script on each).  The mesh's first rank is the
    front: ``submit``, ``predict`` and the batcher.  Each other rank
    runs a follower thread that receives every batch from the front (the
    bucket and the padded batch, by broadcast), runs the same forward
    and drops its output; ``submit``/``predict`` raise there.  A reload
    is called on every rank too, and each rank applies it when the front
    does; a follower's ``close()`` returns once the front has closed.

    ``autotune=True`` (or ``MXNET_AUTOTUNE=1``) picks fusion on or off
    by measuring (``autotune.tune_serve_pipeline``); ``"joint"`` searches
    fusion x bucket grid x quantize op set
    (``autotune.tune_serve_joint``; an explicit ``batch_buckets`` pins
    the grid).  An explicit ``pipeline=`` or ``fuse=`` wins over both.
    The winner persists, and a fresh process loads it without measuring.

    Warm-up (``warmup=True``, on the dispatcher thread as the engine
    starts): each bucket runs once through the batch path, counted as
    its program's build in ``compile_report()``; a failure names its
    bucket.
    """

    def __init__(self, symbol, params: Dict,
                 input_shapes: Dict[str, Tuple[int, ...]], *,
                 data_name: Optional[str] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 output_index: int = 0,
                 dev_type: str = "gpu", dev_id: int = 0,
                 type_dict: Optional[Dict] = None,
                 name: str = "serve", warmup: bool = True,
                 mesh=None, param_specs: Optional[Dict] = None,
                 quantize=None, calib_data=None, u8_wire=None,
                 fuse=None, pipeline=None, autotune=None,
                 embed_dedup=None):
        if param_specs and mesh is None:
            raise ServeError("param_specs without mesh=: specs are "
                             "PartitionSpecs over a named mesh")
        if not input_shapes:
            raise ServeError("input_shapes must name at least one input")
        sym_json = symbol.tojson() if hasattr(symbol, "tojson") else symbol
        explicit_buckets = batch_buckets is not None
        if batch_buckets is None:
            batch_buckets = default_buckets(
                get_env("MXNET_SERVE_MAX_BATCH", 8, int))
        self._buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if not self._buckets or self._buckets[0] < 1:
            raise ServeError("batch_buckets must be positive ints, got %r"
                             % (batch_buckets,))
        self.max_batch_size = self._buckets[-1]
        if max_delay_ms is None:
            max_delay_ms = get_env("MXNET_SERVE_MAX_DELAY_MS", 2.0, float)
        if queue_depth is None:
            queue_depth = get_env("MXNET_SERVE_QUEUE_DEPTH",
                                  4 * self.max_batch_size, int)
        if deadline_ms is None:
            deadline_ms = get_env("MXNET_SERVE_DEADLINE_MS", 1000.0, float)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_depth = int(queue_depth)
        self.deadline_ms = float(deadline_ms) or None
        self._shapes_tpl = {k: tuple(v) for k, v in input_shapes.items()}
        if data_name is None:
            data_name = "data" if "data" in self._shapes_tpl \
                else next(iter(self._shapes_tpl))
        if data_name not in self._shapes_tpl:
            raise ServeError("data_name %r not in input_shapes %s"
                             % (data_name, sorted(self._shapes_tpl)))
        self.data_name = data_name
        self.item_shape = self._shapes_tpl[data_name][1:]
        self._output_index = int(output_index)
        self.name = name
        self.weights_version = 0
        # serializes batch execution against weight swaps; an RLock so
        # reload() and pause() nest on one thread.  _pause_owner guards
        # close() inside pause(), which would wait on this lock forever
        self._swap_lock = make_rlock("serve.engine_swap")
        self._pause_owner: Optional[int] = None
        # RLock: a future's done-callback may close() again inline on the
        # closing thread
        self._close_lock = make_rlock("serve.engine_close")
        self._shapes_by_bucket = {b: {k: (b,) + v[1:]
                                      for k, v in self._shapes_tpl.items()}
                                  for b in self._buckets}
        from ..autotune import mode as _autotune_mode
        autotuned = False
        amode = _autotune_mode(autotune) \
            if pipeline is None and fuse is None else None
        if amode == "joint":
            from ..autotune import tune_serve_joint
            fuse, win_buckets, quantize, pipeline = tune_serve_joint(
                sym_json, params, self._shapes_tpl, self._buckets,
                data_name=data_name, quantize=quantize,
                calib_data=calib_data, u8_wire=u8_wire,
                dev=(dev_type, dev_id), name=name,
                explicit_buckets=explicit_buckets)
            if win_buckets != self._buckets:
                self._buckets = win_buckets
                self.max_batch_size = self._buckets[-1]
                self._shapes_by_bucket = {
                    b: {k: (b,) + v[1:] for k, v in self._shapes_tpl.items()}
                    for b in self._buckets}
            autotuned = True
        elif amode is not None:
            from ..autotune import tune_serve_pipeline
            fuse, pipeline = tune_serve_pipeline(
                sym_json, params, self._shapes_by_bucket[self.max_batch_size],
                data_name=data_name, quantize=quantize,
                calib_data=calib_data, u8_wire=u8_wire,
                dev=(dev_type, dev_id), name=name)
            autotuned = True
        if embed_dedup is None and pipeline is None:
            # the env default alone builds a pipeline too
            embed_dedup = default_embed_dedup() or None
        if pipeline is None and (quantize or u8_wire or fuse or autotuned
                                 or embed_dedup):
            pipeline = build_serving_pipeline(
                quantize=quantize, calib_data=calib_data,
                calib_shapes=self._shapes_by_bucket[self.max_batch_size],
                data_name=data_name, u8_wire=u8_wire,
                fuse=True if fuse is None else fuse, name=name,
                ctx=Context(dev_type, dev_id), embed_dedup=embed_dedup)
        self.pipeline = pipeline
        self._predictor = Predictor(
            sym_json, params, self._shapes_by_bucket[self.max_batch_size],
            dev_type, dev_id, type_dict=type_dict, pipeline=pipeline)
        self._data_dtype = self._predictor._exec.arg_dict[data_name].dtype
        self.stats = ServeStats(name, self.max_batch_size)
        from .. import profiler
        profiler.register_serve_stats(self.stats)
        self._mesh = None
        self._param_specs = dict(param_specs or {})
        self._channel = None
        self._follower = None
        self._closed = False
        if mesh is not None:
            from ..parallel.mesh import Mesh, make_mesh
            self._mesh = mesh if isinstance(mesh, Mesh) else make_mesh(mesh)
        self._bind_grid()
        if self._mesh is not None and self._mesh.size > 1:
            self._channel = _Channel(self._mesh)
            if not self._channel.front:
                self._batcher = None
                self._follower = _Follower(self)
                return
        self._batcher = MicroBatcher(
            self._run_batch, self._finish,
            max_batch_size=self.max_batch_size,
            max_delay_ms=self.max_delay_ms, queue_depth=self.queue_depth,
            default_deadline_ms=self.deadline_ms, validate=self._validate,
            stats=self.stats, name=name,
            on_start=self._warmup if warmup else None)

    @classmethod
    def from_checkpoint(cls, prefix: str, epoch: int,
                        input_shapes: Dict[str, Tuple[int, ...]],
                        **kwargs) -> "ServeEngine":
        """Serve a ``save_checkpoint`` pair."""
        sym_json, params = load_checkpoint_pair(prefix, epoch)
        return cls(sym_json, params, input_shapes, **kwargs)

    @classmethod
    def from_checkpoint_dir(cls, directory: str, symbol,
                            input_shapes: Dict[str, Tuple[int, ...]],
                            step: Optional[int] = None,
                            **kwargs) -> "ServeEngine":
        """Serve a ``mx.checkpoint`` store (the train state that
        ``CheckpointManager`` / ``Module.fit(checkpoint=...)`` saved): the
        newest committed step (or ``step``), params and aux, the
        optimizer state left behind.  The store holds arrays, not the
        graph: pass ``symbol``."""
        params, _meta = load_checkpoint_dir_params(directory, step)
        return cls(symbol, params, input_shapes, **kwargs)

    # -- bucket grid -------------------------------------------------------
    def _grid_fail(self, bucket, phase, exc):
        raise ServeError(
            "serve bucket-grid construction failed at bucket %d (input "
            "shapes %s, %s phase): %s: %s"
            % (bucket, sorted(self._shapes_by_bucket[bucket].items()),
               phase, type(exc).__name__, exc)) from exc

    def _bind_grid(self) -> None:
        """Bind every bucket's executor (they share the parameters) and,
        with a mesh, place each on it."""
        for b in self._buckets:
            try:
                ex = self._predictor.ensure_bound(self._shapes_by_bucket[b])
            except Exception as e:
                self._grid_fail(b, "bind", e)
            if self._mesh is not None:
                try:
                    ex.set_mesh(self._mesh, param_specs=self._param_specs,
                                input_specs=self._input_specs(b))
                except Exception as e:
                    self._grid_fail(b, "mesh placement", e)

    def _input_specs(self, bucket: int) -> Dict:
        """The bucket's inputs cut over ``dp`` on the batch dim when the
        mesh has a ``dp`` that divides the bucket, else replicated."""
        from ..parallel.mesh import PartitionSpec as P
        dp = int(dict(self._mesh.shape).get("dp", 1))
        return {name: P("dp") if dp > 1 and shape and shape[0] % dp == 0
                else P()
                for name, shape in self._shapes_by_bucket[bucket].items()}

    def _warmup(self) -> None:
        """Run every bucket once through the batch path before the first
        request, on the dispatcher thread (reference engine.py:366-400):
        the kernels' libraries (from the store under
        ``MXNET_COMPILE_CACHE``), allocator blocks, the thread's
        cuBLAS/cuDNN handles and plans and the pinned output buffers are
        all ready then.  That run is the bucket's program build in
        ``compile_report()``.  One pass, on one thread: the reference's
        pool of compiles has no counterpart here, since eager walks on
        one device serialize on it and on the GIL.  A failure raises a
        ServeError naming its bucket."""
        for b in self._buckets:
            prog = self._predictor.ensure_bound(
                self._shapes_by_bucket[b])._program("fwd_eval")
            try:
                prog.first_run(lambda b=b: self._finish(self._execute(
                    np.zeros((b,) + self.item_shape, self._data_dtype), b)))
            except Exception as e:
                self._grid_fail(b, "first run", e)

    def _validate(self, data) -> np.ndarray:
        """Admission-time request validation (caller's thread)."""
        arr = np.asarray(data)
        if arr.dtype.kind not in "biuf":
            raise ServeRequestError(
                "request dtype %s is not numeric (expected castable to %s)"
                % (arr.dtype, self._data_dtype))
        if tuple(arr.shape) != tuple(self.item_shape):
            raise ServeRequestError(
                "request shape %s != item shape %s (submit ONE item; the "
                "server owns the batch dim)"
                % (tuple(arr.shape), tuple(self.item_shape)))
        return np.ascontiguousarray(arr, dtype=self._data_dtype)

    def _pick_bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self.max_batch_size

    # -- batch execution (dispatcher thread) ------------------------------
    def _run_batch(self, reqs) -> Tuple:
        n = len(reqs)
        bucket = self._pick_bucket(n)
        # replica-failure seam: an injected `error` fails this batch
        # (every future gets the exception, what a broken replica looks
        # like to the router), a `crash` kills the process
        _fault_point("serve.dispatch", n=n, bucket=bucket)
        with _trace.span("serve:run_batch", cat="serve", n=n,
                         bucket=bucket):
            data = np.stack([r.data for r in reqs])
            if bucket > n:
                pad = np.zeros((bucket - n,) + self.item_shape,
                               self._data_dtype)
                data = np.concatenate([data, pad], axis=0)
            handoff = self._execute(data, n)
        self.stats.on_batch(n, bucket)
        return handoff

    def _forward(self, data: np.ndarray) -> torch.Tensor:
        """One padded batch through its bucket's executor (under the swap
        lock); -> the served output."""
        p = self._predictor
        p.reshape(self._shapes_by_bucket[data.shape[0]])
        p.set_input(self.data_name, data)
        p.forward()
        return p._exec.outputs[self._output_index]._get()

    def _execute(self, data: np.ndarray, n: int) -> Tuple:
        """Run one padded batch; start the copy of its first ``n`` output
        rows to the host and return without waiting for it."""
        with self._swap_lock:
            if self._channel is not None:
                self._channel.send_batch(data)
            out = self._forward(data)
        done = None
        if out.is_cuda:
            # copy into pinned memory; the completion thread waits on the
            # event while this thread runs the next batch
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            out = host
        return out, done, n

    def _finish(self, handoff) -> List[np.ndarray]:
        """Completion thread: wait for the copy, slice per request."""
        out, done, n = handoff
        with _trace.span("serve:d2h_finish", cat="serve", n=n):
            if done is not None:
                done.synchronize()
            host = out.numpy()
            return [np.array(host[i]) for i in range(n)]

    # -- client API --------------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None):
        """Enqueue one item (shape ``item_shape``); returns a Future of
        its output row."""
        if self._follower is not None:
            raise ServeError(
                "ServeEngine %r: rank %d follows the mesh's front (rank %d), "
                "which takes every request" % (
                    self.name, self._channel.rank, self._channel.root))
        return self._batcher.submit(data, deadline_ms=deadline_ms)

    def submit_many(self, items, deadline_ms: Optional[float] = None):
        """One future per item."""
        return [self.submit(x, deadline_ms=deadline_ms) for x in items]

    def predict(self, data, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking one-shot: submit, then wait for the result."""
        return self.submit(data).result(timeout=timeout)

    # -- hot weight reload -------------------------------------------------
    def reload(self, arg_params: Dict,
               aux_params: Optional[Dict] = None) -> int:
        """Swap weights between batches; returns the new version.  Under
        a mesh every rank calls it; a follower's weights change when the
        front's do."""
        if self._follower is not None:
            return self._follower.reload(arg_params, aux_params)
        with self._swap_lock:
            if self._channel is not None:
                self._channel.send(_RELOAD)
            self._predictor.set_params(arg_params, aux_params)
            self.weights_version += 1
            version = self.weights_version
        self.stats.on_reload()
        return version

    def reload_from_checkpoint(self, prefix: str, epoch: int) -> int:
        """Hot-swap to a checkpoint pair's params (the symbol must match
        the serving graph: only weights move)."""
        _sym_json, params = load_checkpoint_pair(prefix, epoch)
        return self.reload(params)

    def reload_from_checkpoint_dir(self, directory: str,
                                   step: Optional[int] = None) -> int:
        """Hot-swap to a ``mx.checkpoint`` step (default: the newest
        committed)."""
        params, _meta = load_checkpoint_dir_params(directory, step)
        return self.reload(params)

    @contextlib.contextmanager
    def pause(self):
        """Hold batch execution between batches (the weights-swap lock):
        queued requests wait, admissions keep their overload rules.
        reload() and nested pause() work inside; close() inside raises
        instead of hanging, and a close() from another thread waits for
        the pause to end."""
        with self._swap_lock:
            prev = self._pause_owner
            self._pause_owner = threading.get_ident()
            try:
                yield
            finally:
                self._pause_owner = prev

    # -- introspection -----------------------------------------------------
    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def pending_requests(self) -> int:
        """Requests waiting in the bounded queue (``queue_depth`` is the
        configured bound); 0 on a follower."""
        return self._batcher.queue_depth() if self._batcher else 0

    def outstanding(self) -> int:
        """Admitted requests not yet resolved (queued or in flight)."""
        return self.stats.outstanding()

    def device_bytes(self) -> int:
        """Bytes of the persistent buffers the bucket executors bind:
        parameters (shared, counted once) and per-bucket inputs.
        Transient forward outputs are not counted."""
        return exec_device_bytes(self._predictor._exec_cache.values())

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop admissions, drain (or fail) queued requests, join the
        worker threads.  Thread-safe and idempotent; raises inside
        pause() on the pausing thread (the dispatcher needs the lock)."""
        if self._pause_owner == threading.get_ident():
            raise ServeError(
                "close() inside pause() would deadlock: the dispatcher "
                "needs the paused lock to finish its in-flight batch; exit "
                "pause() first (or close from another thread)")
        if self._follower is not None:
            with self._close_lock:
                self._closed = True
                self._follower.join()
            return
        if self._batcher.is_worker_thread():
            self._batcher.request_close(drain=drain)
            return
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._batcher.close(drain=drain)
            if self._channel is not None:
                with self._swap_lock:
                    self._channel.send(_CLOSE)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_BATCH, _RELOAD, _CLOSE = 1, 2, 3


class _Channel:
    """The front's messages to the other ranks of a mesh: a header of two
    int64s (kind, bucket) and, for a batch, the padded batch, each a
    broadcast from the front over a gloo group of the mesh's ranks made
    for this engine (every rank makes it, in the same order, at
    construction)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        from ..dist import boot
        ranks = [int(r) for r in mesh.devices.ravel()]
        self.root = ranks[0]
        self.rank = boot.rank()
        self.front = self.rank == self.root
        self.group = dist.new_group(ranks, backend="gloo")

    def send(self, kind: int, bucket: int = 0) -> None:
        import torch.distributed as dist
        dist.broadcast(torch.tensor([kind, bucket], dtype=torch.int64),
                       self.root, group=self.group)

    def send_batch(self, data: np.ndarray) -> None:
        import torch.distributed as dist
        self.send(_BATCH, data.shape[0])
        dist.broadcast(torch.from_numpy(np.ascontiguousarray(data)),
                       self.root, group=self.group)

    def recv(self, item_shape, dtype):
        """-> (kind, the batch for a batch message, else None)."""
        import torch.distributed as dist
        head = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(head, self.root, group=self.group)
        kind, bucket = int(head[0]), int(head[1])
        if kind != _BATCH:
            return kind, None
        data = torch.from_numpy(np.zeros((bucket,) + tuple(item_shape),
                                         dtype=dtype))
        dist.broadcast(data, self.root, group=self.group)
        return kind, data.numpy()


class _Follower:
    """A follower rank's loop: every batch the front runs, run here too,
    until the front closes."""

    def __init__(self, engine: "ServeEngine"):
        import queue
        self.engine = engine
        self.reloads = queue.Queue()
        self.applied = queue.Queue()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="serve-follower-%s" % engine.name)
        self.thread.start()

    def _loop(self) -> None:
        eng = self.engine
        try:
            while True:
                kind, data = eng._channel.recv(eng.item_shape,
                                               eng._data_dtype)
                if kind == _CLOSE:
                    return
                with eng._swap_lock:
                    if kind == _BATCH:
                        eng._forward(data)
                    else:
                        args = self.reloads.get()
                        eng._predictor.set_params(*args)
                        eng.weights_version += 1
                        self.applied.put(eng.weights_version)
        except BaseException as e:    # noqa: BLE001 re-raised in join()
            self.error = e
            self.applied.put(None)

    def reload(self, arg_params, aux_params) -> int:
        self.reloads.put((arg_params, aux_params))
        version = self.applied.get()
        if version is None:
            raise ServeError("follower failed: %r" % (self.error,))
        return version

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise ServeError("follower failed: %r" % (self.error,)) \
                from self.error


def exec_device_bytes(execs) -> int:
    """Distinct bytes bound by an iterable of executors (argument and
    aux buffers), each buffer counted once however many executors share
    it; transient forward outputs are excluded."""
    seen = set()
    total = 0
    for ex in execs:
        for d in (ex.arg_dict, ex.aux_dict):
            for arr in d.values():
                t = arr._get()
                key = (t.device, t.untyped_storage().data_ptr())
                if key in seen:
                    continue
                seen.add(key)
                total += t.numel() * t.element_size()
    return total


def load_checkpoint_dir_params(directory: str,
                               step: Optional[int] = None) -> Tuple[Dict,
                                                                    Dict]:
    """Serving weights out of a ``mx.checkpoint`` store: params, fixed
    params and aux (the optimizer slots and random state stay behind).
    -> (params dict, meta)."""
    from ..base import MXNetError
    from ..checkpoint import CheckpointManager
    with CheckpointManager(directory, async_save=False,
                           name="serve-restore") as mgr:
        tree, meta = mgr.restore(step=step)
    if not isinstance(tree, dict) or "params" not in tree:
        raise MXNetError(
            "checkpoint under %r is not a module train state (expected a "
            "{'params', ...} tree, got %s); serve needs a state saved by "
            "save_module / Module.fit(checkpoint=...)"
            % (directory, type(tree).__name__))
    params: Dict = {}
    for group in ("params", "fixed", "aux"):
        params.update(tree.get(group) or {})
    return params, meta
