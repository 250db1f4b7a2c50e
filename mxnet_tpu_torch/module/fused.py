"""Fused train step: forward, backward, the optimizer and the BatchNorm
aux updates of one batch as one captured CUDA graph.

The counterpart of ``mxnet_tpu/module/fused.py``, whose one donated XLA
program per step (``fused.py:57-70, 604-738``) becomes, on the card:

* **state**: persistent device tensors laid out like the reference's,
  ``{"params", "opt", "aux", "fixed"}``, plus the step ``t`` and the
  learning rate ``lr`` as device scalars, and static input buffers per
  batch shape that ``make_batch`` copies each batch into;
* **capture**: the first steps of a batch shape run eagerly on a side
  stream (the warm-up ``torch.cuda.graph`` needs); the next is captured
  (forward, ``torch.autograd.grad`` over the params, the optimizer's
  fused update written in place, the aux states copied back) and every
  later step is one ``replay()``.  A capture that fails raises: no path
  runs the eager step in its place;
* **lr and t**: written into their device scalars before each replay, so
  an lr-scheduler change costs no recapture, as the reference feeds lr
  into its program as a scalar.  A change to ``hparam_signature`` (the
  values the graph baked in) takes the module's ``_disable_fused`` path;
* **outputs**: static buffers the next replay overwrites; the module
  hands out copies.

On a CPU context the same step function runs eagerly, every step.
``stats`` counts captures, replays and eager steps, the port's
counterpart of the reference's compile guard: a steady fit makes one
capture per (shapes, dtypes) and one replay per batch.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from ..base import MXNetError
from ..executor import _GraphProgram
from ..ndarray import NDArray
from ..ops.registry import OpContext
from .. import random as _random

__all__ = ["FusedTrainStep", "GraphStats"]

# eager steps of a batch shape before its capture: the side-stream
# warm-up CUDA graph capture needs (cuBLAS/cuDNN handles, workspaces)
WARMUP_STEPS = 3


class GraphStats:
    """Counts of the fused step's executions: graph captures, replays,
    and eager steps (the warm-up steps on the card, every step on the
    CPU)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0

    def report(self) -> Dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps}


class _Captured:
    __slots__ = ("graph", "outputs")

    def __init__(self, graph, outputs):
        self.graph = graph
        self.outputs = outputs


class FusedTrainStep:
    """One batch body (forward + backward + update) per call, captured as
    a CUDA graph per (shapes, dtypes) on the card."""

    def __init__(self, symbol, context, data_names: Sequence[str],
                 label_names: Sequence[str], param_names: Sequence[str],
                 fixed_param_names: Sequence[str], optimizer):
        self.device = context.torch_device()
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        fixed = set(fixed_param_names or ())
        self.train_names = [n for n in param_names if n not in fixed]
        self.fixed_names = [n for n in param_names if n in fixed]
        self.aux_names = symbol.list_auxiliary_states()
        self.optimizer = optimizer
        fused = optimizer.fused_update_fn()
        if fused is None:
            raise MXNetError("optimizer has no fused form")
        self._opt_init, self._opt_update = fused
        self._lr_mult = {n: optimizer._name_lr_mult(n)
                         for n in self.train_names}
        self._wd = {n: optimizer._name_wd(n) for n in self.train_names}
        self._rescale = optimizer.rescale_grad
        self._clip = optimizer.clip_gradient
        self._prog = _GraphProgram(symbol)
        self.stats = GraphStats()
        self.state = None
        self._buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._graphs: Dict[tuple, _Captured] = {}
        self._warm: Dict[tuple, int] = {}
        self._side = None
        self._lr_host = None

    @property
    def captured(self) -> bool:
        return self.device.type == "cuda"

    # -- state ---------------------------------------------------------------
    def init_state(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]) -> None:
        """Copy the params onto the device as the persistent state (the
        params are autograd leaves, updated in place); drops every
        captured graph, which read the old state."""
        def put(v):
            return v._get().detach().to(self.device, copy=True)
        params = {n: put(arg_params[n]).requires_grad_(True)
                  for n in self.train_names}
        self.state = {
            "params": params,
            "fixed": {n: put(arg_params[n]) for n in self.fixed_names},
            "aux": {n: put(aux_params[n]) for n in self.aux_names},
            "opt": {n: self._opt_init(w.detach())
                    for n, w in params.items()},
            "t": torch.zeros((), dtype=torch.float32, device=self.device),
            "lr": torch.zeros((), dtype=torch.float32, device=self.device)}
        self._buffers.clear()
        self._graphs.clear()
        self._warm.clear()
        self._lr_host = None

    def hparam_signature(self):
        """The optimizer values baked into the step (everything except
        lr and t, which are device scalars); the module compares it
        before every step."""
        opt = self.optimizer
        baked = tuple((k, getattr(opt, k, None))
                      for k in sorted(opt.fused_hparams))
        return (tuple(sorted(opt.lr_mult.items())),
                tuple(sorted(opt.wd_mult.items())),
                opt.wd, opt.rescale_grad, opt.clip_gradient, baked)

    @staticmethod
    def _key(batch: Dict[str, torch.Tensor]) -> tuple:
        return tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in batch.items()))

    def make_batch(self, data_batch) -> Dict[str, torch.Tensor]:
        """Copy one DataBatch into the step's static input buffers of its
        shapes (allocated on first sight); -> {name: buffer}."""
        src = {}
        for names, arrs in ((self.data_names, data_batch.data),
                            (self.label_names, data_batch.label or [])):
            for name, arr in zip(names, arrs):
                src[name] = arr._get() if isinstance(arr, NDArray) \
                    else torch.as_tensor(arr)
        missing = [n for n in self.data_names + self.label_names
                   if n not in src]
        if missing:
            raise MXNetError("the batch lacks inputs %s" % missing)
        key = self._key(src)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = {n: torch.empty(t.shape, dtype=t.dtype,
                                   device=self.device)
                    for n, t in src.items()}
            self._buffers[key] = bufs
        for n, t in src.items():
            bufs[n].copy_(t, non_blocking=True)
        return bufs

    # -- the step --------------------------------------------------------------
    def _body(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The batch body, in place on the state; -> outputs.  Its three
        parts are profiler ranges (``fused:forward``, ``fused:backward``,
        ``fused:update``) for a profile of an eager step."""
        st = self.state
        params = st["params"]
        names = list(params)
        st["t"].add_(1.0)
        args = dict(params)
        args.update(st["fixed"])
        args.update(batch)
        opctx = OpContext(is_train=True,
                          generator=_random.generator(self.device))
        with torch.enable_grad():
            with record_function("fused:forward"):
                outs, new_aux = self._prog.eval(args, st["aux"], opctx)
            heads = [o for o in outs if o.requires_grad]
            with record_function("fused:backward"):
                grads = torch.autograd.grad(
                    heads, [params[n] for n in names],
                    grad_outputs=[torch.ones_like(o) for o in heads],
                    allow_unused=True) if heads else [None] * len(names)
        with torch.no_grad(), record_function("fused:update"):
            for n, g in zip(names, grads):
                w = params[n]
                if g is None:
                    g = torch.zeros_like(w)
                if self._rescale != 1.0:
                    g = g * self._rescale
                if self._clip is not None:
                    g = torch.clamp(g, -self._clip, self._clip)
                self._opt_update(w, g, st["opt"][n],
                                 st["lr"] * self._lr_mult[n], self._wd[n],
                                 st["t"])
            for k, v in new_aux.items():
                st["aux"][k].copy_(v)
        return [o.detach() for o in outs]

    def step(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Advance one batch (``batch`` from :meth:`make_batch`); -> the
        outputs (on the card: the graph's static buffers)."""
        lr = float(self.optimizer.base_lr())
        if lr != self._lr_host:
            self.state["lr"].fill_(lr)
            self._lr_host = lr
        if not self.captured:
            self.stats.eager_steps += 1
            return self._body(batch)
        key = self._key(batch)
        cap = self._graphs.get(key)
        if cap is None:
            done = self._warm.get(key, 0)
            if done < WARMUP_STEPS:
                if self._side is None:
                    self._side = torch.cuda.Stream(device=self.device)
                main = torch.cuda.current_stream(self.device)
                self._side.wait_stream(main)
                with torch.cuda.stream(self._side):
                    outs = self._body(batch)
                main.wait_stream(self._side)
                for o in outs:
                    o.record_stream(main)
                self._warm[key] = done + 1
                self.stats.eager_steps += 1
                return outs
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._body(batch)
            self.stats.captures += 1
            cap = self._graphs[key] = _Captured(graph, outs)
        cap.graph.replay()
        self.stats.replays += 1
        return cap.outputs

    def forward_only(self, batch: Dict[str, torch.Tensor],
                     is_train: bool = False) -> List[torch.Tensor]:
        """A forward on the live params that changes no state (eval, or
        a train-mode forward whose aux updates are dropped)."""
        st = self.state
        args = dict(st["params"])
        args.update(st["fixed"])
        args.update(batch)
        opctx = OpContext(is_train=is_train,
                          generator=_random.generator(self.device))
        with torch.no_grad():
            outs, _ = self._prog.eval(args, st["aux"], opctx)
        return outs

    def read_params(self, arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray]) -> None:
        """Copy the live state into the given dicts' arrays."""
        with torch.no_grad():
            for group, names, out in (("params", self.train_names,
                                       arg_params),
                                      ("fixed", self.fixed_names,
                                       arg_params),
                                      ("aux", self.aux_names, aux_params)):
                for n in names:
                    out[n][:] = self.state[group][n].detach()
