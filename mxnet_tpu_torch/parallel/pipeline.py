"""GPipe pipeline parallelism over a ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

Homogeneous stages: stage s applies ``stage_fn(params[s], x)`` with its
own slice of params stacked on a leading axis of size S, and rank s of
the ``pp`` axis holds slice s.  The JAX package scans a fill-drain
schedule of M + S - 1 ticks under ``shard_map``, activations hopping
stage to stage with ``lax.ppermute``; the port runs the same ticks on
every rank, activations hopping with ``collectives.ring_shift``.  Every
rank builds the same autograd graph (the stage-0 injection and the
last stage's recording are ``torch.where`` masks, not branches), so the
backward's reverse hops line up across ranks as the JAX package gets
them from autodiff of ``ppermute``.  The last stage's outputs are made
replicated with an all-reduce, whose gradient passes through: every
rank computes the loss from the same outputs.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..context import gpu
from . import collectives as C

__all__ = ["pipeline_apply", "GPipeTrainStep"]


def _leaves(tree):
    """The tensors of a dict/list tree, in the order ``_map`` visits."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _check_stages(stacked_params, S):
    for leaf in _leaves(stacked_params):
        if leaf.shape[0] != S:
            raise ValueError(
                "stacked param leading dim %d != pipeline stages %d "
                "(each leaf must stack one slice per pp-axis device)"
                % (leaf.shape[0], S))


def run_stages(stage_fn: Callable, axis, local_params, micros):
    """The fill-drain schedule on this rank with its stage's params;
    -> the last stage's outputs (M, ...), replicated over the axis."""
    S = axis.size
    M = micros.shape[0]
    dev = micros.device
    first = torch.tensor(axis.index == 0, device=dev)
    last = torch.tensor(axis.index == S - 1, device=dev)
    buf = torch.zeros_like(micros[0])
    rec = []
    for t in range(M + S - 1):
        x = torch.where(first, micros[min(t, M - 1)], buf)
        y = stage_fn(local_params, x)
        if t >= S - 1:
            rec.append(torch.where(last, y, torch.zeros_like(y)))
        if t < M + S - 2:
            buf = C.ring_shift(y, axis, 1)
    return C.all_reduce(torch.stack(rec), axis)


def pipeline_apply(stage_fn: Callable, mesh, stacked_params, micros,
                   axis: str = "pp"):
    """Run microbatches ``micros`` (M, ...) through the S stages; ->
    the outputs (M, ...) on every rank.  ``stacked_params``' leaves have
    leading dim S (the global stacked form); this rank uses its slice.
    ``stage_fn(params_slice, x)`` keeps x's shape."""
    S = mesh.shape[axis]
    _check_stages(stacked_params, S)
    ax = mesh.axis(axis)
    local = _map(lambda a: torch.as_tensor(a)[ax.index], stacked_params)
    return run_stages(stage_fn, ax, local, torch.as_tensor(micros))


class GPipeTrainStep:
    """Microbatched pipeline training step over a ``pp`` axis
    (reference ``GPipeTrainStep``): S stages of ``stage_fn``, then
    ``loss_fn(tail_params, h, labels)`` -> scalar on every rank (the
    tail replicated), SGD on both.  ``ctx``: this rank's device."""

    def __init__(self, stage_fn, loss_fn, mesh, num_micro: int,
                 learning_rate: float = 0.1, axis: str = "pp", ctx=None):
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.num_micro = num_micro
        self.lr = learning_rate
        self.axis_name = axis
        self.ctx = ctx if ctx is not None else gpu(0)
        self.device = self.ctx.torch_device()
        self._axis = None

    @property
    def axis(self):
        if self._axis is None:
            self._axis = self.mesh.axis(self.axis_name)
        return self._axis

    def _put(self, a):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(self.device, copy=True)

    def init(self, stacked_params, tail_params):
        """-> {"stages": this rank's stage slice, "tail": the tail},
        autograd leaves on this rank's device."""
        _check_stages(stacked_params, self.mesh.shape[self.axis_name])
        i = self.axis.index
        stages = _map(lambda a: self._put(a)[i].clone().requires_grad_(True),
                      stacked_params)
        tail = _map(lambda a: self._put(a).requires_grad_(True),
                    tail_params)
        return {"stages": stages, "tail": tail}

    def loss_and_grads(self, params, data, labels):
        """-> (loss, gradients in the structure of ``params``); the
        stage gradients are this rank's stage's."""
        if len(data) % self.num_micro:
            raise ValueError(
                "batch size %d must be divisible by num_micro=%d"
                % (len(data), self.num_micro))
        data, labels = self._put(data), self._put(labels)
        M = self.num_micro
        micros = data.reshape((M, data.shape[0] // M) + tuple(data.shape[1:]))
        leaves = _leaves(params)
        with torch.enable_grad():
            outs = run_stages(self.stage_fn, self.axis, params["stages"],
                              micros)
            h = outs.reshape((data.shape[0],) + tuple(outs.shape[2:]))
            loss = self.loss_fn(params["tail"], h, labels)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        return loss.detach(), _map(lambda _x: next(it), params)

    def __call__(self, params, data, labels):
        """One step, in place on ``params``; -> (params, loss)."""
        loss, grads = self.loss_and_grads(params, data, labels)
        with torch.no_grad():
            for p, g in zip(_leaves(params), _leaves(grads)):
                p.sub_(self.lr * g)
        return params, loss

    def stacked(self, tree):
        """A stage-slice tree (params or gradients) all-gathered into the
        global stacked form (leading dim S), as host arrays."""
        with torch.no_grad():
            return _map(lambda a: C.all_gather(a.detach()[None], self.axis)
                        .cpu().numpy(), tree)

