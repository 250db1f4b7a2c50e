"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``).

The registry, SGD/NAG/SGLD/ccSGD/Adam/AdaGrad/RMSProp/AdaDelta/Test,
``get_updater`` and the lr_mult/wd_mult resolution from symbol attributes,
with the reference's update formulas written out on tensors (not
``torch.optim``, whose SGD keeps the learning rate outside the momentum
buffer and whose Adam places epsilon and the bias correction elsewhere).

Each optimizer with a fused form gives ``fused_update_fn() -> (init_state,
update)`` for the fused train step: ``update(w, g, state, lr, wd, t)``
writes the new weight and state in place; ``g`` arrives rescaled and
clipped, ``lr`` (with the parameter's multiplier) and the 1-based step
``t`` are device scalars, so a CUDA graph that captured the update reads
new values on every replay.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .ndarray import NDArray, zeros
from . import random as _random

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Test", "create", "get_updater",
           "register"]


def _zeros_like(weight: NDArray) -> NDArray:
    return zeros(weight.shape, weight.context, dtype=weight.dtype)


class Optimizer:
    """Base optimizer with registry (reference optimizer.py:12-160)."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        assert isinstance(klass, type)
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1.0, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](
                rescale_grad=rescale_grad, **kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, arg_names=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict)
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.lr_mult = {}
        self.wd_mult = {}
        if sym is not None:
            attr = sym.attr_dict()
            for name in sym.list_arguments():
                if name in attr:
                    if "lr_mult" in attr[name]:
                        self.lr_mult[name] = float(attr[name]["lr_mult"])
                    if "wd_mult" in attr[name]:
                        self.wd_mult[name] = float(attr[name]["wd_mult"])

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_scale(self, args_lrscale):
        self.lr_mult = {self.idx2name.get(i, i): s
                        for i, s in args_lrscale.items()}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = 0
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        return self.base_lr() * self._name_lr_mult(
            self.idx2name.get(index, index))

    def _get_wd(self, index):
        return self._name_wd(self.idx2name.get(index, index))

    def _preprocess_grad(self, grad: NDArray) -> torch.Tensor:
        g = grad._get() * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _name_lr_mult(self, name):
        """Static per-param lr multiplier by name (shared between the
        index-keyed updater path and the fused train step)."""
        return self.lr_mult.get(name, 1.0)

    def _name_wd(self, name):
        """Static per-param weight decay by name: wd_mult override, else
        the bias/gamma/beta -> 0 naming rule."""
        wd = self.wd
        if name in self.wd_mult:
            wd *= self.wd_mult[name]
        elif isinstance(name, str) and (
                name.endswith("_bias") or name.endswith("_gamma")
                or name.endswith("_beta")):
            wd *= 0.0
        return wd

    def base_lr(self):
        """Current base learning rate (scheduler applied on num_update)."""
        return (self.lr_scheduler(self.num_update) if self.lr_scheduler
                else self.lr)

    def fused_update_fn(self):
        """``(init_state, update)`` for the fused train step, or None when
        the optimizer has no fused form (SGLD draws host-side noise).  A
        class that overrides this declares ``fused_hparams``, the
        attributes its closures bake in, so the module can see them
        change."""
        return None


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (reference optimizer.py:163):
    mom = momentum * mom - lr * g - lr * wd * w; w += mom."""

    fused_hparams = ("momentum",)

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._preprocess_grad(grad)
        w = weight._get()
        if state is not None:
            mom = self.momentum * state._get() - lr * g - lr * wd * w
            state._get().copy_(mom)
            w.add_(mom)
        else:
            w.copy_(w - lr * (g + wd * w))

    def fused_update_fn(self):
        momentum = self.momentum

        def init_state(w):
            return torch.zeros_like(w) if momentum else None

        def update(w, g, mom, lr, wd, t):
            if momentum:
                mom.mul_(momentum).sub_(lr * g).sub_(lr * wd * w)
                w.add_(mom)
            else:
                w.sub_(lr * (g + wd * w))
        return init_state, update


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference optimizer.py:235)."""

    fused_hparams = ("momentum",)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._preprocess_grad(grad)
        w = weight._get()
        if state is not None:
            mom = self.momentum * state._get() + g + wd * w
            state._get().copy_(mom)
            w.sub_(lr * (self.momentum * mom + g))
        else:
            w.copy_(w - lr * (g + wd * w))

    def fused_update_fn(self):
        momentum = self.momentum

        def init_state(w):
            return torch.zeros_like(w) if momentum else None

        def update(w, g, mom, lr, wd, t):
            if momentum:
                mom.mul_(momentum).add_(g).add_(wd * w)
                w.sub_(lr * (momentum * mom + g))
            else:
                w.sub_(lr * (g + wd * w))
        return init_state, update


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer.py:288);
    no fused form: its noise comes from ``mx.random`` per update."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._preprocess_grad(grad)
        w = weight._get()
        noise = _random.normal(0, math.sqrt(lr), shape=weight.shape,
                               ctx=weight.context)._get()
        w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class ccSGD(SGD):
    """C++-backed SGD in the reference (optimizer.py:341); same math."""


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py:404), with the per-parameter update
    count as the bias-correction step."""

    fused_hparams = ("beta1", "beta2", "epsilon")

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, decay_factor=(1 - 1e-8), **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.decay_factor = decay_factor

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        mean, variance = state
        g = self._preprocess_grad(grad)
        w = weight._get()
        t = self._index_update_count[index]
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        m = self.beta1 * mean._get() + (1 - self.beta1) * g
        v = self.beta2 * variance._get() + (1 - self.beta2) * torch.square(g)
        mean._get().copy_(m)
        variance._get().copy_(v)
        w.copy_(w - lr_t * (m / (torch.sqrt(v) + self.epsilon) + wd * w))

    def fused_update_fn(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon

        def init_state(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, lr, wd, t):
            mean, var = state
            lr_t = lr * torch.sqrt(1.0 - torch.pow(b2, t)) \
                / (1.0 - torch.pow(b1, t))
            mean.mul_(b1).add_((1 - b1) * g)
            var.mul_(b2).add_((1 - b2) * torch.square(g))
            w.sub_(lr_t * (mean / (torch.sqrt(var) + eps) + wd * w))
        return init_state, update


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py:475)."""

    fused_hparams = ("float_stable_eps",)

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._preprocess_grad(grad)
        w = weight._get()
        hist = state._get() + torch.square(g)
        state._get().copy_(hist)
        w.copy_(w - lr * (g / torch.sqrt(hist + self.float_stable_eps)
                          + wd * w))

    def fused_update_fn(self):
        eps = self.float_stable_eps

        def init_state(w):
            return torch.zeros_like(w)

        def update(w, g, hist, lr, wd, t):
            hist.add_(torch.square(g))
            w.sub_(lr * (g / torch.sqrt(hist + eps) + wd * w))
        return init_state, update


@register
class RMSProp(Optimizer):
    """RMSProp (reference optimizer.py:512)."""

    fused_hparams = ("gamma1", "gamma2")

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        n, gbar, delta = state
        g = self._preprocess_grad(grad)
        w = weight._get()
        nn = (1 - self.gamma1) * torch.square(g) + self.gamma1 * n._get()
        gg = (1 - self.gamma1) * g + self.gamma1 * gbar._get()
        dd = (self.gamma2 * delta._get()
              - lr * (g / torch.sqrt(nn - torch.square(gg) + 1e-4)
                      + wd * w))
        n._get().copy_(nn)
        gbar._get().copy_(gg)
        delta._get().copy_(dd)
        w.add_(dd)

    def fused_update_fn(self):
        g1, g2 = self.gamma1, self.gamma2

        def init_state(w):
            return (torch.zeros_like(w), torch.zeros_like(w),
                    torch.zeros_like(w))

        def update(w, g, state, lr, wd, t):
            n, gbar, delta = state
            n.copy_((1 - g1) * torch.square(g) + g1 * n)
            gbar.copy_((1 - g1) * g + g1 * gbar)
            delta.copy_(g2 * delta
                        - lr * (g / torch.sqrt(n - torch.square(gbar)
                                               + 1e-4) + wd * w))
            w.add_(delta)
        return init_state, update


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py:568)."""

    fused_hparams = ("rho", "epsilon")

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        g = self._preprocess_grad(grad)
        w = weight._get()
        ag = self.rho * acc_g._get() + (1.0 - self.rho) * torch.square(g)
        cur = (torch.sqrt(acc_delta._get() + self.epsilon)
               / torch.sqrt(ag + self.epsilon) * g)
        ad = self.rho * acc_delta._get() \
            + (1.0 - self.rho) * torch.square(cur)
        acc_g._get().copy_(ag)
        acc_delta._get().copy_(ad)
        w.copy_(w - cur - wd * w)

    def fused_update_fn(self):
        rho, eps = self.rho, self.epsilon

        def init_state(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, lr, wd, t):
            acc_g, acc_delta = state
            acc_g.copy_(rho * acc_g + (1.0 - rho) * torch.square(g))
            cur = torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps) * g
            acc_delta.copy_(rho * acc_delta + (1.0 - rho) * torch.square(cur))
            w.copy_(w - cur - wd * w)
        return init_state, update


@register
class Test(Optimizer):
    """Test optimizer: weight += grad * rescale_grad (reference
    optimizer.py:620)."""

    fused_hparams = ()

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        w = weight._get()
        w.add_(grad._get() * self.rescale_grad)
        state._get().copy_(w)

    def fused_update_fn(self):
        def init_state(w):
            return torch.zeros_like(w)

        def update(w, g, state, lr, wd, t):
            w.add_(g)
            state.copy_(w)
        return init_state, update


def create(name, rescale_grad=1.0, **kwargs):
    """Create an optimizer by registered name (reference
    optimizer.py:786)."""
    return Optimizer.create_optimizer(name, rescale_grad=rescale_grad,
                                      **kwargs)


def get_updater(optimizer: Optimizer):
    """Closure updater(index, grad, weight) (reference
    optimizer.py:804-824); its ``states`` dict is keyed by index."""
    states: Dict[int, object] = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])
    updater.optimizer = optimizer
    updater.states = states
    return updater
