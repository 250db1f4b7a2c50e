"""WarpCTC plugin parity: the CTC loss layer.

The counterpart of ``mxnet_tpu/plugins/warpctc.py`` (reference
plugin/warpctc/warpctc-inl.h): inputs [data, label], params
label_length (the padded label width; blank is 0 and labels are
0-padded) and input_length (T); data is the (T*batch, alphabet) concat
of per-step activations.  Forward outputs the softmax; backward injects
the CTC gradient of the summed loss with respect to data, ignoring the
head gradient.

The alpha recursion is plain PyTorch in log space over T
(:func:`ctc_loss`), the formulation of ``optax.ctc_loss`` that the JAX
package calls, with its ``log_epsilon`` for impossible paths, so an
infeasible alignment gives a finite loss; autograd gives the gradient.
It is not ``F.ctc_loss``: that op's CUDA backward is nondeterministic
(it raises under ``torch.use_deterministic_algorithms(True)``) and it
gives ``inf`` on an infeasible alignment.  The recursion is capture-safe:
no host sync, and no shape that depends on the labels (label lengths
become masks on the device), so the fused step captures a WarpCTC graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.registry import OpDef, Param, register_op

__all__ = ["ctc_loss", "WarpCTCOp"]


def _update_phi(phi, added):
    """``phi[:, 1:]`` with ``added`` summed in log space."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """Per-sequence CTC loss, ``(B,)``, of ``logits`` (B, T, K) against
    ``labels`` (B, N) int, right-padded with ``blank_id`` (optax's
    ``ctc_loss`` with no logit padding and the label padding
    ``labels == blank_id``, as the JAX package calls it)."""
    B, T, K = logits.shape
    N = labels.shape[1]
    dt = logits.dtype
    logprobs = F.log_softmax(logits, dim=-1)
    label_pad = (labels == blank_id).to(dt)
    labellens = N - label_pad.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    lp_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)  # T,B,1
    lp_emit = torch.gather(logprobs, 2, labels.unsqueeze(1).expand(
        B, T, N)).transpose(0, 1)                                    # T,B,N
    phi = torch.cat([logits.new_zeros((B, 1)),
                     logits.new_full((B, N), log_epsilon)], dim=1)
    emit = logits.new_full((B, N), log_epsilon)
    eps_rep = log_epsilon * repeat
    eps_norep = log_epsilon * (1.0 - repeat)
    for t in range(T):
        # emit-to-phi epsilon transition, unless the next label repeats
        prev_phi = _update_phi(phi, emit + eps_rep)
        # phi-to-emit transition and the self loop
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = prev_phi + lp_phi[t]
        # emit-to-phi blank transition only when the next label repeats
        phi = _update_phi(next_phi, emit + lp_phi[t] + eps_norep)
        emit = next_emit
    last = _update_phi(phi, emit)
    pick = (labellens.unsqueeze(1) == torch.arange(
        N + 1, device=logits.device)).to(dt)
    return -(last * pick).sum(dim=1)


class _WarpCTC(torch.autograd.Function):
    """softmax(data) forward; the backward is the gradient of the summed
    CTC loss with respect to data, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, T):
        ctx.save_for_backward(data, label)
        ctx.T = T
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return (ctc_grad(data, label, ctx.T),
                torch.zeros_like(label) if ctx.needs_input_grad[1] else None,
                None)


def ctc_grad(data: torch.Tensor, label: torch.Tensor, T: int):
    """d(sum of the CTC losses)/d(data), data (T*B, A) time-major."""
    A = data.shape[1]
    B = data.shape[0] // T
    with torch.enable_grad():
        d = data.detach().requires_grad_(True)
        logits = d.reshape(T, B, A).transpose(0, 1)          # (B, T, A)
        # the JAX package hands optax log-probabilities, which applies
        # log_softmax again
        logprobs = F.log_softmax(logits, dim=-1)
        loss = ctc_loss(logprobs, label.to(torch.int64), blank_id=0)
        grad, = torch.autograd.grad(loss.sum(), d)
    return grad


@register_op("WarpCTC", hint="warpctc")
class WarpCTCOp(OpDef):
    params = [Param("label_length", int, required=True),
              Param("input_length", int, required=True)]

    def list_arguments(self, p):
        return ["data", "label"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        batch = d[0] // p.input_length
        return [d, (batch, p.label_length)], [d], []

    def forward(self, p, inputs, aux, ctx):
        data, label = inputs
        return [_WarpCTC.apply(data, label, p.input_length)]
