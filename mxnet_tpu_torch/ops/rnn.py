"""The fused recurrent operator ``RNN`` (counterpart of
``mxnet_tpu/ops/rnn.py``).

The reference expresses the time loop as one ``lax.scan``; here it is a
Python loop over time, recorded by autograd (and by a CUDA graph
capture when the fused train step captures it).  The structure is the
reference's: per layer, the input projection of the whole sequence is
hoisted out of the loop as one product ((T*B, E) x (E, G*H)), and each
step adds one recurrent ``addmm`` ((B, H) x (H, G*H)) and the gates, in
the order [in, transform, forget, out] for the LSTM, as ``models/lstm.py``
slices them.  cuDNN's LSTM is not used: its gates run i, f, g, o.

Interface (mxnet-1.x RNN flavor, unpacked weights):
  arguments: data (T, B, input) +
             l{i}_i2h_weight/bias, l{i}_h2h_weight/bias per layer +
             state (L, B, H) [+ state_cell (L, B, H) for lstm]
  outputs:   output (T, B, H) [+ state (+ state_cell) with
             state_outputs=True]
"""
from __future__ import annotations

import torch

from .nn import sigmoid
from .registry import OpDef, Param, register_op


def _gates(mode: str) -> int:
    return {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}[mode]


def _cell(mode, H, gi, wh, bh, h, c):
    """One step from this step's input projection ``gi``: -> (h, c)."""
    gh = torch.addmm(bh, h, wh.t())
    if mode == "gru":
        # the reset gate applies to the recurrent term only, so gi and gh
        # stay apart
        r = sigmoid(gi[:, :H] + gh[:, :H])
        z = sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        return (1 - z) * n + z * h, c
    g = gi + gh
    if mode == "lstm":
        i = sigmoid(g[:, :H])
        u = torch.tanh(g[:, H:2 * H])
        f = sigmoid(g[:, 2 * H:3 * H])
        o = sigmoid(g[:, 3 * H:])
        c_new = f * c + i * u
        return o * torch.tanh(c_new), c_new
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    return act(g), c


@register_op("RNN", hint="rnn")
class RNNOp(OpDef):
    """Multi-layer unidirectional recurrent block (reference
    ``ops/rnn.py:36``): modes rnn_relu, rnn_tanh, gru and lstm; with
    ``state_outputs`` the final h (and c) of every layer; dropout ``p``
    between layers in training, drawn from the op context's generator."""

    params = [Param("state_size", int, required=True),
              Param("num_layers", int, required=True),
              Param("mode", str, required=True,
                    enum=["rnn_relu", "rnn_tanh", "gru", "lstm"]),
              Param("p", float, default=0.0),
              Param("state_outputs", bool, default=False)]
    needs_rng = True   # inter-layer dropout

    def list_arguments(self, p):
        names = ["data"]
        for i in range(p.num_layers):
            names += ["l%d_i2h_weight" % i, "l%d_i2h_bias" % i,
                      "l%d_h2h_weight" % i, "l%d_h2h_bias" % i]
        names.append("state")
        if p.mode == "lstm":
            names.append("state_cell")
        return names

    def list_outputs(self, p):
        outs = ["output"]
        if p.state_outputs:
            outs.append("state")
            if p.mode == "lstm":
                outs.append("state_cell")
        return outs

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None] * len(self.list_outputs(p)), []
        T, B, E = d
        H, L, G = p.state_size, p.num_layers, _gates(p.mode)
        shapes = [d]
        for i in range(L):
            in_dim = E if i == 0 else H
            shapes += [(G * H, in_dim), (G * H,), (G * H, H), (G * H,)]
        state_shape = (L, B, H)
        shapes.append(state_shape)
        if p.mode == "lstm":
            shapes.append(state_shape)
        outs = [(T, B, H)]
        if p.state_outputs:
            outs.append(state_shape)
            if p.mode == "lstm":
                outs.append(state_shape)
        return shapes, outs, []

    def forward(self, p, inputs, aux, ctx):
        H, L = p.state_size, p.num_layers
        data = inputs[0]
        weights = inputs[1:1 + 4 * L]
        h0 = inputs[1 + 4 * L]
        c0 = inputs[2 + 4 * L] if p.mode == "lstm" else None
        dropout = p.p > 0.0 and ctx.is_train
        if dropout and L > 1 and ctx.generator is None:
            # training without the requested regularization would be
            # invisible to the user: fail loudly, as the reference does
            raise ValueError(
                "RNN: p=%g inter-layer dropout requires an rng at training "
                "time, but the executor supplied none" % p.p)
        T, B = data.shape[0], data.shape[1]
        layer_in = data
        finals_h, finals_c = [], []
        for i in range(L):
            wi, bi, wh, bh = weights[4 * i:4 * i + 4]
            h = h0[i]
            c = c0[i] if c0 is not None else torch.zeros_like(h)
            # the input projection of the whole sequence, hoisted out of
            # the time loop as one product; unbind's backward is one
            # stack, where indexing step t would add a zero-filled
            # sequence-sized gradient per step
            gi_all = torch.addmm(bi, layer_in.reshape(T * B, -1),
                                 wi.t()).reshape(T, B, -1)
            outs = []
            for gi in gi_all.unbind(0):
                h, c = _cell(p.mode, H, gi, wh, bh, h, c)
                outs.append(h)
            finals_h.append(h)
            finals_c.append(c)
            layer_in = torch.stack(outs)
            if dropout and i < L - 1 and ctx.generator is not None:
                # (T, B, H) holds the data's batch rows where the data
                # does: one device's mask over a batch cut over dp
                keep = ctx.draw(
                    lambda s: torch.rand(s, generator=ctx.generator,
                                         device=layer_in.device),
                    tuple(layer_in.shape), ctx.row_cuts(0)) < 1.0 - p.p
                layer_in = torch.where(keep, layer_in / (1.0 - p.p),
                                       torch.zeros_like(layer_in))
        outputs = [layer_in]
        if p.state_outputs:
            outputs.append(torch.stack(finals_h))
            if p.mode == "lstm":
                outputs.append(torch.stack(finals_c))
        return outputs
