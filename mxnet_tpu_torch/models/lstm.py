"""The PTB LSTM language model, unrolled and through the ``RNN`` op,
built on the port's symbol API exactly as the JAX package builds it
(``mxnet_tpu/models/lstm.py``): the same node names and argument names,
so a checkpoint written by either form, from either package, loads in
the others.  ``ctx_groups`` is kept as the ``ctx_group`` attribute of
each layer's nodes only: the port runs on one device."""
import contextlib
from collections import namedtuple

from .. import symbol as sym
from ..attribute import AttrScope

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
              dropout=0.0):
    """One LSTM step: the 4 gates from one FC pair, sliced [in,
    transform, forget, out]."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    slices = sym.SliceChannel(gates, num_outputs=4,
                              name="t%d_l%d_slice" % (seqidx, layeridx))
    in_gate = sym.Activation(slices[0], act_type="sigmoid")
    in_transform = sym.Activation(slices[1], act_type="tanh")
    forget_gate = sym.Activation(slices[2], act_type="sigmoid")
    out_gate = sym.Activation(slices[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def _lm_embed(input_size, num_embed):
    """Shared LM front: token ids -> embeddings (both unroll forms)."""
    data = sym.Variable("data")
    return sym.Embedding(data=data, input_dim=input_size,
                         weight=sym.Variable("embed_weight"),
                         output_dim=num_embed, name="embed")


def _lm_head(hidden_flat, num_label):
    """Shared LM tail: time-major flattened hiddens -> softmax over the
    time-major flattened labels (both unroll forms; keeps the
    checkpoint-interchange guarantee in one place)."""
    pred = sym.FullyConnected(data=hidden_flat, num_hidden=num_label,
                              weight=sym.Variable("cls_weight"),
                              bias=sym.Variable("cls_bias"), name="pred")
    label = sym.Variable("softmax_label")
    label_t = sym.transpose(data=label)
    label_flat = sym.Reshape(data=label_t, target_shape=(0,), shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0, ctx_groups=None):
    """Unrolled LSTM LM (reference lstm.py lstm_unroll).

    ctx_groups: optional list of group names per layer for model-parallel
    placement (example/model-parallel-lstm capability).
    """
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        param_cells.append(LSTMParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
        last_states.append(LSTMState(
            c=sym.Variable("l%d_init_c" % i),
            h=sym.Variable("l%d_init_h" % i)))

    embed = _lm_embed(input_size, num_embed)
    wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len,
                               squeeze_axis=True, name="wordvec_slice")

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_lstm_layer):
            with (AttrScope(ctx_group=ctx_groups[i]) if ctx_groups
                  is not None else contextlib.nullcontext()):
                next_state = lstm_cell(num_hidden, indata=hidden,
                                       prev_state=last_states[i],
                                       param=param_cells[i],
                                       seqidx=seqidx, layeridx=i,
                                       dropout=dropout if i > 0 else 0.0)
            hidden = next_state.h
            last_states[i] = next_state
        if dropout > 0.0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, dim=0)
    return _lm_head(hidden_concat, num_label)


def lstm_inference_symbol(num_lstm_layer, input_size, num_hidden, num_embed,
                          num_label, dropout=0.0):
    """Single-step inference symbol (reference lstm.py lstm_inference_symbol)."""
    return lstm_unroll(num_lstm_layer, 1, input_size, num_hidden, num_embed,
                       num_label, dropout)


def lstm_unroll_scan(num_lstm_layer, seq_len, input_size, num_hidden,
                     num_embed, num_label, dropout=0.0):
    """The LM of lstm_unroll through the ``RNN`` op (``ops/rnn.py``)
    instead of seq_len x layers unrolled cells: the same argument names
    (data, softmax_label, l%d_init_c/h, l%d_i2h/h2h weights, embed/cls
    params) and gate layout, so a checkpoint of one form loads in the
    other."""
    L, H = num_lstm_layer, num_hidden
    embed = _lm_embed(input_size, num_embed)                   # (B, T, E)
    x = sym.transpose(embed, axes=(1, 0, 2))                   # (T, B, E)

    def stacked(prefix):
        parts = [sym.expand_dims(sym.Variable("l%d_init_%s" % (i, prefix)),
                                 axis=0) for i in range(L)]
        if L == 1:
            return parts[0]
        return sym.Concat(*parts, num_args=L, dim=0)           # (L, B, H)

    weight_inputs = {}
    for i in range(L):
        for w in ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"):
            n = "l%d_%s" % (i, w)
            weight_inputs[n] = sym.Variable(n)

    rnn = sym.RNN(x, state=stacked("h"), state_cell=stacked("c"),
                  state_size=H, num_layers=L, mode="lstm", p=dropout,
                  name="rnn", **weight_inputs)                 # (T, B, H)
    if dropout > 0.0:
        # lstm_unroll applies output dropout on every timestep's final
        # hidden before the classifier; match it (the RNN op itself only
        # does between-layer dropout)
        rnn = sym.Dropout(data=rnn, p=dropout)

    flat = sym.Reshape(rnn, shape=(-1, H))                     # (T*B, H)
    return _lm_head(flat, num_label)
