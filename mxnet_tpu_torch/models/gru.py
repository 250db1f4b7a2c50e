"""Unrolled GRU and vanilla-RNN language models, built on the port's
symbol API exactly as the JAX package builds them
(``mxnet_tpu/models/gru.py``): the same node and argument names, so
checkpoints cross between the packages."""
from collections import namedtuple

from .. import symbol as sym

GRUState = namedtuple("GRUState", ["h"])
GRUParam = namedtuple("GRUParam", ["gates_i2h_weight", "gates_i2h_bias",
                                   "gates_h2h_weight", "gates_h2h_bias",
                                   "trans_i2h_weight", "trans_i2h_bias",
                                   "trans_h2h_weight", "trans_h2h_bias"])
RNNState = namedtuple("RNNState", ["h"])
RNNParam = namedtuple("RNNParam", ["i2h_weight", "i2h_bias",
                                   "h2h_weight", "h2h_bias"])


def gru_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0):
    """One GRU step: the update and reset gates from one FC pair."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.gates_i2h_weight,
                             bias=param.gates_i2h_bias,
                             num_hidden=num_hidden * 2,
                             name="t%d_l%d_gates_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.gates_h2h_weight,
                             bias=param.gates_h2h_bias,
                             num_hidden=num_hidden * 2,
                             name="t%d_l%d_gates_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    slices = sym.SliceChannel(gates, num_outputs=2,
                              name="t%d_l%d_slice" % (seqidx, layeridx))
    update_gate = sym.Activation(slices[0], act_type="sigmoid")
    reset_gate = sym.Activation(slices[1], act_type="sigmoid")
    htrans_i2h = sym.FullyConnected(data=indata,
                                    weight=param.trans_i2h_weight,
                                    bias=param.trans_i2h_bias,
                                    num_hidden=num_hidden,
                                    name="t%d_l%d_trans_i2h"
                                    % (seqidx, layeridx))
    h_after_reset = prev_state.h * reset_gate
    htrans_h2h = sym.FullyConnected(data=h_after_reset,
                                    weight=param.trans_h2h_weight,
                                    bias=param.trans_h2h_bias,
                                    num_hidden=num_hidden,
                                    name="t%d_l%d_trans_h2h"
                                    % (seqidx, layeridx))
    h_trans = sym.Activation(htrans_i2h + htrans_h2h, act_type="tanh")
    next_h = prev_state.h + update_gate * (h_trans - prev_state.h)
    return GRUState(h=next_h)


def rnn_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             act_type="tanh", dropout=0.0):
    """One vanilla-RNN step (reference rnn.py rnn)."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    return RNNState(h=sym.Activation(i2h + h2h, act_type=act_type))


def _unroll_lm(cell_kind, num_layer, seq_len, input_size, num_hidden,
               num_embed, num_label, dropout=0.0):
    """Shared LM unroll skeleton for gru/rnn (mirrors lstm_unroll)."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_layer):
        if cell_kind == "gru":
            param_cells.append(GRUParam(
                gates_i2h_weight=sym.Variable("l%d_i2h_gates_weight" % i),
                gates_i2h_bias=sym.Variable("l%d_i2h_gates_bias" % i),
                gates_h2h_weight=sym.Variable("l%d_h2h_gates_weight" % i),
                gates_h2h_bias=sym.Variable("l%d_h2h_gates_bias" % i),
                trans_i2h_weight=sym.Variable("l%d_i2h_trans_weight" % i),
                trans_i2h_bias=sym.Variable("l%d_i2h_trans_bias" % i),
                trans_h2h_weight=sym.Variable("l%d_h2h_trans_weight" % i),
                trans_h2h_bias=sym.Variable("l%d_h2h_trans_bias" % i)))
            last_states.append(GRUState(h=sym.Variable("l%d_init_h" % i)))
        else:
            param_cells.append(RNNParam(
                i2h_weight=sym.Variable("l%d_i2h_weight" % i),
                i2h_bias=sym.Variable("l%d_i2h_bias" % i),
                h2h_weight=sym.Variable("l%d_h2h_weight" % i),
                h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
            last_states.append(RNNState(h=sym.Variable("l%d_init_h" % i)))

    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=input_size,
                          weight=embed_weight, output_dim=num_embed,
                          name="embed")
    wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len,
                               squeeze_axis=True, name="wordvec_slice")

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_layer):
            dp = dropout if i > 0 else 0.0
            if cell_kind == "gru":
                next_state = gru_cell(num_hidden, indata=hidden,
                                      prev_state=last_states[i],
                                      param=param_cells[i], seqidx=seqidx,
                                      layeridx=i, dropout=dp)
            else:
                next_state = rnn_cell(num_hidden, indata=hidden,
                                      prev_state=last_states[i],
                                      param=param_cells[i], seqidx=seqidx,
                                      layeridx=i, dropout=dp)
            hidden = next_state.h
            last_states[i] = next_state
        if dropout > 0.0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, dim=0)
    pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label_t = sym.transpose(data=label)
    label_flat = sym.Reshape(data=label_t, target_shape=(0,), shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")


def gru_unroll(num_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0):
    """Unrolled GRU LM (reference gru.py gru_unroll)."""
    return _unroll_lm("gru", num_layer, seq_len, input_size, num_hidden,
                      num_embed, num_label, dropout)


def rnn_unroll(num_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0):
    """Unrolled vanilla-RNN LM (reference rnn.py rnn_unroll)."""
    return _unroll_lm("rnn", num_layer, seq_len, input_size, num_hidden,
                      num_embed, num_label, dropout)
