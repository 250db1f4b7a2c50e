"""Model zoo: the networks the port carries so far, built on its symbol
API exactly as the JAX package builds them."""
from .mlp import get_mlp
from .lenet import get_lenet
from .resnet import get_resnet, get_resnet50, get_resnet_cifar
from .vgg import get_vgg
from .lstm import (lstm_unroll, lstm_unroll_scan, lstm_cell,
                   LSTMState, LSTMParam)
from .gru import gru_unroll, gru_cell, rnn_unroll, rnn_cell, GRUState, \
    GRUParam, RNNState, RNNParam

__all__ = ["get_mlp", "get_lenet", "get_resnet", "get_resnet50",
           "get_resnet_cifar", "get_vgg", "lstm_unroll", "lstm_unroll_scan",
           "lstm_cell", "LSTMState", "LSTMParam", "gru_unroll", "gru_cell",
           "rnn_unroll", "rnn_cell", "GRUState", "GRUParam", "RNNState",
           "RNNParam"]
