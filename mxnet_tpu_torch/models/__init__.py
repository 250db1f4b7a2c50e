"""Model zoo: every network of the JAX package's ``models/``, built on the
port's symbol API exactly as the JAX package builds them."""
from .mlp import get_mlp
from .lenet import get_lenet
from .alexnet import get_alexnet
from .googlenet import get_googlenet
from .inception_v3 import get_inception_v3
from .resnet import get_resnet, get_resnet50, get_resnet_cifar
from .inception_bn import get_inception_bn, get_inception_bn_28small
from .vgg import get_vgg
from .lstm import (lstm_unroll, lstm_unroll_scan, lstm_cell,
                   LSTMState, LSTMParam)
from .dcgan import make_generator, make_discriminator
from .fcn import get_fcn32s, get_fcn16s, get_fcn8s
from .rcnn import get_fast_rcnn, get_rpn
from .gru import gru_unroll, gru_cell, rnn_unroll, rnn_cell, GRUState, \
    GRUParam, RNNState, RNNParam

__all__ = ["get_mlp", "get_lenet", "get_alexnet", "get_googlenet",
           "get_inception_v3", "get_resnet", "get_resnet50",
           "get_resnet_cifar", "get_inception_bn",
           "get_inception_bn_28small", "get_vgg", "lstm_unroll",
           "lstm_unroll_scan", "lstm_cell", "LSTMState", "LSTMParam",
           "make_generator", "make_discriminator", "get_fcn32s",
           "get_fcn16s", "get_fcn8s", "get_fast_rcnn", "get_rpn",
           "gru_unroll", "gru_cell", "rnn_unroll", "rnn_cell", "GRUState",
           "GRUParam", "RNNState", "RNNParam"]
