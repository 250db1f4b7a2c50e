"""The legacy checkpoint pair (counterpart of ``save_checkpoint`` /
``load_checkpoint`` in ``mxnet_tpu/model.py``): ``prefix-symbol.json``
plus ``prefix-%04d.params`` with ``arg:``/``aux:`` key prefixes, in the
formats both packages read and write; and ``BatchEndParam``, what the
fit loop hands its batch-end callbacks."""
from __future__ import annotations

import glob
import os
from collections import namedtuple
from typing import Dict, Optional, Tuple

from .base import MXNetError, local_path, open_stream
from .context import Context
from .ndarray import NDArray, load as nd_load, save as nd_save
from .symbol import Symbol, load_json as sym_load_json

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix: str, epoch: int, symbol: Symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray]) -> None:
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, each
    published atomically."""
    symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd_save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix: str, epoch: int, ctx: Optional[Context] = None
                    ) -> Tuple[Symbol, Dict[str, NDArray], Dict[str, NDArray]]:
    """-> (symbol, arg_params, aux_params), the arrays on ``ctx`` (default:
    the current context).  A missing file is named with the param files
    that do exist for the prefix."""
    sym_file = "%s-symbol.json" % prefix
    param_file = "%s-%04d.params" % (prefix, epoch)
    for fname, kind in ((sym_file, "symbol"), (param_file, "params")):
        if not os.path.exists(local_path(fname)):
            have = sorted(glob.glob("%s-*.params" % prefix))
            raise MXNetError(
                "checkpoint %s file missing: %r (existing param files for "
                "this prefix: %s)" % (kind, fname, have or "none"))
    with open_stream(sym_file) as f:
        symbol = sym_load_json(f.read())
    arg_params: Dict[str, NDArray] = {}
    aux_params: Dict[str, NDArray] = {}
    for k, v in nd_load(param_file, ctx=ctx).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
