"""Predictor: the deployment mini-API (counterpart of
``mxnet_tpu/predictor.py``).

A Predictor loads a checkpoint pair (or a symbol JSON plus params),
optionally runs a graph pass pipeline over it, and binds one executor per
input-shape set; every cached executor shares one set of parameter
buffers on the device, so ``reshape`` to a seen shape costs nothing and
``set_params`` swaps weights for every shape at once.  It runs on
``gpu(dev_id)`` unless ``dev_type="cpu"`` is asked for.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .base import MXNetError
from .context import Context, cpu
from .ndarray import NDArray, array as nd_array, load as nd_load
from .symbol import load_json as sym_load_json

__all__ = ["Predictor", "load_ndarray_file", "create_predictor",
           "load_checkpoint_pair", "strip_param_prefixes"]


def strip_param_prefixes(params: Dict) -> Dict:
    """Drop the ``arg:``/``aux:`` checkpoint key prefixes."""
    return {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in params.items()}


def _as_nd(v) -> NDArray:
    """To a host NDArray, keeping the dtype."""
    if isinstance(v, NDArray):
        return v
    arr = np.asarray(v)
    return nd_array(arr, ctx=cpu(), dtype=arr.dtype)


def load_ndarray_file(path: str) -> Dict[str, NDArray]:
    """Read a saved param blob onto the host, prefixes stripped."""
    return strip_param_prefixes(nd_load(path, ctx=cpu()))


def load_checkpoint_pair(prefix: str, epoch: int) -> Tuple[str, Dict]:
    """-> (symbol_json, params dict on the host) for a checkpoint pair.
    Failures name the file and tell a missing one from a corrupt one."""
    sym_file = "%s-symbol.json" % prefix
    param_file = "%s-%04d.params" % (prefix, epoch)
    if not os.path.exists(sym_file):
        pat = os.path.join(os.path.dirname(sym_file) or ".", "*-symbol.json")
        raise MXNetError(
            "predictor symbol file missing: %r (symbol files present in "
            "that directory: %s)" % (sym_file, sorted(glob.glob(pat))
                                      or "none"))
    with open(sym_file) as f:
        sym_json = f.read()
    try:
        sym_load_json(sym_json)
    except (ValueError, KeyError, MXNetError) as e:
        raise MXNetError("predictor symbol file corrupt: %r (%s: %s)"
                         % (sym_file, type(e).__name__, e)) from e
    if not os.path.exists(param_file):
        have = sorted(glob.glob("%s-*.params" % prefix))
        raise MXNetError(
            "predictor params file missing: %r (existing param files for "
            "this prefix: %s)" % (param_file, have or "none"))
    try:
        params = load_ndarray_file(param_file)
    except (ValueError, KeyError, OSError, EOFError, MXNetError) as e:
        raise MXNetError("predictor params file corrupt: %r (%s: %s)"
                         % (param_file, type(e).__name__, e)) from e
    return sym_json, params


class Predictor:
    """Create from a symbol JSON (string or path) and params (a dict,
    ``arg:``/``aux:`` prefixes accepted, or a ``.params`` path)."""

    def __init__(self, symbol_json: str, param_bytes_or_path,
                 input_shapes: Dict[str, Tuple[int, ...]],
                 dev_type: str = "gpu", dev_id: int = 0,
                 type_dict: Optional[Dict] = None,
                 pipeline=None):
        if not symbol_json.lstrip().startswith("{"):
            with open(symbol_json) as f:
                symbol_json = f.read()
        self.symbol = sym_load_json(symbol_json)
        self.ctx = Context(dev_type, dev_id)
        self.ctx.torch_device()         # no card -> raise now, not at bind
        if isinstance(param_bytes_or_path, dict):
            params = strip_param_prefixes(param_bytes_or_path)
        else:
            params = load_ndarray_file(param_bytes_or_path)
        # graph pass pipeline: bind the TRANSFORMED symbol; its
        # fingerprint rides in the graph attrs (``__passes__``)
        self._pipeline = pipeline
        if pipeline is not None:
            self.symbol, params = pipeline.run(self.symbol, params)
            params = dict(params)
            # a pass that retypes an input (the u8 wire) publishes it
            # here; the caller's type_dict entries still win below
            type_dict = dict(pipeline.type_overrides, **(type_dict or {}))
        self._arg_names = frozenset(self.symbol.list_arguments())
        self._aux_names = frozenset(self.symbol.list_auxiliary_states())
        self._arg_params = {k: _as_nd(v) for k, v in params.items()
                            if k in self._arg_names}
        self._aux_params = {k: _as_nd(v) for k, v in params.items()
                            if k in self._aux_names}
        # bind every argument at its stored dtype, and the non-param
        # inputs at the params' common float dtype; type_dict wins
        self._type_dict: Dict[str, np.dtype] = {
            k: v.dtype for k, v in self._arg_params.items()}
        float_dts = {dt for dt in self._type_dict.values() if dt.kind == "f"}
        if len(float_dts) == 1:
            common = float_dts.pop()
            for name in self._arg_names - set(self._type_dict):
                self._type_dict[name] = common
        for k, v in (type_dict or {}).items():
            self._type_dict[k] = np.dtype(v)
        self._exec_cache: Dict[Tuple, object] = {}
        self._bind(dict(input_shapes))

    @staticmethod
    def _shape_key(input_shapes: Dict[str, Tuple[int, ...]]) -> Tuple:
        return tuple(sorted((k, tuple(v)) for k, v in input_shapes.items()))

    def _bind(self, input_shapes: Dict[str, Tuple[int, ...]]):
        self._input_shapes = input_shapes
        key = self._shape_key(input_shapes)
        cached = self._exec_cache.get(key)
        if cached is not None:
            self._exec = cached
            return
        shared = next(iter(self._exec_cache.values())) \
            if self._exec_cache else None
        ex = self.symbol.simple_bind(
            self.ctx, grad_req="null", type_dict=dict(self._type_dict),
            shared_exec=shared, **input_shapes)
        # arrays shared with the first executor already hold the params
        shared_ids = {id(a) for a in (list(shared.arg_dict.values())
                                      + list(shared.aux_dict.values()))} \
            if shared is not None else set()
        ex.copy_params_from(
            {k: v for k, v in self._arg_params.items()
             if id(ex.arg_dict.get(k)) not in shared_ids},
            {k: v for k, v in self._aux_params.items()
             if id(ex.aux_dict.get(k)) not in shared_ids},
            allow_extra_params=True)
        self._exec = ex
        self._exec_cache[key] = self._exec

    def set_input(self, name: str, data) -> None:
        """Write one input, cast to the bound input's dtype."""
        self._exec.arg_dict[name][:] = np.asarray(data)

    def set_params(self, arg_params: Optional[Dict] = None,
                   aux_params: Optional[Dict] = None) -> None:
        """Hot-swap weights into the shared parameter buffers (every
        cached executor sees them)."""
        if self._pipeline is not None and (arg_params or aux_params):
            merged = strip_param_prefixes(dict(arg_params or {}))
            merged.update(strip_param_prefixes(dict(aux_params or {})))
            arg_params, aux_params = \
                self._pipeline.transform_params(merged), None
        for k, v in strip_param_prefixes(dict(arg_params or {})).items():
            if k in self._arg_names:
                self._arg_params[k] = _as_nd(v)
            elif k in self._aux_names:
                self._aux_params[k] = _as_nd(v)
        for k, v in strip_param_prefixes(dict(aux_params or {})).items():
            if k in self._aux_names:
                self._aux_params[k] = _as_nd(v)
        for ex in self._exec_cache.values():
            ex.copy_params_from(self._arg_params, self._aux_params,
                                allow_extra_params=True)

    def forward(self) -> None:
        self._exec.forward(is_train=False)

    def get_output(self, index: int) -> np.ndarray:
        return self._exec.outputs[index].asnumpy()

    def get_output_shape(self, index: int) -> Tuple[int, ...]:
        """The shape of output ``index``: of the last forward, else as
        inferred for the bound input shapes."""
        if self._exec._outputs_nd is not None:
            return tuple(self._exec.outputs[index].shape)
        return tuple(self.symbol.infer_shape(**self._input_shapes)[1][index])

    def reshape(self, input_shapes: Dict[str, Tuple[int, ...]]
                ) -> "Predictor":
        """New input shapes, shared weights; a seen shape set reuses its
        executor."""
        self._bind(dict(input_shapes))
        return self

    def ensure_bound(self, input_shapes: Dict[str, Tuple[int, ...]]):
        """Bind (or fetch) the executor for this shape set without
        switching the current one.  Returns the executor."""
        keep_exec, keep_shapes = self._exec, self._input_shapes
        try:
            self._bind(dict(input_shapes))
            return self._exec
        finally:
            self._exec, self._input_shapes = keep_exec, keep_shapes

    def precompile(self, shape_sets) -> int:
        """Bind every shape set and run one forward of each (zeros in),
        so buffers, library handles and the kernels' builds are ready
        before the first real input.  The port has no compile cache yet
        (ROADMAP.md, queue 1 item 11): nothing persists across processes.
        Returns the number of shape sets warmed."""
        shape_sets = list(shape_sets)
        for shapes in shape_sets:
            self.ensure_bound(dict(shapes)).forward(is_train=False)
        return len(shape_sets)

    def predict(self, data) -> np.ndarray:
        """One-shot: set the first input, forward, output 0."""
        first = next(iter(self._input_shapes))
        self.set_input(first, data)
        self.forward()
        return self.get_output(0)


def create_predictor(prefix: str, epoch: int, input_shapes,
                     dev_type="gpu", dev_id=0, type_dict=None) -> Predictor:
    """Build a Predictor from a ``save_checkpoint`` pair."""
    sym_json, params = load_checkpoint_pair(prefix, epoch)
    return Predictor(sym_json, params, input_shapes, dev_type, dev_id,
                     type_dict=type_dict)
