"""Quantize/dequantize insertion and the serving pipeline factories
(counterpart of ``mxnet_tpu/passes/quantize.py``).

The rewrite, per eligible ``FullyConnected``/``Convolution`` node::

    x (f32) ──> _contrib_quantize(scale=s_x) ──> int8 ─┐
    W (f32 param)  ── pre-quantized host-side ── int8 ─┤──> _quantized_*  ──> f32
    W_wscale (new f32 param, per-out-channel)  ────────┤     (int32 sums,
    bias (f32 param, untouched) ───────────────────────┘      fused dequant)

* Activation scales come from a :class:`CalibrationTable`; weight scales
  are computed here, per output channel, and baked into the parameters
  as a small f32 vector, so hot reload re-quantizes.
* One ``_contrib_quantize`` node is inserted per (tensor, scale).
* Nodes whose op is not int8-eligible fall back to float16 (a ``Cast``
  sandwich and float16 params) when a fallback dtype is configured.
* The output layer (a matmul with no matmul downstream) is skipped by
  default: quantization noise on logits flips top-1 answers.

The defaults follow the device of the pass's ``ctx`` (default: the
current context, the card), where the JAX package asks jax for its
platform: on CUDA, int8 ``FullyConnected`` and ``Convolution`` and a
float16 fallback; on the CPU, ``FullyConnected`` only and no fallback,
as the reference on the CPU.  Env knobs, as in the reference:
``MXNET_QUANTIZE_OPS``, ``MXNET_QUANTIZE_FALLBACK``,
``MXNET_QUANTIZE_CALIB_MODE``, ``MXNET_QUANTIZE_PERCENTILE``,
``MXNET_QUANTIZE_CALIB_BATCHES`` and ``MXNET_QUANTIZE_SKIP``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, _AttrDict, get_env
from ..ndarray import NDArray
from ..ops.quantized import quantize_array
from ..symbol import Symbol, _Node, _topo
from .calibrate import CalibrationTable, calibrate_arrays
from .fuse import fusion_passes
from .graph_passes import (CSEPass, DeadNodeEliminationPass,
                           FoldConstantsPass, U8WirePass, _make_node,
                           rebuild, tensor_name)
from .moe import MoEServeParityPass
from .pipeline import Pass, PassError, PassPipeline, _as_np

__all__ = ["QuantizePass", "default_inference_pipeline",
           "build_serving_pipeline", "quantize_model",
           "default_quantize_ops", "default_fallback_dtype", "not_ported"]

# ops the rewrite understands at all (the matmul/conv family)
_TARGET_OPS = ("FullyConnected", "Convolution")
# Convolution params the quantized op does not carry
_DROP_CONV_PARAMS = ("workspace", "cudnn_tune", "cudnn_off")


def not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        "%s is not in the port yet (ROADMAP.md, queue 1)" % option)


def _on_cpu(ctx) -> bool:
    from ..context import current_context
    ctx = ctx if ctx is not None else current_context()
    return ctx.device_type in ("cpu", "cpu_pinned")


def default_quantize_ops(ctx=None) -> Tuple[str, ...]:
    """int8-eligible ops for ``ctx``'s device: both families on the card,
    ``FullyConnected`` only on the CPU (where an int8 convolution is slow,
    as in the reference)."""
    env = get_env("MXNET_QUANTIZE_OPS", "", str)
    if env:
        return tuple(x for x in env.split(",") if x)
    if _on_cpu(ctx):
        return ("FullyConnected",)
    return ("FullyConnected", "Convolution")


def default_fallback_dtype(ctx=None) -> Optional[str]:
    """Precision for targets int8 cannot take: float16 on the card; None
    (stay float32) on the CPU."""
    env = get_env("MXNET_QUANTIZE_FALLBACK", "", str)
    if env:
        return None if env in ("float32", "off", "none") else env
    return None if _on_cpu(ctx) else "float16"


def _dtype_name(v) -> str:
    """A param's dtype name, bfloat16 included, without numpy."""
    if isinstance(v, NDArray):
        v = v._get()
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def _cast_param(v, dt: str):
    """A float param rounded to ``dt`` (round to nearest even, as
    ``jnp.astype``): numpy for float16, a host NDArray for bfloat16,
    which numpy cannot hold without ``ml_dtypes``."""
    if dt == "bfloat16":
        t = v._get() if isinstance(v, NDArray) else \
            torch.from_numpy(np.array(_as_np(v), np.float32))
        return NDArray(t.detach().cpu().to(torch.bfloat16))
    return _as_np(v).astype(dt)


class QuantizePass(Pass):
    """The q/dq insertion pass (see the module docstring).

    Parameters
    ----------
    calib : CalibrationTable, optional
        Activation ranges.  When absent, ``calib_data`` must be given
        and the pass calibrates on the graph it is applied to (so the
        passes before it, the u8 wire and folds, are in effect).
    calib_data : ndarray or list of feed dicts, optional
        Feed sample in wire format: an array of items batched into
        ``calib_shapes``'s data shape, or explicit feed dicts.
    calib_shapes : dict name -> shape, optional
        Bind shapes for calibration (batch dim included).
    ops / fallback_dtype / skip / per_channel / skip_output_layer :
        See the module docstring; defaults follow ``ctx`` and the env.
    ctx : Context, optional
        Where calibration runs and what the defaults follow (default:
        the current context).
    """

    name = "quantize"

    def __init__(self, calib: Optional[CalibrationTable] = None, *,
                 calib_data=None, calib_shapes=None,
                 data_name: str = "data",
                 num_batches: Optional[int] = None,
                 mode: Optional[str] = None,
                 percentile: Optional[float] = None,
                 ops: Optional[Sequence[str]] = None,
                 fallback_dtype: Optional[str] = "auto",
                 skip: Sequence[str] = (),
                 skip_output_layer: bool = True,
                 per_channel: bool = True,
                 ctx=None):
        super().__init__()
        self.calib = calib
        self.calib_data = calib_data
        self.calib_shapes = dict(calib_shapes or {})
        self.data_name = data_name
        self.num_batches = num_batches if num_batches is not None else \
            get_env("MXNET_QUANTIZE_CALIB_BATCHES", 10, int)
        self.mode = mode or get_env("MXNET_QUANTIZE_CALIB_MODE",
                                    "percentile", str)
        self.percentile = percentile if percentile is not None else \
            get_env("MXNET_QUANTIZE_PERCENTILE", 99.99, float)
        self.ops = tuple(ops) if ops is not None \
            else default_quantize_ops(ctx)
        self.fallback_dtype = default_fallback_dtype(ctx) \
            if fallback_dtype == "auto" else fallback_dtype
        env_skip = get_env("MXNET_QUANTIZE_SKIP", "", str)
        self.skip = tuple(skip) + tuple(x for x in env_skip.split(",") if x)
        self.skip_output_layer = skip_output_layer
        self.per_channel = per_channel
        self.ctx = ctx
        # weight-transform records for hot reload:
        # [(wname, wscale_name, axis)] int8; [(pname, dtype)] casts
        self._w_quant: List[Tuple[str, str, Optional[int]]] = []
        self._p_cast: List[Tuple[str, str]] = []

    def config(self) -> str:
        return ";".join([
            "calib=%s" % (self.calib.digest() if self.calib else "-"),
            "ops=%s" % ",".join(self.ops),
            "fallback=%s" % (self.fallback_dtype or "-"),
            "skip=%s" % ",".join(self.skip),
            "skip_output=%s" % self.skip_output_layer,
            "per_channel=%s" % self.per_channel,
            "mode=%s;pct=%r;batches=%d" % (self.mode, self.percentile,
                                           self.num_batches),
        ])

    # -- calibration --------------------------------------------------------
    def _feeds(self) -> List[Dict[str, np.ndarray]]:
        data = self.calib_data
        if isinstance(data, (list, tuple)) and data and \
                isinstance(data[0], dict):
            return list(data)
        arr = _as_np(data)
        shape = self.calib_shapes.get(self.data_name)
        if shape is None:
            raise PassError("quantize: calib_shapes must name %r when "
                            "calib_data is an array" % self.data_name)
        b = int(shape[0])
        n = (arr.shape[0] // b) * b
        if n == 0:
            raise PassError(
                "quantize: calib_data has %d items, need >= one batch of "
                "%d" % (arr.shape[0], b))
        return [{self.data_name: arr[i:i + b].reshape((b,) + tuple(shape[1:]))}
                for i in range(0, min(n, b * self.num_batches), b)]

    def _ensure_calib(self, sym: Symbol, params: Dict) -> None:
        if self.calib is not None or self.calib_data is None:
            return
        # params is the merged arg+aux blob: pass it as both (copy_params
        # filters by name), so BatchNorm calibrates on its trained stats
        self.calib = calibrate_arrays(
            sym, self._feeds(), arg_params=params, aux_params=params,
            mode=self.mode, percentile=self.percentile, ctx=self.ctx,
            default_shapes=self.calib_shapes)

    # -- eligibility --------------------------------------------------------
    def _skippable(self, name: str) -> bool:
        return any(s and s in name for s in self.skip)

    @staticmethod
    def _output_layers(sym: Symbol) -> set:
        """ids of target nodes with no target node downstream: the
        logits layer(s), skipped by default (argmax fidelity)."""
        downstream_has_target: Dict[int, bool] = {}
        consumers: Dict[int, List[_Node]] = {}
        topo = _topo(sym._heads)
        for n in topo:
            for (i, _x) in n.inputs:
                consumers.setdefault(id(i), []).append(n)

        def walk(node) -> bool:
            key = id(node)
            if key in downstream_has_target:
                return downstream_has_target[key]
            downstream_has_target[key] = False      # cycle guard
            found = False
            for c in consumers.get(key, ()):
                if (not c.is_variable and c.op.name in _TARGET_OPS) \
                        or walk(c):
                    found = True
                    break
            downstream_has_target[key] = found
            return found

        return {id(n) for n in topo
                if not n.is_variable and n.op.name in _TARGET_OPS
                and not walk(n)}

    def _int8_eligible(self, node: _Node) -> bool:
        if node.op.name not in self.ops:
            return False
        if node.op.name == "Convolution" and (
                node.params.get("num_group") or 1) != 1:
            return False
        return True

    # -- the rewrite --------------------------------------------------------
    def apply(self, sym, params):
        if params is None:
            raise PassError("quantize needs the parameter blob (weights "
                            "are pre-quantized host-side)")
        self._ensure_calib(sym, params)
        new_params = dict(params)
        self._w_quant, self._p_cast = [], []
        output_layers = self._output_layers(sym) if self.skip_output_layer \
            else set()
        # weight vars consumed by >1 node cannot be retyped safely
        var_consumers: Dict[str, int] = {}
        for n in _topo(sym._heads):
            for (i, _x) in n.inputs:
                if i.is_variable:
                    var_consumers[i.name] = var_consumers.get(i.name, 0) + 1
        q_cache: Dict[Tuple[int, int, float], Tuple[_Node, int]] = {}
        quantized: List[str] = []
        fp16ed: List[str] = []
        q_nodes = 0

        def q_insert(src: Tuple[_Node, int], scale: float, label: str):
            nonlocal q_nodes
            key = (id(src[0]), src[1], scale)
            hit = q_cache.get(key)
            if hit is not None:
                return hit
            node = _make_node("_contrib_quantize", "%s_quantize" % label,
                              {"scale": scale}, [src])
            q_cache[key] = (node, 0)
            q_nodes += 1
            return (node, 0)

        def try_int8(node, new_inputs):
            src_node, src_idx = node.inputs[0]
            in_name = tensor_name(src_node, src_idx)
            s_in = self.calib.scale(in_name) if self.calib else None
            if s_in is None:
                return None
            wvar = node.inputs[1][0]
            wname = wvar.name
            if _dtype_name(new_params[wname]) not in ("float32", "float64"):
                return None                       # already transformed
            w = _as_np(new_params[wname])
            axis = 0 if self.per_channel else None
            wq, wscale = quantize_array(w, axis=axis)
            new_params[wname] = wq
            wsname = "%s_wscale" % wname
            new_params[wsname] = np.broadcast_to(
                np.asarray(wscale, np.float32).reshape(-1),
                (w.shape[0],)).copy()
            self._w_quant.append((wname, wsname, axis))
            p = {k: v for k, v in node.op.serialize_params(node.params)
                 .items() if k not in _DROP_CONV_PARAMS}
            p["scale_data"] = s_in
            qdata = q_insert(new_inputs[0], s_in, in_name)
            wsvar = _Node(None, wsname, attrs={})
            new_wvar = _Node(None, wname, attrs=dict(wvar.attrs))
            inputs = [qdata, (new_wvar, 0), (wsvar, 0)]
            if not node.params.get("no_bias"):
                inputs.append(new_inputs[2])
            qnode = _make_node("_quantized_%s" % node.op.name, node.name,
                               p, inputs, node.attrs)
            quantized.append(node.name)
            return [(qnode, 0)]

        def try_fp16(node, new_inputs):
            dt = self.fallback_dtype
            cast_in = _make_node("Cast", "%s_%scast" % (node.name, dt[:3]),
                                 {"dtype": dt}, [new_inputs[0]])
            inputs = [(cast_in, 0)] + list(new_inputs[1:])
            for (pv, _x) in node.inputs[1:]:
                if not (pv.is_variable and pv.name in new_params):
                    return None
            for (pv, _x) in node.inputs[1:]:
                name = _dtype_name(new_params[pv.name])
                if name.startswith("float") and name != dt:
                    new_params[pv.name] = _cast_param(new_params[pv.name],
                                                      dt)
                    self._p_cast.append((pv.name, dt))
            body = _Node(node.op, node.name, _AttrDict(node.params),
                         dict(node.attrs), inputs, node.is_aux)
            out = _make_node("Cast", "%s_f32cast" % node.name,
                             {"dtype": "float32"}, [(body, 0)])
            fp16ed.append(node.name)
            return [(out, 0)]

        def transform(node, new_inputs):
            if node.is_variable or node.op.name not in _TARGET_OPS:
                return None
            if self._skippable(node.name) or id(node) in output_layers:
                return None
            wvar = node.inputs[1][0]
            if not (wvar.is_variable and wvar.name in new_params
                    and var_consumers.get(wvar.name, 0) == 1):
                return None                  # shared/missing weight: leave
            if self._int8_eligible(node):
                res = try_int8(node, new_inputs)
                if res is not None:
                    return res
            if self.fallback_dtype:
                return try_fp16(node, new_inputs)
            return None

        out = rebuild(sym, transform)
        self.summary = {
            "rewrites": len(quantized) + len(fp16ed),
            "int8_nodes": quantized, "fp16_nodes": fp16ed,
            "q_nodes_inserted": q_nodes,
            "calib_tensors": len(self.calib) if self.calib else 0,
            "calib_digest": self.calib.digest() if self.calib else None,
        }
        return out, new_params

    def transform_params(self, params):
        """Hot reload: re-quantize fresh f32 weights into the rewritten
        graph's int8 + wscale convention, re-cast fallback params.
        Weights already at their target dtype pass through."""
        out = dict(params)
        for wname, wsname, axis in self._w_quant:
            if wname not in out or _dtype_name(out[wname]) == "int8":
                continue
            w = _as_np(out[wname])
            wq, wscale = quantize_array(w, axis=axis)
            out[wname] = wq
            out[wsname] = np.broadcast_to(
                np.asarray(wscale, np.float32).reshape(-1),
                (w.shape[0],)).copy()
        for pname, dt in self._p_cast:
            if pname in out:
                name = _dtype_name(out[pname])
                if name.startswith("float") and name != dt:
                    out[pname] = _cast_param(out[pname], dt)
        return out


# -- pipeline factories ------------------------------------------------------

def default_inference_pipeline(quantize: Optional[QuantizePass] = None,
                               u8_wire: Optional[U8WirePass] = None,
                               fuse=None, name: str = "inference",
                               verify: bool = True,
                               embed_dedup=None,
                               moe_exact=None) -> PassPipeline:
    """The serving pipeline: [u8 wire] -> fold -> cse -> dce ->
    [quantize] -> [moe parity] -> [fuse] -> [sparse embed].  The u8
    prologue must exist before calibration sees the graph; fusion runs
    after quantize so the int8 epilogues exist to fuse.  ``fuse``: falsy
    = off (the default here), True or a dict of FuseEpiloguePass kwargs
    plus ``elemwise``.  ``moe_exact``: None = the
    ``MXNET_MOE_SERVE_EXACT`` default (on).  ``embed_dedup``: True or a
    unique cap (int) appends ``SparseEmbedPass``."""
    from .embed import SparseEmbedPass
    from .moe import default_moe_exact
    passes: List[Pass] = [] if u8_wire is None else [u8_wire]
    passes += [FoldConstantsPass(), CSEPass(), DeadNodeEliminationPass()]
    if quantize is not None:
        passes.append(quantize)
    if moe_exact is None:
        moe_exact = default_moe_exact()
    if moe_exact:
        passes.append(MoEServeParityPass())
    passes += fusion_passes(fuse)
    if embed_dedup:
        passes.append(SparseEmbedPass(
            None if embed_dedup is True else int(embed_dedup)))
    return PassPipeline(passes, name=name, verify=verify)


def build_serving_pipeline(quantize=None, calib_data=None, calib_shapes=None,
                           data_name: str = "data", u8_wire=None,
                           fuse=True, name: str = "serve",
                           ctx=None, embed_dedup=None) -> PassPipeline:
    """ServeEngine's pipeline factory.

    ``quantize``: falsy = off; ``"int8"``/``"float16"``/``"bfloat16"``;
    or a dict of QuantizePass kwargs (plus an optional ``"dtype"``).
    int8 needs ``calib_data`` (a sample of requests in wire format) or a
    ``calib=`` table in the dict.  ``u8_wire``: falsy = off; True or a
    dict with ``mean``/``scale``/``hwc``.  ``fuse``: on unless False.
    ``ctx``: where calibration runs and what the quantize defaults
    follow (default: the current context, the card).  ``embed_dedup``:
    None = the ``MXNET_EMBED_DEDUP`` default (off); True or an int (the
    unique cap) rewrites Embedding lookups to ``_sparse_embedding``."""
    from .embed import default_embed_dedup
    if embed_dedup is None:
        embed_dedup = default_embed_dedup()
    u8_pass = None
    if u8_wire:
        kw = dict(u8_wire) if isinstance(u8_wire, dict) else {}
        u8_pass = U8WirePass(data_name=data_name, **kw)
    q_pass = None
    if quantize:
        kw = dict(quantize) if isinstance(quantize, dict) else {}
        dtype = kw.pop("dtype", quantize if isinstance(quantize, str)
                       else "int8")
        if dtype in ("float16", "bfloat16"):
            # a pure precision rewrite: no calibration, and calib_data is
            # not forwarded (no table would be consulted)
            kw.setdefault("ops", ())
            kw.setdefault("fallback_dtype", dtype)
        elif dtype != "int8":
            raise MXNetError("quantize dtype must be int8|float16|bfloat16, "
                             "got %r" % (dtype,))
        kw.setdefault("data_name", data_name)
        if dtype == "int8":
            if calib_data is not None:
                kw.setdefault("calib_data", calib_data)
            if calib_shapes is not None:
                kw.setdefault("calib_shapes", calib_shapes)
            if kw.get("calib") is None and kw.get("calib_data") is None:
                raise MXNetError(
                    "quantize='int8' needs calibration: pass calib_data= "
                    "(a sample of requests) or quantize={'calib': table}")
        kw.setdefault("ctx", ctx)
        q_pass = QuantizePass(**kw)
    return default_inference_pipeline(quantize=q_pass, u8_wire=u8_pass,
                                      fuse=fuse, name=name,
                                      embed_dedup=embed_dedup)


def quantize_model(sym: Symbol, arg_params: Dict, aux_params: Dict,
                   calib_data=None, calib_shapes=None, **kwargs):
    """One-call offline flow: -> (qsym, qarg_params, qaux_params,
    pipeline).  ``kwargs`` go to QuantizePass."""
    pipe = default_inference_pipeline(
        quantize=QuantizePass(calib_data=calib_data,
                              calib_shapes=calib_shapes, **kwargs),
        name="quantize_model")
    params = dict(arg_params)
    params.update(aux_params or {})
    qsym, qparams = pipe.run(sym, params)
    aux_names = set(qsym.list_auxiliary_states())
    qarg = {k: v for k, v in qparams.items() if k not in aux_names}
    qaux = {k: v for k, v in qparams.items() if k in aux_names}
    return qsym, qarg, qaux, pipe
