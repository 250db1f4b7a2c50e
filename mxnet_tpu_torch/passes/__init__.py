"""``mxnet_tpu_torch.passes``: the symbol-graph pass pipeline
(counterpart of ``mxnet_tpu.passes``).

* ``FoldConstantsPass``, ``CSEPass``, ``DeadNodeEliminationPass``
* ``U8WirePass`` (the in-graph uint8 cast/normalize prologue)
* ``QuantizePass`` (calibrated int8, float16 fallback) with
  ``calibrate``/``calibrate_arrays`` and ``CalibrationTable``
* ``MoEServeParityPass`` and ``SparseEmbedPass``
* ``FuseEpiloguePass`` (matmul/conv + Activation (+ ``_contrib_quantize``)
  -> one ``_fused_*`` op) and ``ElementwiseFusePass``

with a round-trip + attr-preservation verifier after every pass and the
pipeline fingerprint stamped into the result (``__passes__``).  The
serving flow ``ServeEngine(quantize=...)`` runs::

    table = passes.calibrate(sym, data_iter, num_batches=10,
                             arg_params=arg, aux_params=aux)
    pipe = passes.default_inference_pipeline(
        quantize=passes.QuantizePass(calib=table), fuse=True)
    qsym, qparams = pipe.run(sym, {**arg, **aux})
"""
from .pipeline import Pass, PassError, PassPipeline, PassStats
from .verify import check_attrs_preserved, diff_attrs, verify_roundtrip
from .graph_passes import (CSEPass, DeadNodeEliminationPass,
                           FoldConstantsPass, U8WirePass, rebuild,
                           tensor_name)
from .calibrate import CalibrationTable, calibrate, calibrate_arrays
from .moe import MoEServeParityPass, default_moe_exact
from .embed import SparseEmbedPass, default_embed_dedup
from .fuse import ElementwiseFusePass, FuseEpiloguePass, fusion_passes
from .quantize import (QuantizePass, build_serving_pipeline,
                       default_fallback_dtype, default_inference_pipeline,
                       default_quantize_ops, quantize_model)

__all__ = [
    "Pass", "PassError", "PassPipeline", "PassStats",
    "check_attrs_preserved", "diff_attrs", "verify_roundtrip",
    "CSEPass", "DeadNodeEliminationPass", "FoldConstantsPass",
    "U8WirePass", "rebuild", "tensor_name",
    "ElementwiseFusePass", "FuseEpiloguePass", "fusion_passes",
    "MoEServeParityPass", "default_moe_exact",
    "SparseEmbedPass", "default_embed_dedup",
    "CalibrationTable", "calibrate", "calibrate_arrays",
    "QuantizePass", "build_serving_pipeline", "default_fallback_dtype",
    "default_inference_pipeline", "default_quantize_ops", "quantize_model",
]
