"""``mxnet_tpu_torch.passes``: the symbol-graph pass pipeline
(counterpart of ``mxnet_tpu.passes``).

* ``FoldConstantsPass``, ``CSEPass``, ``DeadNodeEliminationPass``
* ``MoEServeParityPass``
* ``FuseEpiloguePass`` (matmul/conv + Activation -> one ``_fused_*`` op)
  and ``ElementwiseFusePass``

with a round-trip + attr-preservation verifier after every pass and the
pipeline fingerprint stamped into the result (``__passes__``).
"""
from .pipeline import Pass, PassError, PassPipeline
from .verify import check_attrs_preserved, diff_attrs, verify_roundtrip
from .graph_passes import (CSEPass, DeadNodeEliminationPass,
                           FoldConstantsPass, rebuild)
from .moe import MoEServeParityPass
from .fuse import ElementwiseFusePass, FuseEpiloguePass, fusion_passes
from .quantize import build_serving_pipeline, default_inference_pipeline

__all__ = [
    "Pass", "PassError", "PassPipeline",
    "check_attrs_preserved", "diff_attrs", "verify_roundtrip",
    "CSEPass", "DeadNodeEliminationPass", "FoldConstantsPass",
    "rebuild", "MoEServeParityPass",
    "ElementwiseFusePass", "FuseEpiloguePass", "fusion_passes",
    "build_serving_pipeline", "default_inference_pipeline",
]
