"""Serving pipeline builders (counterpart of the builders in
``mxnet_tpu/passes/quantize.py``).

The pipeline is fold -> cse -> dce -> moe_serve_parity -> [fuse_epilogue
-> elemwise_fuse], the JAX package's default serving pipeline without
quantization.  ``QuantizePass``, the uint8 wire prologue and embedding
dedup come with the serving-options slice; asking for them raises.
"""
from __future__ import annotations

from typing import List

from .fuse import fusion_passes
from .graph_passes import CSEPass, DeadNodeEliminationPass, FoldConstantsPass
from .moe import MoEServeParityPass
from .pipeline import Pass, PassPipeline

__all__ = ["default_inference_pipeline", "build_serving_pipeline",
           "not_ported"]


def not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        "%s is not in the port yet (ROADMAP.md, queue 1 item 6: serving "
        "options)" % option)


def default_inference_pipeline(fuse=None, name: str = "inference",
                               verify: bool = True) -> PassPipeline:
    """fold -> cse -> dce -> moe parity -> [fuse].  ``fuse``: falsy =
    off, True or a dict of FuseEpiloguePass kwargs plus ``elemwise``."""
    passes: List[Pass] = [FoldConstantsPass(), CSEPass(),
                          DeadNodeEliminationPass(), MoEServeParityPass()]
    passes += fusion_passes(fuse)
    return PassPipeline(passes, name=name, verify=verify)


def build_serving_pipeline(quantize=None, calib_data=None, u8_wire=None,
                           fuse=True, name: str = "serve",
                           embed_dedup=None) -> PassPipeline:
    """ServeEngine's pipeline factory: fusion on unless ``fuse=False``."""
    for option, value in (("quantize=", quantize),
                          ("calib_data=", calib_data),
                          ("u8_wire=", u8_wire),
                          ("embed_dedup=", embed_dedup)):
        if value is not None and value is not False:
            raise not_ported(option)
    return default_inference_pipeline(fuse=fuse, name=name)
