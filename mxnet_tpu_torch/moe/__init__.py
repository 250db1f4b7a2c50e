"""``mxnet_tpu_torch.moe``: top-k routed Mixture-of-Experts (counterpart
of ``mxnet_tpu.moe``).

* ``router``    top-k softmax gating, static capacity, GShard priority,
                the load-balance aux loss
* ``dispatch``  the capacity-bucketed scatter/gather (sentinel slots land
                in a scratch row past the buffer)
* ``layer``     ``MoEFeedForward`` over the ``_moe_dispatch`` /
                ``_moe_expert_ffn`` / ``_moe_combine`` ops, and
                ``with_aux_loss``
* ``detect``    ``find_moe_blocks`` for the fused step and the serving
                parity pass
* ``stats``     ``MoeStats`` behind ``mx.profiler.moe_report()``

Training rides the fused train step (the aux loss is one more head);
serving rides ``DecodeEngine(moe_hits_state=)``.
"""
from .router import resolve_capacity, route
from .dispatch import dispatch, combine
from .layer import (MoEFeedForward, aux_loss_symbols, count_symbols,
                    hit_symbols, with_aux_loss)
from .detect import MoEBlockSpec, find_moe_blocks
from .stats import MoeStats

__all__ = [
    "resolve_capacity", "route", "dispatch", "combine",
    "MoEFeedForward", "aux_loss_symbols", "count_symbols",
    "hit_symbols", "with_aux_loss",
    "MoEBlockSpec", "find_moe_blocks", "MoeStats",
]
