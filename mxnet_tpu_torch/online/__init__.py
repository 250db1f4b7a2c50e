"""mxnet_tpu_torch.online: continuous training on live serve traffic
(counterpart of ``mxnet_tpu/online``, the same names, files and knobs).

The closed loop the system papers promise: the same substrate trains
and serves, and models move from learner to server continuously ::

    serve --> capture --> replay --> fine-tune --> gate --> promote
      ^                                                        |
      +------------- rolling_restart (zero drops) -------------+

* :mod:`capture`  — sampled request/response capture at the router
  seam into crash-tolerant SEALED shards (``ServeRouter(capture=w)``).
* :mod:`replay`   — sealed shards back into a ``FeedDataIter`` whose
  checkpointed cursor resumes exactly.
* :mod:`trainer`  — ``OnlineTrainer``: cumulative ``Module.fit``
  rounds against one checkpoint store, Supervisor-restartable bitwise.
* :mod:`promote`  — ``PromotionGate`` (held-out quality + drift) and
  the zero-drop ``rolling_restart`` promotion, with embed-table
  freshness carried forward.

Every stage rides the fault plane (``online.capture@seal``,
``online.train@round``, ``online.promote@decide/restart/record``), and
the whole loop is chaos-tested: torn capture shard, worker SIGKILL
mid-fit, crash mid-promotion, and the promoted weights stay bitwise equal
to a fault-free run.  The shards, their SEALED markers and the
PROMOTED/QUARANTINED records are byte-compatible with the JAX
package's: shards sealed by either package replay in the other.
"""
from . import capture
from . import replay
from . import trainer
from . import promote

from .capture import (CaptureWriter, is_sealed, sealed_shards,
                      shard_path, seal_path)
from .replay import (UnsealedShardError, load_shard, replay_pipeline,
                     replay_source)
from .trainer import OnlineTrainer
from .promote import (PromotionGate, freshen_embed, promote as
                      promote_checkpoint, quarantine, read_record,
                      PROMOTED_RECORD, QUARANTINED_RECORD)

__all__ = [
    "capture", "replay", "trainer", "promote",
    "CaptureWriter", "is_sealed", "sealed_shards", "shard_path",
    "seal_path",
    "UnsealedShardError", "load_shard", "replay_pipeline",
    "replay_source",
    "OnlineTrainer",
    "PromotionGate", "freshen_embed", "promote_checkpoint",
    "quarantine", "read_record", "PROMOTED_RECORD",
    "QUARANTINED_RECORD",
]
