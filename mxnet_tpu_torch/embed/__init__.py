"""``mxnet_tpu_torch.embed``: the sparse embedding engine (counterpart of
``mxnet_tpu.embed``).

    sparse.py    dedup_ids / dedup_lookup / dedup_scatter_add /
                 sparse_apply_rows on tensors of a fixed shape (no host
                 read, so they run inside a captured CUDA graph)
    detect.py    which Embedding layers of a symbol can train sparsely
    table.py     EmbeddingTable: lookup / update / accumulate, state
    kvstore.py   kvstore.create("device_embed")
    stats.py     dedup ratios -> mx.profiler.embed_report

``Module.fit`` needs none of this imported: the fused train step finds
eligible Embedding layers and trains their tables with the deduped lazy
row update (``MXNET_EMBED_SPARSE=0`` trains them densely).
"""
from .detect import SparseEmbedSpec, find_sparse_embeds
from .kvstore import KVStoreDeviceEmbed, sparse_bound
from .sparse import (dedup_ids, dedup_lookup, dedup_scatter_add,
                     naive_lookup, naive_scatter_add, resolve_cap,
                     slot_leaves_row_shaped, sparse_apply_rows)
from .stats import EmbedStats
from .table import EmbeddingTable

__all__ = ["EmbeddingTable", "KVStoreDeviceEmbed", "EmbedStats",
           "SparseEmbedSpec", "find_sparse_embeds", "sparse_bound",
           "dedup_ids", "dedup_lookup", "dedup_scatter_add",
           "naive_lookup", "naive_scatter_add", "resolve_cap",
           "slot_leaves_row_shaped", "sparse_apply_rows"]
