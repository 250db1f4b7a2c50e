"""Parallelism: meshes, collectives, data-parallel, pipeline and
sequence-parallel steps (counterpart of ``mxnet_tpu/parallel``).

The port runs one rank per device over ``torch.distributed``
(``dist.boot``): a mesh is an array of ranks with named axes
(``mesh.py``), ``collectives.py`` stands in for the collectives XLA
inserts, and the steps take the JAX package's global forms (a global
batch, a global sequence, stacked stage params), each rank keeping its
slice.  Tensor parallelism over axes other than ``dp`` is ROADMAP.md
queue 1 item 10b.
"""
from .mesh import (make_mesh, parse_mesh_spec, mesh_from_env,
                   normalize_spec, spec_axes, validate_spec,
                   sharding_attrs, dp_sharding, replicated,
                   Mesh, NamedSharding, PartitionSpec)
from . import collectives
from .data_parallel import DPTrainStep
from .pipeline import GPipeTrainStep, pipeline_apply
from .ring import (attention_reference, make_ring_attention,
                   ring_attention, ulysses_attention)

__all__ = ["make_mesh", "parse_mesh_spec", "mesh_from_env",
           "normalize_spec", "spec_axes", "validate_spec",
           "sharding_attrs", "dp_sharding", "replicated",
           "Mesh", "NamedSharding", "PartitionSpec", "DPTrainStep",
           "GPipeTrainStep", "pipeline_apply", "collectives",
           "attention_reference", "make_ring_attention", "ring_attention",
           "ulysses_attention"]
