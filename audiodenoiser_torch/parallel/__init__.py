"""Parallelism (port of ``parallel/``, its mesh half): the ('data', 'model')
device mesh with channel tensor parallelism and fsdp (``mesh``), the
process group (``distributed``) and the multi-process check (``hybrid``).

The pipeline (``pipeline.py``, ``pipeline_train.py``), the sequence-parallel
halos (``spatial.py``) and the expert-parallel routed dispatch are not
ported yet (ROADMAP A.11)."""

from audiodenoiser_torch.parallel.distributed import is_primary, maybe_initialize
from audiodenoiser_torch.parallel.hybrid import launch_hybrid_check
from audiodenoiser_torch.parallel.mesh import (
    batch_sharding,
    gather_rows,
    make_mesh,
    param_shardings,
    param_spec,
    shard_batch,
    shard_model,
    shard_train_state,
    shard_variables,
)

__all__ = [
    "launch_hybrid_check",
    "make_mesh",
    "batch_sharding",
    "param_shardings",
    "param_spec",
    "shard_batch",
    "gather_rows",
    "shard_model",
    "shard_train_state",
    "shard_variables",
    "maybe_initialize",
    "is_primary",
]
