"""Parallelism (port of ``parallel/``): the ('data', 'model') device mesh
with channel tensor parallelism and fsdp (``mesh``), the process group
(``distributed``), the multi-process check (``hybrid``), the stage
pipeline and its 1F1B training (``pipeline``, ``pipeline_train``) and the
sequence-parallel halos (``spatial``). The expert-parallel routed
dispatch lives with the mixture, in ``eval.ensemble``.

The pipeline's and the halos' names load on first use: their modules
build on ``models.unet``, which imports ``parallel.layers`` from here."""

import importlib

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

_LAZY = {
    "PipelinedDenoiser": "pipeline",
    "make_stages": "pipeline",
    "PipelineTrainer": "pipeline_train",
    "PipeTrainState": "pipeline_train",
    "schedule_1f1b": "pipeline_train",
    "RECEPTIVE_RADIUS": "spatial",
    "denoise_spec_sharded": "spatial",
    "make_seq_mesh": "spatial",
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)

__all__ = [
    "PipelinedDenoiser",
    "PipelineTrainer",
    "PipeTrainState",
    "schedule_1f1b",
    "launch_hybrid_check",
    "make_stages",
    "RECEPTIVE_RADIUS",
    "denoise_spec_sharded",
    "make_seq_mesh",
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
