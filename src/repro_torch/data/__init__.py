"""Deterministic synthetic data pipelines (port of ``repro.data``): the LM
and frame tasks, IID and non-IID, and the pluggable client partitioners."""

from .partition import (
    DirichletPartition,
    DomainPartition,
    IIDPartition,
    ShardPartition,
    make_partitioned_batch_fn,
)
from .synthetic import (
    FrameTask,
    LMTask,
    Partitioner,
    frame_batch,
    lm_batch,
    make_frame_task,
    make_lm_task,
)

__all__ = [
    "LMTask", "FrameTask", "Partitioner", "lm_batch", "frame_batch", "make_lm_task",
    "make_frame_task", "DirichletPartition", "DomainPartition", "IIDPartition",
    "ShardPartition", "make_partitioned_batch_fn",
]
