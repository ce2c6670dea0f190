"""Data parallelism and ZeRO-3 over ``torch.distributed`` ranks.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel``'s
data axis: ``mesh`` (DP), ``multihost`` (per-rank rows, summed eval
counts) and ``fsdp``. Tensor, sequence, expert and pipeline parallelism
(``tp``, ``sp``, ``ep``, ``pp``) are not ported yet.
"""

from .fsdp import fsdp_partition_specs, setup_fsdp
from .mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    setup_data_parallel,
    shard_batch,
)
from .multihost import allreduce_counts, distribute_batch, local_replica, process_slice

__all__ = [
    "allreduce_counts",
    "batch_sharding",
    "distribute_batch",
    "fsdp_partition_specs",
    "local_replica",
    "make_mesh",
    "process_slice",
    "replicate",
    "replicated",
    "setup_data_parallel",
    "setup_fsdp",
    "shard_batch",
]
