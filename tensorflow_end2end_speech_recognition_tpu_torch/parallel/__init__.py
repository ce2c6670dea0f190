"""Data, tensor, sequence, expert and pipeline parallelism and ZeRO-3
over ``torch.distributed`` ranks.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel``:
``mesh`` (named axes, DP, the hops between pipeline stages),
``multihost`` (per-rank rows, summed eval counts), ``fsdp`` (ZeRO-3,
composed with tp / ep through ``base_specs``), ``tp`` (Megatron column ->
row pairs over ``model``), ``sp`` (the conformer's frames over ``seq``),
``ep`` (MoE experts over ``expert``) and ``pp`` (GPipe stages of the
conformer's layers over ``pipe``, composed with tp).
"""

from .ep import expert_partition_specs, make_mesh_dp_ep, setup_expert_parallel
from .fsdp import fsdp_partition_specs, setup_fsdp
from .mesh import (
    batch_sharding,
    make_grid,
    make_mesh,
    replicate,
    replicated,
    setup_data_parallel,
    shard_batch,
)
from .multihost import (
    allreduce_counts,
    distribute_batch,
    global_device_batch,
    local_replica,
    process_slice,
)
from .pp import (
    apply_conformer_pipelined,
    make_mesh_dp_pp,
    make_mesh_dp_pp_tp,
    make_mesh_pp,
    microbatch,
    pipeline_apply,
    pipeline_param_specs,
    place_pipeline_params,
    pp_stack_tree,
    pp_unstack_tree,
    setup_pipeline_parallel,
    stack_layers,
    unstack_layers,
)
from .sp import make_mesh_dp_sp, seq_shard_fn, setup_sequence_parallel
from .tp import (
    make_mesh_2d,
    make_mesh_3d,
    opt_state_shardings,
    param_partition_specs,
    setup_tensor_parallel,
)

__all__ = [
    "allreduce_counts",
    "apply_conformer_pipelined",
    "batch_sharding",
    "distribute_batch",
    "expert_partition_specs",
    "fsdp_partition_specs",
    "global_device_batch",
    "local_replica",
    "make_grid",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_3d",
    "make_mesh_dp_ep",
    "make_mesh_dp_pp",
    "make_mesh_dp_pp_tp",
    "make_mesh_dp_sp",
    "make_mesh_pp",
    "microbatch",
    "opt_state_shardings",
    "param_partition_specs",
    "pipeline_apply",
    "pipeline_param_specs",
    "place_pipeline_params",
    "pp_stack_tree",
    "pp_unstack_tree",
    "process_slice",
    "replicate",
    "replicated",
    "seq_shard_fn",
    "setup_data_parallel",
    "setup_expert_parallel",
    "setup_fsdp",
    "setup_pipeline_parallel",
    "setup_sequence_parallel",
    "setup_tensor_parallel",
    "shard_batch",
    "stack_layers",
    "unstack_layers",
]
