"""The paper's primary contribution on ``torch.distributed``: synchronous
data-parallel training with MPI-style all-to-all reduction (port of
``repro.core``): the replicated strategies, the ZeRO ladder (zero1 /
zero2 / zero3 and the two-level zero1_hier / zero3_hier), the
bucket-level overlap scheduler and the train-state contract.  The perf
model waits for ROADMAP A.10."""
from repro_torch.core.collectives import (
    all_gather_tree, allreduce_bucketed, allreduce_flat,
    allreduce_hierarchical, allreduce_mean, dp_batch_axes, dp_world_size,
    flatten_padded, hier_all_gather_tree, hier_reduce_scatter_mean,
    local_shard, reduce_scatter_mean, unflatten_padded,
)
from repro_torch.core.data_parallel import (
    DPConfig, SyncTimer, make_dp_train_step, make_sequential_step,
)
from repro_torch.core.overlap import (
    BucketPlan, overlapped_all_gather, overlapped_allreduce,
    overlapped_reduce_scatter, plan_buckets, plan_local_shard, run_pipeline,
)
from repro_torch.core.strategy import (
    ReplicatedStrategy, ShardedStrategy, Strategy, available_strategies,
    get_strategy, register_strategy,
)
from repro_torch.core.train_state import (
    Layout, assemble_full_flat, check_layout, host_params, init_train_state,
    split_flat_shards,
)

batch_axes = dp_batch_axes

__all__ = [
    "allreduce_mean", "allreduce_flat", "allreduce_bucketed",
    "allreduce_hierarchical", "flatten_padded", "unflatten_padded",
    "reduce_scatter_mean", "all_gather_tree", "hier_reduce_scatter_mean",
    "hier_all_gather_tree", "local_shard",
    "BucketPlan", "plan_buckets", "plan_local_shard", "run_pipeline",
    "overlapped_allreduce", "overlapped_reduce_scatter",
    "overlapped_all_gather",
    "DPConfig", "SyncTimer", "make_dp_train_step", "make_sequential_step",
    "batch_axes", "dp_world_size",
    "Layout", "init_train_state", "host_params", "check_layout",
    "assemble_full_flat", "split_flat_shards",
    "Strategy", "ReplicatedStrategy", "ShardedStrategy",
    "available_strategies", "get_strategy", "register_strategy",
]
