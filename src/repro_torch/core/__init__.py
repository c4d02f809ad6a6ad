"""The paper's primary contribution on ``torch.distributed``: synchronous
data-parallel training with MPI-style all-to-all reduction (port of
``repro.core`` for the replicated strategies; the ZeRO ladder, the
overlap scheduler and the perf model wait for ROADMAP A.4 and A.10)."""
from repro_torch.core.collectives import (
    allreduce_bucketed, allreduce_flat, allreduce_hierarchical,
    allreduce_mean, dp_batch_axes, dp_world_size,
)
from repro_torch.core.data_parallel import (
    DPConfig, SyncTimer, make_dp_train_step, make_sequential_step,
)
from repro_torch.core.strategy import (
    ReplicatedStrategy, Strategy, available_strategies, get_strategy,
    register_strategy,
)

batch_axes = dp_batch_axes

__all__ = [
    "allreduce_mean", "allreduce_flat", "allreduce_bucketed",
    "allreduce_hierarchical",
    "DPConfig", "SyncTimer", "make_dp_train_step", "make_sequential_step",
    "batch_axes", "dp_world_size",
    "Strategy", "ReplicatedStrategy",
    "available_strategies", "get_strategy", "register_strategy",
]
