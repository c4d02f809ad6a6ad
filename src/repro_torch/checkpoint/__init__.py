"""Checkpoints in the reference's on-disk format (``store``)."""
from repro_torch.checkpoint.store import (
    CorruptCheckpointError, StateSnapshot, checkpoint_meta, latest_step,
    published_steps, restore_checkpoint, restore_serve_params,
    restore_sharded_checkpoint, restore_train_state, save_checkpoint,
    save_sharded_checkpoint, snapshot_train_state, state_tree,
    write_state_snapshot,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "published_steps", "checkpoint_meta",
           "save_sharded_checkpoint", "restore_sharded_checkpoint",
           "restore_train_state", "restore_serve_params",
           "CorruptCheckpointError", "StateSnapshot", "state_tree",
           "snapshot_train_state", "write_state_snapshot"]
