"""Elastic resize: resume a killed run under another mesh, strategy or
layout (port of ``repro.elastic.resize``).

Losing a node changes the world size; waiting for it to come back
wastes the rest.  The store reshards on restore (replicated, zero1,
zero2, zero3 and the hier kinds, contiguous or bucket-major, any shard
count), so an elastic resume is just: build a fresh trainer for the NEW
topology, then restore the newest *published* step into its state.

:func:`resume_elastic` adds the survival policy on top of the plain
restore: it walks ``published_steps`` newest-first and, when a step's
data turns out to be torn/corrupt (``CorruptCheckpointError`` -- e.g. a
truncated file from a dying disk), falls back to the previous
published step instead of dying, reporting every step it skipped.  The
atomic-publish protocol makes this safe: a *published* directory name
guarantees the rename happened, so an unreadable member is data
corruption, not a half-write -- and older steps are independent.  The
store reads every member before it writes a tensor, so a skipped step
leaves the state as it was.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.store import (
    CorruptCheckpointError, published_steps, restore_train_state,
)


def resume_elastic(ckpt_dir, template, *, step: Optional[int] = None):
    """Restore the newest usable published step into ``template`` (a
    ``TrainState`` of any world size, strategy and layout; its masters,
    shards and moments are overwritten in place).  Returns ``(state, step,
    skipped)`` where ``skipped`` is a list of ``(step, reason)`` for
    every newer published step that had to be abandoned as corrupt.

    ``step=`` resumes at/below a specific step instead of the newest.

    Raises ``FileNotFoundError`` when nothing is published, and
    ``CorruptCheckpointError`` when every candidate step is unreadable
    (carrying the per-step reasons)."""
    steps = published_steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s <= step]
    if not steps:
        raise FileNotFoundError(
            f"no published checkpoint in {ckpt_dir}"
            + (f" at or below step {step}" if step is not None else ""))
    skipped = []
    for s in reversed(steps):
        try:
            state, at = restore_train_state(ckpt_dir, template, s)
            return state, at, skipped
        except CorruptCheckpointError as e:
            skipped.append((s, str(e)))
    raise CorruptCheckpointError(
        f"every candidate step in {ckpt_dir} is unreadable: "
        + "; ".join(f"step {s}: {r.splitlines()[0]}" for s, r in skipped))
