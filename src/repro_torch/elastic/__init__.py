"""Elastic fault-tolerant training (port of ``repro.elastic``).

The source paper assumes a fixed set of MPI ranks for the whole run;
at scale preemption is routine and checkpoint I/O cannot sit on the
step path.  This package turns the checkpoint store
(``repro_torch.checkpoint``) into a survival mechanism:

* :class:`AsyncCheckpointer` -- device->host snapshot at a step
  boundary (the only blocking part), write + atomic publish on a
  background thread, bounded in-flight queue with last-publish-wins;
* :class:`FaultInjector` / :class:`FaultPlan` -- deterministic
  preemption: kill the process hard at a chosen step;
* :func:`resume_elastic` -- resume the latest *published* step into a
  state of another world size, strategy or layout (replicated or any
  ZeRO kind: the store reshards), falling back past corrupt steps.

A sharded state's async save runs on every rank, each writing its own
shards; rank 0 publishes once every rank's file is complete.
"""
from repro_torch.elastic.async_ckpt import AsyncCheckpointer
from repro_torch.elastic.faults import (FAULT_EXIT_CODE, FaultInjector,
                                        FaultPlan, SimulatedFault)
from repro_torch.elastic.resize import resume_elastic

__all__ = ["AsyncCheckpointer", "FAULT_EXIT_CODE", "FaultInjector",
           "FaultPlan", "SimulatedFault", "resume_elastic"]
