"""The paper's contribution: synchronous data-parallel training with an
all-to-all reduction (port of ``repro.core.data_parallel`` on
``torch.distributed``).

Synchronisation modes:

* ``sync="grads"``   -- average GRADIENTS every step (the §3.3.3
  synchronous method; mathematically equal to sequential SGD on the
  concatenated batch, which ``tests/test_torch_data_parallel.py``
  asserts);
* ``sync="weights"`` -- each rank runs locally and the WEIGHTS are
  averaged every ``sync_period`` steps (the §3.3.2 communication model:
  local SGD / periodic model averaging);
* ``sync="none"``    -- fully independent ranks (the divergence
  baseline).

Ranks are processes; a step runs on every rank of the mesh at once.
The gradient strategy is resolved through the
``repro_torch.core.strategy`` registry: ``flat`` / ``bucketed`` /
``hierarchical`` keep a model copy and its optimizer state on every
rank, as the paper does; the ZeRO ladder (``zero1`` / ``zero2`` /
``zero3``, and ``zero1_hier`` / ``zero3_hier`` over a pod x data mesh)
shards the optimizer state, then the gradients, then the params 1/p a
rank, and its step is the strategy's own (``grad_sync`` then
``step_transform``); its metrics are the averaged loss and the norm of
the averaged gradient, taken over the shards.  ``overlap=True`` runs
the collectives bucket by bucket through ``repro_torch.core.overlap``
(zero2 with microbatches: each microbatch's reduce-scatter behind the
next one's backward), ``"serial"`` the same buckets one after another.
A plain (global) batch is scattered from rank 0
(``data.pipeline.rank0_scatter``, the paper's MPI_Scatter); a batch
``rank0_scatter`` already returned is taken as it is.  The per-rank forward and backward, with its microbatch loop, is
``train.step.accumulate_grads``, shared with the one-device step; the
all-reduce then works in place on the gradients it returns (the
masters' ``.grad``, or fp32 buffers where bf16 masters sum
microbatches; a tied table is one master, so it is reduced once).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

import repro_torch.data.pipeline as pipeline    # imports core.collectives
from repro_torch.core.collectives import (_dp_group, allreduce_flat,
                                          check_dp_mesh)
from repro_torch.core.strategy import get_strategy
from repro_torch.core.train_state import check_layout
from repro_torch.train.step import (TrainState, accumulate_grads,
                                    global_norm, trainable)

SYNC_MODES = ("grads", "weights", "none")


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Synchronisation policy for data-parallel training.

    sync          -- "grads" | "weights" | "none" (divergence baseline).
    strategy      -- registry name of the gradient-sync strategy
                     ("flat" | "bucketed" | "hierarchical" | "zero1" |
                     "zero2" | "zero3" | "zero1_hier" | "zero3_hier"; see
                     ``repro_torch.core.strategy.available_strategies()``).
    sync_period   -- weights mode: steps between weight averages.
    compress      -- "none" | "bf16" (wire compression; the sharded
                     strategies reduce / gather in bf16 but keep the
                     fp32 master shard).
    bucket_bytes  -- bucketed / overlap: target bucket size.
    microbatches  -- gradient-accumulation factor; the per-rank batch is
                     split into this many sequential microbatches.
    overlap       -- False (one collective per phase), True (the
                     bucket-level double-buffered scheduler of
                     ``core.overlap``; a sharded state's shards are then
                     bucket-major, except zero2's with microbatches), or
                     "serial" (the same buckets, one after another).
    """
    sync: str = "grads"
    sync_period: int = 1
    strategy: str = "flat"
    compress: str = "none"
    bucket_bytes: int = 64 * 2 ** 20
    microbatches: int = 1
    overlap: Any = False


class SyncTimer:
    """Times each step's collectives: CUDA events around each on a card,
    the host clock on the CPU.  A span has a label: ``"grad_sync"``
    (a replicated strategy's all-reduce, or a weight average),
    ``"reduce_scatter"`` and ``"all_gather"`` (a sharded strategy's
    halves).  ``ms()`` waits for the card and returns the times recorded
    since the last read, in order; ``by_label()`` the same, grouped."""

    def __init__(self):
        self._spans = []

    @contextlib.contextmanager
    def span(self, device, label="grad_sync"):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._spans.append((label, (start, end)))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((label, (time.perf_counter() - t0) * 1e3))

    def _read(self) -> list:
        out = []
        for label, s in self._spans:
            if isinstance(s, tuple):
                s[1].synchronize()
                s = s[0].elapsed_time(s[1])
            out.append((label, s))
        self._spans = []
        return out

    def ms(self) -> list:
        return [s for _, s in self._read()]

    def by_label(self) -> dict:
        out = {}
        for label, s in self._read():
            out.setdefault(label, []).append(s)
        return out


def _scalar_loss(loss_fn):
    return lambda model, batch: (loss_fn(model, batch), {})


def make_dp_train_step(loss_fn: Callable, optimizer, mesh,
                       dp: DPConfig = DPConfig(), *, timer=None):
    """The data-parallel train step, run by every rank of ``mesh``.

    loss_fn(model, batch) -> scalar loss (the rank's mean).  Returns
    ``step(state, batch) -> (state, metrics)`` on a
    ``train.step.TrainState`` built for ``dp`` (``init_train_state``;
    the state's masters and moments are updated in place).  The metrics
    are the loss averaged over the ranks and the norm of the averaged
    gradient (``grad_norm``; a replicated strategy adds the norm of the
    rank's own, ``grad_norm_local``, and without gradient sync
    ``grad_norm`` is that).  ``timer`` (a ``SyncTimer``) times each
    collective."""
    if dp.overlap not in (False, True, "serial"):
        raise ValueError(f"overlap must be False, True or 'serial', "
                         f"got {dp.overlap!r}")
    if dp.sync not in SYNC_MODES:
        raise ValueError(f"sync must be one of {SYNC_MODES}, got "
                         f"{dp.sync!r}")
    if dp.sync_period < 1:
        raise ValueError(f"sync_period must be >= 1, got {dp.sync_period}")
    strategy = get_strategy(dp.strategy)
    strategy.validate(dp, mesh)
    check_dp_mesh(mesh)
    expected_kind = strategy.state_kind(dp)
    pair_loss = _scalar_loss(loss_fn)

    def timed(dev, label="grad_sync"):
        return timer.span(dev, label) if timer is not None \
            else contextlib.nullcontext()

    def sharded_step(state, batch, dev):
        def span(label):
            return timed(dev, label)
        loss, gshard = strategy.grad_sync(pair_loss, state, batch, mesh, dp,
                                          span)
        strategy.step_transform(optimizer, gshard, state, mesh, dp, span)
        sq = gshard.float().square().sum()
        allreduce_flat([loss], mesh)
        dist.all_reduce(sq, group=_dp_group(mesh))   # a sum over shards
        return (state._replace(step=state.step + 1),
                {"loss": loss, "grad_norm": sq.sqrt()})

    def step(state: TrainState, batch):
        check_layout(getattr(state, "layout", None), expected_kind, dp, mesh)
        model = state.params
        params = trainable(model)
        dev = next(iter(params.values())).device
        if not isinstance(batch, pipeline.Scattered):
            batch = pipeline.rank0_scatter(mesh, batch, device=dev)
        if state.layout.sharded:
            return sharded_step(state, batch, dev)
        # microbatches sum in fp32, as the reference's strategies sum
        # them whatever the masters' dtype
        loss, _, grads = accumulate_grads(pair_loss, model, params, batch,
                                          dp.microbatches)
        gnorm_local = gnorm = global_norm(grads)
        if dp.sync == "grads":
            with timed(dev):
                strategy.grad_sync(list(grads.values()), mesh, dp)
            gnorm = global_norm(grads)      # norm of the averaged grad
        optimizer.update(grads, state.opt_state, params)
        if dp.sync == "weights" and (state.step + 1) % dp.sync_period == 0:
            with timed(dev), torch.no_grad():
                strategy.weight_sync([p.detach() for p in params.values()],
                                     mesh, dp)
        allreduce_flat([loss], mesh)
        return (state._replace(step=state.step + 1),
                {"loss": loss, "grad_norm_local": gnorm_local,
                 "grad_norm": gnorm})

    return step


# --------------------------------------------------------------------------
# sequential-equivalence reference (the paper's correctness claim)
# --------------------------------------------------------------------------

def make_sequential_step(loss_fn: Callable, optimizer):
    """One-process large-batch step -- the ground truth that
    sync="grads" DP must match (up to reduction order).  Same
    ``step(state, batch) -> (state, metrics)`` contract; the batch is
    the whole (global) batch."""
    pair_loss = _scalar_loss(loss_fn)

    def step(state: TrainState, batch):
        model = state.params
        params = trainable(model)
        loss, _, grads = accumulate_grads(pair_loss, model, params, batch,
                                          1)
        optimizer.update(grads, state.opt_state, params)
        return (state._replace(step=state.step + 1),
                {"loss": loss})

    return step
