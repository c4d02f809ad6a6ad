"""The user-facing training facade -- the paper's transparency claim as
an API (port of ``repro.api`` on ``torch.distributed``).

    from repro_torch.api import Trainer
    from repro_torch.core import DPConfig

    trainer = Trainer.create(model_cfg=cfg, dp=DPConfig(strategy="flat"),
                             mesh=mesh)       # on every rank
    for batch in batches:
        metrics = trainer.step(batch)
    trainer.save(ckpt_dir)            # the reference's format, atomic
    ...
    trainer = Trainer.create(...same...)
    trainer.restore(ckpt_dir)         # any replicated world size
    engine = trainer.serve()          # cast once from the masters
    print(trainer.describe())

Every strategy the registry holds runs here: the replicated ones and the
ZeRO ladder (``DPConfig(strategy="zero1" | "zero2" | "zero3" |
"zero1_hier" | "zero3_hier", overlap=...)``), whose state each rank
holds 1/p of; a ZeRO state's checkpoint is written by every rank (its
own shards) and restores into any layout and world size.

``create`` takes either a ``model_cfg`` (a ``repro_torch.configs``
architecture: the loss is ``train.step.make_loss_fn`` and the params
come from ``init_model(..., train=True)``) or an explicit ``loss_fn``
+ ``params`` pair (a Table-1 ``PaperNet``, custom research code).
``mesh=None`` builds the one-process sequential reference step -- the
same object, so A/B-ing distributed against sequential is one
argument.  With a mesh (a ``DeviceMesh`` of dims ``("data",)`` or
``("pod", "data")`` spanning every rank), every rank runs ``create``
and ``step``; ``create`` broadcasts rank 0's initial masters, so every
replica starts equal.  Checkpoints (``repro_torch.checkpoint``) are
the reference's: a checkpoint either package writes restores in the
other.  On a mesh, every rank calls ``save`` / ``save_async`` /
``restore`` (rank 0 writes a replicated state alone; each rank writes
its own shards of a sharded one), and for a zero3 state ``params`` and
``serve`` too: they gather the params, a collective.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Callable, Optional

import torch.distributed as dist

from repro_torch import optim as optim_lib
from repro_torch.checkpoint import (restore_train_state,
                                    save_sharded_checkpoint)
from repro_torch.checkpoint.store import is_writer
from repro_torch.core.collectives import (broadcast_from_rank0,
                                          dp_world_size, wire_bytes)
from repro_torch.core.data_parallel import (DPConfig, SyncTimer,
                                            make_dp_train_step,
                                            make_sequential_step)
from repro_torch.core.strategy import get_strategy
from repro_torch.core.train_state import host_params, init_train_state
from repro_torch.device import resolve_device
from repro_torch.train.step import trainable


def _resolve_optimizer(optimizer, lr):
    if isinstance(optimizer, str):
        return optim_lib.get_optimizer(optimizer, lr)
    return optimizer


@dataclasses.dataclass
class Trainer:
    """A bound (step_fn, state) pair -- see module docstring.  Build
    with :meth:`create`; ``state`` is the live ``TrainState``."""
    state: Any                      # train.step.TrainState
    optimizer: Any
    loss_fn: Callable
    dp: DPConfig
    mesh: Any                       # None => sequential reference step
    model_cfg: Any = None           # set when created from a ModelConfig
    timer: Optional[SyncTimer] = None
    _step_fn: Callable = dataclasses.field(repr=False, default=None)
    _async_ckpt: Any = dataclasses.field(repr=False, default=None)

    # ---- construction ----------------------------------------------------
    @classmethod
    def create(cls, model_cfg=None, *, loss_fn=None, params=None,
               optimizer="adam", lr: float = 1e-3,
               dp: Optional[DPConfig] = None, mesh=None, train_cfg=None,
               seed: int = 0, device="cuda") -> "Trainer":
        """Build a ready-to-step Trainer.

        model_cfg -- a ``repro_torch.configs`` architecture config.
        loss_fn   -- alternatively ``loss_fn(model, batch) -> scalar``;
                     requires ``params``.
        params    -- an ``nn.Module`` whose trainable parameters are the
                     masters, fp32 or bf16 (moved to ``device``).
        optimizer -- a ``repro_torch.optim`` Optimizer, or a name
                     ("adam", "adamw", "sgd", "momentum", ...) with `lr`.
        dp        -- DPConfig; ``dp.strategy`` any registered name.
        mesh      -- ``DeviceMesh`` for the data-parallel step, or None
                     for the sequential reference.
        train_cfg -- ``train.step.TrainConfig`` for ``model_cfg``'s loss
                     (remat); its microbatches are superseded by
                     ``dp.microbatches``.
        seed      -- ``model_cfg``'s weights when ``params`` is None.
        device    -- where the masters live: the card unless "cpu".
        """
        dp = dp if dp is not None else DPConfig()
        dev = resolve_device(device)
        optimizer = _resolve_optimizer(optimizer, lr)
        if model_cfg is not None:
            if loss_fn is not None:
                raise ValueError("pass model_cfg OR loss_fn, not both")
            from repro_torch.models import check_train_ported, init_model
            from repro_torch.train.step import TrainConfig, make_loss_fn
            check_train_ported(model_cfg)
            tc = train_cfg if train_cfg is not None else TrainConfig(
                remat=False)
            base_loss = make_loss_fn(model_cfg, tc)
            loss_fn = lambda m, b: base_loss(m, b)[0]  # noqa: E731
            if params is None:
                params = init_model(model_cfg, seed=seed, device=dev,
                                    train=True)
        elif loss_fn is None or params is None:
            raise ValueError(
                "Trainer.create needs model_cfg, or loss_fn + params")
        params = params.to(dev)
        timer = None
        if mesh is None:
            step_fn = make_sequential_step(loss_fn, optimizer)
        else:
            timer = SyncTimer()
            step_fn = make_dp_train_step(loss_fn, optimizer, mesh, dp,
                                         timer=timer)
            broadcast_from_rank0(
                [p.detach() for p in trainable(params).values()], mesh)
        # a sharded strategy takes the masters over: views of its flat
        # vector, the moments over this rank's shard only
        state = init_train_state(optimizer, params, mesh, dp)
        return cls(state=state, optimizer=optimizer, loss_fn=loss_fn,
                   dp=dp, mesh=mesh, model_cfg=model_cfg, timer=timer,
                   _step_fn=step_fn)

    # ---- training --------------------------------------------------------
    def step(self, batch) -> dict:
        """Advance one step on `batch` (the global batch, or this rank's
        ``rank0_scatter`` share); returns the metrics dict."""
        self.state, metrics = self._step_fn(self.state, batch)
        return metrics

    def sync_ms(self) -> list:
        """ms of each collective since the last call (CUDA events on a
        card, the host clock on the CPU); [] for the sequential step."""
        return self.timer.ms() if self.timer is not None else []

    def sync_ms_by_label(self) -> dict:
        """The same, grouped by label (``"grad_sync"``, and a sharded
        strategy's ``"reduce_scatter"`` / ``"all_gather"``)."""
        return self.timer.by_label() if self.timer is not None else {}

    @property
    def params(self) -> dict:
        """Host copy of the full masters, ``{name: numpy array}`` -- always
        a copy (on the CPU too: the masters are updated in place by later
        steps).  A zero3 state's shards are gathered and reassembled on
        the host (``core.host_params``; a collective: every rank reads
        it)."""
        return host_params(self.state, self.mesh)

    # ---- checkpointing ---------------------------------------------------
    def save(self, ckpt_dir, *, keep_last: Optional[int] = None,
             extra: Optional[dict] = None) -> str:
        """Write the checkpoint synchronously (the reference's sharded
        format; on a mesh rank 0 writes, and every rank returns after
        the publish); returns the published step path.  ``keep_last``
        prunes older published steps; ``extra`` rides in ``meta.json``
        (e.g. the data cursor)."""
        return save_sharded_checkpoint(ckpt_dir, self.state.step,
                                       self.state, keep_last=keep_last,
                                       extra=extra)

    def save_async(self, ckpt_dir, *, keep_last: Optional[int] = None,
                   extra: Optional[dict] = None) -> Optional[dict]:
        """Asynchronous save: block only for the device->host copy,
        publish in the background (``repro_torch.elastic.
        AsyncCheckpointer``, created on first use and cached on this
        trainer -- a different ``ckpt_dir`` rebuilds it).  Returns the
        save receipt ``{"step", "blocking_s", "bytes"}``; on a mesh, only
        rank 0 saves a replicated state, and the other ranks get None,
        while every rank saves its own shards of a sharded one.  Call
        :meth:`finish_saves` before a planned shutdown so the final step
        is durable."""
        if not (is_writer(self.state) or self.state.layout.sharded):
            return None
        from repro_torch.elastic import AsyncCheckpointer
        ck = self._async_ckpt
        if ck is None or ck.ckpt_dir != pathlib.Path(ckpt_dir):
            if ck is not None:
                ck.close()
            ck = AsyncCheckpointer(ckpt_dir, keep_last=keep_last)
            self._async_ckpt = ck
        return ck.save(self.state, extra=extra)

    def finish_saves(self, timeout: Optional[float] = None):
        """Drain the async checkpointer (publish barrier; on a mesh every
        rank leaves after rank 0's publish); returns its telemetry
        ``stats()`` dict, or None where :meth:`save_async` saved nothing.
        Re-raises any background writer error."""
        try:
            if self._async_ckpt is None:
                return None
            self._async_ckpt.wait(timeout)
            return self._async_ckpt.stats()
        finally:
            if self.mesh is not None:
                dist.barrier()

    def restore(self, ckpt_dir, step: Optional[int] = None) -> int:
        """Restore into this trainer's state (the masters and moments in
        place), picking the store by what is ON DISK
        (``restore_train_state``): a ``.shards`` directory -- of any
        layout, world size and strategy -- or a legacy ``.npz``.
        Returns the restored step."""
        self.state, at = restore_train_state(ckpt_dir, self.state, step)
        return at

    def restore_elastic(self, ckpt_dir, step: Optional[int] = None):
        """Elastic resume: restore the newest *published* step that is
        actually readable, falling back past torn/corrupt steps
        (``repro_torch.elastic.resume_elastic``) -- this trainer may run
        another world size or strategy than the one that saved.  Returns
        ``(step, skipped)`` where ``skipped`` lists ``(step, reason)``
        for abandoned steps."""
        from repro_torch.elastic import resume_elastic
        self.state, at, skipped = resume_elastic(ckpt_dir, self.state,
                                                 step=step)
        return at, skipped

    # ---- serving ---------------------------------------------------------
    def serve(self, *, engine: str = "continuous", **engine_kw):
        """Serve THIS trainer's current parameters -- the in-memory half
        of the train-and-serve loop (``serve.make_engine_from_checkpoint``
        is the on-disk half).  The serving model is cast once from the
        masters (``bridge.serving_model``, copies on the masters'
        device), so its tokens equal those of a model cast from the same
        masters' checkpoint; ``engine`` and ``engine_kw`` go to
        ``serve.make_engine``.  Requires the trainer to have been
        created from a ``model_cfg``."""
        if self.model_cfg is None:
            raise ValueError(
                "Trainer.serve needs a model architecture; create the "
                "trainer with Trainer.create(model_cfg=...) (a custom "
                "loss_fn has no serving forward pass)")
        from repro_torch.bridge import serving_model
        from repro_torch.serve import make_engine
        flat = self.state.flat
        if self.state.layout.params_flat:      # zero3: gather, cast, free
            get_strategy(self.dp.strategy).gather_params(
                self.state, self.mesh, self.dp)
        try:
            model = serving_model(self.state.params)
        finally:
            if self.state.layout.params_flat:
                flat.free()
        return make_engine(self.model_cfg, model, engine=engine,
                           device=model.embed.device, **engine_kw)

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        """What this trainer physically runs: strategy, sync mode, layout
        kind, world size, parameter count, per-rank persistent memory
        (the strategy's ``memory_entry``: params, grads and optimizer
        state, each 1/p where the strategy shards it), and, on a mesh,
        the bytes one rank hands its collectives in one sync and the
        strategy's modeled wire time of a step (``comm_time_s``: its
        ``comm_time`` for fp32 gradients of every param, 4 bytes each,
        with the mesh's pod and data sizes, on the perf model's default
        fabrics -- the reference's, a TPU pod's).  The memory entry
        counts 4-byte params and gradients whatever the masters' dtype,
        as the reference's does."""
        strategy = get_strategy(self.dp.strategy)
        masters = list(trainable(self.state.params).values())
        n_params = sum(p.numel() for p in masters)
        world = dp_world_size(self.mesh) if self.mesh is not None else 1
        mem = strategy.memory_entry(n_params, self.optimizer.state_factor,
                                    world)
        d = {"strategy": strategy.name, "sync": self.dp.sync,
             "layout": self.state.layout.kind,
             "world_size": world, "params": int(n_params),
             "memory_per_device_bytes": {k: float(v)
                                         for k, v in mem.items()}}
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names
            n_intra = (self.mesh.size(names.index("data"))
                       if "pod" in names else 1)
            n_pods = (self.mesh.size(names.index("pod"))
                      if "pod" in names else 1)
            d["comm_time_s"] = float(strategy.comm_time(
                4.0 * n_params, p=world,
                n_intra=self.mesh.size(names.index("data")),
                n_pods=n_pods, microbatches=self.dp.microbatches))
            d["allreduce_bytes_per_sync"] = wire_bytes(
                masters, strategy=getattr(strategy, "collective",
                                          strategy.name),
                compress=self.dp.compress, bucket_bytes=self.dp.bucket_bytes,
                n_intra=n_intra)
        return d
