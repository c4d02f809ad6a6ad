"""The user-facing training facade -- the paper's transparency claim as
an API (port of ``repro.api`` on ``torch.distributed``).

    from repro_torch.api import Trainer
    from repro_torch.core import DPConfig

    trainer = Trainer.create(model_cfg=cfg, dp=DPConfig(strategy="flat"),
                             mesh=mesh)       # on every rank
    for batch in batches:
        metrics = trainer.step(batch)
    print(trainer.describe())

``create`` takes either a ``model_cfg`` (a ``repro_torch.configs``
architecture: the loss is ``train.step.make_loss_fn`` and the params
come from ``init_model(..., train=True)``) or an explicit ``loss_fn``
+ ``params`` pair (a Table-1 ``PaperNet``, custom research code).
``mesh=None`` builds the one-process sequential reference step -- the
same object, so A/B-ing distributed against sequential is one
argument.  With a mesh (a ``DeviceMesh`` of dims ``("data",)`` or
``("pod", "data")`` spanning every rank), every rank runs ``create``
and ``step``; ``create`` broadcasts rank 0's initial masters, so every
replica starts equal.  Checkpoints (``save``, ``restore``) and
``serve`` wait for ROADMAP A.3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch import optim as optim_lib
from repro_torch.core.collectives import (broadcast_from_rank0,
                                          dp_world_size, wire_bytes)
from repro_torch.core.data_parallel import (DPConfig, SyncTimer,
                                            make_dp_train_step,
                                            make_sequential_step)
from repro_torch.core.strategy import get_strategy
from repro_torch.device import resolve_device
from repro_torch.train.step import TrainState, trainable


def _resolve_optimizer(optimizer, lr):
    if isinstance(optimizer, str):
        return optim_lib.get_optimizer(optimizer, lr)
    return optimizer


@dataclasses.dataclass
class Trainer:
    """A bound (step_fn, state) pair -- see module docstring.  Build
    with :meth:`create`; ``state`` is the live ``TrainState``."""
    state: TrainState
    optimizer: Any
    loss_fn: Callable
    dp: DPConfig
    mesh: Any                       # None => sequential reference step
    model_cfg: Any = None           # set when created from a ModelConfig
    timer: Optional[SyncTimer] = None
    _step_fn: Callable = dataclasses.field(repr=False, default=None)

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
                     fp32 masters (moved to ``device``).
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
        masters = trainable(params)
        timer = None
        if mesh is None:
            step_fn = make_sequential_step(loss_fn, optimizer)
        else:
            timer = SyncTimer()
            step_fn = make_dp_train_step(loss_fn, optimizer, mesh, dp,
                                         timer=timer)
            broadcast_from_rank0([p.detach() for p in masters.values()],
                                 mesh)
        state = TrainState(params, optimizer.init(masters), 0)
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
        """ms of each sync since the last call (CUDA events on a card,
        the host clock on the CPU); [] for the sequential step."""
        return self.timer.ms() if self.timer is not None else []

    @property
    def params(self) -> dict:
        """Host copy of the masters, ``{name: numpy array}`` (a copy on
        the CPU too: the masters are updated in place by later steps)."""
        return {k: p.detach().to("cpu", copy=True).numpy()
                for k, p in trainable(self.state.params).items()}

    # ---- checkpointing and serving: ROADMAP A.3 --------------------------
    def save(self, *args, **kw):
        raise NotImplementedError("Trainer.save: checkpoints wait for "
                                  "ROADMAP A.3")

    def restore(self, *args, **kw):
        raise NotImplementedError("Trainer.restore: checkpoints wait for "
                                  "ROADMAP A.3")

    def serve(self, *args, **kw):
        raise NotImplementedError("Trainer.serve: serving a trainer's "
                                  "params waits for ROADMAP A.3")

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        """What this trainer physically runs: strategy, sync mode, world
        size, parameter count, per-device persistent memory, and the
        bytes one rank hands its collectives in one sync."""
        strategy = get_strategy(self.dp.strategy)
        masters = list(trainable(self.state.params).values())
        n_params = sum(p.numel() for p in masters)
        world = dp_world_size(self.mesh) if self.mesh is not None else 1
        mem = strategy.memory_entry(n_params, self.optimizer.state_factor,
                                    world)
        d = {"strategy": strategy.name, "sync": self.dp.sync,
             "world_size": world, "params": int(n_params),
             "memory_per_device_bytes": {k: float(v)
                                         for k, v in mem.items()}}
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names
            n_intra = (self.mesh.size(names.index("data"))
                       if "pod" in names else 1)
            d["allreduce_bytes_per_sync"] = wire_bytes(
                masters, strategy=getattr(strategy, "collective",
                                          strategy.name),
                compress=self.dp.compress, bucket_bytes=self.dp.bucket_bytes,
                n_intra=n_intra)
        return d
