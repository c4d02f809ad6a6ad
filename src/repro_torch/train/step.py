"""The train step on one device.

Port of ``repro.train.step``: the loss is the mean over the batch, its
gradient is taken by autograd, and the optimizer updates the fp32
masters.  Features, as in the reference:

  * microbatch gradient accumulation -- a Python loop of forward and
    backward passes whose fp32 gradients accumulate in the masters'
    ``.grad`` (the reference's ``lax.scan``), the loss and the
    gradients then scaled by ``1 / microbatches``;
  * per-layer rematerialisation (``remat``: ``torch.utils.checkpoint``
    around each layer, ``models.transformer.apply_stack``);
  * fp32 master weights (trainable ``nn.Parameter``s of ``Model(...,
    train=True)``) with compute in ``cfg.dtype``;
  * global-norm gradient clipping and the cosine lr schedule.

One device only: the mesh, the sharded state and the gradient
all-reduce join with the data-parallel slice (ROADMAP A.2), pure-bf16
masters and the MTP term with the configs that need them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.models import apply_model, init_model
from repro_torch.train.loss import lm_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    microbatches: int = 1
    remat: bool = True
    grad_dtype: str = "float32"      # accumulation dtype
    param_dtype: str = "float32"     # master-weight dtype
    mtp_weight: float = 0.1
    grad_clip: float = 0.0           # global-norm clip; 0 = off
    # lr schedule: "constant" | "cosine" (peak=lr, warmup/total in steps)
    schedule: str = "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000


class TrainState(NamedTuple):
    """The train-step contract: ``step(state, batch) -> (state,
    metrics)``.  ``params`` is the ``Model`` holding the fp32 masters,
    ``opt_state`` the optimizer's dict, ``step`` a host int.  The
    reference's ``Layout`` (``core/train_state.py``), which describes
    how a data-parallel strategy shards the state, joins with the ZeRO
    strategies (ROADMAP A.4)."""
    params: Any
    opt_state: Any
    step: int


def trainable(model) -> dict:
    """The model's trainable masters by name (a tied table once)."""
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def _global_norm(grads):
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads, max_norm):
    """Scale every (fp32) gradient by min(1, max_norm / global norm), IN
    PLACE (the step's own gradient buffers; a copy would cost another
    set of fp32 gradients).  Returns (grads, norm)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


def _split_micro(batch, n):
    """(B, ...) -> (n, B/n, ...) for the accumulation loop."""
    for v in batch.values():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split into "
                             f"{n} microbatches")
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def make_loss_fn(cfg, tc: TrainConfig):
    def loss_fn(model, batch):
        out = apply_model(cfg, model, batch["tokens"], mode="train",
                          remat=tc.remat)
        return lm_loss(cfg, out, batch, mtp_weight=tc.mtp_weight)
    return loss_fn


def make_train_step(cfg, tc: TrainConfig):
    """Returns (step_fn, optimizer) -- ``step(state, batch) -> (state,
    metrics)`` on the ``TrainState`` contract; ``batch`` is ``{"tokens":
    (B, S)}`` (numpy or a tensor), moved to the masters' device.  The
    masters and the optimizer state are updated in place, and the
    returned state holds the same objects."""
    if (tc.param_dtype, tc.grad_dtype) != ("float32", "float32"):
        raise ValueError("the port trains fp32 masters with fp32 gradients; "
                         f"got param_dtype={tc.param_dtype!r}, "
                         f"grad_dtype={tc.grad_dtype!r}")
    lr = (optim_lib.cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
          if tc.schedule == "cosine" else tc.lr)
    optimizer = optim_lib.get_optimizer(tc.optimizer, lr)
    loss_fn = make_loss_fn(cfg, tc)
    n = tc.microbatches

    def step(state: TrainState, batch):
        model = state.params
        params = trainable(model)
        if not params:
            raise ValueError("the model has no trainable masters; build it "
                             "with train=True")
        dev = next(iter(params.values())).device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for p in params.values():       # each step starts from no gradient
            p.grad = None
        if n == 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
        else:
            micro = _split_micro(batch, n)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                l, _ = loss_fn(model, {k: v[i] for k, v in micro.items()})
                l.backward()
                loss = loss + l.detach()
            inv = 1.0 / n
            for p in params.values():
                p.grad.mul_(inv)
            loss = loss * inv
            metrics = {}
        grads = {k: p.grad for k, p in params.items()}
        if tc.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
            metrics["grad_norm"] = gnorm
        optimizer.update(grads, state.opt_state, params)
        return (TrainState(model, state.opt_state, state.step + 1),
                {"loss": loss.detach(), **metrics})

    return step, optimizer


def init_train_state(cfg, tc: TrainConfig, *, seed=0, device="cuda"):
    """A ``TrainState`` at step 0: a training ``Model`` of fp32 masters
    drawn from ``seed`` on ``device`` (``models.init_model(...,
    train=True)``) and the optimizer's zero state."""
    optimizer = optim_lib.get_optimizer(tc.optimizer, tc.lr)
    model = init_model(cfg, seed=seed, device=device, train=True)
    return TrainState(model, optimizer.init(trainable(model)), 0)
