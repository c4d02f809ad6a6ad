"""The train step on one device.

Port of ``repro.train.step``: the loss is the mean over the batch, its
gradient is taken by autograd, and the optimizer updates the masters.
Features, as in the reference:

  * microbatch gradient accumulation -- a Python loop of forward and
    backward passes whose gradients accumulate in ``grad_dtype`` (the
    reference's ``lax.scan``), the loss and the gradients then scaled by
    ``1 / microbatches``; one microbatch's gradient keeps the masters'
    dtype, as the reference's ``value_and_grad`` does;
  * per-layer rematerialisation (``remat``: ``torch.utils.checkpoint``
    around each layer, ``models.transformer.apply_stack``);
  * master weights (trainable ``nn.Parameter``s of ``Model(...,
    train=True)``) in ``param_dtype`` -- fp32, or bf16, each cast as it
    is drawn -- with compute in ``cfg.dtype``;
  * global-norm gradient clipping (the norm and the scaling in fp32,
    each gradient cast back to its dtype) and the cosine lr schedule.

One device; ``accumulate_grads`` is shared with the data-parallel step
(``core.data_parallel``), which averages the gradients it returns over
the ranks; its microbatches accumulate in fp32 whatever ``grad_dtype``
says, as the reference's strategies do.  A model with a
multi-token-prediction head adds its CE at ``mtp_weight``
(``train.loss.lm_loss``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.models import apply_model, batch_inputs, init_model
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
    metrics)``.  ``params`` is the ``Model`` holding the masters,
    ``opt_state`` the optimizer's dict, ``step`` a host int, ``layout``
    the ``core.train_state.Layout`` the checkpoint store records
    (``start_state`` builds the one of a state without a mesh), and
    ``flat`` a sharded state's ``core.flat.FlatMasters`` (None for a
    replicated one)."""
    params: Any
    opt_state: Any
    step: int
    layout: Any
    flat: Any = None


def trainable(model) -> dict:
    """The model's trainable masters by name (a tied table once)."""
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def global_norm(grads):
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads, max_norm):
    """Scale every gradient by min(1, max_norm / global norm), IN PLACE
    (the step's own gradient buffers; a copy would cost another set of
    gradients).  The norm and each product are fp32, the product cast
    back to the gradient's dtype, as the reference does.  Returns
    (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
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
        tokens, frontends = batch_inputs(batch)
        out = apply_model(cfg, model, tokens, mode="train", remat=tc.remat,
                          **frontends)
        return lm_loss(cfg, out, batch, mtp_weight=tc.mtp_weight)
    return loss_fn


def make_train_step(cfg, tc: TrainConfig):
    """Returns (step_fn, optimizer) -- ``step(state, batch) -> (state,
    metrics)`` on the ``TrainState`` contract; ``batch`` is ``{"tokens":
    (B, S)}``, with ``"vision_embeds"`` for a VLM, or an
    encoder-decoder's ``{"src_embeds", "tgt_tokens"}`` (numpy or
    tensors), moved to the masters' device.  The
    masters and the optimizer state are updated in place, and the
    returned state holds the same objects.  The masters' dtype is the
    model's (``init_train_state`` draws them in ``tc.param_dtype``);
    microbatches accumulate in ``tc.grad_dtype``."""
    gdt = getattr(torch, tc.grad_dtype)
    lr = (optim_lib.cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
          if tc.schedule == "cosine" else tc.lr)
    optimizer = optim_lib.get_optimizer(tc.optimizer, lr)
    loss_fn = make_loss_fn(cfg, tc)
    n = tc.microbatches

    def step(state: TrainState, batch):
        model = state.params
        params = trainable(model)
        loss, metrics, grads = accumulate_grads(loss_fn, model, params,
                                                batch, n, grad_dtype=gdt)
        if tc.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
            metrics["grad_norm"] = gnorm
        optimizer.update(grads, state.opt_state, params)
        return (state._replace(step=state.step + 1),
                {"loss": loss, **metrics})

    return step, optimizer


def accumulate_grads(loss_fn, model, params, batch, n,
                     grad_dtype=torch.float32):
    """``(loss, metrics, grads)`` of ``batch``: one forward and backward,
    its gradient in the masters' dtype (the reference's
    ``value_and_grad``, whatever ``grad_dtype`` says); or -- with ``n``
    microbatches -- a loop of them whose gradients accumulate in
    ``grad_dtype``, the loss and the gradients then scaled by ``1 / n``
    in that dtype (the reference's ``lax.scan``).  ``grads`` is
    ``{name: tensor}``: the masters' ``.grad`` where the accumulation
    dtype is theirs, else buffers of ``grad_dtype`` (``.grad`` is then
    cleared after each microbatch).  ``loss_fn(model, batch)`` returns
    ``(loss, metrics)``; the metrics are returned detached, for
    microbatches their mean (the reference returns none there).
    ``batch`` (numpy or tensors) is moved to the masters' device.  A
    master the backward never reaches (DeepSeek-V3's router balance
    bias, which only selects) gets a zero gradient, as the reference
    gives such a leaf: the optimizer still applies its weight decay."""
    if not params:
        raise ValueError("the model has no trainable masters; build it "
                         "with train=True")
    dev = next(iter(params.values())).device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    for p in params.values():           # each step starts from no gradient
        p.grad = None
    if n == 1:
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        _zero_missing_grads(params)
        return loss.detach(), {
            k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}, {
            k: p.grad for k, p in params.items()}
    # accumulate in .grad where it has the accumulation dtype, else in
    # buffers of grad_dtype beside it
    direct = all(p.dtype == grad_dtype for p in params.values())
    acc = None if direct else {
        k: torch.zeros_like(p, dtype=grad_dtype) for k, p in params.items()}
    micro = _split_micro(batch, n)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    sums = {}
    for i in range(n):
        l, metrics = loss_fn(model, {k: v[i] for k, v in micro.items()})
        l.backward()
        loss = loss + l.detach()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + (
                v.detach() if isinstance(v, torch.Tensor) else v)
        if not direct:
            for k, p in params.items():
                if p.grad is not None:
                    acc[k].add_(p.grad.to(grad_dtype))
                p.grad = None
    if direct:
        _zero_missing_grads(params)
        acc = {k: p.grad for k, p in params.items()}
    inv = 1.0 / n
    for g in acc.values():
        # the reference scales by a weakly typed 1/n: in g's dtype
        g.mul_(torch.tensor(inv, dtype=g.dtype))
    return loss * inv, {k: v * inv for k, v in sums.items()}, acc


def _zero_missing_grads(params):
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def start_state(model, optimizer) -> TrainState:
    """``model``'s ``TrainState`` at step 0 without a mesh: the
    optimizer's zero state of its masters and the replicated layout."""
    from repro_torch.core.train_state import replicated_layout
    masters = trainable(model)
    return TrainState(model, optimizer.init(masters), 0,
                      replicated_layout(masters))


def init_train_state(cfg, tc: TrainConfig, *, seed=0, device="cuda"):
    """A ``TrainState`` at step 0: a training ``Model`` of masters in
    ``tc.param_dtype`` drawn from ``seed`` on ``device``
    (``models.init_model(..., train=True)``; the reference draws fp32
    and casts every leaf, the port casts each as it is drawn) and the
    optimizer's zero state."""
    optimizer = optim_lib.get_optimizer(tc.optimizer, tc.lr)
    return start_state(init_model(cfg, seed=seed, device=device, train=True,
                                  param_dtype=getattr(torch, tc.param_dtype)),
                       optimizer)
