"""Optimizers: SGD, momentum, AdaGrad, Adam(W), and the cosine schedule.

Port of ``repro.optim``.  All share the reference's interface, on dicts
of tensors (``name -> tensor``, e.g. ``dict(model.named_parameters())``):

    opt = adamw(3e-4)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

The formulas are the reference's, term for term; ``torch.optim.AdamW``
is not used, since it orders the decay and the bias correction
differently.  ``update`` writes the new values into ``params`` and the
moments into ``state`` IN PLACE, under ``torch.no_grad()`` (the
reference returns new trees): a full-width model's fp32 masters and
moments are 27.5 GB, and a copy of either would not fit beside them.
It returns the same ``(params, state)``.

``lr`` may be a float or a callable step -> lr (``cosine_schedule``).
``state["step"]`` is a host int.  As in the reference, ``sgd``,
``momentum`` and ``adagrad`` read the rate at the step BEFORE the
increment and ``adam`` at ``step + 1``, so under ``cosine_schedule``
SGD's first update has lr 0.  Optimizer state is fp32 whatever the
gradient's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

Schedule = Union[float, Callable[[Any], Any]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]
    state_factor: int              # fp32 state floats per param (for memory est.)


def _lr_at(lr: Schedule, step: int):
    return lr(step) if callable(lr) else lr


def _zeros(params):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd(lr: Schedule = 1e-2) -> Optimizer:
    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        eta = _lr_at(lr, state["step"])
        for k, p in params.items():
            p.sub_(eta * grads[k].to(p.dtype))
        state["step"] += 1
        return params, state

    return Optimizer("sgd", init, update, 0)


def momentum(lr: Schedule = 1e-2, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0, "m": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        eta = _lr_at(lr, state["step"])
        for k, p in params.items():
            m = state["m"][k].mul_(beta).add_(grads[k].float())
            p.sub_(eta * m.to(p.dtype))
        state["step"] += 1
        return params, state

    return Optimizer("momentum", init, update, 1)


def adagrad(lr: Schedule = 1e-2, eps: float = 1e-10) -> Optimizer:
    def init(params):
        return {"step": 0, "g2": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        eta = _lr_at(lr, state["step"])
        for k, p in params.items():
            g = grads[k].float()
            a = state["g2"][k].add_(g.square())
            p.sub_((eta * g / (a.sqrt() + eps)).to(p.dtype))
        state["step"] += 1
        return params, state

    return Optimizer("adagrad", init, update, 1)


def adam(lr: Schedule = 3e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": 0, "m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = _lr_at(lr, step)
        # fp32 bias corrections, as the reference's b ** step; 0-dim CPU
        # tensors, which combine with tensors on any device
        s = torch.tensor(float(step), dtype=torch.float32)
        bc1 = 1 - b1 ** s
        bc2 = 1 - b2 ** s
        for k, p in params.items():
            g = grads[k].float()
            m = state["m"][k].mul_(b1).add_((1 - b1) * g)
            v = state["v"][k].mul_(b2).add_((1 - b2) * g.square())
            u = (m / bc1) / ((v / bc2).sqrt() + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.sub_((eta * u).to(p.dtype))
        state["step"] = step
        return params, state

    return Optimizer("adamw" if weight_decay else "adam", init, update, 2)


def adamw(lr: Schedule = 3e-4, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``; the rate is an fp32 scalar tensor on
    the CPU, computed as the reference computes it."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adagrad": adagrad,
              "adam": adam, "adamw": adamw}


def get_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr, **kw)


__all__ = ["Optimizer", "sgd", "momentum", "adagrad", "adam", "adamw",
           "cosine_schedule", "OPTIMIZERS", "get_optimizer"]
