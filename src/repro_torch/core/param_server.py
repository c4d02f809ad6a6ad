"""DistBelief-style asynchronous parameter server -- the paper's REJECTED
alternative (§3.3.2), implemented so the comparison is reproducible
(port of ``repro.core.param_server``).

The paper argues a parameter server "suffers from bottleneck at
parameter server, especially at scale" and that async updates make it
"difficult to reason about the correctness of the algorithm".  The
async dynamics are emulated deterministically on one device:

  * ``p`` workers hold stale snapshots of the server's parameters.
  * Round-robin ticks: at tick t, worker (t mod p) computes the loss and
    gradient at its snapshot (staleness ≈ p ticks), the server applies
    the gradient, and the worker pulls the fresh parameters.

The reference scans the ticks under ``jit``; here they are an eager
loop on the params' device.  Each snapshot is a COPY of the server's
tensors, never a view: the optimizer updates the server in place, and a
view would follow it -- every gradient would then be taken at the fresh
parameters, which is synchronous SGD, not the async regime.
"""
from __future__ import annotations

from typing import Callable

import torch


def _detached(params) -> dict:
    """Fresh copies of ``params`` ({name: tensor}), not views of them."""
    return {k: v.detach().clone() for k, v in params.items()}


def make_ps_trainer(loss_fn: Callable, optimizer, num_workers: int):
    """Returns ``run(params, opt_state, batches) -> (params, opt_state,
    losses)``.

    ``loss_fn(params, batch) -> scalar`` over ``params`` ({name:
    tensor}); ``optimizer`` a ``repro_torch.optim`` Optimizer (its
    ``update`` writes the server's tensors in place); ``batches`` a
    tuple, list or dict of arrays with a leading tick axis -- one
    microbatch a tick, consumed round-robin by the workers.  The
    returned params are the server's (``params`` itself, updated in
    place) and ``losses`` the (ticks,) fp32 tensor of each tick's loss
    at the stale snapshot it was taken at."""
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")

    def tick_batch(batches, t, dev):
        pick = lambda a: torch.as_tensor(a[t], device=dev)  # noqa: E731
        if isinstance(batches, dict):
            return {k: pick(v) for k, v in batches.items()}
        return type(batches)(pick(v) for v in batches)

    def ticks_of(batches):
        leaves = (batches.values() if isinstance(batches, dict)
                  else batches)
        return {len(a) for a in leaves}.pop()

    def run(params, opt_state, batches):
        dev = next(iter(params.values())).device
        # every worker starts from the server's params
        snapshots = [_detached(params) for _ in range(num_workers)]
        n_ticks = ticks_of(batches)
        losses = torch.empty(n_ticks, dtype=torch.float32, device=dev)
        for t in range(n_ticks):
            w = t % num_workers
            snap = {k: v.requires_grad_(True)
                    for k, v in snapshots[w].items()}
            # gradient computed at the STALE snapshot
            loss = loss_fn(snap, tick_batch(batches, t, dev))
            grads = torch.autograd.grad(loss, list(snap.values()))
            losses[t] = loss.detach()
            optimizer.update(dict(zip(snap, grads)), opt_state, params)
            # the worker pulls the fresh params
            snapshots[w] = _detached(params)
        return params, opt_state, losses

    return run
