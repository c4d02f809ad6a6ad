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

``accumulate_grads`` is shared with the data-parallel step
(``core.data_parallel``), which averages the gradients it returns over
the ranks; its microbatches accumulate in fp32 whatever ``grad_dtype``
says, as the reference's strategies do.  A model with a
multi-token-prediction head adds its CE at ``mtp_weight``
(``train.loss.lm_loss``).

With ``mesh=`` (a ``DeviceMesh`` of ``("data", "model")`` or ``("pod",
"data", "model")``; the reference's full-config GSPMD step): every
master is a DTensor placed by ``sharding.rules.param_specs`` in train
mode (each cut as it is drawn, ``bridge.mesh_placer``), each optimizer
moment mirrors its master's placements and the step counter is a host
int, as ``opt_state_shardings`` replicates it.  Each microbatch of the
global batch is cut over pod x data by ``batch_spec``; where its rows
do not divide, each row's sequence is cut over ``"data"`` instead when
it divides (the reference's residual constraint; ``_splits``), else the
microbatch is replicated.  The forward and backward run the layers'
mesh forms under the registered activation mesh (``sharding.ctx``),
and the loss is the mean over the global batch
(``train.loss.lm_loss_mesh``).  The gradients
arrive already summed over the batch axes, each as its master's block
(``sharding.comm.use``); the clip's norm sums the blocks over the mesh
and the optimizer updates every block in place.  ``mesh=None`` is the
one-device step, unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.models import apply_model, batch_inputs, init_model
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import MeshComm, all_reduce, shard_dims
from repro_torch.sharding.rules import batch_spec
from repro_torch.train.loss import lm_loss, lm_loss_mesh


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


def make_train_step(cfg, tc: TrainConfig, *, mesh=None):
    """Returns (step_fn, optimizer) -- ``step(state, batch) -> (state,
    metrics)`` on the ``TrainState`` contract; ``batch`` is ``{"tokens":
    (B, S)}``, with ``"vision_embeds"`` for a VLM, or an
    encoder-decoder's ``{"src_embeds", "tgt_tokens"}`` (numpy or
    tensors), moved to the masters' device.  The
    masters and the optimizer state are updated in place, and the
    returned state holds the same objects.  The masters' dtype is the
    model's (``init_train_state`` draws them in ``tc.param_dtype``);
    microbatches accumulate in ``tc.grad_dtype``.  With ``mesh``, the
    step of a mesh state (module docstring): every rank passes the same
    global batch and gets the same metrics."""
    gdt = getattr(torch, tc.grad_dtype)
    lr = (optim_lib.cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
          if tc.schedule == "cosine" else tc.lr)
    optimizer = optim_lib.get_optimizer(tc.optimizer, lr)
    loss_fn = (make_loss_fn(cfg, tc) if mesh is None
               else _mesh_loss_fn(cfg, tc, mesh))
    n = tc.microbatches

    def step(state: TrainState, batch):
        model = state.params
        params = trainable(model)
        if mesh is None:
            loss, metrics, grads = accumulate_grads(loss_fn, model, params,
                                                    batch, n, grad_dtype=gdt)
            clip, opt = clip_by_global_norm, state.opt_state
        else:
            # the scope spans the backward: remat recomputes the layers'
            # mesh forms there
            split = _splits(cfg, batch, n, mesh)
            with shctx.activation_mesh(mesh), shctx.batch_split(
                    split == "batch"), shctx.seq_split(split == "seq"):
                loss, metrics, grads = accumulate_grads(
                    loss_fn, model, params, batch, n, grad_dtype=gdt)
            # each rank's loss is its share: the metric is the global loss
            loss = metrics.pop("loss")
            clip = functools.partial(_clip_mesh, masters=params)
            params, grads, opt = (_local(params), _local(grads),
                                  _local(state.opt_state))
        if tc.grad_clip > 0:
            grads, gnorm = clip(grads, tc.grad_clip)
            metrics["grad_norm"] = gnorm
        optimizer.update(grads, opt, params)
        if opt is not state.opt_state:
            state.opt_state["step"] = opt["step"]
        return (state._replace(step=state.step + 1),
                {"loss": loss, **metrics})

    return step, optimizer


# --------------------------------------------------------------------------
# on a mesh
# --------------------------------------------------------------------------

def _splits(cfg, batch, n, mesh):
    """How each of the ``n`` microbatches of ``batch`` is cut, in the
    reference's order of tests (``ctx.constrain_bsd``): ``"batch"``, its
    rows over pod x data (``batch_spec``); else ``"seq"``, each row's
    sequence (the residual stream's: a VLM's image rows and text, an
    encoder-decoder's targets) over ``"data"`` when it divides; else
    None, replicated."""
    B = next(iter(batch.values())).shape[0]
    if batch_spec(mesh, B // n) != (None,):
        return "batch"
    names = tuple(mesh.mesh_dim_names)
    D = int(mesh.mesh.shape[names.index("data")]) if "data" in names else 1
    S = batch.get("tgt_tokens", batch.get("tokens")).shape[1]
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        S += batch["vision_embeds"].shape[1]
    return "seq" if D > 1 and S > 1 and S % D == 0 else None


def _mesh_loss_fn(cfg, tc, mesh):
    """``loss_fn(model, global microbatch) -> (this rank's share of the
    objective, global metrics)``, under the activation mesh and the
    batch split the step registers: this rank's pod x data block of the
    rows, or all of them when the batch does not divide."""
    def loss_fn(model, batch):
        comm = shctx.get_comm()
        if shctx.is_batch_split():
            rows = next(iter(batch.values())).shape[0] // comm.dp_size()
            lo = comm.dp_index() * rows
            batch = {k: v[lo:lo + rows] for k, v in batch.items()}
        tokens, frontends = batch_inputs(batch)
        out = apply_model(cfg, model, tokens, mode="train", remat=tc.remat,
                          **frontends)
        return lm_loss_mesh(cfg, out, batch, comm, mtp_weight=tc.mtp_weight)
    return loss_fn


@torch.no_grad()
def _local(tree):
    """A dict (of dicts) of DTensors as their local blocks, which share
    the DTensors' storage; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def _clip_mesh(grads, max_norm, *, masters):
    """``clip_by_global_norm`` of local gradient blocks: each block's sum
    of squares over the ranks holding a copy of it (the mesh axes that
    do not split it), summed over every rank -- the norm of the whole
    gradients."""
    total = None
    comm = None
    for k, g in grads.items():
        comm = comm or MeshComm(masters[k].device_mesh)
        dims = shard_dims(masters[k], comm)
        copies = 1
        for a in comm.names:
            if a not in dims:
                copies *= comm.size(a)
        part = g.float().square().sum() / copies
        total = part if total is None else total + part
    norm = torch.sqrt(all_reduce(total, comm, comm.names))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


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


def init_train_state(cfg, tc: TrainConfig, *, mesh=None, seed=0,
                     device="cuda"):
    """A ``TrainState`` at step 0: a training ``Model`` of masters in
    ``tc.param_dtype`` drawn from ``seed`` on ``device``
    (``models.init_model(..., train=True)``; the reference draws fp32
    and casts every leaf, the port casts each as it is drawn) and the
    optimizer's zero state.  With ``mesh``, every rank draws the same
    weights and keeps its block of each as it is drawn
    (``bridge.mesh_placer``): the masters and the moments are DTensors
    placed by the rules, and no rank holds more than its blocks and one
    whole leaf; ``device="meta"`` lays out a state without storage."""
    from repro_torch.bridge import mesh_placer
    optimizer = optim_lib.get_optimizer(tc.optimizer, tc.lr)
    model = init_model(cfg, seed=seed, device=device, train=True,
                       param_dtype=getattr(torch, tc.param_dtype),
                       place=None if mesh is None else mesh_placer(cfg, mesh))
    return start_state(model, optimizer)
