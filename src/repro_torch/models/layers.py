"""Core building blocks: norms, MLPs, embeddings, RoPE, init helpers.

Port of ``repro.models.layers``.  Functions take tensors and weights
explicitly and cast each weight to the compute dtype at use, as the
reference's ``.astype(dt)`` does: a training model's fp32 masters are
cast on every call (and their gradients flow back through the cast),
while a serving model's weights, cast once at load, pass through
``Tensor.to`` untouched (no copy, no launch).  Norm scales stay fp32,
as the reference multiplies them in fp32.

The mesh forms (``apply_mlp_mesh``, ``apply_embed_mesh``,
``apply_unembed_mesh``) take DTensor masters and activations replicated
over ``"model"`` (``sharding.comm``): the MLP is column-parallel in
``w_up`` / ``w_gate`` and row-parallel in ``w_down`` when the rule
splits the ffn over ``"model"``, and the table vocab-parallel when the
rule splits the vocabulary; otherwise the weight is gathered and the
work replicated.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.comm import copy_to, reduce_from, shard_dims, use

MODEL = ("model",)


# --------------------------------------------------------------------------
# init helpers (fp32 draws from an explicit generator, cast as drawn)
# --------------------------------------------------------------------------

_ON_DRAW = None      # what every draw passes through (``on_draw``)


@contextlib.contextmanager
def on_draw(fn):
    """Scope ``fn``: every ``truncated_normal`` draw in the body returns
    ``fn(draw)`` instead of the draw (``bridge.mesh_placer`` records the
    draws, or cuts each to this rank's block as it is drawn)."""
    global _ON_DRAW
    prev, _ON_DRAW = _ON_DRAW, fn
    try:
        yield
    finally:
        _ON_DRAW = prev


def truncated_normal(shape, std, *, generator, device="cpu",
                     dtype=torch.float32, shift=0.0, scale=None):
    """Normal(0, std) truncated at +-3 std, plus ``shift``, drawn in fp32
    and cast to ``dtype`` at once, so a bf16 model never holds more than
    the one fp32 master being drawn (the values are those of casting
    later); ``scale`` (a numpy factor broadcast over the draw, e.g. the
    padded heads' 0 / 1 mask) multiplies it in ``dtype`` before the
    ``on_draw`` hook sees it."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                generator=generator)
    if shift:
        t.add_(shift)
    t = t.to(dtype)
    if scale is not None:
        t = t * torch.from_numpy(scale).to(device, dtype)
    return t if _ON_DRAW is None else _ON_DRAW(t)


def dense_init(d_in, d_out, *, generator, device="cpu", std=None,
               dtype=torch.float32, scale=None):
    std = std if std is not None else 1.0 / np.sqrt(d_in)
    return truncated_normal((d_in, d_out), std, generator=generator,
                            device=device, dtype=dtype, scale=scale)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(scale, x, eps=1e-6):
    """fp32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale).to(dt)


# --------------------------------------------------------------------------
# MLP (gated SwiGLU or plain 2-mat)
# --------------------------------------------------------------------------

def init_mlp(d_model, d_ff, *, gated=True, generator, device="cpu", dtype):
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"w_up": dense_init(d_model, d_ff, **kw),
         "w_down": dense_init(d_ff, d_model, **kw)}
    if gated:
        p["w_gate"] = dense_init(d_model, d_ff, **kw)
    return p


def apply_mlp(p, x, gated=True):
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if gated:
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"].to(dt)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def apply_embed(table, tokens, dtype):
    """Rows of the table in ``dtype``: gathered, then cast -- the values
    of the reference's cast-then-gather, without casting the whole
    table."""
    return table[tokens].to(dtype)


def apply_unembed(table, x):
    """Logits in fp32 against the table in fp32."""
    return x.float() @ table.float().t()


# --------------------------------------------------------------------------
# RoPE (split-half convention)
# --------------------------------------------------------------------------

def rope_freqs(head_dim, theta):
    """(hd/2,) fp32 inverse frequencies, computed in numpy exactly as the
    reference does; the model keeps them on its device once, so the
    decode loop copies nothing from the host."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def rope_angles(positions, freqs):
    """(cos, sin) of the rotation angles, each (B, S, 1, hd/2) fp32, for
    (B, S) per-slot positions; freqs is ``rope_freqs(hd, theta)`` on the
    positions' device.  Every layer of a model call rotates by the same
    angles, so the call computes them once."""
    ang = positions[..., :, None].float() * freqs        # (B, S, hd/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x, angles):
    """Split-half rotation of x: (B, S, heads, hd) by ``rope_angles``."""
    cos, sin = angles
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# mesh forms (DTensor masters; activations replicated over "model")
# --------------------------------------------------------------------------

def apply_mlp_mesh(p, x, comm, gated=True):
    """``apply_mlp`` of DTensor masters: column-parallel ``w_up`` /
    ``w_gate`` and row-parallel ``w_down`` over ``"model"`` when the
    rule split the ffn so, the partial sums all-reduced; else every
    weight gathered and the MLP replicated."""
    if shard_dims(p["w_up"], comm).get("model") != 1:
        return apply_mlp({k: use(v, comm) for k, v in p.items()}, x, gated)
    w = {k: use(v, comm, keep=MODEL) for k, v in p.items()}
    return reduce_from(apply_mlp(w, copy_to(x, comm, MODEL), gated), comm,
                       MODEL)


def vocab_shard(table, comm):
    """(first row, rows) of this rank's block of a vocab-parallel table,
    or None when the table is not split over ``"model"``."""
    if shard_dims(table, comm).get("model") != 0:
        return None
    rows = table.shape[0] // comm.size("model")
    return comm.index("model") * rows, rows


def vocab_start(table, comm):
    """The first vocabulary row of this rank's logits against ``table``
    (``apply_unembed_mesh``), or None when they are the whole
    vocabulary."""
    shard = vocab_shard(table, comm)
    return None if shard is None else shard[0]


def apply_embed_mesh(table, tokens, dtype, comm):
    """``apply_embed`` of a DTensor table.  Vocab-parallel: each rank
    looks up the tokens its rows hold (zeros elsewhere) and the rows are
    summed over ``"model"`` -- one rank adds each row to zeros, so the
    values are the one-device lookup's."""
    shard = vocab_shard(table, comm)
    if shard is None:
        return apply_embed(use(table, comm), tokens, dtype)
    start, rows = shard
    t = use(table, comm, keep=MODEL)
    local = tokens - start
    mine = (local >= 0) & (local < rows)
    hit = t[local.clamp(0, rows - 1)] * mine[..., None].to(t.dtype)
    return reduce_from(hit, comm, MODEL).to(dtype)


def apply_unembed_mesh(table, x, comm):
    """fp32 logits against a DTensor table: this rank's vocab block (B,
    S, V / |model|) from row ``vocab_start`` when the table is
    vocab-parallel, else all of them."""
    if vocab_shard(table, comm) is None:
        return apply_unembed(use(table, comm), x)
    return apply_unembed(use(table, comm, keep=MODEL),
                         copy_to(x, comm, MODEL))
