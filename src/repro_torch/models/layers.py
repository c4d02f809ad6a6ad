"""Core building blocks: norms, MLPs, embeddings, RoPE, init helpers.

Port of ``repro.models.layers``.  Functions take tensors and weights
explicitly and cast each weight to the compute dtype at use, as the
reference's ``.astype(dt)`` does: a training model's fp32 masters are
cast on every call (and their gradients flow back through the cast),
while a serving model's weights, cast once at load, pass through
``Tensor.to`` untouched (no copy, no launch).  Norm scales stay fp32,
as the reference multiplies them in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# init helpers (fp32 draws from an explicit generator, cast as drawn)
# --------------------------------------------------------------------------

def truncated_normal(shape, std, *, generator, device="cpu",
                     dtype=torch.float32):
    """Normal(0, std) truncated at +-3 std, drawn in fp32 and cast to
    ``dtype`` at once, so a bf16 model never holds more than the one
    fp32 master being drawn (the values are those of casting later)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                generator=generator)
    return t.to(dtype)


def dense_init(d_in, d_out, *, generator, device="cpu", std=None,
               dtype=torch.float32):
    std = std if std is not None else 1.0 / np.sqrt(d_in)
    return truncated_normal((d_in, d_out), std, generator=generator,
                            device=device, dtype=dtype)


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
