"""Decoder stack: ("attn", "mlp") layers as ``nn.Module``s.

Port of ``repro.models.transformer`` for dense attention/MLP stacks.
The reference scans one stacked super-block (a leading ``n_rep`` axis
on every leaf); here the layers are an ``nn.ModuleList`` and the stack
is a Python loop.  Each layer's paged KV pool is its own ``{"k", "v"}``
pair of ``(N, hk, hd)`` tensors, updated in place.

Weights keep the reference's layouts (wq (d, h, hd), wk/wv (d, hk, hd),
wo (h, hd, d), MLP (d_in, d_out)) and are cast ONCE to the compute
dtype when the module is built -- the reference casts at every use to
the same values.  Norm scales stay fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_mlp, dense_init, rmsnorm,
                                       rope_angles)


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


def init_mlp(d_model, d_ff, *, gated=True, generator, device="cpu"):
    kw = dict(generator=generator, device=device)
    p = {"w_up": dense_init(d_model, d_ff, **kw),
         "w_down": dense_init(d_ff, d_model, **kw)}
    if gated:
        p["w_gate"] = dense_init(d_model, d_ff, **kw)
    return p


def init_layer(cfg, *, generator, device="cpu"):
    """fp32 master weights of one ("attn", "mlp") layer, as a tree in
    the reference's layout."""
    d = cfg.d_model
    return {
        "norm1": {"scale": torch.ones((d,), device=device)},
        "mixer": attn_lib.init_attention(cfg, generator=generator,
                                         device=device),
        "norm2": {"scale": torch.ones((d,), device=device)},
        "ffn": init_mlp(d, cfg.d_ff, gated=cfg.mlp_gated,
                        generator=generator, device=device),
    }


class Layer(nn.Module):
    """One decoder layer built from a reference-layout tree.  Nested
    norm scales ({"q_norm": {"scale": t}}) are flattened to their name."""

    def __init__(self, tree, dtype):
        super().__init__()
        self.norm1 = _frozen(tree["norm1"]["scale"].float())
        self.norm2 = _frozen(tree["norm2"]["scale"].float())
        self.mixer = nn.ParameterDict({
            k: _frozen(v["scale"].float() if isinstance(v, dict)
                       else v.to(dtype))
            for k, v in tree["mixer"].items()})
        self.ffn = nn.ParameterDict({k: _frozen(v.to(dtype))
                                     for k, v in tree["ffn"].items()})


def init_layer_cache(cfg, dtype, *, pool, device="cpu"):
    """One attention layer's paged pool (token-major, no batch axis)."""
    return attn_lib.make_cache(cfg, dtype, pool=pool, device=device)


def apply_layer(cfg, layer: Layer, x, *, positions, cache, paged,
                write_idx, rope):
    """Pre-norm residual block: attention then MLP.  Returns x."""
    h = rmsnorm(layer.norm1, x, cfg.norm_eps)
    x = x + attn_lib.apply_attention(cfg, layer.mixer, h,
                                     positions=positions, cache=cache,
                                     paged=paged, write_idx=write_idx,
                                     rope=rope)
    h = rmsnorm(layer.norm2, x, cfg.norm_eps)
    return x + apply_mlp(layer.ffn, h, gated=cfg.mlp_gated)


def apply_stack(cfg, layers, x, *, positions, cache, paged, rope_freqs):
    """The layers in order.  What every layer derives alike from the
    positions -- pool write rows and RoPE angles -- is computed once."""
    write_idx = attn_lib.paged_write_indices(paged, positions)
    rope = rope_angles(positions, rope_freqs)
    for layer, c in zip(layers, cache):
        x = apply_layer(cfg, layer, x, positions=positions, cache=c,
                        paged=paged, write_idx=write_idx, rope=rope)
    return x
