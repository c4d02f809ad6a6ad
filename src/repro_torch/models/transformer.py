"""Decoder stack: ("attn", "mlp") and ("rwkv6", -) layers as ``nn.Module``s.

Port of ``repro.models.transformer`` for GQA attention/MLP layers and
RWKV-6 blocks.  The reference scans one stacked super-block (a leading
``n_rep`` axis on every leaf); here the layers are an ``nn.ModuleList``
and the stack is a Python loop that takes each layer's kind from
``cfg.layer_pattern()``.  An attention layer's paged KV pool is its own
``{"k", "v"}`` pair of ``(N, hk, hd)`` tensors; an RWKV layer's cache
is its per-slot recurrent state (``ssm.make_rwkv6_cache``).  Both are
updated in place.

Weights keep the reference's layouts (wq (d, h, hd), wk/wv (d, hk, hd),
wo (h, hd, d), MLP (d_in, d_out), RWKV as in ``models.ssm``) and are
cast ONCE to the compute dtype when the module is built -- the
reference casts at every use to the same values.  Norm scales and the
RWKV weights it reads in fp32 (``ssm.FP32_WEIGHTS``) stay fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
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


def init_layer(cfg, kind, *, generator, device="cpu"):
    """fp32 master weights of one layer of mixer ``kind`` ("attn" with
    an MLP, or "rwkv6", whose channel mix lives in its mixer), as a
    tree in the reference's layout."""
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    if kind == "rwkv6":
        return {"norm1": {"scale": torch.ones((d,), device=device)},
                "mixer": ssm_lib.init_rwkv6(cfg, **kw),
                "norm2": {"scale": torch.ones((d,), device=device)}}
    return {
        "norm1": {"scale": torch.ones((d,), device=device)},
        "mixer": attn_lib.init_attention(cfg, **kw),
        "norm2": {"scale": torch.ones((d,), device=device)},
        "ffn": init_mlp(d, cfg.d_ff, gated=cfg.mlp_gated, **kw),
    }


class Layer(nn.Module):
    """One decoder layer of mixer ``kind`` built from a reference-layout
    tree.  Nested norm scales ({"q_norm": {"scale": t}}, {"ln_x": ...})
    are flattened to their name.  An RWKV block has no ``ffn``."""

    def __init__(self, tree, dtype, kind):
        super().__init__()
        self.kind = kind
        keep = ssm_lib.FP32_WEIGHTS if kind == "rwkv6" else ()
        self.norm1 = _frozen(tree["norm1"]["scale"].float())
        self.norm2 = _frozen(tree["norm2"]["scale"].float())
        self.mixer = nn.ParameterDict({
            k: _frozen(v["scale"].float() if isinstance(v, dict)
                       else v.float() if k in keep else v.to(dtype))
            for k, v in tree["mixer"].items()})
        self.ffn = (nn.ParameterDict({k: _frozen(v.to(dtype))
                                      for k, v in tree["ffn"].items()})
                    if "ffn" in tree else None)


def init_layer_cache(cfg, kind, dtype, *, pool, slots, device="cpu"):
    """An attention layer's paged pool (token-major, no batch axis), or
    an RWKV layer's recurrent state with one row per serving slot."""
    if kind == "rwkv6":
        return ssm_lib.make_rwkv6_cache(cfg, slots, dtype, device=device)
    return attn_lib.make_cache(cfg, dtype, pool=pool, device=device)


def apply_layer(cfg, layer: Layer, x, *, positions, cache, paged,
                write_idx, rope):
    """Pre-norm residual block: attention then MLP, or RWKV time mix
    then channel mix.  Returns x."""
    h = rmsnorm(layer.norm1, x, cfg.norm_eps)
    if layer.kind == "rwkv6":
        x = x + ssm_lib.apply_rwkv6_time_mix(cfg, layer.mixer, h,
                                             cache=cache)
        h = rmsnorm(layer.norm2, x, cfg.norm_eps)
        return x + ssm_lib.apply_rwkv6_channel_mix(cfg, layer.mixer, h,
                                                   cache=cache)
    x = x + attn_lib.apply_attention(cfg, layer.mixer, h,
                                     positions=positions, cache=cache,
                                     paged=paged, write_idx=write_idx,
                                     rope=rope)
    h = rmsnorm(layer.norm2, x, cfg.norm_eps)
    return x + apply_mlp(layer.ffn, h, gated=cfg.mlp_gated)


def has_attention(cfg) -> bool:
    return any(mixer == "attn" for mixer, _ in cfg.layer_pattern())


def apply_stack(cfg, layers, x, *, positions, cache, paged, rope_freqs):
    """The layers in order.  What every attention layer derives alike
    from the positions -- pool write rows and RoPE angles -- is computed
    once, and only when the stack has an attention layer."""
    write_idx = rope = None
    if has_attention(cfg):
        write_idx = attn_lib.paged_write_indices(paged, positions)
        rope = rope_angles(positions, rope_freqs)
    for layer, c in zip(layers, cache):
        x = apply_layer(cfg, layer, x, positions=positions, cache=c,
                        paged=paged, write_idx=write_idx, rope=rope)
    return x
