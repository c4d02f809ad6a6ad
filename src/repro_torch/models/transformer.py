"""Decoder stack: attention, Mamba and RWKV-6 layers as ``nn.Module``s.

Port of ``repro.models.transformer`` for GQA or MLA attention and Mamba
mixers with an MLP or MoE ffn, and RWKV-6 blocks.  The reference scans
one stacked super-block (a leading ``n_rep`` axis on every leaf); here
the layers are an ``nn.ModuleList`` and the stack is a Python loop that
takes each layer's (mixer, ffn) kinds from ``cfg.layer_pattern()``.
An attention layer's paged KV pool is its own ``{"k", "v"}`` pair of
``(N, hk, hd)`` tensors (MLA: ``{"ckv": (N, kv_lora), "krope": (N,
rope)}``), or for the lockstep slab path a ``{"k", "v"}`` pair of
``(B, max_len, hk, hd)`` (GQA only); a Mamba or RWKV layer's cache is
its per-slot recurrent state (``ssm.make_mamba_cache``,
``ssm.make_rwkv6_cache``).  All are updated in place.  The training
forward (``mode="train"``, GQA with an MLP) has no cache.

Weights keep the reference's layouts (wq (d, h, hd), wk/wv (d, hk, hd),
wo (h, hd, d), MLA as in ``attention.init_mla``, MLP (d_in, d_out), MoE
experts (E, d_in, d_out), Mamba and RWKV as in ``models.ssm``) and are
cast ONCE to the compute dtype in a serving model: as they are drawn
(``init_layer``), or when the module is built from a reference tree --
the reference casts at every use to the same values.  Norm scales and
the weights it reads in fp32 (``ssm.FP32_WEIGHTS``,
``moe.FP32_WEIGHTS``) stay fp32.  A training model keeps every weight
as a trainable fp32 master and casts it at use.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_mlp, init_mlp, rmsnorm, rope_angles


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


def _master(t):
    """A trainable fp32 master weight."""
    return nn.Parameter(t.float(), requires_grad=True)


class ParamTree(nn.Module):
    """A nested dict of parameters (an ffn tree: an MLP, or an MoE
    layer's router, ``experts`` and ``shared``) as a module that reads
    like the dict: ``p["experts"]["w_up"]``, ``"w_gate" in p``.  Each
    leaf is ``param(name, tensor)``."""

    def __init__(self, tree, param):
        super().__init__()
        self._names = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, param))
            else:
                self.register_parameter(k, param(k, v))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k):
        return k in self._names

    def items(self):
        return [(k, self[k]) for k in self._names]


def init_layer(cfg, spec, *, generator, device="cpu", dense_ff=0, dtype):
    """Weights of one layer of kinds ``spec`` = (mixer, ffn): an "attn"
    (GQA, or MLA when ``cfg.attention == "mla"``) or "mamba" mixer with
    an "mlp" (of width ``dense_ff`` when given, else ``d_ff``) or "moe"
    ffn, or an "rwkv6" block, whose channel mix lives in its mixer; as a
    tree in the reference's layout.  Drawn in fp32, each weight cast to
    ``dtype`` as it is drawn (norm scales and the weights read in fp32
    stay fp32), so a bf16 draw never holds two fp32 masters at once."""
    mixer, ffn = spec
    d = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda: {"scale": torch.ones((d,), device=device)}
    if mixer == "rwkv6":
        return {"norm1": ones(), "mixer": ssm_lib.init_rwkv6(cfg, **kw),
                "norm2": ones()}
    if mixer == "mamba":
        mix = ssm_lib.init_mamba(cfg, **kw)
    elif cfg.attention == "mla":
        mix = attn_lib.init_mla(cfg, **kw)
    else:
        mix = attn_lib.init_attention(cfg, **kw)
    p = {"norm1": ones(), "mixer": mix, "norm2": ones()}
    p["ffn"] = (moe_lib.init_moe(cfg, **kw) if ffn == "moe" else
                init_mlp(d, dense_ff or cfg.d_ff, gated=cfg.mlp_gated, **kw))
    return p


class Layer(nn.Module):
    """One decoder layer of kinds ``spec`` = (mixer, ffn) built from a
    reference-layout tree.  Nested mixer norm scales ({"q_norm":
    {"scale": t}}, {"ln_x": ...}) are flattened to their name; the ffn
    keeps its nesting (``ParamTree``).  An RWKV block has no ``ffn``.

    Serving (``train`` False): frozen weights, each cast once to
    ``dtype`` (norm scales and ``FP32_WEIGHTS`` in fp32).  Training:
    every weight a trainable fp32 master, cast to the compute dtype at
    use."""

    def __init__(self, tree, dtype, spec, *, train=False):
        super().__init__()
        self.kind, self.ffn_kind = spec
        if train:
            param = lambda k, v: _master(v)
        else:
            param = lambda k, v: _frozen(
                v.float() if k in ssm_lib.FP32_WEIGHTS + moe_lib.FP32_WEIGHTS
                else v.to(dtype))
        scale = lambda t: (_master if train else _frozen)(t.float())
        self.norm1 = scale(tree["norm1"]["scale"])
        self.norm2 = scale(tree["norm2"]["scale"])
        self.mixer = nn.ParameterDict({
            k: scale(v["scale"]) if isinstance(v, dict) else param(k, v)
            for k, v in tree["mixer"].items()})
        self.ffn = ParamTree(tree["ffn"], param) if "ffn" in tree else None


def init_layer_cache(cfg, kind, dtype, *, pool=None, slots=None, batch=None,
                     max_len=None, device="cpu"):
    """An attention layer's paged pool (token-major, no batch axis; or,
    with ``pool`` None, its (batch, max_len) slab), or a Mamba or RWKV
    layer's recurrent state with one row per serving slot."""
    if pool is None:
        return attn_lib.make_cache(cfg, dtype, batch=batch, max_len=max_len,
                                   device=device)
    if kind == "rwkv6":
        return ssm_lib.make_rwkv6_cache(cfg, slots, dtype, device=device)
    if kind == "mamba":
        return ssm_lib.make_mamba_cache(cfg, slots, dtype, device=device)
    if cfg.attention == "mla":
        return attn_lib.make_mla_cache(cfg, dtype, pool=pool, device=device)
    return attn_lib.make_cache(cfg, dtype, pool=pool, device=device)


def apply_layer(cfg, layer: Layer, x, *, positions, cache, paged,
                write_idx, rope, mode="decode", cache_pos=0):
    """Pre-norm residual block: attention or Mamba then an MLP or MoE,
    or RWKV time mix then channel mix.  Returns (x, aux), aux being the
    MoE load-balance loss or None.  ``paged`` None is the slab path
    (GQA attention only): ``mode`` and the scalar ``cache_pos`` say
    where the new keys go, and ``mode="train"`` (cache None) is the
    training forward."""
    h = rmsnorm(layer.norm1, x, cfg.norm_eps)
    if layer.kind == "rwkv6":
        x = x + ssm_lib.apply_rwkv6_time_mix(cfg, layer.mixer, h,
                                             cache=cache)
        h = rmsnorm(layer.norm2, x, cfg.norm_eps)
        return x + ssm_lib.apply_rwkv6_channel_mix(cfg, layer.mixer, h,
                                                   cache=cache), None
    if layer.kind == "mamba":
        x = x + ssm_lib.apply_mamba(cfg, layer.mixer, h, cache=cache)
    elif cfg.attention == "mla":
        x = x + attn_lib.apply_mla(cfg, layer.mixer, h, positions=positions,
                                   cache=cache, paged=paged,
                                   write_idx=write_idx, rope=rope)
    else:
        x = x + attn_lib.apply_attention(cfg, layer.mixer, h,
                                         positions=positions, cache=cache,
                                         paged=paged, write_idx=write_idx,
                                         rope=rope, mode=mode,
                                         cache_pos=cache_pos)
    h = rmsnorm(layer.norm2, x, cfg.norm_eps)
    if layer.ffn_kind == "moe":
        h, aux = moe_lib.apply_moe(cfg, layer.ffn, h)
        return x + h, aux
    return x + apply_mlp(layer.ffn, h, gated=cfg.mlp_gated), None


def has_attention(cfg) -> bool:
    return any(mixer == "attn" for mixer, _ in cfg.layer_pattern())


def apply_stack(cfg, layers, x, *, positions, cache, paged, rope_freqs,
                mode="decode", cache_pos=0, remat=False):
    """The layers in order; returns (x, the summed MoE aux loss or
    None).  What every attention layer derives alike from the positions
    -- pool write rows (paged) and RoPE angles -- is computed once, and
    only when the stack has an attention layer.  ``paged`` None is the
    slab path, and ``mode="train"`` (cache None) the training forward:
    positions (1, S), shared by every slot.  ``remat`` runs each layer
    under ``torch.utils.checkpoint`` (per-layer rematerialisation, as
    the reference's ``jax.checkpoint`` of one layer): its activations
    are recomputed in the backward instead of kept."""
    write_idx = rope = None
    if has_attention(cfg):
        if paged is not None:
            write_idx = attn_lib.paged_write_indices(paged, positions)
        rope = rope_angles(positions, rope_freqs)
    aux = None
    for layer, c in zip(layers, [None] * len(layers) if cache is None
                         else cache):
        fn = functools.partial(apply_layer, cfg, layer, positions=positions,
                               cache=c, paged=paged, write_idx=write_idx,
                               rope=rope, mode=mode, cache_pos=cache_pos)
        x, a = (checkpoint(fn, x, use_reentrant=False) if remat else fn(x))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux
