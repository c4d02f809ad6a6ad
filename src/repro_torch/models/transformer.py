"""Decoder stack: attention, Mamba and RWKV-6 layers as ``nn.Module``s.

Port of ``repro.models.transformer`` for GQA or MLA attention and Mamba
mixers with an MLP or MoE ffn, and RWKV-6 blocks.  The reference scans
one stacked super-block (a leading ``n_rep`` axis on every leaf); here
the layers are an ``nn.ModuleList`` and the stack is a Python loop that
takes each layer's (mixer, ffn) kinds from ``cfg.layer_pattern()``.
An attention layer's paged KV pool is its own ``{"k", "v"}`` pair of
``(N, hk, hd)`` tensors (MLA: ``{"ckv": (N, kv_lora), "krope": (N,
rope)}``), or for the lockstep slab path a ``{"k", "v"}`` pair of
``(B, max_len, hk, hd)`` (MLA: ``{"ckv", "krope"}`` of ``(B, max_len,
...)``); a Mamba or RWKV layer's cache is its per-slot (or, on the slab
path, per-batch-row) recurrent state (``ssm.make_mamba_cache``,
``ssm.make_rwkv6_cache``).  All are updated in place.  The training
forward (``mode="train"``) has no cache.

An encoder-decoder's decoder layers also hold ``norm_cross`` and a
``cross``-attention (after the self-attention, before the ffn), and
their slab cache is ``{"self": the layer's own, "cross": {"k", "v"}
of (B, cross_len, hk, hd)}``; the paged pool refuses them.  The
encoder is a stack of the same layers run with ``causal=False``.

Weights keep the reference's layouts (wq (d, h, hd), wk/wv (d, hk, hd),
wo (h, hd, d), MLA as in ``attention.init_mla``, MLP (d_in, d_out), MoE
experts (E, d_in, d_out), Mamba and RWKV as in ``models.ssm``) and are
cast ONCE to the compute dtype in a serving model: as they are drawn
(``init_layer``), or when the module is built from a reference tree --
the reference casts at every use to the same values.  Norm scales and
the weights it reads in fp32 (``ssm.FP32_WEIGHTS``,
``moe.FP32_WEIGHTS``) stay fp32.  A training model keeps every weight
as a trainable master of one dtype (fp32, or bf16 under
``TrainConfig(param_dtype="bfloat16")``) and casts it at use.

On a mesh (an activation mesh registered, ``sharding.ctx``; the masters
DTensors) a train-mode layer takes its mesh forms: GQA attention and the
MLP tensor-parallel over ``"model"`` where the rules split heads or the
ffn (``attention.apply_attention_mesh``, ``layers.apply_mlp_mesh``), the
MoE expert-parallel (``moe.apply_moe_ep``), and everything else -- MLA,
Mamba, RWKV-6, cross-attention, the norms -- gathered at use
(``sharding.comm.use``) and run replicated.  The gathers run inside the
layer, so under remat they are redone in the recomputation.  Under a
serve topology the serving modes take the same forms (``ctx.layer_comm``)
over the weights placed by the serve-mode rules: the paged pool is read
as ``attention`` sets out, and a slab cache cut over ``"model"``
(``ctx.Placed``) is gathered for the layer and its block written back
after it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mlp, apply_mlp_mesh, init_mlp,
                                       rmsnorm, rope_angles)
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import gather_seq, own_block, use


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


def _master(t, dtype=torch.float32):
    """A trainable master weight of ``dtype``."""
    return nn.Parameter(t.to(dtype), requires_grad=True)


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


def init_layer(cfg, spec, *, generator, device="cpu", dense_ff=0, dtype,
               cross=False):
    """Weights of one layer of kinds ``spec`` = (mixer, ffn): an "attn"
    (GQA, or MLA when ``cfg.attention == "mla"``) or "mamba" mixer with
    an "mlp" (of width ``dense_ff`` when given, else ``d_ff``) or "moe"
    ffn, or an "rwkv6" block, whose channel mix lives in its mixer; as a
    tree in the reference's layout.  ``cross`` adds ``norm_cross`` and a
    bias-free ``cross``-attention (drawn after the mixer).  Drawn in
    fp32, each weight cast to ``dtype`` as it is drawn (norm scales and
    the weights read in fp32 stay fp32), so a bf16 draw never holds two
    fp32 masters at once."""
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
    if cross:
        p["norm_cross"] = ones()
        p["cross"] = attn_lib.init_attention(cfg, cross=True, **kw)
    p["ffn"] = (moe_lib.init_moe(cfg, **kw) if ffn == "moe" else
                init_mlp(d, dense_ff or cfg.d_ff, gated=cfg.mlp_gated, **kw))
    return p


class Layer(nn.Module):
    """One decoder layer of kinds ``spec`` = (mixer, ffn) built from a
    reference-layout tree.  Nested mixer norm scales ({"q_norm":
    {"scale": t}}, {"ln_x": ...}) are flattened to their name; the ffn
    keeps its nesting (``ParamTree``).  An RWKV block has no ``ffn``.
    A decoder layer of an encoder-decoder also has ``norm_cross`` and
    ``cross`` (flattened like the mixer); other layers have None.

    Serving (``train`` False): frozen weights, each cast once to
    ``dtype`` (norm scales and ``FP32_WEIGHTS`` in fp32).  Training:
    every weight a trainable master of ``param_dtype``, cast to the
    compute dtype at use."""

    def __init__(self, tree, dtype, spec, *, train=False,
                 param_dtype=torch.float32):
        super().__init__()
        self.kind, self.ffn_kind = spec
        if train:
            param = lambda k, v: _master(v, param_dtype)
            scale = param
        else:
            param = lambda k, v: _frozen(
                v.float() if k in ssm_lib.FP32_WEIGHTS + moe_lib.FP32_WEIGHTS
                else v.to(dtype))
            scale = lambda k, t: _frozen(t.float())
        self.norm1 = scale("norm1", tree["norm1"]["scale"])
        self.norm2 = scale("norm2", tree["norm2"]["scale"])
        flat = lambda t: nn.ParameterDict({
            k: scale(k, v["scale"]) if isinstance(v, dict) else param(k, v)
            for k, v in t.items()})
        self.mixer = flat(tree["mixer"])
        self.ffn = ParamTree(tree["ffn"], param) if "ffn" in tree else None
        self.norm_cross = self.cross = None
        if "cross" in tree:
            self.norm_cross = scale("norm_cross", tree["norm_cross"]["scale"])
            self.cross = flat(tree["cross"])


def init_layer_cache(cfg, kind, dtype, *, pool=None, slots=None, batch=None,
                     max_len=None, device="cpu", cross=False, cross_len=0):
    """An attention layer's paged pool (token-major, no batch axis; or,
    with ``pool`` None, its (batch, max_len) slab), or a Mamba or RWKV
    layer's recurrent state with one row per serving slot (with ``pool``
    None, per batch row).  ``cross``: {"self": that, "cross": a (batch,
    cross_len) slab of the encoder's K/V}; the paged pool raises."""
    if cross:
        if pool is not None:
            raise ValueError("paged cache does not support cross-attention")
        return {"self": init_layer_cache(cfg, kind, dtype, batch=batch,
                                         max_len=max_len, device=device),
                "cross": attn_lib.make_cache(cfg, dtype, batch=batch,
                                             max_len=cross_len,
                                             device=device)}
    rows = slots if pool is not None else batch
    if kind == "rwkv6":
        return ssm_lib.make_rwkv6_cache(cfg, rows, dtype, device=device)
    if kind == "mamba":
        return ssm_lib.make_mamba_cache(cfg, rows, dtype, device=device)
    kw = dict(pool=pool, device=device) if pool is not None else dict(
        batch=batch, max_len=max_len, device=device)
    if cfg.attention == "mla":
        return attn_lib.make_mla_cache(cfg, dtype, **kw)
    return attn_lib.make_cache(cfg, dtype, **kw)


def apply_layer(cfg, layer: Layer, x, *, positions, cache, paged,
                write_idx, rope, mode="decode", cache_pos=0, enc_out=None,
                causal=True, seq=False):
    """Pre-norm residual block: attention or Mamba then an MLP or MoE,
    or RWKV time mix then channel mix.  Returns (x, aux), aux being the
    MoE load-balance loss or None.  ``paged`` None is the slab path:
    ``mode`` and the scalar ``cache_pos`` say where the new keys go (a
    recurrent mixer takes its one-step update only in a one-token
    decode call), and ``mode="train"`` (cache None) is the training
    forward.  ``causal`` False: an encoder layer.  A layer with a
    ``cross``-attention runs it after the mixer, over ``enc_out`` (train
    and prefill) or its cross cache (decode).  ``seq``: x is this rank's
    block of a sequence cut over ``"data"`` (``ctx.seq_cut``)."""
    with shctx.seq_cut(seq):
        return _apply_layer(cfg, layer, x, positions=positions, cache=cache,
                            paged=paged, write_idx=write_idx, rope=rope,
                            mode=mode, cache_pos=cache_pos, enc_out=enc_out,
                            causal=causal)


def _apply_layer(cfg, layer, x, *, positions, cache, paged, write_idx, rope,
                 mode, cache_pos, enc_out, causal):
    # a mesh step's activation mesh or a serve topology (module
    # docstring): the weights read through ``use`` are gathered, the
    # tensor-parallel forms selected; without one ``use`` is the identity
    comm = shctx.layer_comm(mode)
    # a placed slab layer (an encoder-decoder's: its self and cross parts)
    parts = ({"": cache} if isinstance(cache, shctx.Placed) else cache
             if isinstance(cache, dict)
             and isinstance(cache.get("self"), shctx.Placed) else None)
    if comm is not None and paged is None and parts is not None:
        full = {k: shctx.gather_placed(c, comm) for k, c in parts.items()}
        out = _apply_layer(cfg, layer, x, positions=positions,
                           cache=full.get("", full), paged=paged,
                           write_idx=write_idx, rope=rope, mode=mode,
                           cache_pos=cache_pos, enc_out=enc_out,
                           causal=causal)
        for k, c in parts.items():
            shctx.scatter_placed(c, full[k], comm)
        return out
    gather = (lambda p: p) if comm is None else (           # noqa: E731
        lambda p: {k: use(v, comm) for k, v in p.items()})
    norm = lambda w, t: rmsnorm(use(w, comm), t, cfg.norm_eps)  # noqa: E731
    cross_cache = None
    if isinstance(cache, dict) and "cross" in cache:
        cache, cross_cache = cache["self"], cache["cross"]
    # the sequence split: a recurrent layer scans the gathered sequence
    # whole and keeps this rank's block
    cut = comm is not None and shctx.is_seq_cut()
    whole = (lambda t: gather_seq(t, comm, 1)) if cut else (  # noqa: E731
        lambda t: t)
    own = (lambda t: own_block(t, comm, "data", 1)) if cut else (  # noqa
        lambda t: t)
    if layer.kind == "rwkv6":
        mixer = gather(layer.mixer)
        x = whole(x)
        x = x + ssm_lib.apply_rwkv6_time_mix(cfg, mixer, norm(layer.norm1, x),
                                             mode=mode, cache=cache)
        return own(x + ssm_lib.apply_rwkv6_channel_mix(
            cfg, mixer, norm(layer.norm2, x), cache=cache)), None
    h = norm(layer.norm1, x)
    if layer.kind == "mamba":
        x = x + own(ssm_lib.apply_mamba(cfg, gather(layer.mixer), whole(h),
                                        mode=mode, cache=cache))
    elif cfg.attention == "mla":
        x = x + attn_lib.apply_mla(cfg, gather(layer.mixer), h,
                                   positions=positions, cache=cache,
                                   paged=paged, write_idx=write_idx,
                                   rope=rope, mode=mode, cache_pos=cache_pos,
                                   comm=comm)
    elif comm is not None:
        x = x + attn_lib.apply_attention_mesh(
            cfg, layer.mixer, h, comm, rope=rope, causal=causal,
            positions=positions, cache=cache, paged=paged,
            write_idx=write_idx, mode=mode, cache_pos=cache_pos)
    else:
        x = x + attn_lib.apply_attention(cfg, layer.mixer, h,
                                         positions=positions, cache=cache,
                                         paged=paged, write_idx=write_idx,
                                         rope=rope, mode=mode,
                                         cache_pos=cache_pos, causal=causal)
    if layer.cross is not None:
        x = x + attn_lib.apply_cross_attention(
            cfg, gather(layer.cross), norm(layer.norm_cross, x),
            enc_out=enc_out, cache=cross_cache)
    h = norm(layer.norm2, x)
    if layer.ffn_kind == "moe":
        h, aux = moe_lib.apply_moe(cfg, layer.ffn, h)
        return x + h, aux
    if comm is not None:
        return x + apply_mlp_mesh(layer.ffn, h, comm,
                                  gated=cfg.mlp_gated), None
    return x + apply_mlp(layer.ffn, h, gated=cfg.mlp_gated), None


def has_attention(cfg) -> bool:
    return any(mixer == "attn" for mixer, _ in cfg.layer_pattern())


def apply_stack(cfg, layers, x, *, positions, cache, paged, rope_freqs,
                mode="decode", cache_pos=0, remat=False, enc_out=None,
                causal=True, seq=False):
    """The layers in order; returns (x, the summed MoE aux loss or
    None).  What every attention layer derives alike from the positions
    -- pool write rows (paged) and RoPE angles -- is computed once, and
    only when the stack has an attention layer.  ``paged`` None is the
    slab path, and ``mode="train"`` (cache None) the training forward:
    positions (1, S), shared by every slot.  ``remat`` runs each layer
    under ``torch.utils.checkpoint`` (per-layer rematerialisation, as
    the reference's ``jax.checkpoint`` of one layer): its activations
    are recomputed in the backward instead of kept.  ``enc_out`` feeds
    every cross-attention; ``causal`` False runs an encoder stack;
    ``seq``: x is this rank's block of a sequence cut over ``"data"``
    (bound into each layer's call, so a recompute keeps it)."""
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
                               rope=rope, mode=mode, cache_pos=cache_pos,
                               enc_out=enc_out, causal=causal, seq=seq)
        x, a = (checkpoint(fn, x, use_reentrant=False) if remat else fn(x))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux
