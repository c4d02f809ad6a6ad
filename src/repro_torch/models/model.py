"""Top-level decoder: init, serving caches, forward, logits.

Port of ``repro.models.model`` for decoder-only stacks of GQA or MLA
attention and Mamba layers (each with an MLP or MoE ffn) and RWKV-6
blocks, in the modes the serving paths use: the continuous engine's
paged decode mode (decode steps and chunked-prefill chunks), and the
lockstep engine's slab ``prefill`` and ``decode`` (GQA stacks with an
MLP only, ``check_slab_ported``); and in the training mode ``"train"``
(GQA stacks with an MLP, ``check_train_ported``), on a ``Model`` of
trainable fp32 masters.  ``apply_model`` returns ``{"logits",
"hidden", "aux"}``; the caches and the per-slot recurrent states are
updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_embed, apply_unembed, rmsnorm,
                                       rope_freqs, truncated_normal)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Model(nn.Module):
    """Decoder weights on one device.

    tree: {"embed": {"table"}, "layers": iterable of layer trees,
    "final_norm": {"scale"}, "unembed": {"table"} (untied only)} in
    fp32 masters or already in the dtype each weight keeps; each weight
    is cast once to the compute dtype here (a no-op for one already
    cast).  The layers are built one at a time, so an iterable that
    draws each tree on demand holds one layer's weights at a time.  The
    unembedding table is kept in fp32 for the fp32 logits (the same
    tensor as the embedding when it is tied and the compute dtype is
    fp32; an untied embedding may arrive in the compute dtype).

    ``train=True`` builds a model for training instead: every weight a
    trainable fp32 master (``requires_grad``), one per reference leaf,
    cast to the compute dtype at each use.  A tied table is ONE master,
    registered as both ``embed`` and ``unembed_f32`` (so
    ``named_parameters`` lists it once): the embedding reads it cast to
    the compute dtype, the unembedding in fp32, and its gradient sums
    both uses.
    """

    def __init__(self, cfg, tree, *, device, train=False):
        super().__init__()
        check_ported(cfg)
        if train:
            check_train_ported(cfg)
        dt = compute_dtype(cfg)
        table = tree["embed"]["table"].to(device=device)
        out = table if cfg.tie_embeddings else tree["unembed"]["table"]
        if train:
            self.embed = tfm._master(table)
            self.unembed_f32 = (self.embed if cfg.tie_embeddings
                                else tfm._master(out.to(device)))
        else:
            self.embed = tfm._frozen(table.to(dt))
            self.unembed_f32 = tfm._frozen(out.to(device=device,
                                                  dtype=torch.float32))
        del table, out
        # no name (and no zip/enumerate tuple) may hold a layer's tree
        # while the next one is drawn
        trees = iter(tree["layers"])
        self.layers = nn.ModuleList()
        for spec in cfg.layer_pattern():
            self.layers.append(tfm.Layer(_to_device(next(trees), device), dt,
                                         spec, train=train))
        self.final_norm = (tfm._master if train else tfm._frozen)(
            tree["final_norm"]["scale"].to(device=device, dtype=torch.float32))
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(rope_dim(cfg), cfg.rope_theta)).to(device)
            if tfm.has_attention(cfg) else None)


def rope_dim(cfg) -> int:
    """The width RoPE rotates: the head width, or MLA's decoupled rope
    part (``qk_rope_head_dim``).  ``rope_freqs(64)`` is not a prefix of
    ``rope_freqs(128)``, so MLA needs its own frequencies."""
    return cfg.mla.qk_rope_head_dim if cfg.attention == "mla" \
        else cfg.head_dim


def check_ported(cfg):
    """Raise, naming the part, unless every layer of ``cfg`` is one the
    port has: a GQA or MLA attention or Mamba mixer with an MLP or MoE
    ffn, or an RWKV-6 block."""
    missing = []
    kinds = {mixer for mixer, _ in cfg.layer_pattern()}
    missing += sorted(kinds - {"attn", "mamba", "rwkv6"})
    if cfg.is_encoder_decoder:
        missing.append("encoder-decoder")
    if cfg.frontend != "none":
        missing.append(f"{cfg.frontend} frontend")
    if missing:
        raise ValueError(f"{cfg.name}: {', '.join(missing)} not ported; the "
                         "port serves GQA or MLA attention and Mamba layers "
                         "(MLP or MoE) and RWKV-6 stacks")


def _not_gqa_mlp(cfg) -> list:
    """The parts of ``cfg`` other than GQA attention layers with an MLP,
    by name (the whole-sequence branches the port has only for those)."""
    pattern = cfg.layer_pattern()
    missing = []
    if cfg.attention == "mla":
        missing.append("MLA attention")
    names = {"mamba": "Mamba", "rwkv6": "RWKV-6"}
    missing += [f"{names.get(k, k)} layers"
                for k in sorted({m for m, _ in pattern} - {"attn"})]
    if any(f == "moe" for _, f in pattern):
        missing.append("MoE ffn")
    return missing


def check_slab_ported(cfg):
    """Raise, naming the part, unless the slab (lockstep) path of
    ``cfg`` is ported: GQA attention layers with an MLP."""
    missing = _not_gqa_mlp(cfg)
    if missing:
        raise ValueError(f"{cfg.name}: the slab path of {', '.join(missing)} "
                         "is not ported; the lockstep slab engine serves GQA "
                         "attention with an MLP (use engine='continuous')")


def check_train_ported(cfg):
    """Raise, naming the part, unless training ``cfg`` is ported: GQA
    attention layers with an MLP and no multi-token-prediction head.
    MLA, Mamba, RWKV-6 and MoE wait for their whole-sequence train
    branches (ROADMAP A.5), MTP for its head (A.8)."""
    missing = _not_gqa_mlp(cfg)
    if cfg.mtp_depth > 0:
        missing.append("the MTP head")
    if missing:
        raise ValueError(f"{cfg.name}: training {', '.join(missing)} is not "
                         "ported; the port trains GQA attention with an MLP")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_model(cfg, *, seed=0, device="cuda", train=False) -> Model:
    """Random weights from a seed: truncated normal, std 1/sqrt(d_in)
    for projections and 0.02 for the embedding, drawn in fp32 with an
    explicit ``torch.Generator`` on ``device``, in the order embedding,
    unembedding, layers.  Each weight is cast to the dtype it keeps as
    soon as it is drawn (the untied embedding too), so the peak is the
    cast model plus the one fp32 tensor being drawn: at DeepSeek-V3's
    4-layer cut, one (256, 7168, 2048) expert tensor of 15 GB, where
    casting layer by layer held a whole MoE layer's 45 GB of masters.
    Layers are drawn one at a time as ``Model`` builds them (a dense
    prefix, e.g. DeepSeek's, takes ``moe.dense_d_ff``).  ``train``
    keeps the fp32 draws as trainable masters (``Model``); their values
    cast to the compute dtype are the serving model's weights."""
    dev = resolve_device(device)
    dt = torch.float32 if train else compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_prefix = len(cfg.block_structure()[0])
    dense_ff = cfg.moe.dense_d_ff if cfg.moe is not None else 0
    layers = (tfm.init_layer(cfg, spec, generator=gen, device=dev,
                             dense_ff=dense_ff if i < n_prefix else 0,
                             dtype=dt)
              for i, spec in enumerate(cfg.layer_pattern()))
    # a tied table is also the fp32 unembedding: it stays fp32
    tree = {"embed": {"table": truncated_normal(
        (cfg.vocab_size, cfg.d_model), 0.02, generator=gen, device=dev,
        dtype=torch.float32 if cfg.tie_embeddings else dt)},
        "layers": layers,
        "final_norm": {"scale": torch.ones((cfg.d_model,), device=dev)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": truncated_normal(
            (cfg.vocab_size, cfg.d_model), 0.02, generator=gen, device=dev)}
    return Model(cfg, tree, device=dev, train=train)


def init_cache(cfg, dtype, *, pool=None, slots=None, batch=None,
               max_len=None, device="cuda"):
    """The serving cache, one entry per layer.  With pool =
    (num_pages, page_size), the continuous engine's: an attention
    layer's {"k", "v"} pool, each ``(num_pages * page_size, hk, hd)``
    (an MLA layer's {"ckv", "krope"} latent pool, ``(num_pages *
    page_size, kv_lora | rope)``); a Mamba layer's {"ssm", "conv"} or an
    RWKV layer's {"state", "shift_tm", "shift_cm"} with ``slots`` rows.
    Without a pool, the lockstep engine's slab: {"k", "v"} of (batch,
    max_len, hk, hd) per layer (GQA stacks only)."""
    dev = resolve_device(device)
    kinds = [kind for kind, _ in cfg.layer_pattern()]
    if pool is None:
        check_slab_ported(cfg)
        if batch is None or max_len is None:
            raise ValueError("the slab cache needs batch= and max_len=")
        return [tfm.init_layer_cache(cfg, kind, dtype, batch=batch,
                                     max_len=max_len, device=dev)
                for kind in kinds]
    if slots is None and any(kind != "attn" for kind in kinds):
        raise ValueError(f"{cfg.name}: recurrent layers need slots=")
    return [tfm.init_layer_cache(cfg, kind, dtype, pool=pool, slots=slots,
                                 device=dev) for kind in kinds]


def _logits(cfg, model: Model, x):
    return apply_unembed(model.unembed_f32,
                         rmsnorm(model.final_norm, x, cfg.norm_eps))


def apply_model(cfg, model: Model, tokens, *, cache=None, cache_pos=None,
                paged=None, mode="decode", last_only=False, logits=True,
                remat=False):
    """Forward over a serving cache, or the training forward.

    Train (``mode="train"``, no cache): tokens (B, S) at positions
    0..S-1, causal attention through ``chunked_attention`` (the flash
    kernel on the card); ``remat`` checkpoints each layer
    (``tfm.apply_stack``).  GQA stacks with an MLP only
    (``check_train_ported``).

    tokens: (B, S) int.  Paged (``paged``: a PagedView): cache_pos (B,)
    int32, the per-slot position of the first token; cache: per-layer
    entries whose recurrent rows match the B slots of this call
    (``PagedKVCache.slot_cache`` for a one-slot prefill); S is 1 for a
    decode step or a prefill chunk's length.  Slab (``paged`` None, GQA
    stacks): cache from ``init_cache(..., batch=, max_len=)`` (or rows
    of it); ``mode="prefill"`` with cache_pos 0 fills positions 0..S-1,
    ``mode="decode"`` with an int cache_pos appends at cache_pos for
    every slot.  ``last_only`` slices the last position before the
    unembedding.  Returns {"logits": (B, S', V) fp32, "hidden": (B, S',
    d), "aux": the MoE load-balance loss (0 without MoE)} with S' = 1
    under ``last_only``; a call whose logits nobody reads passes
    ``logits=False`` and skips the unembedding."""
    S = tokens.shape[1]
    if mode == "train":
        check_train_ported(cfg)
        if cache is not None or paged is not None:
            raise ValueError("train mode takes no cache")
    elif cache is None:
        raise ValueError(f"mode {mode!r} reads a serving cache; pass cache=")
    elif paged is not None:
        if mode != "decode" or not isinstance(cache_pos, torch.Tensor) \
                or cache_pos.dim() != 1:
            raise ValueError("the paged cache is decode-mode with per-slot "
                             "cache_pos (B,)")
    else:
        check_slab_ported(cfg)
        if mode not in ("prefill", "decode"):
            raise ValueError(f"slab mode {mode!r}: 'prefill' or 'decode'")
        cache_pos = int(cache_pos)
        if mode == "prefill" and cache_pos != 0:
            raise ValueError("a slab prefill fills the cache from 0")
    x = apply_embed(model.embed, tokens, compute_dtype(cfg))
    positions = None
    if tfm.has_attention(cfg):
        if mode == "train":
            positions = torch.arange(S, device=tokens.device)[None]
        elif paged is not None:
            positions = (cache_pos[:, None]
                         + torch.arange(S, device=tokens.device,
                                        dtype=cache_pos.dtype)[None])
        else:
            positions = torch.arange(cache_pos, cache_pos + S,
                                     device=tokens.device)[None]
    x, aux = tfm.apply_stack(cfg, model.layers, x, positions=positions,
                             cache=cache, paged=paged,
                             rope_freqs=model.rope_freqs, mode=mode,
                             cache_pos=cache_pos, remat=remat)
    if last_only:
        x = x[:, -1:]
    out = {"hidden": x, "aux": 0.0 if aux is None else aux}
    if logits:
        out["logits"] = _logits(cfg, model, x)
    return out
