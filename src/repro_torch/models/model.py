"""Top-level models: init, serving caches, forward, logits.

Port of ``repro.models.model``: decoder-only stacks of GQA or MLA
attention and Mamba layers (each with an MLP or MoE ffn) and RWKV-6
blocks; the VLM, whose stubbed vision frontend's patch embeddings pass
through a 2-layer projector and are prepended to the text; and the
encoder-decoder, whose stubbed audio frontend's frame embeddings run
through a bidirectional encoder that feeds every decoder layer's
cross-attention.  In the modes the serving paths use: the continuous
engine's paged decode mode (decode steps and chunked-prefill chunks;
decoder-only text stacks), and the slab ``prefill`` and ``decode``;
and in the training mode ``"train"``, on a ``Model`` of trainable
masters (fp32, or bf16).  ``apply_model`` returns ``{"logits",
"hidden", "aux"}`` (and, in training with a multi-token-prediction head,
``"mtp_logits"``); the caches and the per-slot recurrent states are
updated in place.  ``mtp_draft`` drafts tokens with the MTP head for
speculative decoding.  The paper's Table-1 networks (``PaperNet``,
``init_paper_net``, ``apply_paper_net``) close the module, as in the
reference.

A training ``Model`` whose masters are DTensors (``train.step``'s mesh
state) runs ``apply_model``'s train mode under the activation mesh the
mesh step registers: each rank's batch rows, the layers' mesh forms
(``transformer``), the embedding and the unembedding vocab-parallel
over ``"model"`` -- its logits are then this rank's vocabulary block,
``out["vocab_start"]`` its first row (``train.loss`` reduces the
log-sum-exp over the blocks) -- and the vision projector, the final
norms and the MTP head's own weights gathered at use.  A serving
``Model`` of DTensor weights (placed by the serve-mode rules) runs the
serving modes under a serve topology (``sharding.ctx.serve_topology``)
the same way, and its logits are gathered whole over ``"model"`` for
the argmax and the sampling; ``mtp_draft`` gathers the head's weights
at use and runs it replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_embed, apply_embed_mesh,
                                       apply_mlp, apply_unembed,
                                       apply_unembed_mesh, dense_init,
                                       rmsnorm, rope_angles, rope_freqs,
                                       truncated_normal, vocab_start)
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.comm import all_gather, use

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VISION_EMBED_DIM = 1024      # CLIP ViT-L/14-336 output width (stubbed)
# the keyword tensors of ``apply_model``: the reference's batch keys
FRONTEND_KEYS = ("vision_embeds", "src_embeds")


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def encoder_cfg(cfg):
    """An encoder-decoder's encoder: ``encoder_layers`` attention + MLP
    layers (no MoE, no SSM, no cross-attention)."""
    return cfg.with_overrides(num_layers=cfg.encoder_layers,
                              is_encoder_decoder=False, attn_layer_period=1,
                              ssm_kind="none", moe=None)


def batch_inputs(batch):
    """(tokens, frontends) of a reference-form batch dict: the decoder's
    tokens (``"tgt_tokens"`` of an encoder-decoder, else ``"tokens"``)
    and the frontend tensors it holds, as ``apply_model``'s keywords."""
    tokens = batch["tgt_tokens"] if "tgt_tokens" in batch else batch["tokens"]
    return tokens, {k: batch[k] for k in FRONTEND_KEYS if k in batch}


class Model(nn.Module):
    """A model's weights on one device.

    tree: {"embed": {"table"}, "layers": iterable of layer trees,
    "final_norm": {"scale"}, "unembed": {"table"} (untied only),
    "vision_proj": {"w1" (1024, d), "b1", "w2" (d, d), "b2"} (a vision
    frontend only), "encoder": iterable of layer trees and "enc_norm":
    {"scale"} (an encoder-decoder only), "mtp":
    the MTP head's tree, or a function that draws it (``mtp_depth > 0``
    only: {"norm_h", "norm_e": {"scale"}, "proj" (2 d, d), "block": an
    ("attn", "mlp") layer tree})} in fp32 masters or already in the
    dtype each weight keeps; each weight
    is cast once to the compute dtype here (a no-op for one already
    cast).  The layers are built one at a time, so an iterable that
    draws each tree on demand holds one layer's weights at a time.  The
    unembedding table is kept in fp32 for the fp32 logits (the same
    tensor as the embedding when it is tied and the compute dtype is
    fp32; an untied embedding may arrive in the compute dtype).

    ``train=True`` builds a model for training instead: every weight a
    trainable master (``requires_grad``) of ``param_dtype`` (fp32, or
    bf16 as the reference's ``TrainConfig(param_dtype="bfloat16")``
    casts every leaf), one per reference leaf, cast to the compute
    dtype at each use.  A tied table is ONE master,
    registered as both ``embed`` and ``unembed_f32`` (so
    ``named_parameters`` lists it once): the embedding reads it cast to
    the compute dtype, the unembedding in fp32, and its gradient sums
    both uses.
    """

    def __init__(self, cfg, tree, *, device, train=False,
                 param_dtype=torch.float32):
        super().__init__()
        check_ported(cfg)
        if train:
            check_train_ported(cfg)
        self.cfg = cfg
        dt = compute_dtype(cfg)
        master = lambda t: tfm._master(t.to(device), param_dtype)
        table = tree["embed"]["table"].to(device=device)
        out = table if cfg.tie_embeddings else tree["unembed"]["table"]
        if train:
            self.embed = master(table)
            self.unembed_f32 = (self.embed if cfg.tie_embeddings
                                else master(out))
        else:
            self.embed = tfm._frozen(table.to(dt))
            self.unembed_f32 = tfm._frozen(out.to(device=device,
                                                  dtype=torch.float32))
        del table, out
        scale = master if train else (lambda t: tfm._frozen(
            t.to(device=device, dtype=torch.float32)))
        layers = lambda c, trees: _layers(c, trees, device, dt, train,
                                          param_dtype)
        self.vision_proj = self.encoder = self.enc_norm = None
        if cfg.frontend == "vision":
            self.vision_proj = nn.ParameterDict({
                k: master(v) if train else tfm._frozen(v.to(device, dt))
                for k, v in tree["vision_proj"].items()})
        if cfg.is_encoder_decoder:
            self.encoder = layers(encoder_cfg(cfg), tree["encoder"])
            self.enc_norm = scale(tree["enc_norm"]["scale"])
        self.layers = layers(cfg, tree["layers"])
        self.final_norm = scale(tree["final_norm"]["scale"])
        self.mtp = None
        if cfg.mtp_depth > 0:
            if "mtp" not in tree:
                raise ValueError(f"{cfg.name}: mtp_depth={cfg.mtp_depth} "
                                 "but the weights hold no MTP head")
            mtp = tree["mtp"]
            self.mtp = MTPHead(_to_device(mtp() if callable(mtp) else mtp,
                                          device), dt, train=train,
                               param_dtype=param_dtype)
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(rope_dim(cfg), cfg.rope_theta)).to(device)
            if tfm.has_attention(cfg) else None)


def _layers(cfg, trees, device, dt, train, param_dtype) -> nn.ModuleList:
    """``cfg``'s layers, built one at a time from the iterable ``trees``:
    no name (and no zip/enumerate tuple) may hold a layer's tree while
    the next one is drawn."""
    trees = iter(trees)
    layers = nn.ModuleList()
    for spec in cfg.layer_pattern():
        layers.append(tfm.Layer(_to_device(next(trees), device), dt, spec,
                                train=train, param_dtype=param_dtype))
    return layers


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token-prediction head (depth 1): the norms
    ``norm_h`` (of the trunk's hidden) and ``norm_e`` (of the next
    token's embedding), ``proj`` (2 d, d) back to the model width, and
    ``block``, an ("attn", "mlp") ``transformer.Layer`` whose MLP is
    ``moe.dense_d_ff`` wide on an MoE trunk.  It shares the trunk's
    embedding, final norm and unembedding.  Serving: frozen weights in
    the compute dtype (norm scales fp32); training: masters of
    ``param_dtype``."""

    def __init__(self, tree, dtype, *, train=False,
                 param_dtype=torch.float32):
        super().__init__()
        master = lambda t: tfm._master(t, param_dtype)
        scale = master if train else (lambda t: tfm._frozen(t.float()))
        self.norm_h = scale(tree["norm_h"]["scale"])
        self.norm_e = scale(tree["norm_e"]["scale"])
        self.proj = (master(tree["proj"]) if train
                     else tfm._frozen(tree["proj"].to(dtype)))
        self.block = tfm.Layer(tree["block"], dtype, ("attn", "mlp"),
                               train=train, param_dtype=param_dtype)


def init_mtp(cfg, *, generator, device="cpu", dtype):
    """The MTP head's weights in the reference's layout (``norm_h``,
    ``norm_e``, ``proj`` (2 d, d) and an ("attn", "mlp") ``block`` of
    width ``moe.dense_d_ff`` on an MoE trunk, else ``d_ff``), drawn in
    fp32 and cast to ``dtype`` as drawn."""
    d = cfg.d_model
    dense_ff = cfg.moe.dense_d_ff if cfg.moe is not None else cfg.d_ff
    ones = lambda: {"scale": torch.ones((d,), device=device)}
    return {"norm_h": ones(), "norm_e": ones(),
            "proj": dense_init(2 * d, d, generator=generator, device=device,
                               dtype=dtype),
            "block": tfm.init_layer(cfg, ("attn", "mlp"), generator=generator,
                                    device=device, dense_ff=dense_ff,
                                    dtype=dtype)}


def rope_dim(cfg) -> int:
    """The width RoPE rotates: the head width, or MLA's decoupled rope
    part (``qk_rope_head_dim``).  ``rope_freqs(64)`` is not a prefix of
    ``rope_freqs(128)``, so MLA needs its own frequencies."""
    return cfg.mla.qk_rope_head_dim if cfg.attention == "mla" \
        else cfg.head_dim


def check_ported(cfg):
    """Raise, naming the part, unless ``cfg`` is one the port has: every
    layer a GQA or MLA attention or Mamba mixer with an MLP or MoE ffn,
    or an RWKV-6 block; a frontend of none, the vision stub or the audio
    stub (an encoder-decoder's)."""
    missing = sorted({mixer for mixer, _ in cfg.layer_pattern()}
                     - {"attn", "mamba", "rwkv6"})
    if cfg.frontend not in ("none", "vision", "audio"):
        missing.append(f"{cfg.frontend} frontend")
    if cfg.frontend == "audio" and not cfg.is_encoder_decoder:
        missing.append("audio frontend without an encoder")
    if missing:
        raise ValueError(
            f"{cfg.name}: {', '.join(missing)} not ported; the port has GQA "
            "and MLA attention and Mamba layers (with an MLP or MoE ffn), "
            "RWKV-6 blocks, the encoder-decoder stack with the audio "
            "frontend stub, and the vision frontend stub")


def check_slab_ported(cfg):
    """Raise, naming the part, unless the slab (lockstep) path of
    ``cfg`` is ported: it is for everything ``check_ported`` accepts."""
    check_ported(cfg)


def check_train_ported(cfg):
    """Raise, naming the part, unless training ``cfg`` is ported: it is
    for everything ``check_ported`` accepts, with or without a
    multi-token-prediction head."""
    check_ported(cfg)


def check_token_serving(cfg):
    """Raise unless ``cfg`` is a decoder-only text stack: the serving
    engines (continuous and lockstep), the paged pool and the serve
    launcher take token prompts only, as the reference's do.  A VLM or an
    encoder-decoder serves through ``apply_model``'s slab prefill and
    decode."""
    parts = (["encoder-decoder"] if cfg.is_encoder_decoder else []) + (
        [f"{cfg.frontend} frontend"] if cfg.frontend != "none" else [])
    if parts:
        raise ValueError(f"{cfg.name}: {', '.join(parts)}: the serving "
                         "engines and the paged pool take token prompts to "
                         "decoder-only text architectures; a VLM or an "
                         "encoder-decoder serves through apply_model's slab "
                         "prefill and decode")


def check_paged_ported(cfg):
    """Raise unless ``cfg`` runs on the paged pool (the continuous
    scheduler): a ported decoder-only text stack."""
    check_ported(cfg)
    check_token_serving(cfg)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_model(cfg, *, seed=0, device="cuda", train=False,
               param_dtype=torch.float32, place=None) -> Model:
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
    keeps the draws as trainable masters (``Model``) of ``param_dtype``
    -- fp32, whose values cast to the compute dtype are the serving
    model's weights, or bf16, each weight cast as it is drawn (so a
    bf16-master model never holds its fp32 draws beside it).  An MTP
    head (``mtp_depth > 0``) is drawn last, after every layer, so the
    other weights of a seed are those of the same config without it.
    A vision projector is drawn after the unembedding (biases zero), an
    encoder's layers after that and before the decoder's.

    ``place(path, draw, device, generator)``, when given, draws each
    unit of weights -- a top-level table or norm, the projector, a
    layer, the MTP head -- as ``draw(device, generator)`` does and
    returns its tree, each leaf in the form the model keeps
    (``bridge.mesh_placer``: this rank's block); ``path`` is the unit's
    reference path (``embed``, ``decoder/blocks/layer0``, ...).  The
    meta device draws nothing: shapes only."""
    dev = resolve_device(device)
    dt = param_dtype if train else compute_dtype(cfg)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    unit = lambda path, draw: (draw(dev, gen) if place is None  # noqa: E731
                               else place(path, draw, dev, gen))
    n_prefix = len(cfg.block_structure()[0])
    dense_ff = cfg.moe.dense_d_ff if cfg.moe is not None else 0
    d = cfg.d_model
    ones = lambda dv, g: {"scale": torch.ones((d,), device=dv)}  # noqa: E731

    def table(dtype):
        return lambda dv, g: {"table": truncated_normal(
            (cfg.vocab_size, d), 0.02, generator=g, device=dv, dtype=dtype)}

    def layer(c, spec, **extra):
        return lambda dv, g: tfm.init_layer(c, spec, generator=g, device=dv,
                                            dtype=dt, **extra)

    layers = (unit(layer_path("decoder", cfg, i), layer(
        cfg, spec, dense_ff=dense_ff if i < n_prefix else 0,
        cross=cfg.is_encoder_decoder))
        for i, spec in enumerate(cfg.layer_pattern()))
    # a tied table is also the fp32 unembedding: it stays fp32
    tree = {"embed": unit("embed", table(
        torch.float32 if cfg.tie_embeddings else dt)),
        "layers": layers, "final_norm": unit("final_norm", ones)}
    if not cfg.tie_embeddings:
        tree["unembed"] = unit("unembed", table(torch.float32))
    if cfg.frontend == "vision":
        def proj(dv, g):
            kw = dict(generator=g, device=dv, dtype=dt)
            zeros = lambda: torch.zeros((d,), device=dv, dtype=dt)  # noqa
            return {"w1": dense_init(VISION_EMBED_DIM, d, **kw),
                    "b1": zeros(), "w2": dense_init(d, d, **kw),
                    "b2": zeros()}
        tree["vision_proj"] = unit("vision_proj", proj)
    if cfg.is_encoder_decoder:
        ecfg = encoder_cfg(cfg)
        tree["encoder"] = (unit(layer_path("encoder", ecfg, i),
                                layer(ecfg, spec))
                           for i, spec in enumerate(ecfg.layer_pattern()))
        tree["enc_norm"] = unit("enc_norm", ones)
    if cfg.mtp_depth > 0:
        # drawn by Model after the layers
        tree["mtp"] = lambda: unit("mtp", lambda dv, g: init_mtp(
            cfg, generator=g, device=dv, dtype=dt))
    return Model(cfg, tree, device=dev, train=train, param_dtype=param_dtype)


def layer_path(top, cfg, i) -> str:
    """The reference path of layer ``i`` of the ``top`` stack
    ("decoder" or "encoder") of ``cfg``: an unrolled prefix layer, or
    the super-block layer repetition ``i`` stacks on."""
    prefix, pattern, _ = cfg.block_structure()
    if i < len(prefix):
        return f"{top}/prefix/layer{i}"
    return f"{top}/blocks/layer{(i - len(prefix)) % len(pattern)}"


def init_cache(cfg, dtype, *, pool=None, slots=None, batch=None,
               max_len=None, cross_len=0, device="cuda"):
    """The serving cache, one entry per layer.  With pool =
    (num_pages, page_size), the continuous engine's: an attention
    layer's {"k", "v"} pool, each ``(num_pages * page_size, hk, hd)``
    (an MLA layer's {"ckv", "krope"} latent pool, ``(num_pages *
    page_size, kv_lora | rope)``); a Mamba layer's {"ssm", "conv"} or an
    RWKV layer's {"state", "shift_tm", "shift_cm"} with ``slots`` rows.
    Without a pool, the lockstep engine's slab: {"k", "v"} of (batch,
    max_len, hk, hd) per attention layer ({"ckv", "krope"} of (batch,
    max_len, ...) for MLA), the recurrent state with ``batch`` rows per
    Mamba or RWKV layer; an encoder-decoder's layer holds {"self": that,
    "cross": {"k", "v"} of (batch, cross_len, hk, hd)}, which a prefill
    fills with the encoder's K/V and every decode step reads whole.
    The pool is for decoder-only text stacks (``check_paged_ported``)."""
    dev = resolve_device(device)
    kinds = [kind for kind, _ in cfg.layer_pattern()]
    if pool is None:
        check_slab_ported(cfg)
        if batch is None or max_len is None:
            raise ValueError("the slab cache needs batch= and max_len=")
        if cfg.is_encoder_decoder and cross_len < 1:
            raise ValueError(f"{cfg.name}: the cross cache needs cross_len=")
        return [tfm.init_layer_cache(cfg, kind, dtype, batch=batch,
                                     max_len=max_len, device=dev,
                                     cross=cfg.is_encoder_decoder,
                                     cross_len=cross_len)
                for kind in kinds]
    check_paged_ported(cfg)
    if slots is None and any(kind != "attn" for kind in kinds):
        raise ValueError(f"{cfg.name}: recurrent layers need slots=")
    return [tfm.init_layer_cache(cfg, kind, dtype, pool=pool, slots=slots,
                                 device=dev) for kind in kinds]


def _embed(model: Model, tokens, dt, comm=None):
    if comm is None:
        return apply_embed(model.embed, tokens, dt)
    return apply_embed_mesh(model.embed, tokens, dt, comm)


def _logits(cfg, model: Model, x, comm=None):
    """fp32 logits of the final norm of ``x``: on a mesh (``comm``) this
    rank's vocabulary block (``layers.vocab_start``)."""
    h = rmsnorm(use(model.final_norm, comm), x, cfg.norm_eps)
    if comm is None:
        return apply_unembed(model.unembed_f32, h)
    return apply_unembed_mesh(model.unembed_f32, h, comm)


def _whole_logits(cfg, model: Model, x, comm=None):
    """``_logits`` over the whole vocabulary: a vocab-parallel block is
    gathered over ``"model"`` (the argmax and the sampling read every
    row)."""
    lg = _logits(cfg, model, x, comm)
    if comm is not None and vocab_start(model.unembed_f32, comm) is not None:
        lg = all_gather(lg, comm, "model", lg.dim() - 1)
    return lg


def _vision_proj(p, v, dt, comm=None):
    """The projector ``p``: gelu (tanh form, as ``jax.nn.gelu``) between
    two affine maps, 1024 -> d -> d."""
    w = {k: use(t, comm).to(dt) for k, t in p.items()}
    h = v.to(dt) @ w["w1"] + w["b1"]
    return F.gelu(h, approximate="tanh") @ w["w2"] + w["b2"]


def apply_model(cfg, model: Model, tokens, *, cache=None, cache_pos=None,
                paged=None, mode="decode", last_only=False, logits=True,
                remat=False, vision_embeds=None, src_embeds=None):
    """Forward over a serving cache, or the training forward.

    The frontends are keyword tensors, the reference's batch keys
    (``batch_inputs`` splits a batch dict so): ``vision_embeds`` (B,
    N_img, 1024) of a vision stack are projected (``_vision_proj``) and
    prepended to the tokens' embeddings, and positions run over the
    whole N_img + S sequence (the logits too); an encoder-decoder's
    ``src_embeds`` (B, S_src, d) run through the encoder (train mode,
    bidirectional, RoPE at 0..S_src-1, then ``enc_norm``), whose output
    feeds every decoder layer's cross-attention, and ``tokens`` are the
    target tokens.  A train or slab-prefill call of an encoder-decoder
    needs ``src_embeds`` (the prefill writes the encoder's K/V into the
    cross cache, ``init_cache(..., cross_len=)``); a slab decode step
    passes none and reads that cache.  Neither frontend runs on the
    paged pool.

    Train (``mode="train"``, no cache): tokens (B, S) at positions
    0..S-1, causal attention through ``chunked_attention`` (the flash
    kernel on the card) and the recurrent scans from a zero state (their
    kernels on the card); ``remat`` checkpoints each layer
    (``tfm.apply_stack``).  With an MTP head, also ``"mtp_logits"`` (B,
    S - 1, V): the hidden at position i with the embedding of token i+1
    through the head's block (train-mode attention over the S - 1
    positions, not rematted), predicting token i + 2.

    tokens: (B, S) int.  Paged (``paged``: a PagedView): cache_pos (B,)
    int32, the per-slot position of the first token; cache: per-layer
    entries whose recurrent rows match the B slots of this call
    (``PagedKVCache.slot_cache`` for a one-slot prefill); S is 1 for a
    decode step or a prefill chunk's length.  Slab (``paged`` None):
    cache from ``init_cache(..., batch=, max_len=)`` (or rows of it);
    ``mode="prefill"`` with cache_pos 0 fills positions 0..S-1 (and
    runs the recurrent layers from the state their rows hold),
    ``mode="decode"`` with an int cache_pos appends at cache_pos for
    every slot.  ``last_only`` slices the last position before the
    unembedding.  Returns {"logits": (B, S', V) fp32, "hidden": (B, S',
    d), "aux": the MoE load-balance loss (0 without MoE)} with S' = 1
    under ``last_only``; a call whose logits nobody reads passes
    ``logits=False`` and skips the unembedding."""
    if mode == "train":
        check_train_ported(cfg)
        if cache is not None or paged is not None:
            raise ValueError("train mode takes no cache")
    elif cache is None:
        raise ValueError(f"mode {mode!r} reads a serving cache; pass cache=")
    elif paged is not None:
        check_paged_ported(cfg)
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
    dt = compute_dtype(cfg)
    # a mesh step's activation mesh, or a serve topology (module docstring)
    comm = shctx.layer_comm(mode)
    enc_out = None
    if cfg.is_encoder_decoder and src_embeds is not None:
        enc_out = _encode(cfg, model, torch.as_tensor(
            src_embeds, device=tokens.device), remat, comm)
    elif cfg.is_encoder_decoder and mode != "decode":
        raise ValueError(f"{cfg.name}: a {mode} call of an encoder-decoder "
                         "needs src_embeds")
    x = _embed(model, tokens, dt, comm)
    if cfg.frontend == "vision" and vision_embeds is not None:
        vis = _vision_proj(model.vision_proj, torch.as_tensor(
            vision_embeds, device=tokens.device), dt, comm)
        x = torch.cat([vis, x], dim=1)
    S = x.shape[1]
    # the sequence split of a train step (``ctx.seq_split``): this rank's
    # block of the positions; the cotangent outside it is zero
    cut = comm is not None and mode == "train" and shctx.is_seq_split()
    start = 0
    if cut:
        start, S = shctx.seq_block(comm, S)
        x = x[:, start:start + S]
    positions = None
    if tfm.has_attention(cfg):
        if mode == "train":
            positions = torch.arange(start, start + S,
                                     device=tokens.device)[None]
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
                             cache_pos=cache_pos, remat=remat,
                             enc_out=enc_out, seq=cut)
    if last_only:
        x = x[:, -1:]
    out = {"hidden": x, "aux": 0.0 if aux is None else aux}
    if logits:
        if mode == "train":
            out["logits"] = _logits(cfg, model, x, comm)
            if comm is not None:
                out["vocab_start"] = vocab_start(model.unembed_f32, comm)
        else:
            out["logits"] = _whole_logits(cfg, model, x, comm)
    if mode == "train" and model.mtp is not None:
        out["mtp_logits"] = _mtp_train(cfg, model, x, tokens, comm,
                                       block=(start, S) if cut else None)
    return out


def _encode(cfg, model: Model, src, remat, comm=None):
    """The encoder over frame embeddings (B, S_src, d): bidirectional
    attention with RoPE at 0..S_src-1, then ``enc_norm``."""
    pos = torch.arange(src.shape[1], device=src.device)[None]
    enc, _ = tfm.apply_stack(encoder_cfg(cfg), model.encoder,
                             src.to(compute_dtype(cfg)), positions=pos,
                             cache=None, paged=None,
                             rope_freqs=model.rope_freqs, mode="train",
                             remat=remat, causal=False)
    return rmsnorm(use(model.enc_norm, comm), enc, cfg.norm_eps)


# --------------------------------------------------------------------------
# the multi-token-prediction head
# --------------------------------------------------------------------------

def _mtp_in(cfg, head: MTPHead, h, e, comm=None):
    """The head's input: norm_h(hidden) and norm_e(embedding),
    concatenated and projected back to d."""
    return torch.cat([rmsnorm(use(head.norm_h, comm), h, cfg.norm_eps),
                      rmsnorm(use(head.norm_e, comm), e, cfg.norm_eps)],
                     dim=-1) @ use(head.proj, comm).to(h.dtype)


def _mtp_train(cfg, model: Model, x, tokens, comm=None, block=None):
    """The train-mode head: the hidden at position i (pre-final-norm)
    with the embedding of token i + 1, through the block at positions
    0..S-2, read off the shared unembedding.  ``block`` = (start, s)
    under the sequence split: ``x`` is this rank's block of the hidden,
    and the head runs on the same positions, the last one (S - 1, whose
    label is IGNORE and whose key only it sees) fed a stand-in token."""
    dt = x.dtype
    if block is None:
        h, nxt = x[:, :-1], tokens[:, 1:]
        pos = torch.arange(h.shape[1], device=tokens.device)[None]
    else:
        start, s = block
        h = x
        nxt = torch.cat([tokens[:, 1:], tokens[:, :1]],
                        dim=1)[:, start:start + s]
        pos = torch.arange(start, start + s, device=tokens.device)[None]
    hm = _mtp_in(cfg, model.mtp, h, _embed(model, nxt, dt, comm), comm)
    hm, _ = tfm.apply_layer(cfg, model.mtp.block, hm, positions=pos,
                            cache=None, paged=None, write_idx=None,
                            rope=rope_angles(pos, model.rope_freqs),
                            mode="train", seq=block is not None)
    return _logits(cfg, model, hm, comm)


def _mtp_self_attention(cfg, p, x):
    """The MTP block's attention for a window-1 (self-only) query.

    Drafting feeds the block one position at a time, and the only key
    that position sees is itself: the softmax over one key is 1, so the
    output IS the value at the query's own position -- the q/k
    projections, qk-norm and RoPE cancel exactly.  So the draft head
    reads no pool and launches no attention kernel, for GQA and MLA.
    Draft quality moves only the acceptance rate."""
    dt = x.dtype
    if cfg.attention == "mla":
        m = cfg.mla
        dkv = x @ p["w_dkv"].to(dt)
        ckv = rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
        out = torch.einsum("bsr,rhv->bshv", ckv, p["w_uv"].to(dt))
    else:
        hp, head_mask = attn_lib._padded_heads(cfg)
        hk, hd = cfg.num_kv_heads, cfg.head_dim
        v = attn_lib._proj(x, p["wv"].to(dt))
        if "bv" in p:
            v = v + p["bv"].to(dt)
        B, S = v.shape[:2]
        out = v[:, :, :, None, :].expand(B, S, hk, hp // hk, hd).reshape(
            B, S, hp, hd)
        if head_mask is not None:
            out = out * torch.from_numpy(head_mask).to(out)[None, None, :,
                                                             None]
    B, S, h, v = out.shape
    return out.reshape(B, S, h * v) @ p["wo"].to(dt).reshape(h * v, -1)


def _mtp_block(cfg, layer, x, comm=None):
    """norm1 -> self-only attention -> residual -> norm2 -> MLP ->
    residual: the decode-time twin of the train-mode block; on a mesh
    (``comm``) its weights are gathered at use."""
    w = lambda p: {k: use(v, comm) for k, v in p.items()}   # noqa: E731
    h = rmsnorm(use(layer.norm1, comm), x, cfg.norm_eps)
    x = x + _mtp_self_attention(cfg, w(layer.mixer), h)
    h = rmsnorm(use(layer.norm2, comm), x, cfg.norm_eps)
    return x + apply_mlp(w(layer.ffn), h, gated=cfg.mlp_gated)


def mtp_draft(cfg, model: Model, hidden, tokens, k):
    """Greedy-draft ``k`` tokens from the trunk's last hidden state with
    the MTP head, chained: each step combines the current hidden with
    the embedding of the newest token, runs the block (window-1
    attention, ``_mtp_self_attention``), reads a greedy token off the
    shared unembedding, and feeds the block's output hidden and the new
    draft back in.  At depth 1 this is the train-mode head: hidden at
    position i plus token i + 1 predicts token i + 2.

    hidden: (B, 1, d), the trunk hidden at the last accepted position
    (``apply_model(...)["hidden"]``, pre-final-norm); tokens: (B, 1)
    int, the newest token.  Returns (drafts (B, k) int32, last hidden
    (B, 1, d)).  Everything stays on the device."""
    if model.mtp is None:
        raise ValueError("mtp_draft needs cfg.mtp_depth > 0 (no MTP head "
                         "in this architecture)")
    dt = compute_dtype(cfg)
    comm = shctx.layer_comm("decode")
    h, t = hidden.to(dt), tokens
    drafts = []
    for _ in range(k):
        hm = _mtp_in(cfg, model.mtp, h, _embed(model, t, dt, comm), comm)
        hm = _mtp_block(cfg, model.mtp.block, hm, comm)
        t = torch.argmax(_whole_logits(cfg, model, hm, comm),
                         dim=-1).to(torch.int32)
        h = hm
        drafts.append(t[:, 0])
    return torch.stack(drafts, dim=1), h


# ==========================================================================
# Paper Table-1 networks
# ==========================================================================

class _Affine(nn.Module):
    """One layer's weight ``w`` and bias ``b`` (the reference's leaves)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class PaperNet(nn.Module):
    """A Table-1 network's fp32 weights, named after the reference's
    leaves: a DNN's ``layers.{i}.w`` (d_in, d_out) and ``.b``; a CNN's
    ``conv.{i}.w`` (5, 5, c_in, c_out) HWIO and ``.b``, then
    ``fc.{i}.w`` / ``.b``.  ``tree`` is ``{"layers": [{"w", "b"}, ...]}``
    or ``{"conv": [...], "fc": [...]}`` of tensors."""

    def __init__(self, tree, *, device):
        super().__init__()
        for group, layers in tree.items():
            self.add_module(group, nn.ModuleList(
                _Affine(l["w"].to(device, torch.float32),
                        l["b"].to(device, torch.float32)) for l in layers))


def init_paper_net(net, *, seed=0, device="cuda") -> PaperNet:
    """Random weights from a seed, drawn in order from one
    ``torch.Generator`` on ``device``: truncated normal at +-3 sigma,
    sigma = 1/sqrt(d_in) for dense layers and sqrt(2 / (25 c_in)) for
    the 5x5 convs, zero biases (the reference's ``init_paper_net``; its
    JAX random stream is not reproduced, so the values differ)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def affine(w):
        return {"w": w, "b": torch.zeros(w.shape[-1], device=dev)}

    if net.kind == "dnn":
        sizes = net.layer_sizes
        return PaperNet({"layers": [
            affine(dense_init(din, dout, generator=gen, device=dev))
            for din, dout in zip(sizes[:-1], sizes[1:])]}, device=dev)
    cin = net.image_channels
    h, w = net.image_hw
    conv = []
    for cout in net.conv_channels:
        conv.append(affine(truncated_normal(
            (5, 5, cin, cout), (2.0 / (25 * cin)) ** 0.5, generator=gen,
            device=dev)))
        cin = cout
        h, w = h // 2, w // 2        # 2x2 max-pool after each conv
    fc = [affine(dense_init(h * w * cin, net.fc_size, generator=gen,
                            device=dev)),
          affine(dense_init(net.fc_size, net.num_classes, generator=gen,
                            device=dev))]
    return PaperNet({"conv": conv, "fc": fc}, device=dev)


def apply_paper_net(net, model: PaperNet, x):
    """Logits of a Table-1 network.  x: (B, features) for a DNN, (B, H,
    W, C) -- NHWC, as in the reference -- for a CNN.  The convs are
    ``F.conv2d`` on NCHW with the HWIO weights permuted to OIHW:
    ``padding="same"`` is XLA's SAME for a 5x5 window at stride 1, and
    ``max_pool2d(2)`` its VALID 2x2 pool.  The features are flattened in
    NHWC order, as the reference flattens them, so the first FC weight
    lines up row for row.  On a card, fp32 convs need
    ``torch.backends.cudnn.allow_tf32 = False`` (its default is True)."""
    if net.kind == "dnn":
        h = x
        for i, layer in enumerate(model.layers):
            h = h @ layer.w + layer.b
            if i < len(model.layers) - 1:
                h = torch.sigmoid(h)
        return h
    h = x.permute(0, 3, 1, 2)
    for layer in model.conv:
        h = F.conv2d(h, layer.w.permute(3, 2, 0, 1), layer.b,
                     padding="same")
        h = F.max_pool2d(torch.relu(h), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.sigmoid(h @ model.fc[0].w + model.fc[0].b)
    return h @ model.fc[1].w + model.fc[1].b
