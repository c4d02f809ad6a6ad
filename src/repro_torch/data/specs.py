"""Meta-device stand-ins for every model input: the dry run's fake data.

Port of ``repro.data.specs``, whose ``ShapeDtypeStruct``s become
tensors on the meta device: the shapes and dtypes of the real inputs,
with no storage, which the port's real step functions take as they are
(``launch.dryrun``).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import (VISION_EMBED_DIM, compute_dtype,
                                      init_cache)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg, shape, *, mode=None):
    """The training or prefill batch of one input shape: ``{"tokens":
    (B, S)}``; a VLM's text tokens (B, S - N_img) with its
    ``"vision_embeds"`` (B, N_img, 1024); an encoder-decoder's
    ``"src_embeds"`` (B, S, d) and ``"tgt_tokens"`` (B, S).  Tokens are
    int32, embeddings in the compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = compute_dtype(cfg)
    if cfg.is_encoder_decoder:
        return {"src_embeds": _meta((B, S, cfg.d_model), act),
                "tgt_tokens": _meta((B, S), i32)}
    if cfg.frontend == "vision":
        n_img = cfg.num_frontend_tokens
        return {"tokens": _meta((B, S - n_img), i32),
                "vision_embeds": _meta((B, n_img, VISION_EMBED_DIM), act)}
    return {"tokens": _meta((B, S), i32)}


def decode_struct(cfg, shape, cache_dtype=torch.bfloat16):
    """A decode step's inputs: ``{"tokens": (B, 1) int32, "cache": the
    slab of ``init_cache`` at max_len S (and cross_len S) on the meta
    device, "cache_pos": () int32}``."""
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, cache_dtype, batch=B, max_len=S, cross_len=S,
                       device="meta")
    return {"tokens": _meta((B, 1), torch.int32), "cache": cache,
            "cache_pos": _meta((), torch.int32)}


def input_specs(cfg, shape, *, mode=None):
    """Every input of the step ``shape`` lowers: the batch (train,
    prefill) or the decode step's tokens, cache and position."""
    mode = mode or shape.mode
    if mode in ("train", "prefill"):
        return batch_struct(cfg, shape, mode=mode)
    return decode_struct(cfg, shape)
