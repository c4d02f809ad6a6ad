"""Config registry: ``get_config(arch_id)`` + reduced smoke variants.

All ten of the reference's architectures: decoder-only stacks of GQA,
MLA, Mamba and RWKV-6 layers with MLP or MoE ffns, the VLM
(``llava-next-mistral-7b``, vision frontend stub) and the
encoder-decoder (``seamless-m4t-large-v2``, audio frontend stub); and
the input shapes with ``config_for_shape``'s long-context variants.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    DECODE_32K, DECODE_KERNELS, INPUT_SHAPES, LONG_500K, PREFILL_32K, TRAIN_4K, InputShape,
    MLAConfig, MambaConfig, ModelConfig, MoEConfig, PaperNetConfig,
    RWKVConfig)
from repro_torch.configs import (
    deepseek_coder_33b, deepseek_moe_16b, deepseek_v3_671b, granite_20b,
    jamba_v0p1_52b, llava_next_mistral_7b, qwen2p5_32b, qwen3_1p7b,
    rwkv6_1p6b, seamless_m4t_large_v2)
from repro_torch.configs.paper_nets import PAPER_NETS

ARCHITECTURES = {m.CONFIG.name: m.CONFIG
                 for m in (qwen3_1p7b, rwkv6_1p6b, jamba_v0p1_52b,
                           deepseek_v3_671b, granite_20b, qwen2p5_32b,
                           deepseek_coder_33b, deepseek_moe_16b,
                           llava_next_mistral_7b, seamless_m4t_large_v2)}

# archs that do not take long_500k at all: a 524k-frame source is outside
# the encoder-decoder speech family's range
LONG_500K_SKIPS = {"seamless-m4t-large-v2"}
# full-attention archs that take the sliding-window variant for long_500k
SWA_FOR_LONG = {
    "deepseek-coder-33b", "granite-20b", "qwen2.5-32b", "qwen3-1.7b",
    "deepseek-moe-16b", "deepseek-v3-671b", "llava-next-mistral-7b",
}
SWA_WINDOW = 8192


# depth cuts of the configs whose bf16 weights do not fit one 80 GB card;
# every width is kept.  Jamba's 8-layer super-block holds each of its
# layer kinds (13.3 B parameters of 51.6 B); DeepSeek-V3's first four
# layers are its 3 dense layers and one MoE layer of all 256 experts
# (15.1 B allocated of 671 B; each further MoE layer adds 22.6 GB in bf16)
ONE_CARD_LAYERS = {"jamba-v0.1-52b": 8, "deepseek-v3-671b": 4}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch]


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    """The arch's config for an input shape: long_500k raises for
    ``LONG_500K_SKIPS`` and takes ``swa_window=SWA_WINDOW`` for
    ``SWA_FOR_LONG``; every other pair is the config itself."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if arch in LONG_500K_SKIPS:
            raise ValueError(f"{arch} skips long_500k")
        if arch in SWA_FOR_LONG:
            cfg = cfg.with_overrides(swa_window=SWA_WINDOW)
    return cfg


def one_card_config(arch: str) -> ModelConfig:
    """The full-width config, its depth cut where ``ONE_CARD_LAYERS``
    says so."""
    cfg = get_config(arch)
    if arch in ONE_CARD_LAYERS:
        cfg = cfg.with_overrides(num_layers=ONE_CARD_LAYERS[arch])
    return cfg


def smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model 256, the
    GQA ratio kept where possible; MoE gets 4 experts of 128 with a
    generous capacity (8.0); RWKV stacks get 8 heads of 32 and LoRA
    ranks 16 / 8; Mamba stacks d_state 8 with attention at layer 1 of
    every 2; MLA q_lora 64, kv_lora 32, nope 32, rope 16, v 32 with
    head_dim 48; an encoder-decoder 2 encoder layers, a vision stack 16
    frontend tokens -- the reference's ``smoke_config``."""
    cfg = get_config(arch)
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    kw = dict(num_layers=2, d_model=256, num_heads=4,
              num_kv_heads=max(1, 4 // min(ratio, 4)), head_dim=64, d_ff=512,
              vocab_size=512)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_expert=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            dense_d_ff=512, capacity_factor=8.0)
    if cfg.mla is not None:
        kw.update(mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                qk_nope_head_dim=32, qk_rope_head_dim=16,
                                v_head_dim=32),
                  head_dim=48)
    if cfg.rwkv is not None:
        kw.update(rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8),
                  num_heads=8, num_kv_heads=8, head_dim=32)
    if cfg.ssm_kind == "mamba":
        kw.update(mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
                  attn_layer_period=2, attn_layer_offset=1)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
    if cfg.frontend == "vision":
        kw["num_frontend_tokens"] = 16
    return cfg.with_overrides(**kw)


__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "MLAConfig", "PaperNetConfig", "InputShape", "INPUT_SHAPES",
           "DECODE_KERNELS",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "PAPER_NETS", "ARCHITECTURES", "ONE_CARD_LAYERS",
           "LONG_500K_SKIPS", "SWA_FOR_LONG", "SWA_WINDOW", "get_config",
           "config_for_shape", "one_card_config", "smoke_config"]
