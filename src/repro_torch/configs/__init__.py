"""Config registry: ``get_config(arch_id)`` + reduced smoke variants.

Only the architectures the port serves are registered; others join
with the slices that port their layers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    MLAConfig, MambaConfig, ModelConfig, MoEConfig, PaperNetConfig,
    RWKVConfig)
from repro_torch.configs import (deepseek_v3_671b, jamba_v0p1_52b,
                                 qwen3_1p7b, rwkv6_1p6b)
from repro_torch.configs.paper_nets import PAPER_NETS

ARCHITECTURES = {m.CONFIG.name: m.CONFIG
                 for m in (qwen3_1p7b, rwkv6_1p6b, jamba_v0p1_52b,
                           deepseek_v3_671b)}


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
    head_dim 48 -- the reference's ``smoke_config`` for the archs
    registered here."""
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
    return cfg.with_overrides(**kw)


__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "MLAConfig", "PaperNetConfig", "PAPER_NETS", "ARCHITECTURES",
           "ONE_CARD_LAYERS", "get_config", "one_card_config", "smoke_config"]
