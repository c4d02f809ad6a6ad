"""Config registry: ``get_config(arch_id)`` + reduced smoke variants.

Only the architectures the port serves are registered; others join
with the slices that port their layers.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    MLAConfig, MambaConfig, ModelConfig, MoEConfig, RWKVConfig)
from repro_torch.configs import qwen3_1p7b, rwkv6_1p6b

ARCHITECTURES = {m.CONFIG.name: m.CONFIG for m in (qwen3_1p7b, rwkv6_1p6b)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model 256, the
    GQA ratio kept where possible; RWKV stacks get 8 heads of 32 and
    LoRA ranks 16 / 8 -- the reference's ``smoke_config`` for the archs
    registered here."""
    cfg = get_config(arch)
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    kw = dict(num_layers=2, d_model=256, num_heads=4,
              num_kv_heads=max(1, 4 // min(ratio, 4)), head_dim=64, d_ff=512,
              vocab_size=512)
    if cfg.rwkv is not None:
        kw.update(rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8),
                  num_heads=8, num_kv_heads=8, head_dim=32)
    return cfg.with_overrides(**kw)


__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "MLAConfig", "ARCHITECTURES", "get_config", "smoke_config"]
