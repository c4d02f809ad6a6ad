"""RWKV-6 "Finch" 1.6B -- attention-free RNN with data-dependent decay.

[arXiv:2404.05892] Eagle and Finch: RWKV with Matrix-Valued States and
Dynamic Recurrence.  24 layers, d_model=2048, d_ff=7168, vocab=65536,
head_dim=64 (32 heads).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # 2048 / head_dim 64
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    attn_layer_period=0,     # attention-free
    ssm_kind="rwkv6",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
)
