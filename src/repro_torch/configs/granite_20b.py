"""Granite 20B Code — llama-architecture dense with MQA.

[arXiv:2405.04324] 52 layers, d_model=6144, 48 heads (MQA kv=1),
d_ff=24576, vocab=49152.  long_500k uses the sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,       # GPT-BigCode-style plain MLP (gelu)
)
