"""DeepSeek-Coder 33B — llama-architecture dense code model.

[arXiv:2401.14196] 62 layers, d_model=7168, 56 heads (GQA kv=8),
d_ff=19200, vocab=32256.  Pure full attention; long_500k uses the
sliding-window variant (swa_window=8192, ``configs.config_for_shape``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
)
