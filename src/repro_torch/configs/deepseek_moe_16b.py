"""DeepSeekMoE 16B — fine-grained expert segmentation + shared experts.

[arXiv:2401.06066] 28 layers, d_model=2048, 16 heads (kv=16 i.e. MHA),
expert d_ff=1408, vocab=102400.  2 shared + 64 routed experts, top-6.
First layer uses a dense FFN (d_ff=10944, model card value).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        d_expert=1408,
        first_dense_layers=1,
        dense_d_ff=10944,
    ),
)
