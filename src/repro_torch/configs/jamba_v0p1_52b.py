"""Jamba v0.1 52B -- hybrid Mamba + attention (1:7) with MoE.

[arXiv:2403.19887] 32 layers, d_model=4096, 32 heads (GQA kv=8),
d_ff=14336, vocab=65536.  Attention every 8th layer (offset 4); MoE
(16 experts, top-2) every other layer (offset 1).  Mamba: d_state=16,
d_conv=4, expand=2.  The whole model is 51.6 B parameters (103 GB in
bf16); one 8-layer super-block (``with_overrides(num_layers=8)``) holds
every layer kind it has at 13.3 B.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_kind="mamba",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        num_shared_experts=0,
        d_expert=14336,
        moe_layer_period=2,
        moe_layer_offset=1,
    ),
)
