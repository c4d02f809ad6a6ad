"""DeepSeek-V3 671B -- MLA + fine-grained MoE + multi-token prediction.

[arXiv:2412.19437] 61 layers, d_model=7168, 128 heads, MLA
(q_lora=1536, kv_lora=512, nope=128, rope=64, v=128), expert d_ff=2048,
vocab=129280 untied.  1 shared + 256 routed experts, top-8, sigmoid
router with a balance bias; the first 3 layers dense (d_ff=18432).  MTP
depth 1.  The whole model is 671 B parameters; its first four layers
(``with_overrides(num_layers=4)``: the 3 dense layers and one MoE
layer) hold every layer kind at full width in 15.1 B.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: kv "heads" = heads (latent-compressed)
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        num_shared_experts=1,
        d_expert=2048,
        first_dense_layers=3,
        dense_d_ff=18432,
        router_type="sigmoid",   # V3: aux-free bias-balanced sigmoid router
    ),
    mtp_depth=1,
)
