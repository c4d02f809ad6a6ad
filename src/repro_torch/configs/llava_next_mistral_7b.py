"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] Language backbone: 32 layers,
d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000.  The vision
tower (CLIP ViT-L/336) is a stub: the caller supplies precomputed patch
embeddings (``vision_embeds``, 1024 wide), which the 2-layer MLP
projector maps to d_model.  anyres tiling:
base 576 patches + 4 tiles x 576 = 2880 image tokens.  Mistral's native
sliding window (4096) makes long_500k legitimate.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend="vision",
    num_frontend_tokens=2880,   # anyres: (1 base + 4 tiles) x 576 patches
)
