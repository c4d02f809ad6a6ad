"""SeamlessM4T-Large v2 — encoder-decoder multimodal translation backbone.

[arXiv:2308.11596] Text decoder: 24 layers, d_model=1024, 16 heads
(MHA kv=16), d_ff=8192, vocab=256206; speech/text encoder: 24 layers.
The audio frontend (mel-spectrogram + conformer feature extractor) is a
stub: the caller supplies precomputed frame embeddings (``src_embeds``).
long_500k is skipped for this arch (``configs.LONG_500K_SKIPS``): a
524k-frame source in one utterance is outside the enc-dec speech
family's operating range.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    is_encoder_decoder=True,
    encoder_layers=24,
    frontend="audio",
    num_frontend_tokens=0,   # encoder input IS the frame-embedding sequence
)
