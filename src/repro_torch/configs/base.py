"""Model configuration for the port (own copy of ``repro.configs.base``).

Frozen dataclasses, field for field the reference's ``ModelConfig`` and
its sub-configs, so a config built here describes the same network as
the reference's.  The reference's ``decode_kernel`` switch has no
counterpart: the port picks the paged-decode kernel from the tensor's
device (CUDA kernel on the card, plain PyTorch on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Fine-grained mixture-of-experts (DeepSeekMoE-style)."""
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_expert: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    router_type: str = "softmax"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # ---- attention flavour -------------------------------------------------
    attention: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    swa_window: int = 0              # 0 = full attention; >0 = sliding window
    pad_heads_to: int = 0            # structurally-zero padded query heads
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None

    # ---- hybrid / ssm ------------------------------------------------------
    attn_layer_period: int = 1
    attn_layer_offset: int = 0
    ssm_kind: str = "none"           # mamba | rwkv6 | none
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # ---- MoE ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None

    # ---- encoder-decoder (audio) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # ---- modality frontend stub (vlm / audio) ------------------------------
    frontend: str = "none"
    num_frontend_tokens: int = 0

    # ---- extras ------------------------------------------------------------
    mtp_depth: int = 0
    mlp_gated: bool = True           # SwiGLU (3 mats) vs plain 2-mat MLP
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master weights

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    # layer-kind pattern
    # ------------------------------------------------------------------
    def mixer_kind(self, layer_idx: int) -> str:
        """'attn' | 'mamba' | 'rwkv6' for a given layer index."""
        if self.attn_layer_period == 0:
            return self.ssm_kind
        if self.attn_layer_period == 1:
            return "attn"
        if layer_idx % self.attn_layer_period == self.attn_layer_offset:
            return "attn"
        return self.ssm_kind

    def ffn_kind(self, layer_idx: int) -> str:
        """'mlp' | 'moe' for a given layer index."""
        m = self.moe
        if m is None:
            return "mlp"
        if layer_idx < m.first_dense_layers:
            return "mlp"
        if layer_idx % m.moe_layer_period == m.moe_layer_offset % m.moe_layer_period:
            return "moe"
        return "mlp"

    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds for the whole (decoder) stack."""
        return tuple(
            (self.mixer_kind(i), self.ffn_kind(i)) for i in range(self.num_layers)
        )

    def block_structure(self):
        """Split layers into (unrolled prefix, repeating super-block,
        n_repeats) -- the reference stacks its parameters this way, so
        the bridge uses it to unstack them."""
        pat = self.layer_pattern()
        prefix_len = 0
        if self.moe is not None and self.moe.first_dense_layers:
            prefix_len = self.moe.first_dense_layers
        body = pat[prefix_len:]
        period = len(body)
        for cand in range(1, len(body) + 1):
            if len(body) % cand:
                continue
            if body == body[:cand] * (len(body) // cand):
                period = cand
                break
        return pat[:prefix_len], body[:period], len(body) // period

    # ------------------------------------------------------------------
    # parameter counting
    # ------------------------------------------------------------------
    def attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.num_heads * m.v_head_dim * d
            return p
        hd = self.head_dim
        p = d * self.num_heads * hd
        p += 2 * d * self.num_kv_heads * hd
        p += self.num_heads * hd * d
        if self.qkv_bias:
            p += (self.num_heads + 2 * self.num_kv_heads) * hd
        return p

    def mamba_params(self) -> int:
        mc = self.mamba or MambaConfig()
        d_in = mc.expand * self.d_model
        p = self.d_model * 2 * d_in                      # in_proj (x, z)
        p += d_in * mc.d_conv                            # conv1d
        p += d_in * (mc.d_state * 2 + d_in // 16)        # B, C, dt projections
        p += d_in * mc.d_state                           # A
        p += d_in * self.d_model                         # out_proj
        return p

    def rwkv_params(self) -> int:
        """The reference's count, kept as it is so the two agree: it
        leaves out ``cm_wr`` (d*d a layer) and counts the decay LoRA
        twice, so it is not the allocated ``numel``."""
        rc = self.rwkv or RWKVConfig()
        d = self.d_model
        p = 4 * d * d                                    # r, k, v, o (time-mix)
        p += d * d                                       # gate
        p += 2 * (d * rc.decay_lora + rc.decay_lora * d) # decay lora + u
        p += 5 * (d * rc.mix_lora + rc.mix_lora * d)     # token-shift loras
        p += 2 * d * self.d_ff                           # channel-mix (r,k)
        return p

    @property
    def _mlp_mats(self) -> int:
        return 3 if self.mlp_gated else 2

    def ffn_params(self, kind: str) -> int:
        """An MLP's weights, or an MoE layer's: every routed and shared
        expert plus the router (the reference's formula)."""
        d = self.d_model
        if kind == "mlp":
            return self._mlp_mats * d * self.d_ff
        m = self.moe
        per_exp = self._mlp_mats * d * m.d_expert
        return (m.num_experts + m.num_shared_experts) * per_exp \
            + d * m.num_experts

    def _mixer_params(self, kind: str) -> int:
        return {"attn": self.attn_params(),
                "mamba": self.mamba_params(),
                "rwkv6": self.rwkv_params()}[kind]

    def param_count(self) -> int:
        """Total parameter count by the reference's formula, walking the
        layer pattern (an RWKV block carries its own channel mix)."""
        total = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                  else 2)
        for mixer, ffn in self.layer_pattern():
            total += self._mixer_params(mixer)
            if mixer != "rwkv6":
                total += self.ffn_params(ffn)
        return total

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Paper Table-1 networks
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaperNetConfig:
    """A network from Table 1 of Vishnu et al. 2016."""
    name: str
    kind: str                        # dnn | cnn
    layer_sizes: Tuple[int, ...] = ()        # dnn: in-hidden...-out
    # cnn fields (paper: 5x5 conv, stride 1, relu, 2x2 maxpool, sigmoid fc)
    image_hw: Tuple[int, int] = (0, 0)
    image_channels: int = 0
    conv_channels: Tuple[int, ...] = ()
    fc_size: int = 0
    num_classes: int = 0
    dataset: str = ""
