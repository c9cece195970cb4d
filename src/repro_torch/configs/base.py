"""Model configuration dataclass shared by every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int          # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 => d_model // num_heads
    source: str = ""        # citation (arXiv / hf model card)

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0        # gemma2: soft-capping on attn logits
    final_softcap: float = 0.0       # gemma2: soft-capping on LM logits
    sliding_window: int = 0          # 0 => full attention
    local_global: bool = False       # gemma2: alternate SW / global layers
    swa_only_long_context: bool = False  # variant flag for long_500k (DESIGN §5)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual_ff: int = 0       # arctic: parallel dense MLP

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # hybrid (hymba): parallel attn + SSM heads in every layer
    hybrid_parallel: bool = False

    # encoder-decoder / multimodal
    encoder_layers: int = 0          # whisper encoder depth
    encoder_tokens: int = 1500       # stub frontend sequence length
    cross_attn_every: int = 0        # vlm: one cross-attn block per k layers
    vision_tokens: int = 1601        # stub patch-embedding count

    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d_model)
    max_seq: int = 4096              # learned-pos-embedding capacity (audio)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.family == "moe" and (not self.num_experts or not self.experts_per_token):
            raise ValueError("moe family requires num_experts/experts_per_token")

    # -- derived sizes ------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5)."""
        if self.family == "ssm":
            return True
        if self.hybrid_parallel:
            return True
        if self.sliding_window and not self.local_global:
            return True
        if self.local_global and self.swa_only_long_context:
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoding path (whisper: decoder)

    def reduced(self, *, layers: int = 2, d_model: int = 256,
                experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dimensions."""
        heads = 0 if self.num_heads == 0 else max(2, min(4, self.num_heads))
        kvh = 0 if heads == 0 else (1 if self.num_kv_heads == 1 else 2)
        changes = dict(
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=(d_model // heads if heads else 0),
            d_ff=2 * d_model,
            vocab_size=vocab,
            encoder_layers=min(self.encoder_layers, layers),
            encoder_tokens=min(self.encoder_tokens, 64),
            vision_tokens=min(self.vision_tokens, 64),
            dense_residual_ff=(d_model if self.dense_residual_ff else 0),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            cross_attn_every=min(self.cross_attn_every, layers) if self.cross_attn_every else 0,
            dtype="float32",
        )
        if self.num_experts:
            changes["num_experts"] = min(experts, self.num_experts)
            changes["experts_per_token"] = min(self.experts_per_token, 2)
        return dataclasses.replace(self, **changes)
