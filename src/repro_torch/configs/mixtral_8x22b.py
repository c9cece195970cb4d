"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

56L, d_model 6144, 48H (GQA kv=8), expert d_ff 16384, vocab 32768.
All-layer SWA-4096 => long_500k eligible."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    tie_embeddings=False,
    source="arXiv:2401.04088",
)
