"""arctic-480b — 128-expert top-2 MoE with dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56H (GQA kv=8), expert d_ff 4864, vocab 32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    dense_residual_ff=4864,
    tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
