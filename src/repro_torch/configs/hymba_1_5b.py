"""hymba-1.5b — hybrid parallel attention + mamba heads [arXiv:2411.13676].

32L, d_model 1600, 25 query heads (GQA kv=5), d_ff 5504, vocab 32001,
ssm_state 16. Attention heads run sliding-window (global context flows
through the SSM path), making the arch sub-quadratic => long_500k eligible
(DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_parallel=True,
    sliding_window=1024,
    source="arXiv:2411.13676",
)
