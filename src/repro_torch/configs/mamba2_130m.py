"""mamba2-130m — attention-free SSD state-space model [arXiv:2405.21060].

24L, d_model 768, ssm_state 128, expand 2 (d_inner 1536, 24 heads of 64),
vocab 50280. Constant-size state => long_500k eligible."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    rope_theta=0.0,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
