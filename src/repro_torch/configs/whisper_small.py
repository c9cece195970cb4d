"""whisper-small — encoder-decoder audio transformer [arXiv:2212.04356].

12L (decoder; encoder 12L), d_model 768, 12H, d_ff 3072, vocab 51865.
The mel-spectrogram + conv frontend is a stub per the assignment:
input_specs() provides precomputed frame embeddings [B, 1500, 768]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_tokens=1500,
    rope_theta=0.0,          # learned positional embeddings, no RoPE
    tie_embeddings=True,
    max_seq=4096,            # grown per-shape by input_specs (decode shapes)
    source="arXiv:2212.04356",
)
