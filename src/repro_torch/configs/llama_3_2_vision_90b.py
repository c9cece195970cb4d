"""llama-3.2-vision-90b — VLM with gated cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

100L, d_model 8192, 64H (GQA kv=8), d_ff 28672, vocab 128256. Every 5th
layer is a gated cross-attention block over stubbed vision patch embeddings
(ViT encoder + projector stubbed per the assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    vision_tokens=1601,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
