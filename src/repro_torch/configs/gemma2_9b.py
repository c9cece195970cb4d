"""gemma2-9b — local/global alternating attention + logit softcaps
[arXiv:2408.00118].

42L, d_model 3584, 16H (GQA kv=8, head_dim 256), d_ff 14336, vocab 256000.
Local layers are SWA-4096; `swa_only_long_context` enables the documented
long_500k variant where global layers also window (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    swa_only_long_context=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
