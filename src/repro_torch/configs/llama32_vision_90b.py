"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Backbone only: 80 self-attention + 20 cross-attention layers (every 5th
layer cross-attends precomputed vision-patch embeddings, 1600 tokens —
the vision tower is a STUB per the brief)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='llama-3.2-vision-90b', family='vlm',
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=28672, vocab=128_256,
    pattern=('global', 'global', 'global', 'global', 'cross'),
    frontend='vision', n_frontend_tokens=1600,
    rope_theta=500_000.0, tie_embeddings=False, max_seq=131_072,
)
