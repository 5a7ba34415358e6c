"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA [hf:THUDM/glm-4-9b; hf].

Deviation noted in DESIGN.md: GLM's half-rotary is implemented as
full-rotary (identical FLOPs/bytes, simpler lowering)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='glm4-9b', family='dense',
    n_layers=40, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
    d_ff=13696, vocab=151552,
    pattern=('global',), rope_theta=10_000.0,
    tie_embeddings=False, max_seq=131_072,
)
