"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='granite-moe-1b-a400m', family='moe',
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, head_dim=64,
    d_ff=512, vocab=49_155,
    pattern=('moe',), n_experts=32, top_k=8,
    rope_theta=10_000.0, tie_embeddings=True, max_seq=4096,
)
