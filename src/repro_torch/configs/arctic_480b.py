"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

dense_ff=14336 (2x d_model) puts the total at ~479B parameters, matching
the released dense-MoE hybrid decomposition (10B dense + 128x3.66B MoE)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='arctic-480b', family='moe',
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=4864, vocab=32_000,
    pattern=('moe',), n_experts=128, top_k=2, dense_ff=14336,
    rope_theta=10_000.0, tie_embeddings=False, max_seq=4096,
)
