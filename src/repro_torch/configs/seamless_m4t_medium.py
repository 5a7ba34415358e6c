"""seamless-m4t-medium [audio enc-dec]: 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

Backbone only: 12 encoder + 12 decoder layers; the audio frontend is a
STUB — input_specs() supplies precomputed frame embeddings [B, S, 1024].
Classic (non-gated) FFN, per the released architecture."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='seamless-m4t-medium', family='enc_dec',
    n_layers=12, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=4096, vocab=256_206,
    pattern=('cross_dec',), enc_layers=12, gated_mlp=False,
    frontend='audio', tie_embeddings=True, max_seq=4096,
)
