"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcap
[arXiv:2408.00118; hf].  head_dim=256, window=4096, attn softcap 50,
final softcap 30, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='gemma2-2b', family='dense',
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    pattern=('local', 'global'), sliding_window=4096,
    softcap_attn=50.0, softcap_final=30.0, rope_theta=10_000.0,
    tie_embeddings=True, max_seq=8192,
)
