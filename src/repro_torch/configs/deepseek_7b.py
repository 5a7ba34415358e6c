"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=11008 vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='deepseek-7b', family='dense',
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=11008, vocab=102400,
    pattern=('global',), rope_theta=10_000.0,
    tie_embeddings=False, max_seq=4096,
)
