"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified].
d_inner = 2*4096 = 8192, dt_rank = 256, conv width 4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='falcon-mamba-7b', family='ssm',
    n_layers=64, d_model=4096, n_heads=1, n_kv=1, head_dim=64,
    d_ff=0, vocab=65_024,
    pattern=('mamba1',), ssm_state=16, ssm_conv=4, ssm_expand=2,
    ssm_type='mamba1', tie_embeddings=True, max_seq=1_048_576,
)
