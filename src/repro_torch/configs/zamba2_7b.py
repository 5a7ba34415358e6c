"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

Layout: 27 scanned groups of 3 mamba2 blocks, the SHARED full-attention
block (one weight set) applied after every group (27 applications vs ~13
in the release — cadence chosen so the pattern tiles 81 layers; deviation
recorded in DESIGN.md §Arch-applicability)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='zamba2-7b', family='hybrid',
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32_000,
    pattern=('mamba2', 'mamba2', 'mamba2'),
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_type='mamba2',
    ssm_head_p=64, tie_embeddings=True, max_seq=1_048_576,
)
