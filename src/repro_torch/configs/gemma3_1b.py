"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1, MQA) d_ff=6912
vocab=262144 — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified].  head_dim=256, window=512.
26 % 6 == 2 -> the layer stack is 4 scanned groups + 2 tail local layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='gemma3-1b', family='dense',
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, head_dim=256,
    d_ff=6912, vocab=262_144,
    pattern=('local', 'local', 'local', 'local', 'local', 'global'),
    sliding_window=512, rope_theta=1_000_000.0,
    tie_embeddings=True, max_seq=131_072,
)
