"""Architecture configuration schema for the LM substrate.

One frozen dataclass covers all ten assigned families (dense / MoE / SSM /
hybrid / enc-dec / VLM).  Layer heterogeneity (local vs global attention,
cross-attention cadence, shared-attention cadence) is expressed as a
*repeating period*: parameters are stacked ``[n_groups, ...]`` per
position of the period, and ``n_layers % period`` tail layers follow.
A copy of the reference's schema; ``adtype`` names torch dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention pattern ---
    sliding_window: int = 0         # 0 = no local attention anywhere
    pattern: Tuple[str, ...] = ('global',)   # repeating per-layer unit
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    rope_theta: float = 10_000.0
    gated_mlp: bool = True          # SwiGLU (3 mats) vs classic (2 mats)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_ff: int = 0               # arctic-style parallel dense residual ff
    capacity_factor: float = 1.25

    # --- SSM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_type: str = ''              # mamba1 | mamba2
    ssm_head_p: int = 64            # mamba2 head channel width

    # --- enc-dec / frontends ---
    enc_layers: int = 0
    n_frontend_tokens: int = 1600   # stub audio-frame / image-patch tokens
    frontend: str = ''              # '' | audio | vision

    # --- numerics / misc ---
    dtype: str = 'bfloat16'
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    max_seq: int = 131_072

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, (self.d_model + 15) // 16)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_p

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, \
            f'{self.name}: n_layers {self.n_layers} % period {self.period}'
        return self.n_layers // self.period

    @property
    def adtype(self):
        return {'bfloat16': torch.bfloat16, 'float32': torch.float32,
                'float16': torch.float16}[self.dtype]

    @property
    def attn_layer_types(self) -> Tuple[str, ...]:
        """Expanded per-layer tags, length n_layers."""
        return tuple(self.pattern[i % self.period]
                     for i in range(self.n_layers))

    def reduced(self, **overrides) -> 'ModelConfig':
        """A smoke-test sized config of the same family/topology."""
        small = dict(
            n_layers=max(self.period, 2 * self.period if self.n_layers >=
                         2 * self.period else self.period),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, min(self.n_heads, 4)),
            head_dim=16,
            d_ff=min(self.d_ff, 128) or 0,
            vocab=min(self.vocab, 503),
            sliding_window=min(self.sliding_window, 8)
            if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            dense_ff=min(self.dense_ff, 96) if self.dense_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_p=8 if self.ssm_type == 'mamba2' else self.ssm_head_p,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            n_frontend_tokens=16 if self.frontend else self.n_frontend_tokens,
            dtype='float32',
            max_seq=256,
        )
        small.update(overrides)
        # keep n_kv dividing n_heads
        if small['n_heads'] % max(1, small['n_kv']):
            small['n_kv'] = 1
        return replace(self, **small)


# shape registry: (seq_len, global_batch, kind)
SHAPES = {
    'train_4k': dict(seq=4_096, batch=256, kind='train'),
    'prefill_32k': dict(seq=32_768, batch=32, kind='prefill'),
    'decode_32k': dict(seq=32_768, batch=128, kind='decode'),
    'long_500k': dict(seq=524_288, batch=1, kind='decode'),
}

# archs for which long_500k decode is runnable (sub-quadratic position
# mixing / bounded-cache designs); all others are skipped per DESIGN.md.
LONG_CONTEXT_OK = ('falcon-mamba-7b', 'zamba2-7b', 'gemma2-2b', 'gemma3-1b')
