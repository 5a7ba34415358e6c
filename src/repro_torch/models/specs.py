"""Input specifications per (arch x shape), as ``meta`` tensors (the port
of ``repro.models.specs``: ``jax.ShapeDtypeStruct`` stand-ins).

These drive the dry run (``python -m repro_torch.launch.dryrun``): every
model input is described by shape and dtype only, and no memory is
allocated for the full-size configs.  The reference's dtypes are kept,
except the token ids, which are int64, as ``launch.steps`` makes them
(the reference's are int32).
"""

from __future__ import annotations

import torch

from .config import LONG_CONTEXT_OK, SHAPES, ModelConfig
from .transformer import init_cache, param_shapes

TOKENS = torch.long     # the reference: int32


def sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device='meta')


def _frontend(cfg: ModelConfig, seq: int, batch: int, specs):
    if cfg.frontend == 'audio' or cfg.enc_layers:
        specs['frontend'] = sds((batch, seq, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == 'vision':
        specs['frontend'] = sds((batch, cfg.n_frontend_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int):
    return _frontend(cfg, seq, batch, {'tokens': sds((batch, seq), TOKENS),
                                       'labels': sds((batch, seq), TOKENS)})


def prefill_specs(cfg: ModelConfig, seq: int, batch: int):
    return _frontend(cfg, seq, batch, {'tokens': sds((batch, seq), TOKENS)})


def decode_specs(cfg: ModelConfig, seq: int, batch: int):
    return {'tokens': sds((batch, 1), TOKENS),
            'pos': sds((), torch.int32),
            'cache': init_cache(cfg, batch, seq, device='meta')}


def params_specs(cfg: ModelConfig):
    """The float32 parameter tree as meta tensors, from
    ``transformer.param_shapes`` (``init_params`` would draw every weight
    first)."""
    def build(tree):
        return {k: build(v) if isinstance(v, dict)
                else sds(v, torch.float32) for k, v in sorted(tree.items())}
    return build(param_shapes(cfg))


def input_specs(cfg: ModelConfig, shape_name: str):
    """Abstract inputs for one (arch, shape) cell, or None if skipped."""
    s = SHAPES[shape_name]
    if shape_name == 'long_500k' and cfg.name not in LONG_CONTEXT_OK:
        return None
    if s['kind'] == 'train':
        return train_batch_specs(cfg, s['seq'], s['batch'])
    if s['kind'] == 'prefill':
        return prefill_specs(cfg, s['seq'], s['batch'])
    return decode_specs(cfg, s['seq'], s['batch'])
