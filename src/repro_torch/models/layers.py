"""Primitive layers: RMSNorm, RoPE, embeddings, gated MLP, softcap, and
the language-model losses.

The port of ``repro.models.layers``.  Elementwise work that the reference
does in float32 is done in float32 here too, and cast back to the
activation dtype at the same points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .shard_utils import gather_rows, is_dtensor, matmul, pick_last


@lru_cache(maxsize=64)
def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies by a Python
    scalar cast to the activation dtype, while torch would keep it in
    float32 for a bfloat16 tensor."""
    return torch.tensor(value, dtype=dtype).item()


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


@lru_cache(maxsize=64)
def _rope_freq(half: int, theta: float, device: torch.device):
    """The rotary frequencies, computed in numpy float32 as the reference
    computes them and uploaded once a (width, theta, device): an upload at
    call time would wait for the stream on the card."""
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.as_tensor(freq, device=device)


def rope(x, positions, theta: float):
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]."""
    half = x.shape[-1] // 2
    freq = _rope_freq(half, float(theta), x.device)
    ang = positions[..., None].float() * freq             # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def activation(h, w_gate_out):
    """The MLP nonlinearity in float32: SiLU of the gate times ``h`` when a
    gate projection ``w_gate_out`` is given, else the tanh-approximated
    GeLU of ``h`` (``jax.nn.gelu``'s default)."""
    if w_gate_out is not None:
        return F.silu(w_gate_out.float()).to(h.dtype) * h
    return F.gelu(h.float(), approximate='tanh').to(h.dtype)


def mlp(x, w_in, w_gate, w_out):
    """SwiGLU when w_gate is not None, classic GeLU MLP otherwise."""
    h = matmul(x, w_in.to(x.dtype))
    g = None if w_gate is None else matmul(x, w_gate.to(x.dtype))
    return matmul(activation(h, g), w_out.to(x.dtype))


def embed(tokens, table):
    if is_dtensor(table):
        # DTensor has no rule for indexing a dim-sharded table with 2-D
        # ids (its vocab-parallel _MaskPartial raises IndexError)
        return gather_rows(table, tokens)
    return table[tokens]


def unembed(x, table, cap: float = 0.0):
    logits = matmul(x, table.to(x.dtype).T)
    return softcap(logits, cap)


def _nll(logits, labels):
    """Per-position CE in float32. logits [..., V], labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # DTensor's gather along a sharded vocab dim (_MaskPartial) takes
        # 2-D operands only
        return logz - pick_last(logits, labels.long())
    return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE in float32; with ``mask``, the masked mean over
    max(sum(mask), 1) positions."""
    nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _chunk_nll(h, table, labels, cap):
    """Summed CE of one sequence chunk: its logits exist only here."""
    return _nll(unembed(h, table, cap), labels).sum()


def chunked_lm_loss(hidden, table, labels, cap: float = 0.0,
                    n_chunks: int = 8):
    """Mean CE from final hidden states [B, S, d] without the full
    [B, S, V] logits: the sequence is cut into ``n_chunks`` chunks, each
    unembedded on its own and recomputed in the backward
    (``torch.utils.checkpoint``), so the live set is one chunk's logits
    (gemma3's 262k vocabulary at S=4096 would otherwise hold ~17 GB of
    float32 logits a batch of 4).  Where ``n_chunks`` does not divide S,
    or S < n_chunks, the loss is the unchunked ``cross_entropy``, as in
    the reference."""
    B, S, _ = hidden.shape
    if S % n_chunks or S < n_chunks:
        return cross_entropy(unembed(hidden, table, cap), labels)
    C = S // n_chunks
    # no RNG runs here: preserve_rng_state would only stash it
    nll = [checkpoint(_chunk_nll, hidden[:, c:c + C], table,
                      labels[:, c:c + C], cap, use_reentrant=False,
                      preserve_rng_state=False)
           for c in range(0, S, C)]
    return torch.stack(nll).sum() / (B * S)
