"""Primitive layers: RMSNorm, RoPE, embeddings, gated MLP, softcap.

The port of ``repro.models.layers``' forward functions.  Elementwise work
that the reference does in float32 is done in float32 here too, and cast
back to the activation dtype at the same points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


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
    h = x @ w_in.to(x.dtype)
    g = None if w_gate is None else x @ w_gate.to(x.dtype)
    return activation(h, g) @ w_out.to(x.dtype)


def embed(tokens, table):
    return table[tokens]


def unembed(x, table, cap: float = 0.0):
    logits = x @ table.to(x.dtype).T
    return softcap(logits, cap)
