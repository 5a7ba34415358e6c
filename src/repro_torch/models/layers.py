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

from .shard_utils import (batch_layout, is_dtensor, matmul, model_dim,
                          on_rows, pick_last, replicated_on, row_dims,
                          rows_out, sum_over, vocab_logsumexp)


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
        return _embed_on_shards(tokens, table)
    return table[tokens]


def _vocab_slice(table, rows):
    """A DTensor table [V, d] as the plain rows of this rank's slice of
    the vocabulary (split over 'model', unevenly where V does not divide;
    whole over the other mesh dims), and the slice's first word.  Its
    gradient is partial over ``rows``, the mesh dims whose ranks each use
    it on their own batch rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    mi = model_dim(mesh)
    tl = table.redistribute(mesh, [
        Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)
    ]).to_local(grad_placements=[
        Shard(0) if i == mi else Partial() if i in rows else Replicate()
        for i in range(mesh.ndim)])
    off = 0 if mi is None else (mesh.get_local_rank(mi) * -(
        -table.shape[0] // mesh.size(mi)))
    return tl, off


def _embed_on_shards(tokens, table):
    """``table[tokens]`` with each rank on its own batch rows and its own
    slice of the vocabulary: the rows of the ids in the slice, zero for
    the others, partial over 'model' (DTensor sums them where they are
    used), as the reference's partitioner does for its ``embed`` spec."""
    mesh = table.device_mesh
    ids = batch_layout(tokens if is_dtensor(tokens)
                       else replicated_on(mesh, tokens))
    tl, off = _vocab_slice(table, row_dims(ids))
    il = ids.to_local() - off
    got = tl[il.clamp(0, max(tl.shape[0] - 1, 0))]
    inside = ((il >= 0) & (il < tl.shape[0]))[..., None]
    return rows_out(torch.where(inside, got, 0), mesh, ids.placements,
                    model_dim(mesh), partial=True)


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


def _nll_on_shards(h, table, labels, cap):
    """Summed CE of the DTensor hidden states ``h`` [B, C, d], each rank
    on its own rows and its own slice of the vocabulary (the reference's
    layout for its ``embed`` spec): the table split over 'model' by rows
    (unevenly where the vocabulary does not divide) and whole over the
    data axes; the logits' logsumexp from a local max and sum each
    all-reduced over 'model'; the label's logit picked on the rank that
    holds it and summed over 'model'; the rows' sums summed over the data
    axes.  The backward is local but for the sums DTensor makes of the
    gradients: the rows' gradient partial over 'model', the table's over
    the data axes.  No rank holds more than its rows' logits."""
    h = batch_layout(h)
    mesh = h.device_mesh
    mi, rows = model_dim(mesh), row_dims(h)
    tl, off = _vocab_slice(table, rows)
    if is_dtensor(labels):
        labels = labels.redistribute(mesh, h.placements).to_local()
    logits = softcap(on_rows(h, mi) @ tl.to(h.dtype).T, cap).float()
    vocab = [] if mi is None else [mi]
    logz = vocab_logsumexp(logits, mesh, vocab)
    il = labels.long() - off
    n = logits.shape[-1]
    got = torch.gather(logits, -1, il.clamp(0, max(n - 1, 0))[..., None])
    picked = torch.where((il >= 0) & (il < n), got[..., 0], 0)
    nll = (logz - sum_over(picked, mesh, vocab)).sum()
    return replicated_on(mesh, sum_over(nll, mesh, rows))


def _chunk_nll(h, table, labels, cap):
    """Summed CE of one sequence chunk: its logits exist only here."""
    if is_dtensor(h) and is_dtensor(table):
        return _nll_on_shards(h, table, labels, cap)
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
        if is_dtensor(hidden) and is_dtensor(table):
            return _nll_on_shards(hidden, table, labels, cap) / (B * S)
        return cross_entropy(unembed(hidden, table, cap), labels)
    C = S // n_chunks
    # no RNG runs here: preserve_rng_state would only stash it
    nll = [checkpoint(_chunk_nll, hidden[:, c:c + C], table,
                      labels[:, c:c + C], cap, use_reentrant=False,
                      preserve_rng_state=False)
           for c in range(0, S, C)]
    return torch.stack(nll).sum() / (B * S)
