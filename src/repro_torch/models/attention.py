"""Attention (torch ops): the port of ``repro.models.attention``' forward.

- ``flash_attention``: blockwise online-softmax attention, the query
  blocks batched, a loop over key/value blocks; the ``[Sq, Sk]`` score
  matrix is never formed whole.
- ``local_attention``: sliding-window attention over window-sized query
  chunks, each against its own and the previous chunk (O(S * 2W)).
- ``decode_attention``: one query position against a (possibly
  ring-buffered) KV cache.

All support GQA (n_kv <= n_heads), RoPE applied by the caller, optional
logit soft-capping, and float32 softmax accumulation.  Autograd runs
through these torch ops; ``REPRO_FLASH_VJP=1`` selects the flash
backward of ``flash_vjp`` instead.  Masked scores take
the finite ``NEG_INF``: with ``-inf`` a block whose every score is masked
would give NaN in the online softmax.  On a mesh (DTensor operands) GQA's
K/V may be repeated to the query heads first (``_match_heads``).
"""

from __future__ import annotations

import math
import os

import torch

from .flash_vjp import flash_mha
from .layers import rounded, softcap
from .shard_utils import is_dtensor

NEG_INF = -1e30


def _divisor_block(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (block size selection)."""
    b = min(target, s)
    while s % b:
        b -= 1
    return b


def _match_heads(q, k, v):
    """DTensor attention operands laid out so that each rank attends on
    its own shards alone: batch over the data axes where it splits evenly,
    heads over the other mesh dims where q's heads split evenly (else
    whole, and the attention repeats on those ranks).  Where the mesh
    splits q's heads more ways than the G K/V groups divide, each group
    is repeated to q's H heads first, so that a rank's K/V heads are its
    q heads' groups.  The scores are the same products; only K/V's local
    copies grow, to q's local head count."""
    if not is_dtensor(q):
        return q, k, v
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()

    def laid_out(a):    # batch over the data axes, heads over the others
        pl = []
        for i, name in enumerate(names):
            n = mesh.size(i)
            if n == 1:
                pl.append(Replicate())
            elif name in ('pod', 'data'):
                pl.append(Shard(0) if a.shape[0] % n == 0 else Replicate())
            elif a.shape[2] % n == 0 and q.shape[2] % n == 0:
                pl.append(Shard(2))
            else:
                pl.append(Replicate())
        if sum(p.is_shard(0) for p in pl) and a.shape[0] % math.prod(
                mesh.size(i) for i, p in enumerate(pl) if p.is_shard(0)):
            pl = [Replicate() if p.is_shard(0) else p for p in pl]
        pl = tuple(pl)
        return a if pl == a.placements else a.redistribute(mesh, pl)
    q, k, v = laid_out(q), laid_out(k), laid_out(v)
    H, G = q.shape[2], k.shape[2]
    ways = math.prod(mesh.size(i) for i, pl in enumerate(q.placements)
                     if pl.is_shard(2))
    if G == H or G % ways == 0:
        return q, k, v
    B, S, _, hd = k.shape

    def expand(a):
        # K/V's group dim is whole on q's head-sharding mesh dims (no rule
        # shards it there); the repeated heads are split like q's only
        # after the reshape, so the backward's reshape sees them whole
        a = a[:, :, :, None].expand(B, S, G, H // G, hd).reshape(
            B, S, H, hd)
        return a.redistribute(mesh, [
            qp if qp.is_shard(2) else ap
            for qp, ap in zip(q.placements, a.placements)])
    return q, expand(k), expand(v)


def _on_shards(q, k, v, causal, window, q_offset=0, **kw):
    """Blockwise attention of DTensor operands on each rank's shards: laid
    out by ``_match_heads`` (attention is independent across batch rows
    and heads), then q's rows (its sequence) split over the mesh dims
    that leave the heads whole, where they divide, each rank attending
    with its rows' offset (K/V whole there; their gradients partial).
    ``window``: a sliding window (each rank then reads only the keys its
    rows can see).  The result is a DTensor with q's placements."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    q, k, v = _match_heads(q, k, v)
    mesh, names = q.device_mesh, q.device_mesh.mesh_dim_names or ()
    rows, off, pl = q.shape[1], 0, list(q.placements)
    kv_grad = list(k.placements)
    for i, name in enumerate(names):
        n = mesh.size(i)
        if (name not in ('pod', 'data') and n > 1 and pl[i].is_replicate()
                and rows % n == 0):
            rows //= n
            off += mesh.get_local_rank(i) * rows
            pl[i], kv_grad[i] = Shard(1), Partial()
    if tuple(pl) != q.placements:
        q = q.redistribute(mesh, pl)
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    if window and rows == q.shape[1]:   # rows whole: the chunked form
        out = local_attention(ql, kl, vl, window=window, **kw)
        return DTensor.from_local(out, mesh, q.placements, run_check=False)
    if window:          # the keys rows off.. can see: (off - W, off + rows]
        start = max(0, off + q_offset - window + 1)
        kl, vl = kl[:, start:off + q_offset + rows], vl[:, start:
                                                        off + q_offset + rows]
        q_offset += off - start
    else:
        q_offset += off
    out = flash_attention(ql, kl, vl, causal=causal, window=window,
                          q_offset=q_offset, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def flash_attention(q, k, v, *, causal=True, softcap_val=0.0,
                    q_offset=0, block_q=512, block_k=1024, window=0):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, G, hd].  Returns [B, Sq, H, hd].

    ``q_offset``: absolute position of q[0] relative to k[0] (for
    cross-chunk prefill; 0 for self-attention from the start).
    ``window``: if > 0, restrict to kpos > qpos - window (sliding window).

    With ``REPRO_FLASH_VJP=1`` in the environment (read at each call, as
    the reference reads it) and no soft-capping, the block-recomputing
    ``flash_vjp.flash_mha`` runs instead: the same forward, with a
    backward that saves no probability blocks.
    """
    if is_dtensor(q):
        return _on_shards(q, k, v, causal, window, q_offset,
                          softcap_val=softcap_val, block_q=block_q,
                          block_k=block_k)
    B, Sq, H, hd = q.shape
    _, Sk, G, _ = k.shape
    rep = H // G
    block_q = _divisor_block(Sq, block_q)
    block_k = _divisor_block(Sk, block_k)
    if not softcap_val and os.environ.get('REPRO_FLASH_VJP') == '1':
        return flash_mha(q, k, v, causal, window, q_offset, block_q,
                         block_k)
    nq, nk = Sq // block_q, Sk // block_k
    dev = q.device

    qb = (q * rounded(hd ** -0.5, q.dtype)).reshape(
        B, nq, block_q, G, rep, hd)
    kb = k.reshape(B, nk, block_k, G, hd)
    vb = v.reshape(B, nk, block_k, G, hd)
    if causal or window:
        qpos = (q_offset + torch.arange(nq, device=dev)[:, None, None]
                * block_q
                + torch.arange(block_q, device=dev)[None, :, None])

    m = torch.full((B, nq, G, rep, block_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nq, G, rep, block_q), dtype=torch.float32,
                    device=dev)
    acc = torch.zeros((B, nq, block_q, G, rep, hd), dtype=torch.float32,
                      device=dev)
    for ki in range(nk):
        kblk, vblk = kb[:, ki], vb[:, ki]
        s = torch.einsum('bnqgrd,bkgd->bngrqk', qb, kblk).float()
        s = softcap(s, softcap_val)
        if causal or window:
            kpos = ki * block_k + torch.arange(block_k, device=dev)
            ok = (kpos <= qpos) if causal else torch.ones_like(
                qpos - kpos, dtype=torch.bool)
            if window:
                ok = ok & (qpos - kpos < window)
            s = torch.where(ok[None, :, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum('bngrqk,bkgd->bnqgrd', p.to(v.dtype), vblk)
        acc = acc * corr.permute(0, 1, 4, 2, 3)[..., None] + pv.float()
        m = m_new
    out = (acc / l.permute(0, 1, 4, 2, 3)[..., None]).to(q.dtype)
    return out.reshape(B, Sq, H, hd)


def local_attention(q, k, v, *, window, softcap_val=0.0):
    """Sliding-window causal self-attention (Sq == Sk == S).

    Window-sized query chunks; each chunk runs blockwise flash attention
    over [previous chunk, own chunk] with an exact sliding-window mask, so
    the live set is one chunk's flash blocks.
    """
    if is_dtensor(q):   # exact sliding-window attention on the shards
        return _on_shards(q, k, v, True, min(window, q.shape[1]),
                          softcap_val=softcap_val)
    B, S, H, hd = q.shape
    G = k.shape[2]
    W = min(window, S)
    pad = (-S) % W
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
    nc = (S + pad) // W
    qc = q.reshape(B, nc, W, H, hd)
    kc = k.reshape(B, nc, W, G, hd)
    vc = v.reshape(B, nc, W, G, hd)

    bq, bk = min(512, W), min(1024, 2 * W)
    # chunk 0 has no history
    outs = [flash_attention(qc[:, 0], kc[:, 0], vc[:, 0], causal=True,
                            softcap_val=softcap_val, window=W, block_q=bq,
                            block_k=min(1024, W))]
    for c in range(1, nc):
        kk = torch.cat([kc[:, c - 1], kc[:, c]], dim=1)   # [B, 2W, G, hd]
        vv = torch.cat([vc[:, c - 1], vc[:, c]], dim=1)
        # q position i sits at absolute offset W + i within kk
        outs.append(flash_attention(qc[:, c], kk, vv, causal=True,
                                    softcap_val=softcap_val, q_offset=W,
                                    window=W, block_q=bq, block_k=bk))
    out = torch.stack(outs, dim=1).reshape(B, S + pad, H, hd)
    return out[:, :S]


def decode_attention(q, k_cache, v_cache, cache_len, *, softcap_val=0.0):
    """One-token attention against a cache.

    q: [B, 1, H, hd]; k_cache/v_cache: [B, S, G, hd]; cache_len: a Python
    int or a [B] tensor — the number of valid cache positions (q attends
    to all of them; a ring buffer's slots hold its last ``cache_len``
    positions in any order).
    """
    if is_dtensor(k_cache):
        return _decode_on_shards(q, k_cache, v_cache, cache_len,
                                 softcap_val)
    B, _, H, hd = q.shape
    _, S, G, _ = k_cache.shape
    rep = H // G
    qh = (q * rounded(hd ** -0.5, q.dtype)).reshape(B, G, rep, hd)
    s = torch.einsum('bgrd,bkgd->bgrk', qh, k_cache).float()
    s = softcap(s, softcap_val)
    slot = torch.arange(S, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.reshape(-1, 1, 1, 1)
    s = torch.where(slot < cache_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bgrk,bkgd->bgrd', p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def _seq_shard(cache):
    """(offset, length) of this rank's slice of a DTensor cache's sequence
    dim (dim 1), split over the mesh dims that shard it, in order."""
    mesh, n, off = cache.device_mesh, cache.shape[1], 0
    for i, pl in enumerate(cache.placements):
        if pl.is_shard(1):
            n //= mesh.size(i)
            off += mesh.get_local_rank(i) * n
    return off, n


def _decode_on_shards(q, k_cache, v_cache, cache_len, softcap_val):
    """``decode_attention`` of DTensor operands on each rank's cache shard
    as the cache lies (``cache_shardings``: batch, sequence, groups or
    head_dim split over the mesh), without moving the cache: q is laid out
    to match; scores over a split head_dim are summed across its ranks;
    the softmax over a split sequence is combined across its ranks from
    each one's max, sum and weighted values (flash decoding)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, cpl = k_cache.device_mesh, k_cache.placements
    v_cache = v_cache.redistribute(mesh, cpl)
    B, _, H, hd = q.shape
    G = k_cache.shape[2]
    rep = H // G
    # q: [B, 1, H, hd] split like the cache's batch, groups and head_dim
    q = q.redistribute(mesh, [pl if pl.is_shard() and pl.dim != 1
                              else Replicate() for pl in cpl])
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    qh = (ql * rounded(hd ** -0.5, ql.dtype)).reshape(
        ql.shape[0], kl.shape[2], rep, ql.shape[3])
    s = torch.einsum('bgrd,bkgd->bgrk', qh, kl).float()   # [b, g, r, k]

    def across(t, dims, op):
        """``t`` reduced by ``op`` over the mesh dims that shard the
        cache's ``dims``, as a DTensor's Partial made whole."""
        pl = [Partial(op) if p.is_shard() and p.dim in dims else Replicate()
              for p in cpl]
        if all(p.is_replicate() for p in pl):
            return t
        return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
    s = softcap(across(s, (3,), 'sum'), softcap_val)
    off, n = _seq_shard(k_cache)
    slot = off + torch.arange(n, device=s.device)
    s = torch.where(slot < cache_len, s, NEG_INF)
    m = across(s.amax(-1), (1,), 'max')                    # [b, g, r]
    p = torch.exp(s - m[..., None])
    l = across(p.sum(-1), (1,), 'sum')
    o = across(torch.einsum('bgrk,bkgd->bgrd', p.to(vl.dtype), vl).float(),
               (1,), 'sum')
    out = (o / l[..., None]).to(ql.dtype).reshape(ql.shape)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
