"""Attention (torch ops): the port of ``repro.models.attention``' forward.

- ``flash_attention``: blockwise online-softmax attention, the query
  blocks batched, a loop over key/value blocks; the ``[Sq, Sk]`` score
  matrix is never formed whole.
- ``local_attention``: sliding-window attention over window-sized query
  chunks, each against its own and the previous chunk (O(S * 2W)).
- ``decode_attention``: one query position against a (possibly
  ring-buffered) KV cache.

All support GQA (n_kv <= n_heads), RoPE applied by the caller, optional
logit soft-capping, and float32 softmax accumulation.  Masked scores take
the finite ``NEG_INF``: with ``-inf`` a block whose every score is masked
would give NaN in the online softmax.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .layers import softcap

NEG_INF = -1e30


def _divisor_block(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (block size selection)."""
    b = min(target, s)
    while s % b:
        b -= 1
    return b


@lru_cache(maxsize=64)
def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies by a Python
    scalar cast to the activation dtype, while torch would keep it in
    float32 for a bfloat16 tensor."""
    return torch.tensor(value, dtype=dtype).item()


def flash_attention(q, k, v, *, causal=True, softcap_val=0.0,
                    q_offset=0, block_q=512, block_k=1024, window=0):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, G, hd].  Returns [B, Sq, H, hd].

    ``q_offset``: absolute position of q[0] relative to k[0] (for
    cross-chunk prefill; 0 for self-attention from the start).
    ``window``: if > 0, restrict to kpos > qpos - window (sliding window).
    """
    B, Sq, H, hd = q.shape
    _, Sk, G, _ = k.shape
    rep = H // G
    block_q = _divisor_block(Sq, block_q)
    block_k = _divisor_block(Sk, block_k)
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
