"""Flash attention with a block-recomputing backward (the port of
``repro.models.flash_vjp``).

Autograd through the blockwise forward of ``attention.flash_attention``
saves every key/value block's float32 probabilities for the backward.
``flash_mha`` saves only (q, k, v, out, log-sum-exp) and, in the
backward, recomputes each block's scores while it accumulates dq, dk and
dv: the standard flash backward.  As in the forward, the query blocks are
batched and a loop runs over key/value blocks.

Supports GQA and causal/sliding-window masks with a query offset.  Soft-
capping is not supported (``attention.flash_attention`` takes this path
only when ``softcap_val`` is 0).  Masked scores take the finite
``NEG_INF``, so a masked entry's probability exp(-1e30 - lse) is exactly 0
in the backward.
"""

from __future__ import annotations

import torch

from .layers import rounded

NEG_INF = -1e30


def _mask(nq, bq, ki, bk, q_offset, causal, window, device):
    """[nq, bq, bk] bool: which scores of key block ``ki`` every query
    block keeps."""
    qpos = (q_offset + torch.arange(nq, device=device)[:, None, None] * bq
            + torch.arange(bq, device=device)[None, :, None])
    kpos = ki * bk + torch.arange(bk, device=device)
    ok = torch.ones((nq, bq, bk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (qpos - kpos < window)
    return ok


def _blocks(q, k, v, block_q, block_k):
    B, Sq, H, hd = q.shape
    _, Sk, G, _ = k.shape
    nq, nk = Sq // block_q, Sk // block_k
    # the reference's q * hd**-0.5, its scalar taking q's dtype
    qb = (q * rounded(hd ** -0.5, q.dtype)).reshape(
        B, nq, block_q, G, H // G, hd)
    kb = k.reshape(B, nk, block_k, G, hd)
    vb = v.reshape(B, nk, block_k, G, hd)
    return qb, kb, vb


def _flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k):
    """(out [B, Sq, H, hd], lse [B, nq, G, rep, block_q])."""
    B, Sq, H, hd = q.shape
    qb, kb, vb = _blocks(q, k, v, block_q, block_k)
    nq, nk, G, rep = qb.shape[1], kb.shape[1], qb.shape[3], qb.shape[4]
    dev = q.device
    m = torch.full((B, nq, G, rep, block_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nq, block_q, G, rep, hd), dtype=torch.float32,
                      device=dev)
    for ki in range(nk):
        kblk, vblk = kb[:, ki], vb[:, ki]
        s = torch.einsum('bnqgrd,bkgd->bngrqk', qb, kblk).float()
        ok = _mask(nq, block_q, ki, block_k, q_offset, causal, window, dev)
        s = torch.where(ok[None, :, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum('bngrqk,bkgd->bnqgrd', p.to(v.dtype), vblk)
        acc = acc * corr.permute(0, 1, 4, 2, 3)[..., None] + pv.float()
        m = m_new
    out = (acc / l.permute(0, 1, 4, 2, 3)[..., None]).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return out.reshape(B, Sq, H, hd), lse


def _flash_bwd(q, k, v, out, lse, g, causal, window, q_offset, block_q,
               block_k):
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    scale = hd ** -0.5
    qb, kb, vb = _blocks(q, k, v, block_q, block_k)
    nq, nk, rep = qb.shape[1], kb.shape[1], qb.shape[4]
    gb = g.reshape(B, nq, block_q, G, rep, hd)
    ob = out.reshape(B, nq, block_q, G, rep, hd)
    # delta_i = rowsum(dO * O), [B, nq, G, rep, bq]
    delta = (gb.float() * ob.float()).sum(-1).permute(0, 1, 3, 4, 2)
    dev = q.device
    dq = torch.zeros((B, nq, block_q, G, rep, hd), dtype=torch.float32,
                     device=dev)
    dk, dv = [], []
    for ki in range(nk):
        kblk, vblk = kb[:, ki], vb[:, ki]
        s = torch.einsum('bnqgrd,bkgd->bngrqk', qb, kblk).float()
        ok = _mask(nq, block_q, ki, block_k, q_offset, causal, window, dev)
        s = torch.where(ok[None, :, None, None], s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum('bnqgrd,bkgd->bngrqk', gb, vblk).float()
        ds = (p * (dp - delta[..., None])).to(q.dtype)
        dq = dq + torch.einsum('bngrqk,bkgd->bnqgrd', ds,
                               kblk).float() * scale
        # qb already carries the scale, so ds @ q needs none
        dk.append(torch.einsum('bngrqk,bnqgrd->bkgd', ds, qb).float())
        dv.append(torch.einsum('bngrqk,bnqgrd->bkgd', p.to(q.dtype),
                               gb).float())
    return (dq.reshape(B, Sq, H, hd).to(q.dtype),
            torch.cat(dk, dim=1).to(k.dtype), torch.cat(dv, dim=1).to(v.dtype))


class _FlashMHA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, block_q,
                              block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec = (causal, window, q_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g.contiguous(),
                                *ctx.spec)
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q, k, v, causal, window, q_offset, block_q, block_k):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, G, hd] -> [B, Sq, H, hd].  Block
    sizes must divide the sequence lengths (``attention.flash_attention``
    chooses them)."""
    return _FlashMHA.apply(q, k, v, causal, window, q_offset, block_q,
                           block_k)
