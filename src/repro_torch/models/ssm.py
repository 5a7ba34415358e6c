"""Selective state-space layers (Mamba-1 and Mamba-2) with chunked scans.

The port of ``repro.models.ssm``.  The diagonal recurrence
h_t = a_t * h_{t-1} + b_t is evaluated chunk by chunk: a loop carries the
state across chunks, and each chunk is solved by a log-step
(Hillis-Steele) scan with the reference's ``combine``.  torch has no
``associative_scan``; the log-step scan rounds in another order than the
reference's, so tests hold the two to a tolerance.  Only one chunk's
state-update tensors live at a time (Mamba-1: ``[B, chunk, d_inner,
N]``).

Decode is the single-step recurrence (``S == 1``, no scan).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .shard_utils import matmul


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _scan_chunk(la, b):
    """Inclusive scan of (la, b) along axis 1 under
    combine((la1, b1), (la2, b2)) = (la1 + la2, exp(la2) * b1 + b2)."""
    off = 1
    while off < la.shape[1]:
        la, b = (torch.cat([la[:, :off], la[:, :-off] + la[:, off:]], 1),
                 torch.cat([b[:, :off],
                            torch.exp(la[:, off:]) * b[:, :-off]
                            + b[:, off:]], 1))
        off *= 2
    return la, b


def chunked_diag_scan(log_a, b, h0, chunk: int = 64):
    """h_t = exp(log_a_t) * h_{t-1} + b_t along axis 1.

    log_a, b: [B, S, *state]; h0: [B, *state].  Returns (h_all [B,S,*state],
    h_last).  S must be a multiple of ``chunk`` (caller pads).
    """
    S = b.shape[1]
    if S % chunk:
        raise ValueError(f'sequence {S} is not a multiple of chunk {chunk}')
    h, outs = h0, []
    for c0 in range(0, S, chunk):
        la_acc, b_acc = _scan_chunk(log_a[:, c0:c0 + chunk],
                                    b[:, c0:c0 + chunk])
        h_all = torch.exp(la_acc) * h[:, None] + b_acc
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, 1), h


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: [B, S, d]; w: [K, d].

    state: [B, K-1, d] trailing context (decode); returns (y, new_state).
    """
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, d_inner]
    h: torch.Tensor      # mamba1: [B, d_inner, N]; mamba2: [B, H, N, P]


def _chunks(arr, S, C):
    """The chunks of ``arr`` [B, S, ...] along axis 1, the last one
    zero-padded to C."""
    pad = -S % C
    if pad:
        arr = F.pad(arr, (0, 0) * (arr.ndim - 2) + (0, pad))
    return [arr[:, c0:c0 + C] for c0 in range(0, S + pad, C)]


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba): per-channel diagonal A [d_inner, N]
# ---------------------------------------------------------------------------

def mamba1_forward(x, p, cfg, state: MambaState | None = None, chunk=64,
                   reduce=None):
    """x: [B, S, d_model].  p: parameter dict.  Returns (y, new_state).

    The [B, S, d_inner, N] state-update tensors are formed one chunk at a
    time, never for the whole sequence.  ``reduce``: None, or the sum over
    the ranks that each hold a share of the channels (``p`` and ``state``
    then hold this rank's share, :func:`channel_layout`): it completes
    ``x_proj``'s contraction over the channels, and the output is this
    rank's part of ``out_proj``'s sum.
    """
    B, S, _ = x.shape
    d_in = p['conv_w'].shape[-1]     # this rank's channels
    N = cfg.ssm_state
    xz = matmul(x, p['in_proj'].to(x.dtype))
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xs, conv_state = causal_conv1d(
        xs, p['conv_w'].to(x.dtype), None if state is None else state.conv)
    xs = F.silu(xs.float()).to(x.dtype)

    proj = matmul(xs, p['x_proj'].to(x.dtype))
    if reduce is not None:
        proj = reduce(proj)
    r = cfg.dt_rank
    dt, Bc, Cc = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = matmul(dt, p['dt_proj'].to(x.dtype))
    dt = _softplus(dt.float() + p['dt_bias'].float())
    A = -torch.exp(p['A_log'].float())                   # [d_in, N]
    h0 = (x.new_zeros((B, d_in, N), dtype=torch.float32)
          if state is None else state.h.float())

    if S == 1:  # decode fast path: one recurrence step, no scan
        la = dt[:, 0, :, None] * A
        b = (dt[:, 0, :, None] * Bc[:, 0, None, :]
             * xs[:, 0, :, None].float())
        h = torch.exp(la) * h0 + b
        y = torch.einsum('bdn,bn->bd', h, Cc[:, 0].float())
        y = (y + xs[:, 0].float() * p['D'].float())[:, None]
        h_last = h
    else:
        C = min(chunk, S)
        h, ys = h0, []
        for dt_c, B_c, C_c, x_c in zip(*(_chunks(a, S, C)
                                         for a in (dt, Bc, Cc, xs))):
            la = dt_c[..., None] * A                      # [B, C, d, N]
            b = (dt_c[..., None] * B_c[:, :, None, :].float()
                 * x_c[..., None].float())
            la_acc, b_acc = _scan_chunk(la, b)
            h_all = torch.exp(la_acc) * h[:, None] + b_acc
            ys.append(torch.einsum('bcdn,bcn->bcd', h_all, C_c.float()))
            h = h_all[:, -1]
        h_last = h
        y = torch.cat(ys, 1)[:, :S]
        y = y + xs.float() * p['D'].float()
    y = y * F.silu(z.float())
    out = matmul(y.to(x.dtype), p['out_proj'].to(x.dtype))
    return out, MambaState(conv=conv_state, h=h_last.float())


# ---------------------------------------------------------------------------
# Mamba-2 (zamba2): scalar A per head, state [H, N, P]
# ---------------------------------------------------------------------------

def mamba2_forward(x, p, cfg, state: MambaState | None = None, chunk=64,
                   reduce=None):
    """Mamba-2 via the SSD chunked-matmul algorithm: within a chunk the
    scalar-per-head decay makes the solution a decay-masked attention
    product, so the [B, S, H, N, P] state tensor is never formed.
    ``reduce``: as in :func:`mamba1_forward` (a rank's share is its heads;
    ``reduce`` completes the gated norm's sum of squares)."""
    B, S, _ = x.shape
    N = cfg.ssm_state
    P = cfg.ssm_head_p
    H = p['A_log'].shape[0]          # this rank's heads
    d_in = H * P
    zxbcdt = matmul(x, p['in_proj'].to(x.dtype))
    z, xs, Bc, Cc, dt = torch.tensor_split(
        zxbcdt, [d_in, 2 * d_in, 2 * d_in + N, 2 * d_in + 2 * N], dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out, conv_state = causal_conv1d(
        conv_in, p['conv_w'].to(x.dtype),
        None if state is None else state.conv)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xs, Bc, Cc = torch.tensor_split(conv_out, [d_in, d_in + N], dim=-1)

    dt = _softplus(dt.float() + p['dt_bias'].float())    # [B, S, H]
    A = -torch.exp(p['A_log'].float())                   # [H]
    xh = xs.reshape(B, S, H, P)
    h0 = (x.new_zeros((B, H, N, P), dtype=torch.float32)
          if state is None else state.h.float())

    if S == 1:  # decode fast path
        la = (dt[:, 0] * A)[:, :, None, None]            # [B, H, 1, 1]
        b = (dt[:, 0, :, None, None]
             * Bc[:, 0, None, :, None].float()
             * xh[:, 0, :, None, :].float())
        h = torch.exp(la) * h0 + b
        y = torch.einsum('bhnp,bn->bhp', h, Cc[:, 0].float())
        y = y[:, None] + xh.float() * p['D'].float()[..., None]
        h_last = h
    else:
        C = min(chunk, S)
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                    device=x.device))
        h, ys = h0, []
        for dt_c, B_c, C_c, x_c in zip(*(_chunks(a, S, C)
                                         for a in (dt, Bc, Cc, xh))):
            Bf, Cf, xf = B_c.float(), C_c.float(), x_c.float()
            la = dt_c * A                               # [B, C, H] (<= 0)
            cum = torch.cumsum(la, dim=1)               # [B, C, H]
            # intra-chunk: decay-masked attention over positions
            seg = cum[:, :, None, :] - cum[:, None, :, :]   # [B, i, j, H]
            decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
            cb = torch.einsum('bin,bjn->bij', Cf, Bf)
            scores = cb[..., None] * decay * dt_c[:, None, :, :]
            y_c = torch.einsum('bijh,bjhp->bihp', scores, xf)
            # inter-chunk: contribution of the carried state
            y_c = y_c + (torch.exp(cum)[..., None]
                         * torch.einsum('bin,bhnp->bihp', Cf, h))
            # state update for the next chunk
            w = torch.exp(cum[:, -1:, :] - cum) * dt_c  # [B, C, H]
            h = (torch.exp(cum[:, -1])[:, :, None, None] * h
                 + torch.einsum('bjh,bjn,bjhp->bhnp', w, Bf, xf))
            ys.append(y_c)
        h_last = h
        y = torch.cat(ys, 1)[:, :S]
        y = y + xh.float() * p['D'].float()[..., None]
    y = y.reshape(B, S, d_in)
    y = y * F.silu(z.float())
    y = y.to(x.dtype)
    # grouped RMSNorm before out_proj (mamba2 convention)
    yf = y.float()
    if reduce is None:
        var = yf.square().mean(-1, keepdim=True)
    else:
        var = reduce(yf.square().sum(-1, keepdim=True)) / cfg.d_inner
    y = (yf * torch.rsqrt(var + 1e-6)
         * (1 + p['norm_w'].float())).to(x.dtype)
    out = matmul(y, p['out_proj'].to(x.dtype))
    return out, MambaState(conv=conv_state, h=h_last.float())


def channel_layout(cfg, kind: str, r: int, m: int):
    """Rank ``r`` of ``m``'s share of a mamba block's channels (Mamba-2:
    its heads), as ``(params, state)``: ``{name: (dim, ranges)}`` with the
    (start, stop) ranges of each parameter along ``dim`` that the rank
    uses, in the order of the whole, and ``{leaf: (dim, ranges)}`` for the
    recurrent state.  ``in_proj`` interleaves its outputs (Mamba-1: x, z;
    Mamba-2: z, x, B, C, dt), so a rank's columns are one range of each
    per-channel part, and Mamba-2's B and C (shared by every head) go to
    every rank whole, in ``in_proj``, ``conv_w`` and the conv state."""
    d_in, N = cfg.d_inner, cfg.ssm_state
    if kind == 'mamba1':
        c = d_in // m
        own = [(r * c, (r + 1) * c)]
        params = dict(in_proj=(1, own + [(d_in + r * c, d_in + (r + 1) * c)]),
                      conv_w=(1, own), x_proj=(0, own), dt_proj=(1, own),
                      dt_bias=(0, own), A_log=(0, own), D=(0, own),
                      out_proj=(0, own))
        return params, dict(conv=(2, own), h=(1, own))
    hr = cfg.ssm_heads // m
    c = hr * cfg.ssm_head_p
    own, heads = [(r * c, (r + 1) * c)], [(r * hr, (r + 1) * hr)]
    bc = [(d_in, d_in + 2 * N)]
    dt = 2 * d_in + 2 * N
    params = dict(in_proj=(1, own + [(d_in + r * c, d_in + (r + 1) * c),
                                     (2 * d_in, dt),
                                     (dt + r * hr, dt + (r + 1) * hr)]),
                  conv_w=(1, own + bc), dt_bias=(0, heads),
                  A_log=(0, heads), D=(0, heads), norm_w=(0, own),
                  out_proj=(0, own))
    return params, dict(conv=(2, own + bc), h=(1, heads))


def splits_channels(cfg, kind: str, m: int) -> bool:
    """Whether ``m`` ranks can each take an equal share of the block's
    channels (Mamba-2: of its heads)."""
    return (cfg.d_inner if kind == 'mamba1' else cfg.ssm_heads) % m == 0


def mamba_param_shapes(cfg, kind: str):
    """Parameter name -> shape for one mamba block."""
    d, d_in, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    K = cfg.ssm_conv
    if kind == 'mamba1':
        return {
            'in_proj': (d, 2 * d_in),
            'conv_w': (K, d_in),
            'x_proj': (d_in, cfg.dt_rank + 2 * N),
            'dt_proj': (cfg.dt_rank, d_in),
            'dt_bias': (d_in,),
            'A_log': (d_in, N),
            'D': (d_in,),
            'out_proj': (d_in, d),
        }
    H = cfg.ssm_heads
    return {
        'in_proj': (d, 2 * d_in + 2 * N + H),
        'conv_w': (K, d_in + 2 * N),
        'dt_bias': (H,),
        'A_log': (H,),
        'D': (H,),
        'norm_w': (d_in,),
        'out_proj': (d_in, d),
    }
