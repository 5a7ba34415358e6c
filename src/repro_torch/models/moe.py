"""Token-choice top-k Mixture-of-Experts with sort-based capacity dispatch.

The port of ``repro.models.moe.moe_ffn``: tokens are replicated k ways,
stably sorted by expert id, ranked within their expert segment, and laid
into the ``[E, C, d]`` dispatch buffer; tokens beyond capacity are dropped
(the reference's overflow bin), the router softmax runs in float32, and
the combine weights by the renormalized top-k gate probabilities.

Both data movements are gathers, so their bits do not depend on the order
in which the card runs them: the dispatch reads each expert slot's token
from the sorted order, and the combine inverts the sort to ``[T, k]`` and
sums a token's k contributions along that axis.  (The reference's scatter
``y.at[st].add`` has k destinations per token; ``index_add_`` would sum
them with atomics on the card.)  The expert segments come from
``searchsorted`` on the sorted ids, which, unlike ``bincount``, reads no
size back to the host.
"""

from __future__ import annotations

import torch

from .layers import activation


def moe_ffn(x, router_w, w_in, w_gate, w_out, *, top_k, capacity_factor):
    """x: [B, S, d] -> ([B, S, d], router probabilities [T, E]).

    router_w: [d, E]; w_in/w_gate: [E, d, ff]; w_out: [E, ff, d].
    """
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S
    n = T * top_k
    dev = x.device
    xt = x.reshape(T, d)

    gates = xt.float() @ router_w.float()
    probs = torch.softmax(gates, dim=-1)                       # [T, E]
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    C = int(capacity_factor * T * top_k / E)
    C = max(8, min(C, T))

    # --- dispatch: replicate k ways, sort by expert, rank within expert ---
    order = torch.argsort(top_e.reshape(-1), stable=True)      # [T*k]
    se = top_e.reshape(-1)[order]
    st = order // top_k                                        # token id
    sp = top_p.reshape(-1)[order]
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(se, experts)                # [E]
    counts = torch.searchsorted(se, experts, right=True) - seg_start
    rank = torch.arange(n, device=dev) - seg_start[se]         # rank in expert
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)             # overflow bin

    cap = torch.arange(C, device=dev)
    src = (seg_start[:, None] + cap).clamp(max=n - 1)          # [E, C]
    filled = (cap < counts[:, None])[..., None]
    disp = torch.where(filled, xt[st[src]], 0)                 # [E, C, d]

    # --- expert FFN (batched over the expert axis) ---
    h = torch.bmm(disp, w_in.to(x.dtype))
    g = None if w_gate is None else torch.bmm(disp, w_gate.to(x.dtype))
    out_e = torch.bmm(activation(h, g), w_out.to(x.dtype))

    # --- combine: back to token order, weight by gate prob, sum over k ---
    flat_out = out_e.reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           flat_out[slot.clamp(max=E * C - 1)], 0)
    contrib = gathered.float() * sp[:, None] * keep[:, None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dev))
    y = contrib[inv].reshape(T, top_k, d).sum(1)
    return y.to(x.dtype).reshape(B, S, d), probs
