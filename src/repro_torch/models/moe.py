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

Under a mesh the expert axis of ``w_in/w_gate/w_out`` shards over
``model`` (expert parallelism), and ``_constrain`` pins the dispatch and
expert buffers to experts over ``model``, capacity over ``data``, at the
reference's three sites; the routing and the two gathers run on every
rank over the whole token set.
"""

from __future__ import annotations

import torch

from .layers import activation
from .shard_utils import (batch_layout, constrain, is_dtensor, matmul,
                          replicated_on, whole)


def _constrain(x, *axes):
    """The reference's sharding constraint (``shard_utils.constrain``)."""
    return constrain(x, *axes)


def _route(top_e, E: int, C: int):
    """The dispatch plan from the top-k expert ids ``[T, k]``: the sort
    order of the T*k (token, choice) pairs by expert, the sorted experts,
    their tokens, each expert's segment start and count, whether each
    sorted pair fits its expert's capacity C, its slot in the [E*C]
    buffer (E*C for the overflow bin), the sorted pair that fills each
    [E, C] slot, whether that slot is filled, and the inverse order."""
    top_k = top_e.shape[-1]
    n = top_e.numel()
    dev = top_e.device
    order = torch.argsort(top_e.reshape(-1), stable=True)      # [T*k]
    se = top_e.reshape(-1)[order]
    st = order // top_k                                        # token id
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(se, experts)                # [E]
    counts = torch.searchsorted(se, experts, right=True) - seg_start
    rank = torch.arange(n, device=dev) - seg_start[se]         # rank in expert
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)             # overflow bin
    cap = torch.arange(C, device=dev)
    src = (seg_start[:, None] + cap).clamp(max=n - 1)          # [E, C]
    filled = (cap < counts[:, None])[..., None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dev))
    return order, st[src], keep, slot, filled, inv


def moe_ffn(x, router_w, w_in, w_gate, w_out, *, top_k, capacity_factor):
    """x: [B, S, d] -> ([B, S, d], router probabilities [T, E]).

    router_w: [d, E]; w_in/w_gate: [E, d, ff]; w_out: [E, ff, d].
    """
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S
    xt = x.reshape(T, d)
    gates = matmul(xt.float(), router_w.float())
    mesh = xt.device_mesh if is_dtensor(xt) else None
    if mesh is not None:
        # the routing, dispatch and combine index the whole token set
        # (argsort, searchsorted, scatter_ and these gathers have no
        # DTensor rule that keeps the tokens split): on a mesh every rank
        # runs them on the whole tokens and expert outputs, as plain
        # tensors; the expert FFNs stay sharded
        xt, gates = whole(xt), whole(gates)
    probs = torch.softmax(gates, dim=-1)                       # [T, E]
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    C = int(capacity_factor * T * top_k / E)
    C = max(8, min(C, T))

    # --- dispatch: replicate k ways, sort by expert, rank within expert ---
    order, tok, keep, slot, filled, inv = _route(top_e, E, C)
    sp = top_p.reshape(-1)[order]
    disp = torch.where(filled, xt[tok], 0)                     # [E, C, d]
    if mesh is not None:
        disp = replicated_on(mesh, disp)
    # dispatch/expert-compute buffers: experts over 'model' (EP), capacity
    # over 'data'
    disp = _constrain(disp, 'model', 'data', None)

    # --- expert FFN (batched over the expert axis) ---
    h = torch.bmm(disp, w_in.to(x.dtype))
    g = None if w_gate is None else torch.bmm(disp, w_gate.to(x.dtype))
    h = _constrain(activation(h, g), 'model', 'data', None)
    out_e = _constrain(torch.bmm(h, w_out.to(x.dtype)), 'model', 'data',
                       None)
    if mesh is not None:
        out_e = whole(out_e)

    # --- combine: back to token order, weight by gate prob, sum over k ---
    flat_out = out_e.reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           flat_out[slot.clamp(max=E * C - 1)], 0)
    contrib = gathered.float() * sp[:, None] * keep[:, None]
    y = contrib[inv].reshape(T, top_k, d).sum(1).to(x.dtype)
    if mesh is not None:    # each rank keeps its own tokens
        y, probs = (batch_layout(replicated_on(mesh, t)) for t in (y, probs))
    return y.reshape(B, S, d), probs


def load_balance_loss(probs, top_e, n_experts):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e, with f_e the share
    of tokens whose first choice is expert e and P_e the mean router
    probability of e.  probs: [T, E]; top_e: [T, k]."""
    f = torch.nn.functional.one_hot(top_e[:, 0], n_experts).float().mean(0)
    return n_experts * (f * probs.mean(0)).sum()
