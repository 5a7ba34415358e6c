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

Under a mesh (:func:`_moe_on_mesh`) the experts shard over 'model' and
each expert's capacity over the data axes, the reference's layout for its
dispatch buffer (``_constrain(disp, 'model', 'data', None)``), and each
rank routes its own tokens.  The tokens' global order makes the ranks'
rows contiguous, so the per-expert counts of every data rank (an
all-gather of ``[E]``) give each (token, choice) pair its rank within its
expert in the reference's stable order, and the capacity drops are
exactly the reference's.  The kept pairs travel to the rank that owns
their expert and capacity slot and back with ``all_to_all_single`` over
the data axes (XLA's all-to-alls at the dispatch and combine boundaries);
the tokens of a data rank are on every 'model' rank already, so the
dispatch needs no exchange over 'model': each rank takes its own experts'
pairs, and the combine's sum over the experts is partial over 'model'.
"""

from __future__ import annotations

import torch

from .layers import activation
from .shard_utils import (all_gather, batch_layout, constrain,
                          exchange, flat_rank, grad_on_first, is_dtensor, local_part,
                          matmul, model_dim, on_rows, replicated_on,
                          row_dims, rows_out, whole)


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
    C = max(8, min(int(capacity_factor * T * top_k / E), T))
    if is_dtensor(x) and _expert_parallel(batch_layout(x), w_in, C):
        return _moe_on_mesh(batch_layout(x), router_w, w_in, w_gate, w_out,
                            top_k, C)[:2]
    xt = x.reshape(T, d)
    gates = matmul(xt.float(), router_w.float())
    mesh = xt.device_mesh if is_dtensor(xt) else None
    if mesh is not None:
        # the experts do not split over 'model', or an expert's capacity
        # not over the data axes (decode: the reference keeps such a
        # buffer whole too, and its few tokens cost less than moving the
        # expert weights): argsort, searchsorted, scatter_ and the
        # dispatch gathers have no DTensor rule that keeps the tokens
        # split, so every rank routes the whole token set, as plain
        # tensors; the expert FFNs stay sharded
        xt, gates = whole(xt), whole(gates)
    probs = torch.softmax(gates, dim=-1)                       # [T, E]
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

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


def _expert_parallel(x, w_in, C: int) -> bool:
    """Whether :func:`_moe_on_mesh` runs ``x`` (batch layout): the mesh
    has a 'model' dim that splits the experts of ``w_in`` evenly, and an
    expert's capacity ``C`` splits evenly over the data dims that split
    the rows."""
    mesh = x.device_mesh
    mi = model_dim(mesh)
    n = 1
    for i in row_dims(x):
        n *= mesh.size(i)
    return (mi is not None and is_dtensor(w_in)
            and w_in.shape[0] % mesh.size(mi) == 0 and C % n == 0)


def _moe_on_mesh(x, router_w, w_in, w_gate, w_out, top_k, C):
    """``moe_ffn`` of the batch-layout DTensor ``x`` with experts over
    'model' and each expert's C slots over the data dims that split the
    rows (see the module docstring).  Returns ([B, S, d], probs [T, E],
    kept [T, k]), DTensors of each rank's rows."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    mesh = x.device_mesh
    mi, rows = model_dim(mesh), row_dims(x)
    m, r = mesh.size(mi), mesh.get_local_rank(mi)
    n, g = 1, flat_rank(mesh, rows)
    for i in rows:
        n *= mesh.size(i)
    Em, Cn = E // m, C // n
    e0 = r * Em
    xt = on_rows(x, mi)
    T_l = xt.shape[0] * S
    xt = xt.reshape(T_l, d)
    dev = xt.device

    # --- route this rank's tokens (every 'model' rank alike) ---
    probs = torch.softmax(
        xt.float() @ local_part(router_w, rows, mi).float(), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    n_pairs = T_l * top_k
    order = torch.argsort(top_e.reshape(-1), stable=True)
    se = top_e.reshape(-1)[order]
    st = order // top_k
    sp = top_p.reshape(-1)[order]
    experts = torch.arange(E, device=dev)
    seg = torch.searchsorted(se, experts)                      # [E]
    counts = torch.searchsorted(se, experts, right=True) - seg
    # every data rank's counts: a pair's rank in its expert, globally
    every = all_gather(counts, mesh, rows).reshape(n, E)
    ends = torch.cumsum(every, 0)                              # [n, E]
    base = ends[g] - counts
    grank = base[se] + torch.arange(n_pairs, device=dev) - seg[se]
    keep = grank < C

    # --- dispatch: this rank's pairs of its experts, at their global
    # slots [Em, C]; slot block j goes to data rank j ---
    mine = slice(e0, e0 + Em)
    slot = torch.arange(C, device=dev)
    lr = slot - base[mine, None]                               # [Em, C]
    here = (lr >= 0) & (lr < counts[mine, None])
    src = (seg[mine, None] + lr).clamp(0, n_pairs - 1)
    send = torch.where(here[..., None], xt[st[src]], 0)        # [Em, C, d]
    got = exchange(send.reshape(Em, n, Cn, d).transpose(0, 1), mesh, rows)
    disp = got.sum(0)    # [Em, Cn, d]: one data rank fills each slot

    # --- expert FFN on this rank's experts and slots ---
    def part(w):
        return local_part(w, rows, mi, 0, [(e0, e0 + Em)]).to(x.dtype)
    h = torch.bmm(disp, part(w_in))
    gt = None if w_gate is None else torch.bmm(disp, part(w_gate))
    out_e = torch.bmm(activation(h, gt), part(w_out))          # [Em, Cn, d]

    # --- back to the data ranks whose pairs filled the slots ---
    gslot = g * Cn + torch.arange(Cn, device=dev)
    owner = torch.searchsorted(ends[:, mine].T.contiguous(),
                               gslot.expand(Em, Cn).contiguous(),
                               right=True)                     # [Em, Cn]
    to = torch.arange(n, device=dev)[:, None, None] == owner
    back = exchange(torch.where(to[..., None], out_e, 0), mesh, rows)
    flat_out = back.transpose(0, 1).reshape(Em, C, d)

    # --- combine: this rank's experts' part of each token's sum ---
    ours = keep & (se >= e0) & (se < e0 + Em)
    gathered = torch.where(ours[:, None], flat_out[
        (se - e0).clamp(0, Em - 1), grank.clamp(0, C - 1)], 0)
    contrib = gathered.float() * sp[:, None] * ours[:, None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_pairs, device=dev))
    y = contrib[inv].reshape(T_l, top_k, d).sum(1)
    y = rows_out(y.reshape(-1, S, d), mesh, x.placements, mi, partial=True)
    y = y.redistribute(mesh, x.placements).to(x.dtype)
    # the probabilities are alike on every 'model' rank, and the router's
    # gradients are summed over 'model': one rank hands theirs on
    probs = rows_out(grad_on_first(probs, mesh, [mi]), mesh,
                     x.placements, mi)
    kept = rows_out(keep[inv].reshape(T_l, top_k), mesh, x.placements, mi)
    return y, probs, kept


def load_balance_loss(probs, top_e, n_experts):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e, with f_e the share
    of tokens whose first choice is expert e and P_e the mean router
    probability of e.  probs: [T, E]; top_e: [T, k]."""
    f = torch.nn.functional.one_hot(top_e[:, 0], n_experts).float().mean(0)
    return n_experts * (f * probs.mean(0)).sum()
