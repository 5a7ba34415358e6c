"""AdamW with optional int8 block-quantized moments (the port of
``repro.optim.adamw``).

Every moment tensor has its parameter's shape.  ``state_dtype='int8'``
stores m and v as int8 with float32 scales per block of 128 along the last
axis (padded to whole blocks), which is what lets arctic-480b's state fit:
4 + 1 + 1 bytes a parameter instead of 4 + 4 + 4.

``adamw_update`` writes the new parameters and moments into the tensors it
is given, under ``torch.no_grad()``, and returns the same trees: a
functional copy would hold a second set of parameters and moments at the
peak (~16 GB more for gemma3-1b), where the reference's jitted step
donates its inputs.  Clone a state to update it twice.  Nothing is read
back to the host: the step count, the bias corrections and the clip scale
stay on the parameters' device.

On DTensor parameters (a mesh) the update runs through DTensor's
sharding propagation, and each moment keeps its own placements (for int8,
``opt_shardings``' placements of the ``QTensor`` fields).  The int8 block
quantization runs on each rank's rows with the blocked (last) dim made
whole first, so it gives the unsharded result on a sharded leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.shard_utils import is_dtensor, mesh_context
from ..models.transformer import tree_leaves, tree_map

BLOCK = 128


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def _pad_to_block(x):
    n = x.shape[-1]
    pad = (-n) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x, n


def quantize_i8(x):
    """x -> (int8 values [..., n_blocks, 128], float32 scales
    [..., n_blocks, 1], the last axis' length).  The scale is a block's
    max |x| / 127 (at least 1e-12); values round half to even, as
    ``jnp.round`` does."""
    xp, n = _pad_to_block(x.float())
    blocks = xp.reshape(*xp.shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_i8(q, scale, n):
    x = (q.float() * scale).reshape(*q.shape[:-2], -1)
    return x[..., :n]


def _by_rows(fn, lead: int, *xs):
    """``fn`` of the local tensors of DTensors ``xs`` redistributed so that
    only their first ``lead`` dims stay sharded; its results DTensors with
    those placements.  The block quantization works along the trailing
    dims only, so a rank whose trailing dims are whole quantizes its own
    rows exactly as the unsharded leaf would be (a plain ``xs``:
    ``fn(*xs)``)."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = xs[0].device_mesh
    pl = [p if p.is_shard() and p.dim < lead else Replicate()
          for p in xs[0].placements]
    out = fn(*(x.redistribute(mesh, pl).to_local() for x in xs))
    return tuple(DTensor.from_local(t, mesh, pl, run_check=False)
                 if isinstance(t, torch.Tensor) else t for t in out)


class QTensor(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, state_dtype: str = 'float32'):
    """``{'m', 'v'}`` zero moments shaped like ``params`` (``QTensor``
    leaves for ``'int8'``) and an int32 ``count`` of 0, on the device of
    the parameters."""
    def zero_like(p):   # a DTensor's moments take its placements
        z = torch.zeros_like(p, dtype=torch.float32)
        if state_dtype == 'int8':
            q, s, _ = _by_rows(quantize_i8, z.ndim - 1, z)
            return QTensor(q=q, scale=s)
        return z
    dev = tree_leaves(params)[0][1].device
    return {'m': tree_map(zero_like, params),
            'v': tree_map(zero_like, params),
            'count': torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed in the reference's order (sorted keys)."""
    return torch.sqrt(sum(g.float().square().sum()
                          for _, g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state, params, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 state_dtype: str = 'float32'):
    """One AdamW step with global-norm clipping, decay on >= 2-D weights
    only, and bias corrections from the float32 step count.  Writes into
    ``params`` and ``state`` and returns ``(params, state, {'grad_norm'})``.
    """
    with mesh_context(params):
        return _update(grads, state, params, lr, b1, b2, eps, weight_decay,
                       clip_norm, state_dtype)


def _update(grads, state, params, lr, b1, b2, eps, weight_decay, clip_norm,
            state_dtype):
    count = state['count'].add_(1)
    c = count.float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    gn = global_norm(grads)
    scale = torch.clamp(clip_norm / gn.clamp_min(1e-12), max=1.0)
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state['m']))
    flat_v = dict(tree_leaves(state['v']))
    for path, p in tree_leaves(params):
        g = flat_g[path].float() * scale
        m, v = flat_m[path], flat_v[path]
        if state_dtype == 'int8':
            n = p.shape[-1]
            (m_f,), (v_f,) = (
                _by_rows(lambda q, s: (dequantize_i8(q, s, n),),
                         qt.q.ndim - 2, qt.q, qt.scale) for qt in (m, v))
        else:
            m_f, v_f = m, v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g.square()
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps)
        if p.ndim > 1:  # no decay on norms/bias vectors
            upd = upd + weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        if state_dtype == 'int8':
            for qt, x in ((m, m_f), (v, v_f)):
                q, s, _ = _by_rows(quantize_i8, x.ndim - 1, x)
                qt.q.copy_(q)
                qt.scale.copy_(s)
        else:
            m.copy_(m_f)
            v.copy_(v_f)
    return params, state, {'grad_norm': gn}
