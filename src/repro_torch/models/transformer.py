"""Unified transformer stack covering all ten architectures (the port of
``repro.models.transformer``: parameters, the forward with optional
rematerialization, the training loss, prefill and KV-cache decode).

- **Groups.** The per-layer heterogeneity (local/global alternation,
  cross-attention cadence, MoE-every-layer, mamba backbones) is a
  repeating ``pattern`` (period P).  Parameters are stacked
  ``[n_groups, ...]`` per position of the period, and a loop over groups
  applies the P sub-blocks of each; ``n_layers % P`` tail layers follow.
  Parameter paths equal the reference's pytree paths
  (``groups.sub0.wq``, ``tail.tail1.ln1``, ``shared_attn.*``,
  ``encoder.groups.*``).
- **Hybrid (zamba2)**: each group applies P mamba blocks then the
  *shared* attention block (one weight set; one KV cache per
  application).
- **Decode caches**: global attention -> full-length cache; local
  attention -> ring buffer of window size; mamba -> recurrent state;
  cross-attention -> precomputed encoder/frontend KV.  ``decode_step``
  writes each step into its cache's buffers in place (the reference
  donates the cache to its jitted step), so it consumes its cache.
- **Remat.** ``forward(..., remat=True)`` (what ``train_loss`` runs)
  recomputes each stacked group, the hybrid's shared block included, in
  the backward (``torch.utils.checkpoint``); tail layers and the encoder
  keep their activations, as in the reference.
- **Precision.** Master weights are float32; ``cast_for_compute`` casts
  the >= 2-D ones to the compute dtype and leaves already-cast weights as
  they are, so a caller casts once and every later call is free.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.snap import resolve_device
from .attention import decode_attention, flash_attention, local_attention
from .config import ModelConfig
from .layers import (chunked_lm_loss, embed, mlp, rms_norm, rope, rounded,
                     unembed)
from .moe import moe_ffn
from .shard_utils import (batch_layout, is_dtensor, matmul, mesh_context,
                          model_dim, on_batch_rows, on_channel_shards, pin,
                          reshard, unflatten_last, whole_dims)
from .ssm import (MambaState, channel_layout, mamba1_forward,
                  mamba2_forward, mamba_param_shapes, splits_channels)

# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, H, G, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {'wq': (d, H, hd), 'wk': (d, G, hd), 'wv': (d, G, hd),
            'wo': (H, hd, d)}


def _mlp_shapes(cfg: ModelConfig, ff: int) -> Dict[str, tuple]:
    d = cfg.d_model
    s = {'w_in': (d, ff), 'w_out': (ff, d)}
    if cfg.gated_mlp:
        s['w_gate'] = (d, ff)
    return s


def _block_shapes(cfg: ModelConfig, tag: str) -> Dict[str, tuple]:
    d = cfg.d_model
    s: Dict[str, tuple] = {'ln1': (d,)}
    if tag in ('global', 'local', 'enc'):
        s.update(_attn_shapes(cfg))
        s['ln2'] = (d,)
        s.update(_mlp_shapes(cfg, cfg.d_ff))
    elif tag == 'cross':
        # cross-attention block (vision/audio): cross-attn + MLP
        s.update({f'x{k}': v for k, v in _attn_shapes(cfg).items()})
        s['ln2'] = (d,)
        s.update(_mlp_shapes(cfg, cfg.d_ff))
    elif tag == 'cross_dec':
        # enc-dec decoder layer: self-attn + cross-attn + MLP
        s.update(_attn_shapes(cfg))
        s['lnx'] = (d,)
        s.update({f'x{k}': v for k, v in _attn_shapes(cfg).items()})
        s['ln2'] = (d,)
        s.update(_mlp_shapes(cfg, cfg.d_ff))
    elif tag == 'moe':
        s.update(_attn_shapes(cfg))
        s['ln2'] = (d,)
        E, ff = cfg.n_experts, cfg.d_ff
        s.update({'router': (d, E), 'e_in': (E, d, ff),
                  'e_out': (E, ff, d)})
        if cfg.gated_mlp:
            s['e_gate'] = (E, d, ff)
        if cfg.dense_ff:
            s.update({f'r_{k}': v
                      for k, v in _mlp_shapes(cfg, cfg.dense_ff).items()})
    elif tag in ('mamba1', 'mamba2'):
        s.update(mamba_param_shapes(cfg, tag))
    else:
        raise ValueError(tag)
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes: the same nested dict as
    ``init_params`` gives, with a shape tuple at each leaf."""
    n_groups = cfg.n_layers // cfg.period

    def stacked(shapes, n):
        return {k: (n,) + v for k, v in shapes.items()}

    tree: Dict[str, Any] = {'embed': (cfg.vocab, cfg.d_model),
                            'final_ln': (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree['unembed'] = (cfg.vocab, cfg.d_model)
    tree['groups'] = {f'sub{i}': stacked(_block_shapes(cfg, tag), n_groups)
                      for i, tag in enumerate(cfg.pattern)}
    n_tail = cfg.n_layers % cfg.period
    if n_tail:
        tree['tail'] = {f'tail{i}': _block_shapes(cfg, cfg.pattern[i])
                        for i in range(n_tail)}
    if cfg.family == 'hybrid':
        tree['shared_attn'] = _block_shapes(cfg, 'global')
    if cfg.enc_layers:
        tree['encoder'] = {
            'groups': stacked(_block_shapes(cfg, 'enc'), cfg.enc_layers),
            'final_ln': (cfg.d_model,)}
    return tree


def _init_leaf(name, shape, generator, stacked):
    dev = generator.device
    if name.startswith('ln') or name in ('dt_bias', 'D', 'norm_w',
                                         'A_log', 'final_ln'):
        return torch.zeros(shape, dtype=torch.float32, device=dev)  # A = -1
    layer = shape[1:] if stacked else shape
    fan_in = layer[0] if len(layer) == 1 else int(np.prod(layer[:-1]))
    std = min(0.02, fan_in ** -0.5)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=dev) * std


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device='cuda') -> Dict[str, Any]:
    """Full parameter tree of float32 master weights.  Group parameters
    are stacked ``[n_groups, ...]``.  The weights are drawn on the
    generator's device (a CPU generator gives the same weights whatever
    ``device`` is) and placed on ``device``: norm scales, ``dt_bias``,
    ``D``, ``norm_w`` and ``A_log`` are 0 (A = -1), as in the reference,
    and the matrices normal with std min(0.02, fan_in**-0.5).  The draws
    are not the reference's (its PRNG is JAX's)."""
    dev = resolve_device(device)

    def build(tree, stacked):
        return {name: (build(v, stacked or name == 'groups')
                       if isinstance(v, dict)
                       else _init_leaf(name, v, generator, stacked).to(dev))
                for name, v in sorted(tree.items())}

    return build(param_shapes(cfg), False)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_leaves(tree, prefix=''):
    """(dotted path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f'{prefix}{k}.')
        return out
    return [(prefix[:-1], tree)]


def tree_from_paths(flat):
    """The nested dict of ``{dotted path: leaf}`` pairs (the inverse of
    ``tree_leaves``)."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *head, last = path.split('.')
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def value_and_grad(fn, params):
    """``(fn(params) detached, {path: gradient})``: the gradient of the
    scalar ``fn`` with respect to every leaf of the nested dict
    ``params`` (``torch.autograd.grad`` over detached leaves, so the
    caller's tensors keep ``requires_grad`` as they were)."""
    req = {p: t.detach().requires_grad_(True)
           for p, t in tree_leaves(params)}
    with mesh_context(params):   # the backward's recomputation too
        out = fn(tree_from_paths(req))
        grads = torch.autograd.grad(out, list(req.values()))
    return out.detach(), dict(zip(req, grads))


def param_count(params) -> int:
    return sum(int(np.prod(x.shape)) for _, x in tree_leaves(params))


def cast_for_compute(params, adt):
    """Downcast >=2D float32 weights to the compute dtype (norm scales and
    other vectors stay float32 — they are cheap and precision-sensitive).
    A weight already in ``adt`` is passed through, not copied."""
    if adt == torch.float32:
        return params
    return tree_map(lambda p: p.to(adt)
                    if p.ndim >= 2 and p.dtype == torch.float32 else p,
                    params)


class _Tree(nn.Module):
    """A nested dict of tensors as nested modules: ``state_dict`` keys are
    the dotted paths; ``params()`` gives back the nested dict."""

    def __init__(self, tree):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            if isinstance(tree[k], dict):
                self.add_module(k, _Tree(tree[k]))
            else:
                self.register_parameter(
                    k, nn.Parameter(tree[k], requires_grad=False))

    def params(self) -> Dict[str, Any]:
        return {k: (getattr(self, k).params()
                    if isinstance(getattr(self, k), _Tree)
                    else getattr(self, k)) for k in self._keys}


class TransformerLM(_Tree):
    """A parameter tree held as an ``nn.Module``: ``state_dict`` keys are
    the tree's dotted paths (``groups.sub0.wq``, ``embed``, ...), and
    calling it runs ``forward``'s logits."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens, frontend_embeds=None):
        return forward(self.cfg, self.params(), tokens,
                       frontend_embeds=frontend_embeds)[0]


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _proj(h, w):
    """[B, S, d] x [d, H, hd] -> [B, S, H, hd]."""
    if not is_dtensor(w):
        return torch.einsum('bsd,dhk->bshk', h, w.to(h.dtype))
    # on a mesh, the one matmul that the einsum is, with the (H, hd) pair
    # merged and split under placements DTensor can split: a weight
    # sharded on hd alone (the rules' fallback where the heads do not
    # split) is made whole on hd, the product whole on its merged dim
    # where the mesh shards it more ways than H divides, and each merged
    # operand's gradient pinned to its forward placements (pin)
    d, H, hd = w.shape
    out = matmul(h, pin(whole_dims(w, 2).reshape(d, H * hd)).to(h.dtype))
    return unflatten_last(out, (H, hd))


def _proj_qkv(cfg, p, h, positions, prefix=''):
    q = _proj(h, p[prefix + 'wq'])
    k = _proj(h, p[prefix + 'wk'])
    v = _proj(h, p[prefix + 'wv'])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p, attn, prefix=''):
    wo = p[prefix + 'wo']
    if not is_dtensor(wo):
        return torch.einsum('bshk,hkd->bsd', attn, wo.to(attn.dtype))
    H, hd, d = wo.shape     # on a mesh: as in _proj
    # head_dim whole first (a sharded inner dim merges into a strided
    # shard, whose redistributions DTensor plans by a slow graph search)
    return matmul(pin(whole_dims(attn, 3).flatten(2)), pin(whole_dims(
        wo, 1).reshape(H * hd, d)).to(attn.dtype))


def _cross(cfg, p, h, x, cross_kv, enc_out):
    """x + the cross-attention of ``h`` to the encoder / frontend stream
    (its K/V precomputed in ``cross_kv`` when decoding)."""
    q = _proj(h, p['xwq'])
    if cross_kv is not None:
        xk, xv = cross_kv
    else:
        xk, xv = _proj(enc_out, p['xwk']), _proj(enc_out, p['xwv'])
    attn = flash_attention(q, xk, xv, causal=False,
                           softcap_val=cfg.softcap_attn)
    return x + _attn_out(p, attn, 'x')


def _write_slot(buf, slot: int, x):
    """``buf[:, slot] = x[:, 0]`` in place.  A DTensor cache is written on
    its own shard: the rank whose slice of the sequence dim holds ``slot``
    writes it (a slice of a split dim would be a copy, not a view)."""
    if not is_dtensor(buf):
        buf[:, slot:slot + 1].copy_(x)
        return
    from torch.distributed.tensor import Replicate
    from .attention import _seq_shard
    off, n = _seq_shard(buf)
    x = x.redistribute(buf.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in buf.placements])
    if off <= slot < off + n:
        buf.to_local()[:, slot - off:slot - off + 1].copy_(x.to_local())


def apply_block(cfg: ModelConfig, p, tag: str, x, positions,
                cache=None, pos=None, cross_kv=None, enc_out=None):
    """Apply one block.  Prefill when cache is None; decode otherwise, at
    position ``pos`` (a Python int), writing the step into ``cache``'s
    buffers in place.  Returns (x, new_cache)."""
    x = batch_layout(x)     # a DTensor's: the data-parallel layout
    new_cache = cache
    if tag in ('mamba1', 'mamba2'):
        h = rms_norm(x, p['ln1'], cfg.norm_eps)
        fwd = mamba1_forward if tag == 'mamba1' else mamba2_forward
        state = None if cache is None else MambaState(**cache)
        mi = model_dim(h.device_mesh) if is_dtensor(h) else None
        if mi is not None and splits_channels(cfg, tag,
                                              h.device_mesh.size(mi)):
            # the scans reshape S, which DTensor refuses: each rank runs
            # them on its own rows and channels, as plain tensors
            y, new_state = on_channel_shards(
                lambda hl, pl, st, red: fwd(hl, pl, cfg, st, reduce=red),
                h, p, state, lambda r, m: channel_layout(cfg, tag, r, m))
        elif is_dtensor(h):
            # channels that do not split over 'model' (or no 'model'
            # axis): the whole mixer on each rank's rows
            y, new_state = on_batch_rows(
                lambda hl, pl, st: fwd(hl, pl, cfg, st), h, p, state)
        else:
            y, new_state = fwd(h, p, cfg, state)
        if cache is None:
            new_cache = dict(conv=new_state.conv, h=new_state.h)
        else:
            cache['conv'].copy_(new_state.conv)
            cache['h'].copy_(new_state.h)
        return x + y, new_cache

    if tag == 'cross':
        h = rms_norm(x, p['ln1'], cfg.norm_eps)
        x = _cross(cfg, p, h, x, cross_kv, enc_out)
        h2 = rms_norm(x, p['ln2'], cfg.norm_eps)
        x = x + mlp(h2, p['w_in'], p.get('w_gate'), p['w_out'])
        return x, new_cache

    # --- blocks with (causal) self-attention ---
    h = rms_norm(x, p['ln1'], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, p, h, positions)
    local = tag == 'local' and cfg.sliding_window

    if cache is None:  # prefill
        if local:
            attn = local_attention(q, k, v, window=cfg.sliding_window,
                                   softcap_val=cfg.softcap_attn)
        else:
            attn = flash_attention(q, k, v, causal=tag != 'enc',
                                   softcap_val=cfg.softcap_attn)
        # cache-worthy output for prefill: ring-sliced for local layers.
        # Ring alignment: decode writes slot pos % W; prefill slot i holds
        # absolute position S-W+i, consistent iff S < W or W | S.
        if local:
            W = cfg.sliding_window
            S = k.shape[1]
            kw, vw = k[:, -W:], v[:, -W:]
            if S < W:
                kw, vw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, W - S))
                          for a in (kw, vw))
            new_cache = dict(k=kw, v=vw)
        else:
            new_cache = dict(k=k, v=v)
    else:  # decode: update the cache in place, attend to it
        W = cache['k'].shape[1]
        slot = pos % W if tag == 'local' else pos
        _write_slot(cache['k'], slot, k)
        _write_slot(cache['v'], slot, v)
        attn = decode_attention(q, cache['k'], cache['v'], min(pos + 1, W),
                                softcap_val=cfg.softcap_attn)
    x = x + _attn_out(p, attn)

    if tag == 'cross_dec':
        hx = rms_norm(x, p['lnx'], cfg.norm_eps)
        x = _cross(cfg, p, hx, x, cross_kv, enc_out)

    h2 = rms_norm(x, p['ln2'], cfg.norm_eps)
    if tag == 'moe':
        y, _ = moe_ffn(h2, p['router'], p['e_in'], p.get('e_gate'),
                       p['e_out'], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor)
        if cfg.dense_ff:
            y = y + mlp(h2, p['r_w_in'], p.get('r_w_gate'), p['r_w_out'])
        x = x + y
    else:
        x = x + mlp(h2, p['w_in'], p.get('w_gate'), p['w_out'])
    return x, new_cache


# ---------------------------------------------------------------------------
# full stacks
# ---------------------------------------------------------------------------


def _group(tree, gi):
    """Group ``gi``'s slice of a tree stacked [n_groups, ...] (views)."""
    return tree_map(lambda a: a[gi], tree)


def _stack(trees):
    """One tree of [n, ...] tensors from n trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _embed_scaled(cfg, params, tokens):
    adt = cfg.adtype
    x = embed(tokens, params['embed']).to(adt)
    # the reference rounds sqrt(d_model) to the compute dtype first
    return x * rounded(math.sqrt(cfg.d_model), adt)


def _encoder_forward(cfg, params, enc_embeds):
    """Bidirectional encoder over frontend embeddings (enc-dec archs)."""
    x = enc_embeds.to(cfg.adtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    enc = params['encoder']
    for li in range(cfg.enc_layers):
        x, _ = apply_block(cfg, _group(enc['groups'], li), 'enc', x,
                           positions)
    return rms_norm(x, enc['final_ln'], cfg.norm_eps)


def _hidden(cfg, params, tokens, frontend_embeds, collect_cache,
            remat=False, act_sharding=None):
    """Final hidden states [B, S, d] and, when ``collect_cache``, the
    prefill cache; with ``remat`` each group is recomputed in the
    backward; ``act_sharding`` pins the residual stream (``forward``)."""
    params = cast_for_compute(params, cfg.adtype)
    x = _embed_scaled(cfg, params, tokens)
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    enc_out = None
    if cfg.enc_layers:
        enc_out = _encoder_forward(cfg, params, frontend_embeds)
    cross_src = (enc_out if cfg.enc_layers else
                 (frontend_embeds.to(cfg.adtype)
                  if frontend_embeds is not None else None))

    def group_body(x, gp):
        kvs = {}
        if act_sharding is not None:
            # one gather of the sequence axis at group entry
            x = reshard(x, act_sharding[1])
        for i, tag in enumerate(cfg.pattern):
            x, aux = apply_block(cfg, gp[f'sub{i}'], tag, x, positions,
                                 enc_out=cross_src)
            if collect_cache and aux is not None and tag != 'cross':
                kvs[f'sub{i}'] = aux
        if cfg.family == 'hybrid':
            x, aux = apply_block(cfg, params['shared_attn'], 'global', x,
                                 positions)
            if collect_cache:
                kvs['shared'] = aux
        if act_sharding is not None:
            # scatter back: the saved residual stream stays sharded
            x = reshard(x, act_sharding[0])
        return x, kvs

    group_caches = []
    for gi in range(cfg.n_layers // cfg.period):
        gp = _group(params['groups'], gi)
        if remat:   # no RNG runs in a block: no RNG state to stash
            x, kvs = checkpoint(group_body, x, gp, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, kvs = group_body(x, gp)
        group_caches.append(kvs)
    caches = _stack(group_caches) if collect_cache else None
    for i in range(cfg.n_layers % cfg.period):
        x, aux = apply_block(cfg, params['tail'][f'tail{i}'],
                             cfg.pattern[i], x, positions,
                             enc_out=cross_src)
        if collect_cache and aux is not None and cfg.pattern[i] != 'cross':
            caches[f'tail{i}'] = aux
    x = rms_norm(x, params['final_ln'], cfg.norm_eps)
    if collect_cache and cross_src is not None:
        # cross K/V: precomputed once from the encoder / frontend stream
        xk, xv = [], []
        for i, tag in enumerate(cfg.pattern):
            if tag in ('cross', 'cross_dec'):
                gp = params['groups'][f'sub{i}']
                for out, w in ((xk, gp['xwk']), (xv, gp['xwv'])):
                    if is_dtensor(w):   # per group, as in _proj
                        out.append(torch.stack([_proj(cross_src, w[j])
                                                for j in range(len(w))]))
                    else:
                        out.append(torch.einsum('bsd,ndgk->nbsgk',
                                                cross_src,
                                                w.to(cross_src.dtype)))
        if xk:
            caches['cross_k'] = torch.cat(xk, dim=0)
            caches['cross_v'] = torch.cat(xv, dim=0)
    return x, params, caches


def _table(cfg, params):
    return params['embed'] if cfg.tie_embeddings else params['unembed']


def forward(cfg: ModelConfig, params, tokens, *, frontend_embeds=None,
            remat: bool = False, collect_cache: bool = False,
            act_sharding=None, return_hidden: bool = False):
    """Training/prefill forward pass over the whole sequence.

    Returns (logits [B, S, V], caches) — caches is the tree of per-layer
    (k, v) stacks when ``collect_cache``, else None; with
    ``return_hidden`` (hidden [B, S, d], unembedding table) instead.
    ``remat`` recomputes each stacked group in the backward (the
    reference's ``jax.checkpoint`` of its scan body); it changes no bit of
    the result or of its gradients.  Off by default: prefill and serving
    run no backward.  ``act_sharding``: None, or a (between groups, inside
    a group) pair of ``launch.sharding.NamedSharding`` for the residual
    stream [B, S, d] of DTensor parameters (the reference's explicit
    sequence-parallel transitions); it changes no value.
    """
    with mesh_context(params):
        x, params, caches = _hidden(cfg, params, tokens, frontend_embeds,
                                    collect_cache, remat, act_sharding)
        if return_hidden:
            return x, _table(cfg, params)
        return unembed(x, _table(cfg, params), cfg.softcap_final), caches


def prefill(cfg: ModelConfig, params, tokens, frontend_embeds=None):
    """Process a full prompt; returns (last-position logits [B, 1, V],
    prefill cache).  Only the last position is unembedded."""
    with mesh_context(params):
        x, params, cache = _hidden(cfg, params, tokens, frontend_embeds,
                                   True)
        return (unembed(x[:, -1:], _table(cfg, params), cfg.softcap_final),
                cache)


def train_loss(cfg: ModelConfig, params, batch, remat: bool = True,
               loss_chunks: int = 8, act_sharding=None):
    """Mean next-token CE of ``batch`` (``tokens``, ``labels``, optional
    ``frontend``): ``forward``'s hidden states through
    ``chunked_lm_loss``."""
    hidden, table = forward(cfg, params, batch['tokens'],
                            frontend_embeds=batch.get('frontend'),
                            remat=remat, act_sharding=act_sharding,
                            return_hidden=True)
    return chunked_lm_loss(hidden, table, batch['labels'],
                           cap=cfg.softcap_final, n_chunks=loss_chunks)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _cache_entry(cfg, tag, B, S, dtype, device, n=()):
    G, hd = cfg.n_kv, cfg.hd

    def zeros(*shape, dt=dtype):
        return torch.zeros(n + shape, dtype=dt, device=device)

    if tag in ('mamba1', 'mamba2'):
        K = cfg.ssm_conv
        if tag == 'mamba1':
            return dict(conv=zeros(B, K - 1, cfg.d_inner),
                        h=zeros(B, cfg.d_inner, cfg.ssm_state,
                                dt=torch.float32))
        return dict(conv=zeros(B, K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                    h=zeros(B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_p,
                            dt=torch.float32))
    if tag == 'cross':
        return None
    W = min(cfg.sliding_window, S) if tag == 'local' else S
    return dict(k=zeros(B, W, G, hd), v=zeros(B, W, G, hd))


def init_cache(cfg: ModelConfig, B: int, S: int,
               s_cross: Optional[int] = None, device='cuda'):
    """Decode cache tree, stacked [n_groups, ...] per sub-position: real
    buffers (no broadcast views), since decode writes into them.

    s_cross: length of the cross-attention source stream (encoder frames
    for enc-dec, vision patches for VLM).  Defaults: VLM ->
    cfg.n_frontend_tokens; enc-dec -> S (prompt-length audio)."""
    dev = resolve_device(device)
    dtype = cfg.adtype
    ng = (cfg.n_layers // cfg.period,)
    cache: Dict[str, Any] = {}
    for i, tag in enumerate(cfg.pattern):
        e = _cache_entry(cfg, tag, B, S, dtype, dev, ng)
        if e is not None:
            cache[f'sub{i}'] = e
    for i in range(cfg.n_layers % cfg.period):
        e = _cache_entry(cfg, cfg.pattern[i], B, S, dtype, dev)
        if e is not None:
            cache[f'tail{i}'] = e
    if cfg.family == 'hybrid':
        cache['shared'] = _cache_entry(cfg, 'global', B, S, dtype, dev, ng)
    if cfg.enc_layers or cfg.family == 'vlm':
        # precomputed cross K/V per cross-layer (from encoder / frontend)
        n_cross = sum(1 for t in cfg.attn_layer_types
                      if t in ('cross', 'cross_dec'))
        if s_cross is None:
            s_cross = (cfg.n_frontend_tokens if cfg.family == 'vlm' else S)
        shape = (n_cross, B, s_cross, cfg.n_kv, cfg.hd)
        cache['cross_k'] = torch.zeros(shape, dtype=dtype, device=dev)
        cache['cross_v'] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decoding step.  tokens: [B, 1]; pos: Python int (uniform batch
    position).  Returns (logits [B, 1, V], cache).

    The step writes its K/V and recurrent states into ``cache``'s buffers
    in place and returns the same tree: the cache passed in is consumed
    (clone it first to run a step twice from one state).  Nothing is read
    back to the host."""
    with mesh_context(params):
        return _decode(cfg, params, cache, tokens, pos)


def _decode(cfg, params, cache, tokens, pos):
    params = cast_for_compute(params, cfg.adtype)
    x = _embed_scaled(cfg, params, tokens)
    positions = torch.full((1, 1), pos, dtype=torch.long, device=x.device)
    n_cross_per_period = sum(1 for t in cfg.pattern
                             if t in ('cross', 'cross_dec'))

    for gi in range(cfg.n_layers // cfg.period):
        gp = _group(params['groups'], gi)
        ci = 0
        for i, tag in enumerate(cfg.pattern):
            ckv = None
            if tag in ('cross', 'cross_dec'):
                idx = gi * n_cross_per_period + ci
                ckv = (cache['cross_k'][idx], cache['cross_v'][idx])
                ci += 1
            gcache = cache.get(f'sub{i}')
            x, _ = apply_block(cfg, gp[f'sub{i}'], tag, x, positions,
                               cache=None if gcache is None
                               else _group(gcache, gi),
                               pos=pos, cross_kv=ckv)
        if cfg.family == 'hybrid':
            x, _ = apply_block(cfg, params['shared_attn'], 'global', x,
                               positions, cache=_group(cache['shared'], gi),
                               pos=pos)
    for i in range(cfg.n_layers % cfg.period):
        tag = cfg.pattern[i]
        ckv = None
        if tag in ('cross', 'cross_dec'):
            idx = cfg.n_layers // cfg.period * n_cross_per_period
            ckv = (cache['cross_k'][idx], cache['cross_v'][idx])
        x, _ = apply_block(cfg, params['tail'][f'tail{i}'], tag, x,
                           positions, cache=cache.get(f'tail{i}'), pos=pos,
                           cross_kv=ckv)
    x = rms_norm(x, params['final_ln'], cfg.norm_eps)
    return unembed(x, _table(cfg, params), cfg.softcap_final), cache
