"""Turn the reference's parameters into the port's.

A linear SNAP model has no weights beyond ``beta`` (one coefficient per
bispectrum component) and ``beta0`` (the per-atom energy offset).  The
port imports nothing of the reference package, so the caller passes the
reference configuration's fields as a plain dict, for example
``dataclasses.asdict(cfg)``.  A language model's parameters, prefill
cache and AdamW state come as the reference's pytrees of numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.snap import SnapConfig, resolve_device

_FIELDS = {f.name for f in dataclasses.fields(SnapConfig)} - {'dtype'}


def from_reference(cfg_fields: dict, beta, beta0, device='cuda',
                   dtype=torch.float64):
    """(SnapConfig, beta tensor [ncoeff], beta0 float) for the port.

    ``dtype`` sets the port's precision (``SnapConfig.dtype`` and beta);
    a ``dtype`` entry of ``cfg_fields`` names a type of the reference's
    framework and is not carried over.  Unknown fields raise, as does a
    beta whose length does not match ``twojmax``.
    """
    fields = {k: v for k, v in cfg_fields.items() if k != 'dtype'}
    unknown = set(fields) - _FIELDS
    if unknown:
        raise ValueError(f'unknown SnapConfig fields: {sorted(unknown)}')
    cfg = SnapConfig(**fields, dtype=dtype)
    beta = np.asarray(beta, dtype=np.float64)
    if beta.shape != (cfg.ncoeff,):
        raise ValueError(f'beta has shape {beta.shape}; twojmax='
                         f'{cfg.twojmax} needs ({cfg.ncoeff},)')
    beta_t = torch.as_tensor(beta, dtype=dtype, device=resolve_device(device))
    return cfg, beta_t, float(beta0)


# ---------------------------------------------------------------------------
# language models
# ---------------------------------------------------------------------------

def _check_paths(what, got, want):
    missing = sorted(set(want) - set(got))
    unknown = sorted(set(got) - set(want))
    if missing or unknown:
        raise ValueError(f'{what}: missing leaves {missing}, unknown leaves '
                         f'{unknown}')


def lm_params_from_reference(cfg, tree, device='cuda', dtype=None):
    """The port's parameter tree from the reference's pytree of a
    language model (``jax.tree.map(np.asarray, params)`` on the caller's
    side).  Every path and shape is checked against ``cfg``; an unknown
    or missing leaf raises.  Leaves keep their dtype unless ``dtype`` is
    given."""
    from .models.transformer import param_shapes, tree_from_paths, tree_leaves
    flat = dict(tree_leaves(tree))
    want = dict(tree_leaves(param_shapes(cfg)))
    _check_paths(f'{cfg.name} parameters', flat, want)
    dev = resolve_device(device)
    out = {}
    for path, a in flat.items():
        a = np.asarray(a)
        if a.shape != tuple(want[path]):
            raise ValueError(f'{cfg.name} parameter {path}: shape {a.shape}, '
                             f'expected {tuple(want[path])}')
        out[path] = torch.tensor(a, device=dev, dtype=dtype)
    return tree_from_paths(out)


def lm_cache_from_reference(cfg, tree, device='cuda'):
    """The port's prefill cache from the reference's (``prefill``'s second
    output as numpy arrays): the paths must be those of ``cfg``'s cache,
    each leaf of the rank of its decode buffer with the group axis
    ``n_groups`` long where the cache is stacked; an unknown or missing
    leaf raises."""
    from .models.transformer import init_cache, tree_from_paths, tree_leaves
    flat = dict(tree_leaves(tree))
    want = dict(tree_leaves(init_cache(cfg, 1, 1, s_cross=1,
                                       device='meta')))
    _check_paths(f'{cfg.name} cache', flat, want)
    dev = resolve_device(device)
    out = {}
    for path, a in flat.items():
        a, ref = np.asarray(a), want[path]
        stacked = not path.startswith(('tail', 'cross'))
        if a.ndim != ref.ndim or (stacked and a.shape[0] != ref.shape[0]):
            raise ValueError(f'{cfg.name} cache {path}: shape {a.shape} does '
                             f'not fit the decode buffer {tuple(ref.shape)}')
        out[path] = torch.tensor(a, device=dev)
    return tree_from_paths(out)


def lm_opt_state_from_reference(cfg, tree, device='cuda'):
    """The port's AdamW state (``optim.adamw``) from the reference's
    (``jax.tree.map(np.asarray, state)`` on the caller's side): ``m`` and
    ``v`` with the paths of ``cfg``'s parameters, each leaf a float32
    array or a ``QTensor``-like pair ``(q, scale)`` of int8 values
    [..., n_blocks, 128] and float32 scales [..., n_blocks, 1]; ``count``
    a scalar.  A leaf of the wrong path or shape raises."""
    from .models.transformer import param_shapes, tree_from_paths, tree_leaves
    from .optim.adamw import BLOCK, QTensor
    want = dict(tree_leaves(param_shapes(cfg)))
    dev = resolve_device(device)
    out = {}
    for key in ('m', 'v'):
        flat = dict(tree_leaves(tree[key]))
        _check_paths(f'{cfg.name} optimizer {key}', flat, want)
        moments = {}
        for path, a in flat.items():
            shape = tuple(want[path])
            if isinstance(a, tuple):
                q, s = (np.asarray(x) for x in a)
                nb = -(-shape[-1] // BLOCK)
                if (q.shape != shape[:-1] + (nb, BLOCK) or q.dtype != np.int8
                        or s.shape != shape[:-1] + (nb, 1)):
                    raise ValueError(
                        f'{cfg.name} optimizer {key}.{path}: int8 blocks '
                        f'{q.shape} {q.dtype} and scales {s.shape} do not '
                        f'fit the parameter {shape}')
                moments[path] = QTensor(torch.tensor(q, device=dev),
                                        torch.tensor(s, device=dev))
            else:
                a = np.asarray(a)
                if a.shape != shape:
                    raise ValueError(f'{cfg.name} optimizer {key}.{path}: '
                                     f'shape {a.shape}, expected {shape}')
                moments[path] = torch.tensor(a, device=dev)
        out[key] = tree_from_paths(moments)
    out['count'] = torch.tensor(np.asarray(tree['count']), device=dev,
                                dtype=torch.int32)
    return out
