"""Turn the reference's SNAP parameters into the port's.

A linear SNAP model has no weights beyond ``beta`` (one coefficient per
bispectrum component) and ``beta0`` (the per-atom energy offset).  The
port imports nothing of the reference package, so the caller passes the
reference configuration's fields as a plain dict, for example
``dataclasses.asdict(cfg)``.
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
