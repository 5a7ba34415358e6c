"""FitSNAP-style linear fitting of the SNAP coefficients beta.

Port of ``repro.fit.linear``.  SNAP is a machine-learned potential:
E_i = beta0 + beta . B_i is linear in the descriptors, so training against
reference energies AND forces is a (weighted) linear least-squares
problem:

    E_ref(config)  =  N*beta0 + beta . sum_i B_i
    F_ref(atom k)  =  -beta . dB_total/dr_k

The force design-matrix rows come from the baseline pipeline's dB per pair
(the adjoint trick does not apply while fitting: Y depends on beta, which
is what is being solved for).  The rows are built on ``device`` — B, dU,
Z and dB (its COO gathers in slices of bounded size,
:func:`repro_torch.core.bispectrum.compute_dblist`), then dB_total by
destination in a fixed order (the own rows,
then each atom's incoming pairs, :func:`repro_torch.core.bispectrum.
_add_columns`) — and leave it once, as float64.  The weighted ridge solve
runs on the host in float64 (``np.linalg.lstsq``), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core import bispectrum as bs
from ..core.snap import (SnapConfig, _inputs, _pair_geometry,
                         compute_bispectrum, resolve_device)
from ..core.ulist import compute_dulist, compute_ulisttot


@dataclass
class FitData:
    """One training configuration (cell) with reference labels."""
    disp: np.ndarray        # [N, K, 3]
    nbr_idx: np.ndarray     # [N, K]
    mask: np.ndarray        # [N, K]
    e_ref: float            # total energy
    f_ref: np.ndarray       # [N, 3]
    w_e: float = 1.0
    w_f: float = 1.0


def descriptor_rows(cfg: SnapConfig, data: FitData, device='cuda'):
    """(energy_row [ncoeff+1], force_rows [3N, ncoeff+1]), numpy float64,
    computed on ``device`` in ``cfg.dtype``."""
    device = resolve_device(device)
    idx = cfg.index
    disp = np.asarray(data.disp)
    dx, dy, dz, nbr_idx, mask = _inputs(cfg, disp[..., 0], disp[..., 1],
                                        disp[..., 2], data.nbr_idx,
                                        data.mask, device)
    n, k = dx.shape
    b = compute_bispectrum(cfg, dx, dy, dz, mask)
    geom, dgeom, ok = _pair_geometry(cfg, dx, dy, dz, mask, grad=True)
    u, du = compute_dulist(geom, dgeom, idx, cfg.dtype)
    ut = compute_ulisttot(u, geom.sfac, ok, idx, cfg.wself)
    z = bs.compute_zlist(ut, idx)
    atom_of_pair = torch.arange(n, device=device).repeat_interleave(k)
    db = bs.compute_dblist(du.reshape(-1, 3, idx.idxu_max), z,
                           atom_of_pair, idx)          # [P, 3, ncoeff]
    db = db.reshape(n, k, -1) * mask[..., None].to(db.dtype)
    # -dB_total/dr_m = sum_k db(m, k) - sum_{i: m in nbrs(i)} db(i, m);
    # masked slots go to the sentinel row n, dropped
    incoming = db.new_zeros((n + 1, db.shape[-1]))
    bs._add_columns(incoming.T, torch.where(mask, nbr_idx, n).reshape(-1),
                    db.reshape(n * k, -1).T)
    f_rows = (db.sum(dim=1) - incoming[:n]).reshape(3 * n, idx.idxb_max)
    rows = torch.cat([torch.cat([b.new_full((1,), n), b.sum(dim=0)])[None],
                      torch.nn.functional.pad(f_rows, (1, 0))])
    rows = rows.to(torch.float64).cpu().numpy()       # the one readback
    return rows[0], rows[1:]


def fit_snap_linear(cfg: SnapConfig, dataset: List[FitData],
                    ridge: float = 1e-8, device='cuda'):
    """Weighted ridge solve for (beta0, beta), the rows built on
    ``device``.  Returns (beta0, beta [ncoeff] float64 CPU tensor,
    diagnostics)."""
    rows, targets, weights = [], [], []
    for d in dataset:
        e_row, f_rows = descriptor_rows(cfg, d, device)
        rows.append(e_row[None])
        targets.append([d.e_ref])
        weights.append([d.w_e])
        rows.append(f_rows)
        targets.append(np.asarray(d.f_ref).reshape(-1))
        weights.append(np.full(f_rows.shape[0], d.w_f))
    A = np.concatenate(rows, axis=0)
    y = np.concatenate([np.atleast_1d(t) for t in targets])
    w = np.concatenate(weights)
    Aw = A * w[:, None]
    yw = y * w
    if ridge:
        ncols = A.shape[1]
        Aw = np.concatenate([Aw, np.sqrt(ridge) * np.eye(ncols)])
        yw = np.concatenate([yw, np.zeros(ncols)])
    coef, *_ = np.linalg.lstsq(Aw, yw, rcond=None)
    pred = A @ coef
    rms_e = float(np.sqrt(np.mean((pred[:1] - y[:1]) ** 2)))
    rms_f = float(np.sqrt(np.mean((pred[1:] - y[1:]) ** 2)))
    return float(coef[0]), torch.as_tensor(coef[1:]), dict(rms_e=rms_e,
                                                           rms_f=rms_f)
