"""Plain per-stage oracles for the SNAP kernels (port of
``repro.kernels.ref``).

Each ``ref_*`` takes the kernel's input layout and returns its outputs,
built from the :mod:`repro_torch.core` pipeline (itself held against
``repro.core`` and against ``torch.autograd``).  They work on full planes
``[idxu_max, N]``; compare a half plane through ``SnapIndex.half_to_full``.
"""

from __future__ import annotations

import torch

from ..core.geometry import compute_geometry, compute_geometry_grad
from ..core.indices import build_index
from ..core.ulist import compute_dulist, compute_ulist


def _geom_from_disp(disp, rcut, rmin0, rfac0, switch_flag, grad):
    """disp: [nnbor, 4, N] kernel layout -> per-pair geometry [N, nnbor]
    with masked sfac/dsfac."""
    x, y, z, m = (disp[:, c, :].T for c in range(4))
    kw = dict(rcut=rcut, rmin0=rmin0, rfac0=rfac0, switch_flag=switch_flag)
    if grad:
        geom, dgeom = compute_geometry_grad(x, y, z, **kw)
        dgeom = dgeom._replace(dsfac=dgeom.dsfac * m[..., None])
    else:
        geom, dgeom = compute_geometry(x, y, z, **kw), None
    return geom._replace(sfac=geom.sfac * m), dgeom


def ref_snap_u(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
               switch_flag=True):
    """Oracle for the U stage: [nnbor, 4, N] -> (ut_r, ut_i) [idxu_max, N]
    (full planes, no self term)."""
    idx = build_index(twojmax)
    geom, _ = _geom_from_disp(disp, rcut, rmin0, rfac0, switch_flag, False)
    u = compute_ulist(geom, idx, disp.dtype)            # [N, nnbor, idxu]
    tot = torch.sum(u * geom.sfac[..., None], dim=1)
    return tot.real.T.contiguous(), tot.imag.T.contiguous()


def ref_snap_fused_de(disp, y_r, y_i, *, twojmax, rcut, rmin0=0.0,
                      rfac0=0.99363, switch_flag=True):
    """Oracle for the fused dE stage with full Y planes [idxu_max, N]:
    returns [nnbor, 4, N]."""
    idx = build_index(twojmax)
    geom, dgeom = _geom_from_disp(disp, rcut, rmin0, rfac0, switch_flag,
                                  True)
    _, du = compute_dulist(geom, dgeom, idx, disp.dtype)  # [N, nnbor, 3, iu]
    w = torch.as_tensor(idx.dedr_weight, dtype=disp.dtype,
                        device=disp.device)
    wy_r, wy_i = (w * y_r.T)[:, None, None, :], (w * y_i.T)[:, None, None, :]
    dedr = 2.0 * torch.sum(du.real * wy_r + du.imag * wy_i, dim=-1)
    out = torch.cat([dedr, torch.zeros_like(dedr[..., :1])], dim=-1)
    return out.permute(1, 2, 0).contiguous()
