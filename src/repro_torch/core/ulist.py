"""Vectorized Wigner-U recursion (paper eq. 1 / 9) over batches of pairs.

Port of ``repro.core.ulist``: the per-pair scalar recursion of LAMMPS
``compute_uarray`` as per-level dense gathers with the static maps of
:mod:`repro_torch.core.indices`, on complex tensors.  ``compute_dulist``
carries one tangent per Cartesian direction through the same recursion
(LAMMPS ``compute_duarray``).
"""

from __future__ import annotations

import torch

from .geometry import PairGeom, PairGeomGrad
from .indices import SnapIndex
from .tables import device_table


def complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _level_tables(lv, dtype, device):
    return tuple(device_table(lv, name, dt, device) for name, dt in (
        ('a_src', torch.long), ('b_src', torch.long), ('a_coef', dtype),
        ('b_coef', dtype), ('full_src', torch.long), ('full_conj', torch.bool),
        ('full_sign', dtype)))


def _mirror_fill(left, full_src, full_conj, sgn):
    src = left[..., full_src]
    return torch.where(full_conj, sgn * torch.conj(src), src)


def compute_ulist(geom: PairGeom, idx: SnapIndex, dtype=torch.float64):
    """U_j elements for each pair: complex [*batch, idxu_max].

    These are the *raw* rotation-matrix elements; the switching weight
    ``sfac`` is applied at accumulation time (LAMMPS ``add_uarraytot``).
    """
    cdt = complex_dtype(dtype)
    a = torch.complex(geom.a_r.to(dtype), geom.a_i.to(dtype)).to(cdt)
    b = torch.complex(geom.b_r.to(dtype), geom.b_i.to(dtype)).to(cdt)
    dev = a.device
    ac = torch.conj(a)[..., None]
    bc = torch.conj(b)[..., None]
    levels = [torch.ones(a.shape + (1,), dtype=cdt, device=dev)]
    for lv in idx.ulevels:
        a_src, b_src, a_coef, b_coef, fsrc, fconj, fsgn = _level_tables(
            lv, dtype, dev)
        prev = levels[-1]
        left = ac * (prev[..., a_src] * a_coef) + bc * (prev[..., b_src]
                                                        * b_coef)
        levels.append(_mirror_fill(left, fsrc, fconj, fsgn))
    return torch.cat(levels, dim=-1)


def compute_dulist(geom: PairGeom, dgeom: PairGeomGrad, idx: SnapIndex,
                   dtype=torch.float64):
    """(u, du): raw U and d(sfac*U)/d(x,y,z) per pair.

    Returns
        u : complex [*batch, idxu_max]
        du: complex [*batch, 3, idxu_max] — already includes the product
            rule ``dsfac * u * unit + sfac * du_raw`` (LAMMPS
            compute_duidrj final step).
    """
    cdt = complex_dtype(dtype)
    a = torch.complex(geom.a_r.to(dtype), geom.a_i.to(dtype)).to(cdt)
    b = torch.complex(geom.b_r.to(dtype), geom.b_i.to(dtype)).to(cdt)
    da = torch.complex(dgeom.da_r.to(dtype), dgeom.da_i.to(dtype))
    db = torch.complex(dgeom.db_r.to(dtype), dgeom.db_i.to(dtype))
    dev = a.device
    batch = a.shape
    ac = torch.conj(a)[..., None, None]                # [*batch, 1, 1]
    bc = torch.conj(b)[..., None, None]
    dac = torch.conj(da)[..., None]                    # [*batch, 3, 1]
    dbc = torch.conj(db)[..., None]

    u_levels = [torch.ones(batch + (1,), dtype=cdt, device=dev)]
    du_levels = [torch.zeros(batch + (3, 1), dtype=cdt, device=dev)]
    for lv in idx.ulevels:
        a_src, b_src, a_coef, b_coef, fsrc, fconj, fsgn = _level_tables(
            lv, dtype, dev)
        prev, dprev = u_levels[-1], du_levels[-1]
        pa = prev[..., a_src] * a_coef                 # [*batch, nle]
        pb = prev[..., b_src] * b_coef
        dpa = dprev[..., a_src] * a_coef               # [*batch, 3, nle]
        dpb = dprev[..., b_src] * b_coef
        left = ac[..., 0, :] * pa + bc[..., 0, :] * pb
        dleft = (dac * pa[..., None, :] + ac * dpa
                 + dbc * pb[..., None, :] + bc * dpb)
        u_levels.append(_mirror_fill(left, fsrc, fconj, fsgn))
        du_levels.append(_mirror_fill(dleft, fsrc, fconj, fsgn))
    u = torch.cat(u_levels, dim=-1)
    du_raw = torch.cat(du_levels, dim=-1)
    # chain rule with the switching function: d(sfac*u) = dsfac*u + sfac*du
    sfac = geom.sfac.to(dtype)
    dsfac = dgeom.dsfac.to(dtype)                      # [*batch, 3]
    du = dsfac[..., None] * u[..., None, :] + sfac[..., None, None] * du_raw
    return u, du


def compute_ulisttot(u_pairs, sfac, nbr_mask, idx: SnapIndex, wself=1.0):
    """Accumulate sum_k sfac_k * U_k per atom + self contribution.

    u_pairs: complex [natoms, nnbor, idxu]; sfac/nbr_mask: [natoms, nnbor].
    Returns complex [natoms, idxu_max].
    """
    w = (sfac * nbr_mask).to(u_pairs.real.dtype)
    tot = torch.sum(u_pairs * w[..., None], dim=1)
    self_vec = torch.zeros(idx.idxu_max, dtype=u_pairs.dtype,
                           device=u_pairs.device).index_fill_(
        0, device_table(idx, 'self_diag', torch.long, u_pairs.device), wself)
    return tot + self_vec
