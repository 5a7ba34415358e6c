"""Pair geometry for SNAP: Cayley-Klein parameters and switching function.

Port of ``repro.core.geometry``.  A neighbor displacement r_ik = (x, y, z)
inside the cutoff maps to a point on the unit 3-sphere; the Wigner-U
recursion consumes the Cayley-Klein parameters

    a = r0inv (z0 - i z),   b = r0inv (y - i x),   r0inv = 1/sqrt(r^2+z0^2)
    z0 = r / tan(theta0),   theta0 = (r - rmin0) rfac0 pi / (rcut - rmin0)

(LAMMPS compute_ui / compute_duidrj conventions).  Everything is
elementwise over tensors of any shape; masked (padded) pairs must be
sanitized by the caller (safe radius) and their sfac forced to 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.141592653589793


class PairGeom(NamedTuple):
    """Cayley-Klein parameters + switching function per pair."""
    a_r: torch.Tensor
    a_i: torch.Tensor
    b_r: torch.Tensor
    b_i: torch.Tensor
    sfac: torch.Tensor


class PairGeomGrad(NamedTuple):
    """d(a, b, sfac)/d(x, y, z): each field has trailing axis 3."""
    da_r: torch.Tensor
    da_i: torch.Tensor
    db_r: torch.Tensor
    db_i: torch.Tensor
    dsfac: torch.Tensor


def compute_sfac(r, rcut, rmin0=0.0, switch_flag=True):
    """Cosine switching function f_c(r): 1 below rmin0, 0 beyond rcut."""
    if not switch_flag:
        return torch.ones_like(r)
    t = (r - rmin0) * PI / (rcut - rmin0)
    sw = 0.5 * (torch.cos(t) + 1.0)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.where(r <= rmin0, one, torch.where(r > rcut, zero, sw))


def compute_dsfac(r, rcut, rmin0=0.0, switch_flag=True):
    """d f_c / d r."""
    if not switch_flag:
        return torch.zeros_like(r)
    c = PI / (rcut - rmin0)
    t = (r - rmin0) * c
    dsw = -0.5 * torch.sin(t) * c
    return torch.where((r <= rmin0) | (r > rcut), torch.zeros_like(r), dsw)


def compute_geometry(x, y, z, rcut, rmin0=0.0, rfac0=0.99363,
                     switch_flag=True) -> PairGeom:
    """Cayley-Klein parameters a, b and switching value per pair."""
    rsq = x * x + y * y + z * z
    r = torch.sqrt(rsq)
    rscale0 = rfac0 * PI / (rcut - rmin0)
    theta0 = (r - rmin0) * rscale0
    z0 = r * torch.cos(theta0) / torch.sin(theta0)
    r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
    return PairGeom(a_r=r0inv * z0, a_i=-r0inv * z, b_r=r0inv * y,
                    b_i=-r0inv * x,
                    sfac=compute_sfac(r, rcut, rmin0, switch_flag))


def compute_geometry_grad(x, y, z, rcut, rmin0=0.0, rfac0=0.99363,
                          switch_flag=True):
    """(PairGeom, PairGeomGrad): parameters and their d/d(x,y,z).

    Follows LAMMPS compute_duidrj/compute_duarray:
        dz0/dr    = z0/r - r*rscale0*(r^2 + z0^2)/r^2
        dr0inv/dr = -r0inv^3 (r + z0 dz0/dr)
        da/dk     = dz0[k] r0inv + z0 dr0inv[k]  - i (z dr0inv[k] + r0inv e_z)
        db/dk     = y dr0inv[k] + r0inv e_y      - i (x dr0inv[k] + r0inv e_x)
    """
    rsq = x * x + y * y + z * z
    r = torch.sqrt(rsq)
    rscale0 = rfac0 * PI / (rcut - rmin0)
    theta0 = (r - rmin0) * rscale0
    z0 = r * torch.cos(theta0) / torch.sin(theta0)
    dz0dr = z0 / r - r * rscale0 * (rsq + z0 * z0) / rsq
    r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
    dr0invdr = -(r0inv ** 3) * (r + z0 * dz0dr)
    unit = torch.stack([x / r, y / r, z / r], dim=-1)      # [..., 3]
    dr0inv = dr0invdr[..., None] * unit
    dz0 = dz0dr[..., None] * unit
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    r0e = r0inv[..., None, None] * eye                      # [..., 3, 3]

    da_r = dz0 * r0inv[..., None] + z0[..., None] * dr0inv
    da_i = -z[..., None] * dr0inv - r0e[..., 2, :]
    db_r = y[..., None] * dr0inv + r0e[..., 1, :]
    db_i = -x[..., None] * dr0inv - r0e[..., 0, :]

    geom = PairGeom(a_r=r0inv * z0, a_i=-r0inv * z, b_r=r0inv * y,
                    b_i=-r0inv * x,
                    sfac=compute_sfac(r, rcut, rmin0, switch_flag))
    dsfac = compute_dsfac(r, rcut, rmin0, switch_flag)[..., None] * unit
    return geom, PairGeomGrad(da_r=da_r, da_i=da_i, db_r=db_r, db_i=db_i,
                              dsfac=dsfac)


def sanitize_displacements(dx, dy, dz, mask, safe_r=0.5):
    """Replace masked/degenerate displacements with a safe dummy vector.

    The Cayley-Klein map is singular at r=0 and r=rcut under switch;
    padded neighbor slots carry arbitrary data, so give them |r| = safe_r
    along x.  Their sfac must separately be forced to zero via the mask.
    """
    ok = mask & ((dx * dx + dy * dy + dz * dz) > 1e-20)
    dx = torch.where(ok, dx, torch.full_like(dx, safe_r))
    dy = torch.where(ok, dy, torch.zeros_like(dy))
    dz = torch.where(ok, dz, torch.zeros_like(dz))
    return dx, dy, dz, ok
