"""Shared machinery for the SNAP kernels and their plain PyTorch versions.

Port of ``repro.kernels.common``.  Layout convention, kept from the
reference so that every stage compares like with like: the *atom* index is
the fast (last) axis of every plane, quantum numbers are rows, and the
neighbors of an atom are iterated inside the kernel.

The helpers here are plain torch on ``[rows, cols, L]`` tensors (L = lanes:
atoms, or atom x neighbor pairs); the plain versions of the kernels are
built from them.  The per-level recursion constants are small static numpy
tables; :func:`rootpq` hands the same constants to the CUDA kernels.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

LANES = 128          # atom padding of the plane layout (reference contract)
MAX_TWOJMAX = 14     # largest 2J the CUDA kernels' local state is sized for
PI = 3.141592653589793


@lru_cache(maxsize=8)
def level_consts(twojmax: int):
    """Per-level static tables for the Wigner recursion.

    For level j (1..twojmax), left rows mb = 0..j//2:
      CA[mb, ma] =  sqrt((j-ma)/(j-mb))   multiplies conj(a)*u_{j-1}(mb, ma),
                                          contributing to column ma
      CB[mb, ma] = -sqrt((ma+1)/(j-mb))   multiplies conj(b)*u_{j-1}(mb, ma),
                                          contributing to column ma+1
      SGN[r, c]  = (-1)^(mb'+ma') for the mirrored rows mb' = j//2+1 .. j
      W          = half-plane contraction weights over the full layer
    """
    out = []
    for j in range(1, twojmax + 1):
        rows = j // 2 + 1
        ca = np.zeros((rows, j), dtype=np.float64)
        cb = np.zeros((rows, j), dtype=np.float64)
        for mb in range(rows):
            for ma in range(j):
                ca[mb, ma] = math.sqrt((j - ma) / (j - mb))
                cb[mb, ma] = -math.sqrt((ma + 1) / (j - mb))
        nmir = j + 1 - rows
        sgn = np.zeros((nmir, j + 1), dtype=np.float64)
        for r in range(nmir):
            mbp = rows + r
            for ma in range(j + 1):
                sgn[r, ma] = 1.0 if (mbp + ma) % 2 == 0 else -1.0
        w = np.zeros((j + 1, j + 1), dtype=np.float64)
        for mb in range(j + 1):
            if 2 * mb < j:
                w[mb, :] = 1.0
            elif 2 * mb == j:
                w[mb, : j // 2] = 1.0
                w[mb, j // 2] = 0.5
        out.append(dict(j=j, rows=rows, ca=ca, cb=cb, sgn=sgn, w=w))
    return tuple(out)


def level_coefs(j: int, dtype, device):
    """CA, CB [rows, j, 1], SGN [nmir, j+1, 1], W [j+1, j+1, 1] of level j."""
    c = level_consts(j)[j - 1]
    t = dict(dtype=dtype, device=device)
    return tuple(torch.as_tensor(c[k], **t)[..., None]
                 for k in ('ca', 'cb', 'sgn', 'w'))


@lru_cache(maxsize=8)
def rootpq(dtype, device):
    """[MAX_TWOJMAX+1]^2 table sqrt(p/q) (0 where q == 0) for the CUDA
    kernels: CA = rootpq[j-ma, j-mb], CB = -rootpq[ma, j-mb]."""
    n = MAX_TWOJMAX + 1
    p = np.arange(n, dtype=np.float64)[:, None]
    q = np.arange(n, dtype=np.float64)[None, :]
    tab = np.sqrt(np.divide(p, q, out=np.zeros((n, n)), where=q > 0))
    return torch.as_tensor(tab, dtype=dtype, device=device)


def mirror_row(row_r, row_i, j_prev, mbp):
    """Row mb'=mbp of a full layer j_prev from its mirror source row (left
    storage, already reversed by the caller): the (-1)^(mb'+ma') conj
    transform."""
    cols = j_prev + 1
    ma = torch.arange(cols, device=row_r.device)
    sgn = (1 - 2 * ((ma + mbp) % 2)).to(row_r.dtype)[:, None]
    return sgn * row_r, -sgn * row_i


def half_prev_rows(left_r, left_i, j):
    """Rows 0..j//2 of full layer j-1, given left storage of layer j-1
    (rows 0..(j-1)//2).  For even j appends the one mirrored row."""
    if j % 2 == 1:
        return left_r, left_i
    jp = j - 1
    src_r = torch.flip(left_r[j // 2 - 1], dims=(0,))
    src_i = torch.flip(left_i[j // 2 - 1], dims=(0,))
    mr, mi = mirror_row(src_r, src_i, jp, j // 2)
    return (torch.cat([left_r, mr[None]], dim=0),
            torch.cat([left_i, mi[None]], dim=0))


def conj_mul(c_r, c_i, p_r, p_i):
    """conj(c) * p on split re/im planes."""
    return c_r * p_r + c_i * p_i, c_r * p_i - c_i * p_r


def level_stitch(ca, cb, au, bu):
    """Column-stitch of one recursion level: the conj(a)-term feeds column
    ma, the conj(b)-term column ma+1, weighted by the rootpq coefficient
    matrices.  au/bu: (re, im) pairs [rows, j, L]; returns the new left
    rows [rows, j+1, L]."""
    (au_r, au_i), (bu_r, bu_i) = au, bu
    pad_a, pad_b = (0, 0, 0, 1), (0, 0, 1, 0)      # pad the column axis
    return (F.pad(ca * au_r, pad_a) + F.pad(cb * bu_r, pad_b),
            F.pad(ca * au_i, pad_a) + F.pad(cb * bu_i, pad_b))


def mirror_fill(left_r, left_i, sgn, j):
    """Full layer j from its left rows [j//2 + 1, j+1, L]: row mb' > j//2 is
    (-1)^(mb'+ma') conj(u(j - mb', j - ma')), from the first nmir left rows
    flipped in both axes."""
    nmir = j + 1 - (j // 2 + 1)
    src_r = torch.flip(left_r[:nmir], dims=(0, 1))
    src_i = torch.flip(left_i[:nmir], dims=(0, 1))
    return (torch.cat([left_r, sgn * src_r], dim=0),
            torch.cat([left_i, -sgn * src_i], dim=0))


def u_level_step(prev_r, prev_i, a_r, a_i, b_r, b_i, j):
    """One recursion level on full layers (the full-plane U stage).

    prev_*: full previous layer [j, j, L].  Returns full layer
    [j+1, j+1, L]: the left rows by the column stitch of the previous
    layer's rows 0..j//2, then the mirror fill of the rest."""
    rows = j // 2 + 1
    ca, cb, sgn, _ = level_coefs(j, prev_r.dtype, prev_r.device)
    p_r, p_i = prev_r[:rows], prev_i[:rows]
    left_r, left_i = level_stitch(ca, cb, conj_mul(a_r, a_i, p_r, p_i),
                                  conj_mul(b_r, b_i, p_r, p_i))
    return mirror_fill(left_r, left_i, sgn, j)


def dual_level_step(pr, pi, dpr, dpi, a, da, b, db, j):
    """Advance full layers (u, du[3]) one recursion level (the full-plane
    fused dE stage).

    pr/pi: [j, j, L] full previous layer; dpr/dpi: lists of 3 such
    tangents.  a = (a_r, a_i), da = (da_r[3], da_i[3]); likewise b, db.
    Each tangent takes the product rule d(conj(c) u) = conj(dc) u +
    conj(c) du before the same stitch and mirror fill as u.  Returns
    (full_r, full_i, dfull_r[3], dfull_i[3]) at [j+1, j+1, L]."""
    rows = j // 2 + 1
    ca, cb, sgn, _ = level_coefs(j, pr.dtype, pr.device)
    (a_r, a_i), (b_r, b_i) = a, b
    (da_r, da_i), (db_r, db_i) = da, db
    p_r, p_i = pr[:rows], pi[:rows]
    full_r, full_i = mirror_fill(
        *level_stitch(ca, cb, conj_mul(a_r, a_i, p_r, p_i),
                      conj_mul(b_r, b_i, p_r, p_i)), sgn, j)
    dfull_r, dfull_i = [], []
    for k in range(3):
        q_r, q_i = dpr[k][:rows], dpi[k][:rows]
        dau_r, dau_i = conj_mul(da_r[k], da_i[k], p_r, p_i)
        dau = (dau_r + a_r * q_r + a_i * q_i, dau_i + a_r * q_i - a_i * q_r)
        dbu_r, dbu_i = conj_mul(db_r[k], db_i[k], p_r, p_i)
        dbu = (dbu_r + b_r * q_r + b_i * q_i, dbu_i + b_r * q_i - b_i * q_r)
        d_r, d_i = mirror_fill(*level_stitch(ca, cb, dau, dbu), sgn, j)
        dfull_r.append(d_r)
        dfull_i.append(d_i)
    return full_r, full_i, dfull_r, dfull_i


def u_half_level_step(left_r, left_i, a_r, a_i, b_r, b_i, j):
    """One recursion level on left-rows-only storage.

    left_*: [(j-1)//2 + 1, j, L] left storage of layer j-1.  Returns the
    left storage of layer j: [j//2 + 1, j+1, L]."""
    ca, cb, _, _ = level_coefs(j, left_r.dtype, left_r.device)
    p_r, p_i = half_prev_rows(left_r, left_i, j)
    return level_stitch(ca, cb, conj_mul(a_r, a_i, p_r, p_i),
                        conj_mul(b_r, b_i, p_r, p_i))


def _switch(r, rcut, rmin0):
    t = (r - rmin0) * PI / (rcut - rmin0)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    sfac = torch.where(r <= rmin0, one,
                       torch.where(r > rcut, zero, 0.5 * (torch.cos(t) + 1.0)))
    dsf = torch.where((r <= rmin0) | (r > rcut), zero,
                      -0.5 * torch.sin(t) * (PI / (rcut - rmin0)))
    return sfac, dsf


def geom_ck(x, y, z, rcut, rmin0, rfac0, switch_flag):
    """Cayley-Klein parameters + sfac, elementwise on lane vectors."""
    rsq = x * x + y * y + z * z
    r = torch.sqrt(rsq)
    rscale0 = rfac0 * PI / (rcut - rmin0)
    theta0 = (r - rmin0) * rscale0
    z0 = r * torch.cos(theta0) / torch.sin(theta0)
    r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
    sfac = (_switch(r, rcut, rmin0)[0] if switch_flag
            else torch.ones_like(r))
    return r0inv * z0, -r0inv * z, r0inv * y, -r0inv * x, sfac


def geom_ck_grad(x, y, z, rcut, rmin0, rfac0, switch_flag):
    """Geometry + per-direction derivatives, tuple-of-lanes form.

    Returns (a_r, a_i, b_r, b_i, sfac), and per direction k in (x, y, z):
    lists da_r[k], da_i[k], db_r[k], db_i[k], dsfac[k].
    """
    rsq = x * x + y * y + z * z
    r = torch.sqrt(rsq)
    rscale0 = rfac0 * PI / (rcut - rmin0)
    theta0 = (r - rmin0) * rscale0
    z0 = r * torch.cos(theta0) / torch.sin(theta0)
    dz0dr = z0 / r - r * rscale0 * (rsq + z0 * z0) / rsq
    r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
    dr0invdr = -(r0inv ** 3) * (r + z0 * dz0dr)
    unit = (x / r, y / r, z / r)
    if switch_flag:
        sfac, dsf = _switch(r, rcut, rmin0)
    else:
        sfac, dsf = torch.ones_like(r), torch.zeros_like(r)
    da_r, da_i, db_r, db_i, dsfac = [], [], [], [], []
    for k in range(3):
        dr0inv = dr0invdr * unit[k]
        dz0 = dz0dr * unit[k]
        da_r.append(dz0 * r0inv + z0 * dr0inv)
        da_i.append(-z * dr0inv - (r0inv if k == 2 else 0.0))
        db_r.append(y * dr0inv + (r0inv if k == 1 else 0.0))
        db_i.append(-x * dr0inv - (r0inv if k == 0 else 0.0))
        dsfac.append(dsf * unit[k])
    return ((r0inv * z0, -r0inv * z, r0inv * y, -r0inv * x, sfac),
            (da_r, da_i, db_r, db_i, dsfac))
