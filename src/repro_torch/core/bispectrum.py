"""Clebsch-Gordan stages: Z (eq. 3), B (eq. 2), and the adjoint Y (eq. 7).

Port of ``repro.core.bispectrum``: the irregular triple loops of LAMMPS
``compute_zi`` / ``compute_bi`` / ``compute_yi`` as COO gather /
scatter-add (``index_add_``) over the static tables of
:mod:`repro_torch.core.indices`, vectorized over atoms.

``compute_ylist`` fuses the Z product with the beta-weighted accumulation,
so Z is never stored (the paper's adjoint refactorization).
"""

from __future__ import annotations

import numpy as np
import torch

from .indices import SnapIndex

_CHUNK_BYTES = 256 * 1024 * 1024  # peak size of a gathered COO intermediate


def _auto_chunks(natoms: int, nnz: int, itemsize: int = 16) -> int:
    return max(1, int(np.ceil(natoms * nnz * itemsize / _CHUNK_BYTES)))


def _long(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def _chunked_scatter_products(ut, src1, src2, coef, dest, out_width,
                              nchunk=None):
    """out[n, dest] += coef * ut[n, src1] * ut[n, src2], chunked over the
    COO axis to bound the [natoms, chunk] intermediates.

    coef: real tensor [nnz] (or [natoms, nnz]) on ``ut``'s device.
    """
    dev = ut.device
    n = ut.shape[0]
    out = torch.zeros((n, out_width), dtype=ut.dtype, device=dev)
    nnz = len(src1)
    if nchunk is None:
        nchunk = _auto_chunks(n, nnz)
    bounds = np.linspace(0, nnz, nchunk + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        prod = (ut[:, _long(src1[lo:hi], dev)] * ut[:, _long(src2[lo:hi], dev)]
                * coef[..., lo:hi].to(ut.real.dtype))
        out.index_add_(1, _long(dest[lo:hi], dev), prod)
    return out


def compute_zlist(ulisttot, idx: SnapIndex, nchunk=None):
    """Z matrices, complex [natoms, idxz_max] (LAMMPS compute_zi)."""
    cg = torch.as_tensor(idx.z_coo_cg, device=ulisttot.device)
    return _chunked_scatter_products(
        ulisttot, idx.z_coo_src1, idx.z_coo_src2, cg, idx.z_coo_dest,
        idx.idxz_max, nchunk)


def compute_blist(ulisttot, zlist, idx: SnapIndex, bzero_flag=True):
    """Bispectrum components, real [natoms, idxb_max] (LAMMPS compute_bi).

    B[jjb] = 2 * sum_half w * Re(conj(u) z)  [- bzero[j]]
    """
    dev = ulisttot.device
    rdt = ulisttot.real.dtype
    u = ulisttot[:, _long(idx.b_coo_usrc, dev)]
    z = zlist[:, _long(idx.b_coo_zsrc, dev)]
    w = torch.as_tensor(idx.b_coo_w, dtype=rdt, device=dev)
    contrib = w * (u.real * z.real + u.imag * z.imag)
    b = torch.zeros((ulisttot.shape[0], idx.idxb_max), dtype=rdt, device=dev)
    b = b.index_add(1, _long(idx.b_coo_dest, dev), contrib)
    if bzero_flag:
        shift = np.array([idx.bzero[t[2]] for t in idx.idxb_triples])
        b = b - torch.as_tensor(shift, dtype=rdt, device=dev)
    return b


def compute_ylist(ulisttot, beta, idx: SnapIndex, nchunk=None):
    """Adjoint matrices Y_j = sum beta * Z (paper eq. 7, LAMMPS compute_yi).

    The COO destination is remapped ``jjz -> jju`` and the per-jjz factor
    ``betaj`` is folded into the CG coefficient, so no Z storage (O(J^5))
    ever exists.  beta: [idxb_max].  Returns complex [natoms, idxu_max]
    (half-plane filled).
    """
    dev = ulisttot.device
    rdt = ulisttot.real.dtype
    beta = beta.to(device=dev, dtype=rdt)
    betaj = torch.as_tensor(idx.y_fac, dtype=rdt, device=dev) * \
        beta[..., _long(idx.y_jjb, dev)]
    coef = (torch.as_tensor(idx.z_coo_cg, dtype=rdt, device=dev)
            * betaj[..., _long(idx.z_coo_dest, dev)])
    return _chunked_scatter_products(
        ulisttot, idx.z_coo_src1, idx.z_coo_src2, coef,
        idx.idxz_jju[idx.z_coo_dest], idx.idxu_max, nchunk)


def compute_dedr(du_pairs, ylist, atom_of_pair, idx: SnapIndex):
    """Fused force contraction (paper eq. 8, LAMMPS compute_deidrj).

    dE_i/dr_k = 2 * sum_half w * Re(conj(dU) Y);  real [P, 3].
    """
    y = ylist[atom_of_pair]                              # [P, idxu]
    w = torch.as_tensor(idx.dedr_weight, dtype=du_pairs.real.dtype,
                        device=du_pairs.device)
    s = (du_pairs.real * y.real[:, None, :]
         + du_pairs.imag * y.imag[:, None, :]) * w
    return 2.0 * torch.sum(s, dim=-1)
