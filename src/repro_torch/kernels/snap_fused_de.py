"""Full-plane fused dE stage: dU fused with the force contraction.

Replaces the TPU kernel
``repro/kernels/snap_fused_de.py:snap_fused_de_pallas`` (``layout='full'``).
For each (neighbor, atom) pair it carries u and du/d(x, y, z) through the
Wigner recursion and contracts each level with that atom's full-plane
adjoint Y:

    dedr[k, d, atom] = 2 sum w Re(conj(dsfac_d u + sfac du_d) Y)

with the full-layer weights ``common.level_coefs(j).W`` (0 on every mirror
row, 0.5 at j = 0 and on the middle element of the middle row).  Row 3 of
the output is 0.

- :func:`snap_fused_de_full` — the wrapper: CPU tensors run the plain
  version, CUDA tensors launch ``csrc/snap_fused_de.cu`` (one thread per
  pair; it carries the left rows only, since w is 0 on the others, and
  reads Y at their full-plane rows), anything else raises.
- :func:`snap_fused_de_full_plain` — the same function in plain PyTorch,
  built like the TPU kernel: full layers through
  ``common.dual_level_step``, vectorized over all pairs.
"""

from __future__ import annotations

import torch

from .common import dual_level_step, geom_ck_grad, level_coefs
from .snap_fused_de_half import fused_de
from ..core.indices import build_index


def snap_fused_de_full_plain(disp, y_r, y_i, *, twojmax, rcut, rmin0=0.0,
                             rfac0=0.99363, switch_flag=True):
    """Plain version: disp [nnbor, 4, N], Y full planes [idxu_max, N]
    -> dedr [nnbor, 4, N]."""
    idx = build_index(twojmax)
    nnbor, _, n = disp.shape
    dt, dev = disp.dtype, disp.device
    x, y, z, m = (disp[:, c, :].reshape(-1) for c in range(4))
    (a_r, a_i, b_r, b_i, sfac), (da_r, da_i, db_r, db_i, dsfac) = \
        geom_ck_grad(x, y, z, rcut, rmin0, rfac0, switch_flag)
    sfac = sfac * m
    dsfac = [d * m for d in dsfac]
    lanes = x.numel()
    u_r = torch.ones((1, 1, lanes), dtype=dt, device=dev)
    u_i = torch.zeros_like(u_r)
    du_r = [torch.zeros_like(u_r) for _ in range(3)]
    du_i = [torch.zeros_like(u_r) for _ in range(3)]
    acc = [torch.zeros(lanes, dtype=dt, device=dev) for _ in range(3)]

    def contract(j, u_r, u_i, du_r, du_i):
        base, size = int(idx.idxu_block[j]), (j + 1) ** 2
        # pair lane k*N + atom reads the Y column of its atom
        ys_r = y_r[base:base + size].repeat(1, nnbor).reshape(j + 1, j + 1,
                                                              lanes)
        ys_i = y_i[base:base + size].repeat(1, nnbor).reshape(j + 1, j + 1,
                                                              lanes)
        w = (torch.full((1, 1, 1), 0.5, dtype=dt, device=dev) if j == 0
             else level_coefs(j, dt, dev)[3])
        wy_r, wy_i = w * ys_r, w * ys_i
        for d in range(3):
            dU_r = dsfac[d] * u_r + sfac * du_r[d]
            dU_i = dsfac[d] * u_i + sfac * du_i[d]
            acc[d] = acc[d] + torch.sum(dU_r * wy_r + dU_i * wy_i,
                                        dim=(0, 1))

    contract(0, u_r, u_i, du_r, du_i)
    for j in range(1, twojmax + 1):
        u_r, u_i, du_r, du_i = dual_level_step(
            u_r, u_i, du_r, du_i, (a_r, a_i), (da_r, da_i), (b_r, b_i),
            (db_r, db_i), j)
        contract(j, u_r, u_i, du_r, du_i)
    out = torch.zeros((nnbor, 4, n), dtype=dt, device=dev)
    for d in range(3):
        out[:, d, :] = 2.0 * acc[d].reshape(nnbor, n)
    return out


def snap_fused_de_full(disp, y_r, y_i, *, twojmax, rcut, rmin0=0.0,
                       rfac0=0.99363, switch_flag=True):
    """disp [nnbor, 4, natoms_pad]; y_r/y_i full planes
    [idxu_max, natoms_pad] -> dedr [nnbor, 4, natoms_pad]."""
    return fused_de('snap_fused_de_full', snap_fused_de_full_plain,
                    build_index(twojmax).idxu_max, disp, y_r, y_i,
                    dict(twojmax=twojmax, rcut=rcut, rmin0=rmin0,
                         rfac0=rfac0, switch_flag=switch_flag))
