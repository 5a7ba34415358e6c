"""Half-plane fused dE stage: dU fused with the force contraction.

Replaces the TPU kernel
``repro/kernels/snap_fused_de_half.py:snap_fused_de_half_pallas``.  For
each (neighbor, atom) pair it carries u and du/d(x, y, z) on the left rows
2mb <= j through the Wigner recursion and contracts each level with that
atom's half-plane adjoint Y:

    dedr[k, d, atom] = 2 sum w Re(conj(dsfac_d u + sfac du_d) Y)

with weights w from the half-plane sum (0.5 at j = 0 and on the middle
element of the middle row at even j).  Row 3 of the output is 0.

- :func:`snap_fused_de_half` — the wrapper: CPU tensors run the plain
  version, CUDA tensors launch ``csrc/snap_fused_de.cu`` (pairs x the
  elements of each level, the level state in shared memory, with the plan
  of :func:`launch_plan.de_plan`), anything else raises.
- :func:`snap_fused_de_half_plain` — the same function in plain PyTorch,
  vectorized over all pairs.
"""

from __future__ import annotations

import torch

from . import _build
from ..analysis import launches
from .common import (conj_mul, geom_ck_grad, half_prev_rows, level_coefs,
                     level_stitch, rootpq)
from .launch_plan import de_plan
from .snap_u import check_disp
from ..core.indices import build_index

_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.P, _build.I,
         _build.I, _build.I, _build.D, _build.D, _build.D, _build.I,
         # launch plan: lanes, threads, shared bytes
         _build.I, _build.I, _build.I)


def _cm_add(x, y):
    return x[0] + y[0], x[1] + y[1]


def _half_level_step(p_r, p_i, dp_r, dp_i, a, da, b, db, j):
    """Advance left-rows-only (u, du[3]) one level: the value recursion of
    :func:`common.u_half_level_step`, and per tangent the product rule
    d(conj(c) u) = conj(dc) u + conj(c) du before the same column stitch."""
    ca, cb, _, _ = level_coefs(j, p_r.dtype, p_r.device)
    (a_r, a_i), (b_r, b_i) = a, b
    (da_r, da_i), (db_r, db_i) = da, db
    p_r, p_i = half_prev_rows(p_r, p_i, j)
    left = level_stitch(ca, cb, conj_mul(a_r, a_i, p_r, p_i),
                        conj_mul(b_r, b_i, p_r, p_i))
    dleft_r, dleft_i = [], []
    for k in range(3):
        q_r, q_i = half_prev_rows(dp_r[k], dp_i[k], j)
        dau = _cm_add(conj_mul(da_r[k], da_i[k], p_r, p_i),
                      conj_mul(a_r, a_i, q_r, q_i))
        dbu = _cm_add(conj_mul(db_r[k], db_i[k], p_r, p_i),
                      conj_mul(b_r, b_i, q_r, q_i))
        d_r, d_i = level_stitch(ca, cb, dau, dbu)
        dleft_r.append(d_r)
        dleft_i.append(d_i)
    return left[0], left[1], dleft_r, dleft_i


def snap_fused_de_half_plain(disp, y_r, y_i, *, twojmax, rcut, rmin0=0.0,
                             rfac0=0.99363, switch_flag=True):
    """Plain version: disp [nnbor, 4, N], Y half planes [idxu_half_max, N]
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
        base, rows = int(idx.idxu_half_block[j]), j // 2 + 1
        span = slice(base, base + rows * (j + 1))
        # pair lane k*N + atom reads the Y column of its atom
        ys_r = y_r[span].repeat(1, nnbor).reshape(rows, j + 1, lanes)
        ys_i = y_i[span].repeat(1, nnbor).reshape(rows, j + 1, lanes)
        w = (torch.full((1, 1, 1), 0.5, dtype=dt, device=dev) if j == 0
             else level_coefs(j, dt, dev)[3][:rows])
        wy_r, wy_i = w * ys_r, w * ys_i
        for d in range(3):
            dU_r = dsfac[d] * u_r + sfac * du_r[d]
            dU_i = dsfac[d] * u_i + sfac * du_i[d]
            acc[d] = acc[d] + torch.sum(dU_r * wy_r + dU_i * wy_i,
                                        dim=(0, 1))

    contract(0, u_r, u_i, du_r, du_i)
    for j in range(1, twojmax + 1):
        u_r, u_i, du_r, du_i = _half_level_step(
            u_r, u_i, du_r, du_i, (a_r, a_i), (da_r, da_i), (b_r, b_i),
            (db_r, db_i), j)
        contract(j, u_r, u_i, du_r, du_i)
    out = torch.zeros((nnbor, 4, n), dtype=dt, device=dev)
    for d in range(3):
        out[:, d, :] = 2.0 * acc[d].reshape(nnbor, n)
    return out


def check_y(disp, y_r, y_i, nrows):
    for name, t in (('y_r', y_r), ('y_i', y_i)):
        if t.dtype != disp.dtype or t.device != disp.device:
            raise TypeError(f'{name}: dtype/device {t.dtype}/{t.device} != '
                            f'{disp.dtype}/{disp.device}')
        if tuple(t.shape) != (nrows, disp.shape[2]) or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous [{nrows}, '
                             f'{disp.shape[2]}], got {tuple(t.shape)}')


def fused_de(name, plain, nrows, disp, y_r, y_i, geo):
    """The wrapper of both fused dE stages: checks, then the plain version
    on a CPU tensor or kernel ``name`` on a CUDA tensor."""
    check_disp(disp, geo['twojmax'])
    check_y(disp, y_r, y_i, nrows)
    meta = dict(twojmax=geo['twojmax'])
    if disp.device.type == 'cpu':
        return launches.plain(name, (disp, y_r, y_i), meta, plain, disp,
                              y_r, y_i, **geo)
    if disp.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {disp.device}')
    nnbor, _, n = disp.shape
    plan = de_plan(geo['twojmax'], disp.dtype, n, nnbor)
    out = torch.empty_like(disp)
    sym = name + ('_f32' if disp.dtype == torch.float32 else '_f64')
    _build.launch('snap_fused_de', sym, _ARGS, disp, y_r, y_i, out,
                  rootpq(disp.dtype, disp.device), nnbor, n, geo['twojmax'],
                  float(geo['rcut']), float(geo['rmin0']),
                  float(geo['rfac0']), int(geo['switch_flag']), plan.lanes,
                  plan.threads, plan.smem)
    launches.record(name, (disp, y_r, y_i), out, **meta)
    return out


def snap_fused_de_half(disp, y_r, y_i, *, twojmax, rcut, rmin0=0.0,
                       rfac0=0.99363, switch_flag=True):
    """disp [nnbor, 4, natoms_pad]; y_r/y_i half planes
    [idxu_half_max, natoms_pad] -> dedr [nnbor, 4, natoms_pad]."""
    return fused_de('snap_fused_de_half', snap_fused_de_half_plain,
                    build_index(twojmax).idxu_half_max, disp, y_r, y_i,
                    dict(twojmax=twojmax, rcut=rcut, rmin0=rmin0,
                         rfac0=rfac0, switch_flag=switch_flag))
