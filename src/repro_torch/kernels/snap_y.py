"""Half-plane adjoint Y stage (paper Sec. IV, LAMMPS compute_yi).

Replaces the TPU kernel ``repro/kernels/snap_y.py:snap_y_half_pallas``:

    Y_half[dest] += coef * (u1r + i s1 u1i) * (u2r + i s2 u2i)

over the mirror-folded half-space Clebsch-Gordan table
(``SnapIndex.z_half_*``: sources and destination in half space, s = +-1
conjugation factors on the imaginary gathers, mirror signs folded into the
CG weight), with ``coef = cg_folded * y_fac * beta[y_jjb]``.

The TPU kernel fed this table to one-hot matmuls in 512-entry tiles; here
the table is sorted by destination into CSR row pointers once per 2J
(:func:`y_half_csr`), which is the form the CUDA kernel
(``csrc/snap_y_half.cu``, one thread per (row, atom)) walks without
atomics.  :func:`snap_y_half_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..core.indices import build_index

_CHUNK_BYTES = 256 * 1024 * 1024   # bound of one gathered [chunk, N] buffer
_ARGS = (_build.P,) * 10 + (_build.I, _build.I)


class YHalfCSR(NamedTuple):
    """The half-space COO table sorted by destination (stable)."""
    rowptr: np.ndarray    # [idxu_half_max + 1] int32
    dest: np.ndarray      # [nnz] int32, non-decreasing
    src1: np.ndarray      # [nnz] int32
    src2: np.ndarray      # [nnz] int32
    sig1: np.ndarray      # [nnz] +-1 on Im(u[src1])
    sig2: np.ndarray      # [nnz] +-1 on Im(u[src2])
    cg: np.ndarray        # [nnz] mirror-folded CG product
    jjz: np.ndarray       # [nnz] idxz row (runtime beta gather)
    order: np.ndarray     # [nnz] position of each entry in the COO table


@lru_cache(maxsize=16)
def y_half_csr(twojmax: int) -> YHalfCSR:
    idx = build_index(twojmax)
    order = np.argsort(idx.z_half_dest, kind='stable')
    dest = idx.z_half_dest[order].astype(np.int32)
    counts = np.bincount(dest, minlength=idx.idxu_half_max)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return YHalfCSR(rowptr=rowptr, dest=dest,
                    src1=idx.z_half_src1[order].astype(np.int32),
                    src2=idx.z_half_src2[order].astype(np.int32),
                    sig1=idx.z_half_sig1[order], sig2=idx.z_half_sig2[order],
                    cg=idx.z_half_cg[order],
                    jjz=idx.z_half_jjz[order].astype(np.int32), order=order)


@lru_cache(maxsize=16)
def y_half_tables(twojmax: int, dtype, device):
    """CSR table on ``device``: (rowptr, dest, src1, src2) int32 and
    (sig1, sig2) in ``dtype``."""
    t = y_half_csr(twojmax)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.as_tensor(t.rowptr, **i32), torch.as_tensor(t.dest, **i32),
            torch.as_tensor(t.src1, **i32), torch.as_tensor(t.src2, **i32),
            torch.as_tensor(t.sig1, dtype=dtype, device=device),
            torch.as_tensor(t.sig2, dtype=dtype, device=device))


@lru_cache(maxsize=16)
def _coef_tables(twojmax: int, dtype, device):
    """(y_jjb, y_fac, jjz, cg) of :func:`y_coef_half` on ``device``, the
    floats already in ``dtype`` (read-only, cached so an evaluation
    uploads no table)."""
    idx, t = build_index(twojmax), y_half_csr(twojmax)
    i64 = dict(dtype=torch.long, device=device)
    return (torch.as_tensor(idx.y_jjb, **i64),
            torch.as_tensor(idx.y_fac, dtype=dtype, device=device),
            torch.as_tensor(t.jjz, **i64),
            torch.as_tensor(t.cg, dtype=dtype, device=device))


def y_coef_half(beta, twojmax: int):
    """Per-entry coefficient ``cg_folded * y_fac * beta[y_jjb]`` in the CSR
    order of :func:`y_half_csr`: [nnz] in beta's dtype on beta's device.

    The f64 host tables are cast to beta's dtype *before* multiplying, so
    an f32 beta gives f32 arithmetic throughout."""
    jjb, y_fac, jjz, cg = _coef_tables(twojmax, beta.dtype, beta.device)
    return cg * (y_fac * beta[jjb])[jjz]


def _check(ut_r, ut_i, coef, twojmax):
    for name, t in (('ut_r', ut_r), ('ut_i', ut_i), ('coef', coef)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name} must be a tensor')
        if t.dtype != ut_r.dtype or t.device != ut_r.device:
            raise TypeError(f'{name}: dtype/device {t.dtype}/{t.device} != '
                            f'{ut_r.dtype}/{ut_r.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if ut_r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'dtype must be float32/float64, got {ut_r.dtype}')
    nh = build_index(twojmax).idxu_half_max
    if ut_r.ndim != 2 or ut_r.shape[0] != nh or ut_i.shape != ut_r.shape:
        raise ValueError(f'U planes must be [{nh}, N], got '
                         f'{tuple(ut_r.shape)} / {tuple(ut_i.shape)}')
    nnz = len(y_half_csr(twojmax).dest)
    if coef.shape != (nnz,):
        raise ValueError(f'coef must be [{nnz}], got {tuple(coef.shape)}')


def snap_y_half_plain(ut_r, ut_i, coef, *, twojmax):
    """Plain version: gathers and ``index_add_`` over the CSR-ordered
    table, chunked so a gathered [chunk, N] buffer stays under 256 MB."""
    dev, dt = ut_r.device, ut_r.dtype
    _, dest, src1, src2, sig1, sig2 = y_half_tables(twojmax, dt, dev)
    y_r, y_i = torch.zeros_like(ut_r), torch.zeros_like(ut_i)
    n = ut_r.shape[1]
    chunk = max(1, _CHUNK_BYTES // max(1, n * ut_r.element_size()))
    for lo in range(0, len(dest), chunk):
        s = slice(lo, lo + chunk)
        i1, i2 = src1[s].long(), src2[s].long()
        v1r, v1i = ut_r[i1], ut_i[i1] * sig1[s, None]
        v2r, v2i = ut_r[i2], ut_i[i2] * sig2[s, None]
        c = coef[s, None]
        d = dest[s].long()
        y_r.index_add_(0, d, c * (v1r * v2r - v1i * v2i))
        y_i.index_add_(0, d, c * (v1r * v2i + v1i * v2r))
    return y_r, y_i


def snap_y_half(ut_r, ut_i, coef, *, twojmax):
    """ut_r/ut_i: [idxu_half_max, natoms_pad] half U planes (self term
    included); coef: [nnz] from :func:`y_coef_half`, in the planes' dtype.

    Returns (y_r, y_i) [idxu_half_max, natoms_pad]: the left rows of the
    adjoint on the weighted support (dropped weight-0 middle-row columns
    read 0)."""
    _check(ut_r, ut_i, coef, twojmax)
    if ut_r.device.type == 'cpu':
        return snap_y_half_plain(ut_r, ut_i, coef, twojmax=twojmax)
    if ut_r.device.type != 'cuda':
        raise RuntimeError(f'snap_y_half: no kernel for device {ut_r.device}')
    rowptr, _, src1, src2, sig1, sig2 = y_half_tables(twojmax, ut_r.dtype,
                                                      ut_r.device)
    y_r, y_i = torch.empty_like(ut_r), torch.empty_like(ut_i)
    sym = 'snap_y_half_f32' if ut_r.dtype == torch.float32 else \
        'snap_y_half_f64'
    _build.launch('snap_y_half', sym, _ARGS, ut_r, ut_i, rowptr, src1, src2,
                  sig1, sig2, coef, y_r, y_i, ut_r.shape[0], ut_r.shape[1])
    snap_y_half.launches += 1
    return y_r, y_i


snap_y_half.launches = 0
