"""Adjoint Y stage (paper Sec. IV, LAMMPS compute_yi).

Replaces two TPU kernels of ``repro/kernels/snap_y.py``:

- :func:`snap_y_half` — ``snap_y_half_pallas``, the pipeline's default::

      Y_half[dest] += coef * (u1r + i s1 u1i) * (u2r + i s2 u2i)

  over the mirror-folded half-space Clebsch-Gordan table
  (``SnapIndex.z_half_*``: sources and destination in half space, s = +-1
  conjugation factors on the imaginary gathers, mirror signs folded into
  the CG weight), with ``coef = cg_folded * y_fac * beta[y_jjb]``
  (:func:`y_coef_half`).  Its ``mxu_dtype=torch.bfloat16`` option rounds
  the operands to bfloat16 where the TPU kernel fed them to its matrix
  unit, and sums in the planes' dtype.
- :func:`snap_y_full` — ``snap_y_pallas`` (``layout='full'``): the same
  sum over the full-space table (``SnapIndex.z_coo_*`` with the
  destination ``idxz_jju[z_coo_dest]``), no s, coefficients from
  :func:`y_coef`.  The mirror rows have no entries and read 0, as in
  ``compute_ylist``.

The TPU kernels fed these tables to one-hot matmuls in 512-entry tiles;
here each table is sorted by destination into CSR row pointers, and inside
a row by (src1, src2), once per 2J (:func:`y_half_csr`, :func:`y_full_csr`),
with each entry's sources and signs packed in one int32
(:func:`pack_entries`).  The CUDA kernels (``csrc/snap_y.cu``) stage each
block's U column tile in shared memory and walk the table without atomics,
with the plan of :func:`launch_plan.y_plan` and the row groups and slot
shares of :func:`launch_plan.y_segments`.  The ``*_plain`` functions are
the same sums in plain PyTorch.

Coefficients are one row ``[nnz]`` for every atom, or, for the batched
force entry (:func:`repro_torch.kernels.ops.make_batched_force_fn`: B
requests side by side on one atom axis, each with its own beta), one row
a lane ``[L, nnz]`` with ``lane_atoms`` atoms a lane: the TPU kernel got
the same from ``jax.vmap``, one grid slice a lane.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..analysis import launches
from .launch_plan import y_atoms, y_plan, y_segments
from ..core.indices import build_index

_CHUNK_BYTES = 256 * 1024 * 1024   # bound of one gathered [chunk, N] buffer
# planes, row pointers, packed table, coefficients, slot shares, outputs;
# rows, n, the plan's lanes, slots, groups and shared bytes, and the
# coefficient rows' lane width and stride (0, 0: one row)
_ARGS = (_build.P,) * 8 + (_build.I,) * 8
MXU_DTYPES = (None, torch.bfloat16)
SRC_BITS = 15           # a packed source index: rows < 2**15


class YCSR(NamedTuple):
    """A COO table sorted by destination and, inside a row, by (src1,
    src2) (stable), with CSR row pointers."""
    rowptr: np.ndarray    # [rows + 1] int32
    dest: np.ndarray      # [nnz] int32, non-decreasing
    src1: np.ndarray      # [nnz] int32
    src2: np.ndarray      # [nnz] int32
    sig1: np.ndarray | None   # [nnz] +-1 on Im(u[src1]); None: full table
    sig2: np.ndarray | None   # [nnz] +-1 on Im(u[src2]); None: full table
    cg: np.ndarray        # [nnz] CG product (half: mirror-folded)
    jjz: np.ndarray       # [nnz] idxz row (runtime beta gather)
    order: np.ndarray     # [nnz] position of each entry in the COO table
    packed: np.ndarray    # [nnz] int32, :func:`pack_entries`


def pack_entries(src1, src2, sig1=None, sig2=None) -> np.ndarray:
    """One int32 an entry, as ``csrc/snap_y.cu`` reads it: bits 0-14 src1,
    bit 15 set where s1 < 0, bits 16-30 src2, bit 31 set where s2 < 0 (no
    signs: the full table)."""
    src1, src2 = np.asarray(src1, np.int64), np.asarray(src2, np.int64)
    if len(src1) and max(src1.max(), src2.max()) >= 1 << SRC_BITS:
        raise ValueError(f'source rows must be < {1 << SRC_BITS}')
    neg1 = 0 if sig1 is None else (np.asarray(sig1) < 0).astype(np.int64)
    neg2 = 0 if sig2 is None else (np.asarray(sig2) < 0).astype(np.int64)
    word = src1 | neg1 << 15 | src2 << 16 | neg2 << 31
    return word.astype(np.uint32).view(np.int32)


def unpack_entries(packed):
    """(src1, src2, sig1, sig2) of :func:`pack_entries`' words; the signs
    as +-1.0."""
    word = np.asarray(packed).view(np.uint32).astype(np.int64)
    mask = (1 << SRC_BITS) - 1
    return (word & mask, word >> 16 & mask, 1.0 - 2.0 * (word >> 15 & 1),
            1.0 - 2.0 * (word >> 31 & 1))


def _csr(dest, nrows, src1, src2, sig1, sig2, cg, jjz) -> YCSR:
    order = np.lexsort((src2, src1, dest))      # stable, dest major
    counts = np.bincount(dest, minlength=nrows)
    sig1 = None if sig1 is None else sig1[order]
    sig2 = None if sig2 is None else sig2[order]
    return YCSR(rowptr=np.concatenate([[0], np.cumsum(counts)]).astype(
                    np.int32),
                dest=dest[order].astype(np.int32),
                src1=src1[order].astype(np.int32),
                src2=src2[order].astype(np.int32),
                sig1=sig1, sig2=sig2,
                cg=cg[order], jjz=jjz[order].astype(np.int32), order=order,
                packed=pack_entries(src1[order], src2[order], sig1, sig2))


@lru_cache(maxsize=16)
def y_half_csr(twojmax: int) -> YCSR:
    """The half-space table (``z_half_*``) over ``idxu_half_max`` rows."""
    idx = build_index(twojmax)
    return _csr(idx.z_half_dest, idx.idxu_half_max, idx.z_half_src1,
                idx.z_half_src2, idx.z_half_sig1, idx.z_half_sig2,
                idx.z_half_cg, idx.z_half_jjz)


@lru_cache(maxsize=16)
def y_full_csr(twojmax: int) -> YCSR:
    """The full-space table (``z_coo_*``, destination ``idxz_jju[jjz]``)
    over ``idxu_max`` rows."""
    idx = build_index(twojmax)
    return _csr(idx.idxz_jju[idx.z_coo_dest], idx.idxu_max, idx.z_coo_src1,
                idx.z_coo_src2, None, None, idx.z_coo_cg, idx.z_coo_dest)


_CSR = {'half': y_half_csr, 'full': y_full_csr}


@lru_cache(maxsize=64)
def y_launch_tables(twojmax: int, layout: str, device, groups: int,
                    slots: int):
    """The kernel's tables on ``device``: (rowptr, packed, segs) int32, segs
    the slot shares of a plan's ``groups`` x ``slots``
    (:func:`launch_plan.y_segments`); cached, so an evaluation uploads
    nothing."""
    t = _CSR[layout](twojmax)
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in (t.rowptr, t.packed,
                           y_segments(t.rowptr, groups, slots)))


@lru_cache(maxsize=32)
def y_tables(twojmax: int, dtype, device, layout: str = 'half'):
    """The plain version's table on ``device``: (dest, src1, src2) int32
    and (sig1, sig2) in ``dtype``, None for the full table."""
    t = _CSR[layout](twojmax)
    i32 = dict(dtype=torch.int32, device=device)
    sig = [None if v is None else torch.as_tensor(v, dtype=dtype,
                                                  device=device)
           for v in (t.sig1, t.sig2)]
    return (torch.as_tensor(t.dest, **i32), torch.as_tensor(t.src1, **i32),
            torch.as_tensor(t.src2, **i32), *sig)


@lru_cache(maxsize=32)
def _coef_tables(twojmax: int, dtype, device, layout: str):
    """(y_jjb, y_fac, jjz, cg) of a table's coefficient on ``device``, the
    floats already in ``dtype`` (read-only, cached so an evaluation
    uploads no table)."""
    idx, t = build_index(twojmax), _CSR[layout](twojmax)
    i64 = dict(dtype=torch.long, device=device)
    return (torch.as_tensor(idx.y_jjb, **i64),
            torch.as_tensor(idx.y_fac, dtype=dtype, device=device),
            torch.as_tensor(t.jjz, **i64),
            torch.as_tensor(t.cg, dtype=dtype, device=device))


def _coef(beta, twojmax, layout):
    # the f64 host tables are cast to beta's dtype *before* multiplying, so
    # an f32 beta gives f32 arithmetic throughout
    jjb, y_fac, jjz, cg = _coef_tables(twojmax, beta.dtype, beta.device,
                                       layout)
    return cg * (y_fac * beta[..., jjb])[..., jjz]


def y_coef_half(beta, twojmax: int):
    """Per-entry coefficient ``cg_folded * y_fac * beta[y_jjb]`` in the CSR
    order of :func:`y_half_csr`: beta [ncoeff] -> [nnz], or [L, ncoeff] ->
    [L, nnz] (a row a lane), in beta's dtype on beta's device."""
    return _coef(beta, twojmax, 'half')


def y_coef(beta, twojmax: int):
    """Per-entry coefficient ``cg * y_fac * beta[y_jjb]`` in the CSR order
    of :func:`y_full_csr`: beta [ncoeff] -> [nnz], or [L, ncoeff] -> [L,
    nnz], in beta's dtype on beta's device."""
    return _coef(beta, twojmax, 'full')


def check_mxu_dtype(mxu_dtype):
    if mxu_dtype not in MXU_DTYPES:
        raise ValueError(f'mxu_dtype must be one of {MXU_DTYPES}, got '
                         f'{mxu_dtype!r}')


def round_bf16(x):
    """x rounded to the nearest bfloat16 (ties to even), kept in x's dtype.

    float64 rounds once, on its bits, as the kernel's ``__double2bfloat16``
    does (``.to(torch.bfloat16)`` would round through float32: twice); the
    values are taken to lie inside bfloat16's exponent range."""
    if x.dtype != torch.float64:
        return x.to(torch.bfloat16).to(x.dtype)
    drop = 52 - 7                      # mantissa bits float64 -> bfloat16
    bits = x.view(torch.int64)
    odd = (bits >> drop) & 1
    bits = (bits + ((1 << (drop - 1)) - 1) + odd) & ~((1 << drop) - 1)
    return bits.view(torch.float64)


def _check(ut_r, ut_i, coef, twojmax, layout, lane_atoms):
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
    t = _CSR[layout](twojmax)
    nrows = len(t.rowptr) - 1
    if ut_r.ndim != 2 or ut_r.shape[0] != nrows or ut_i.shape != ut_r.shape:
        raise ValueError(f'U planes must be [{nrows}, N], got '
                         f'{tuple(ut_r.shape)} / {tuple(ut_i.shape)}')
    nnz, n = len(t.dest), ut_r.shape[1]
    if lane_atoms is None:
        if coef.shape != (nnz,):
            raise ValueError(f'coef must be [{nnz}], got {tuple(coef.shape)}'
                             ' (a row a lane needs lane_atoms)')
        return
    # a row a lane: every atom tile of the kernel lies inside one lane
    tile = y_atoms(ut_r.element_size(),
                   y_plan(twojmax, ut_r.dtype, layout, n).lanes)
    if coef.ndim != 2 or coef.shape[1] != nnz or \
            coef.shape[0] * lane_atoms != n:
        raise ValueError(f'coef must be [L, {nnz}] with L * lane_atoms = '
                         f'{n}, got {tuple(coef.shape)} and lane_atoms '
                         f'{lane_atoms}')
    if lane_atoms <= 0 or lane_atoms % tile:
        raise ValueError(f'lane_atoms {lane_atoms} must be a positive '
                         f'multiple of the Y tile of {tile} atoms')


def _y_plain(ut_r, ut_i, coef, twojmax, layout, bf16=False,
             lane_atoms=None):
    """Gathers and ``index_add_`` over the CSR-ordered table, chunked so a
    gathered [chunk, N] buffer stays under 256 MB.  With ``lane_atoms``,
    ``coef`` has a row a lane and each atom takes its lane's row."""
    dev, dt = ut_r.device, ut_r.dtype
    dest, src1, src2, sig1, sig2 = y_tables(twojmax, dt, dev, layout)
    y_r, y_i = torch.zeros_like(ut_r), torch.zeros_like(ut_i)
    if bf16:
        ut_r, ut_i, coef = round_bf16(ut_r), round_bf16(ut_i), \
            round_bf16(coef)
    n = ut_r.shape[1]
    lane = (None if lane_atoms is None else
            torch.arange(n, device=dev) // lane_atoms)
    chunk = max(1, _CHUNK_BYTES // max(1, n * ut_r.element_size()))
    for lo in range(0, len(dest), chunk):
        s = slice(lo, lo + chunk)
        i1, i2 = src1[s].long(), src2[s].long()
        v1r, v1i = ut_r[i1], ut_i[i1]
        v2r, v2i = ut_r[i2], ut_i[i2]
        if sig1 is not None:
            v1i, v2i = v1i * sig1[s, None], v2i * sig2[s, None]
        p_r, p_i = v1r * v2r - v1i * v2i, v1r * v2i + v1i * v2r
        if bf16:
            p_r, p_i = round_bf16(p_r), round_bf16(p_i)
        c = coef[s, None] if lane is None else coef[:, s][lane].T
        d = dest[s].long()
        y_r.index_add_(0, d, c * p_r)
        y_i.index_add_(0, d, c * p_i)
    return y_r, y_i


def snap_y_half_plain(ut_r, ut_i, coef, *, twojmax, mxu_dtype=None,
                      lane_atoms=None):
    """Plain version of :func:`snap_y_half`."""
    check_mxu_dtype(mxu_dtype)
    return _y_plain(ut_r, ut_i, coef, twojmax, 'half',
                    bf16=mxu_dtype is not None, lane_atoms=lane_atoms)


def snap_y_full_plain(ut_r, ut_i, coef, *, twojmax, lane_atoms=None):
    """Plain version of :func:`snap_y_full`."""
    return _y_plain(ut_r, ut_i, coef, twojmax, 'full',
                    lane_atoms=lane_atoms)


def _y(name, layout, ut_r, ut_i, coef, twojmax, mxu_dtype=None,
       lane_atoms=None):
    _check(ut_r, ut_i, coef, twojmax, layout, lane_atoms)
    check_mxu_dtype(mxu_dtype)
    if mxu_dtype is not None:
        name += '_bf16'
    meta = dict(twojmax=twojmax, mxu_dtype=mxu_dtype)
    if ut_r.device.type == 'cpu':
        return launches.plain(name, (ut_r, ut_i, coef), meta, _y_plain,
                              ut_r, ut_i, coef, twojmax, layout,
                              bf16=mxu_dtype is not None,
                              lane_atoms=lane_atoms)
    if ut_r.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {ut_r.device}')
    rows, n = ut_r.shape
    plan = y_plan(twojmax, ut_r.dtype, layout, n)
    tables = y_launch_tables(twojmax, layout, ut_r.device, plan.groups,
                             plan.threads)
    y_r, y_i = torch.empty_like(ut_r), torch.empty_like(ut_i)
    sym = name + ('_f32' if ut_r.dtype == torch.float32 else '_f64')
    _build.launch('snap_y', sym, _ARGS, ut_r, ut_i, tables[0], tables[1],
                  coef, tables[2], y_r, y_i, rows, n, plan.lanes,
                  plan.threads, plan.groups, plan.smem, lane_atoms or 0,
                  coef.shape[-1] if lane_atoms else 0)
    launches.record(name, (ut_r, ut_i, coef), (y_r, y_i), **meta)
    return y_r, y_i


def snap_y_half(ut_r, ut_i, coef, *, twojmax, mxu_dtype=None,
                lane_atoms=None):
    """ut_r/ut_i: [idxu_half_max, natoms_pad] half U planes (self term
    included); coef: [nnz] from :func:`y_coef_half`, in the planes' dtype,
    or, with ``lane_atoms``, [L, nnz]: atom a takes row a // lane_atoms
    (L * lane_atoms = natoms_pad, lane_atoms a multiple of the kernel's
    atom tile).

    Returns (y_r, y_i) [idxu_half_max, natoms_pad]: the left rows of the
    adjoint on the weighted support (dropped weight-0 middle-row columns
    read 0).  ``mxu_dtype=torch.bfloat16`` rounds u, the complex products
    and the coefficients to bfloat16 and sums in the planes' dtype (its
    launches count as ``snap_y_half_bf16``)."""
    return _y('snap_y_half', 'half', ut_r, ut_i, coef, twojmax, mxu_dtype,
              lane_atoms)


def snap_y_full(ut_r, ut_i, coef, *, twojmax, lane_atoms=None):
    """ut_r/ut_i: [idxu_max, natoms_pad] full U planes (self term
    included); coef: [nnz] from :func:`y_coef`, in the planes' dtype, or
    [L, nnz] with ``lane_atoms`` as in :func:`snap_y_half`.

    Returns (y_r, y_i) [idxu_max, natoms_pad], the mirror rows 0."""
    return _y('snap_y_full', 'full', ut_r, ut_i, coef, twojmax,
              lane_atoms=lane_atoms)
