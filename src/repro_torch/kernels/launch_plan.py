"""Launch plans of the U, Y and fused dE kernels on the H100.

A plan fixes a kernel's block, grid and dynamic shared memory from
(twojmax, dtype, n, nnbor) (Y: (twojmax, dtype, layout, n)):

- ``lanes`` on ``threadIdx.x``: atoms of one tile (U), 16-byte vectors of
  a tile's atoms (Y) or pairs of one neighbor slot (fused dE), consecutive
  atoms, so plane accesses coalesce;
- ``threads`` on ``threadIdx.y``: the threads that share the elements of a
  Wigner level; thread y takes a contiguous run of the level's left rows
  (:func:`element_map`).  In Y they are row slots: slot y walks its own
  run of the table's entries (:func:`y_segments`);
- ``groups`` on ``blockIdx.y``: U's neighbor groups, each summing its
  share of the neighbors into its partial plane (a second kernel adds the
  groups' partial planes in order); Y's row groups, contiguous ranges of
  destination rows with about equal numbers of table entries
  (:func:`y_row_groups`).

The shared-memory byte counts (:func:`u_smem`, :func:`de_smem`,
:func:`y_smem`) repeat the CUDA sources' own arithmetic (``csrc/snap_u.cu:
u_smem_elems``, ``csrc/snap_fused_de.cu: de_smem_bytes``, ``csrc/snap_y.cu:
y_smem_bytes``); each launcher checks the plan's numbers against it and
refuses a mismatch.  A plan that does not fit the card (more than 232,448
B of shared memory or 1,024 threads a block; Y: 512) raises
``ValueError``.  Plain Python, importable without a card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .common import MAX_TWOJMAX

SMEM_MAX = 232_448      # bytes of shared memory one block may use (H100)
THREADS_MAX = 1024      # threads of one block
SMS = 132               # streaming multiprocessors of an H100 SXM
SM_SMEM = 233_472       # shared memory of one SM (228 KB) ...
BLOCK_RESERVED = 1024   # ... of which each resident block takes 1 KB more
SM_THREADS = 2048       # resident threads of one SM
ROOTPQ_SIZE = (MAX_TWOJMAX + 1) ** 2
# fused dE: geometry fields a pair, state arrays a level, table values
DE_GEO, DE_STATE, DE_TAB = 20, 8, 5
# Defaults, chosen by timing plans on an H100 at 2J = 8 and 14 (PERF.md):
# lanes start at these by element size; threads a level give each thread
# about ELEMS_PER_THREAD elements of the largest level, as a power of two in
# THREADS_RANGE (U rounds up, fused dE, with 8 state arrays a pair, down); a
# block holds at most BLOCK_THREADS threads (~128 registers a thread in
# f64); a U neighbor group walks at most GROUP_NEIGHBORS neighbors
LANES = {8: 16, 4: 32}
ELEMS_PER_THREAD = 6
THREADS_RANGE = (8, 32)
BLOCK_THREADS = 512
GROUP_NEIGHBORS = 9
# Y: a thread owns one 16-byte vector of atoms (Y_VEC_BYTES), a block at
# most Y_THREADS_MAX threads (the kernel's launch bound), lanes one of
# Y_LANES (the kernel's instances); defaults: the widest lanes that fit,
# Y_THREADS_MAX threads a block, whole waves of resident blocks
Y_VEC_BYTES = 16
Y_THREADS_MAX = 512
Y_LANES = (32, 16, 8, 4)


@dataclass(frozen=True)
class LaunchPlan:
    kernel: str          # 'snap_u', 'snap_y' or 'snap_fused_de'
    lanes: int           # atoms (U), atom vectors (Y), pairs (dE) a block
    threads: int         # threads sharing a level's elements; Y: row slots
    groups: int          # neighbor groups (U), row groups (Y); 1 for dE
    block: tuple         # (lanes, threads, 1)
    grid: tuple          # (x, y, 1)
    smem: int            # dynamic shared memory a block, bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def describe(self) -> str:
        return (f'{self.kernel}: lanes {self.lanes} x threads {self.threads}'
                f' ({self.lanes * self.threads} a block), groups '
                f'{self.groups}, grid {self.grid[0]} x {self.grid[1]} = '
                f'{self.blocks} blocks, {self.smem} B shared memory')


def half_level_max(twojmax: int) -> int:
    """Elements of the largest level's left rows, (2J/2 + 1)(2J + 1)."""
    return (twojmax // 2 + 1) * (twojmax + 1)


def half_rows(twojmax: int) -> int:
    """idxu_half_max: left-row elements of every level up to 2J."""
    return sum((j // 2 + 1) * (j + 1) for j in range(twojmax + 1))


def full_rows(twojmax: int) -> int:
    """idxu_max: every element of every level up to 2J."""
    return sum((j + 1) ** 2 for j in range(twojmax + 1))


def _itemsize(dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'no launch plan for dtype {dtype}')
    return torch.empty((), dtype=dtype).element_size()


def u_smem(twojmax: int, itemsize: int, lanes: int, threads: int) -> int:
    """Bytes: rootpq, the Cayley-Klein parameters of ``threads``
    neighbors, the level ping-pong [2][re, im][L][lanes] and the group's
    sum [re, im][idxu_half_max][lanes]."""
    return itemsize * (ROOTPQ_SIZE + 5 * threads * lanes
                       + 4 * half_level_max(twojmax) * lanes
                       + 2 * half_rows(twojmax) * lanes)


def de_buf_size(twojmax: int, parity: int) -> int:
    """Elements of the fused dE level buffer of ``parity``: the largest
    left-rows level of that parity below 2J (level 2J is never read back),
    at least 1."""
    j = twojmax - 1
    if j >= 0 and j % 2 != parity:
        j -= 1
    return (j // 2 + 1) * (j + 1) if j >= 0 else 1


def de_smem(twojmax: int, itemsize: int, lanes: int, threads: int) -> int:
    """Bytes: the pairs' geometry and gradient; the state region, the
    level state [u, du x 3 as re, im][L_b][lanes] of the even and the odd
    buffer, which the end-of-pair reduction [3][threads][lanes] reuses; the
    element table (two term coefficients as re, im and the weight in the
    element type, the stored index as a 4-byte int)."""
    stored = DE_STATE * (de_buf_size(twojmax, 0) + de_buf_size(twojmax, 1))
    h = half_rows(twojmax)
    return (itemsize * (DE_GEO * lanes + max(stored, 3 * threads) * lanes
                        + DE_TAB * h) + 4 * h)


def _check(kernel, twojmax, lanes, threads, smem):
    if not 0 <= twojmax <= MAX_TWOJMAX:
        raise ValueError(f'twojmax={twojmax} outside 0..{MAX_TWOJMAX}')
    if lanes < 1 or threads < 1:
        raise ValueError(f'{kernel}: lanes {lanes} and threads {threads} '
                         'must be positive')
    if lanes * threads > THREADS_MAX:
        raise ValueError(f'{kernel}: {lanes} x {threads} threads a block '
                         f'exceed {THREADS_MAX}')
    if smem > SMEM_MAX:
        raise ValueError(f'{kernel}: {smem} B of shared memory a block '
                         f'exceed {SMEM_MAX} (2J={twojmax}, lanes {lanes})')


def resident_blocks(smem: int, threads: int) -> int:
    """Blocks an SM can hold by shared memory and thread count alone
    (registers permitting; ``chip_smoke.py`` prints the card's own count)."""
    return max(1, min(SM_SMEM // (smem + BLOCK_RESERVED),
                      SM_THREADS // threads))


def level_threads(twojmax: int, round_up: bool) -> int:
    """Threads a level: ~ELEMS_PER_THREAD elements of the largest level
    each, as a power of two in THREADS_RANGE, rounded up or down (8 at
    2J = 8; 32 up, 16 down at 2J = 14)."""
    lo, hi = THREADS_RANGE
    want, t = -(-half_level_max(twojmax) // ELEMS_PER_THREAD), lo
    while t < hi and (t < want if round_up else 2 * t <= want):
        t *= 2
    return t


def _fit_lanes(smem_of, start, threads, min_resident=1):
    """The largest power of two <= ``start`` whose block fits, has at most
    BLOCK_THREADS threads and lets an SM hold ``min_resident`` blocks by
    shared memory; failing the last, the largest that fits."""
    fits = [lanes for lanes in (start >> i for i in range(start.bit_length()))
            if smem_of(lanes) <= SMEM_MAX
            and lanes * threads <= BLOCK_THREADS]
    for lanes in fits:
        if resident_blocks(smem_of(lanes), lanes * threads) >= min_resident:
            return lanes
    return fits[0] if fits else 1


@lru_cache(maxsize=None)
def u_plan(twojmax: int, dtype, n: int, nnbor: int, lanes: int = None,
           threads: int = None, groups: int = None) -> LaunchPlan:
    """Plan of ``snap_u_{half,full}_*``.  Unset numbers are chosen: the
    threads of :func:`level_threads` (rounded up), the widest atom tile
    (16 f64, 32 f32 at most) that fits with two blocks an SM, and enough
    neighbor groups to fill one wave of resident blocks, with at most
    GROUP_NEIGHBORS neighbors a group."""
    size = _itemsize(dtype)
    threads = threads or level_threads(twojmax, round_up=True)
    if lanes is None:
        lanes = _fit_lanes(lambda a: u_smem(twojmax, size, a, threads),
                           LANES[size], threads, min_resident=2)
    smem = u_smem(twojmax, size, lanes, threads)
    _check('snap_u', twojmax, lanes, threads, smem)
    tiles = max(1, math.ceil(n / lanes))
    if groups is None:
        wave = SMS * resident_blocks(smem, lanes * threads)
        groups = min(max(nnbor, 1),
                     max(1, wave // tiles, -(-nnbor // GROUP_NEIGHBORS)))
    if not 1 <= groups <= max(nnbor, 1):
        raise ValueError(f'snap_u: groups {groups} outside 1..{max(nnbor, 1)}')
    return LaunchPlan('snap_u', lanes, threads, groups, (lanes, threads, 1),
                      (tiles, groups, 1), smem)


@lru_cache(maxsize=None)
def de_plan(twojmax: int, dtype, n: int, nnbor: int, lanes: int = None,
            threads: int = None) -> LaunchPlan:
    """Plan of ``snap_fused_de_{half,full}_*``: the threads of
    :func:`level_threads` (rounded down), the widest pair tile that fits
    (16 f64, 32 f32 at most); one block row per neighbor slot."""
    size = _itemsize(dtype)
    threads = threads or level_threads(twojmax, round_up=False)
    if lanes is None:
        lanes = _fit_lanes(lambda p: de_smem(twojmax, size, p, threads),
                           LANES[size], threads)
    smem = de_smem(twojmax, size, lanes, threads)
    _check('snap_fused_de', twojmax, lanes, threads, smem)
    return LaunchPlan('snap_fused_de', lanes, threads, 1, (lanes, threads, 1),
                      (max(1, math.ceil(n / lanes)), nnbor, 1), smem)


def element_map(j: int, threads: int, y: int) -> list:
    """The (mb, ma) left-row elements of level j that thread y computes, in
    its order: the contiguous run of ceil(size / threads) elements starting
    at y * ceil(size / threads), size = (j/2 + 1)(j + 1), walked along the
    rows (``csrc/snap_common.cuh: run_bounds``)."""
    cols, size = j + 1, (j // 2 + 1) * (j + 1)
    run = -(-size // threads)
    lo = min(y * run, size)
    return [divmod(e, cols) for e in range(lo, min(lo + run, size))]


def y_atoms(itemsize: int, lanes: int) -> int:
    """Atoms of a Y tile: ``lanes`` threads of one 16-byte vector each."""
    return lanes * (Y_VEC_BYTES // itemsize)


def y_smem(rows: int, itemsize: int, lanes: int, slots: int) -> int:
    """Bytes: the block's U column tile [rows][re, im][atoms] and the
    slots' partial sums of a row split between slots [re, im][slots][atoms],
    atoms = :func:`y_atoms` (``csrc/snap_y.cu: y_smem_bytes``)."""
    return itemsize * 2 * y_atoms(itemsize, lanes) * (rows + slots)


def y_rows(twojmax: int, layout: str) -> int:
    if layout not in ('half', 'full'):
        raise ValueError(f"layout must be 'half' or 'full', got {layout!r}")
    return half_rows(twojmax) if layout == 'half' else full_rows(twojmax)


@lru_cache(maxsize=None)
def y_plan(twojmax: int, dtype, layout: str, n: int, lanes: int = None,
           slots: int = None, groups: int = None) -> LaunchPlan:
    """Plan of ``snap_y_{half,half_bf16,full}_*``: ``lanes`` threads on
    an atom tile of :func:`y_atoms` atoms (a 16-byte vector each), ``slots``
    (the plan's ``threads``) row slots, ``groups`` row groups.  Unset
    numbers are chosen: the widest lanes of Y_LANES whose block of
    Y_THREADS_MAX threads fits, and Y_THREADS_MAX threads a block (the
    fastest in plan timings on an H100 at 2J = 8 and 14, PERF.md, but for
    the bfloat16 option); and, by a rule, not by the timings, the fewest
    whole waves of resident blocks that launch at least SMS blocks, so
    that every SM gets one (``chip_smoke.py`` checks it at snap-2j8).  One
    wave of fewer than SMS blocks timed faster in every case (PERF.md)."""
    if not 0 <= twojmax <= MAX_TWOJMAX:
        raise ValueError(f'twojmax={twojmax} outside 0..{MAX_TWOJMAX}')
    size, rows = _itemsize(dtype), y_rows(twojmax, layout)
    if lanes is None:
        fits = [a for a in Y_LANES
                if y_smem(rows, size, a, Y_THREADS_MAX // a) <= SMEM_MAX]
        lanes = fits[0] if fits else Y_LANES[-1]
    if lanes not in Y_LANES:
        raise ValueError(f'snap_y: lanes {lanes} not one of {Y_LANES}')
    slots = slots or Y_THREADS_MAX // lanes
    smem = y_smem(rows, size, lanes, slots)
    _check('snap_y', twojmax, lanes, slots, smem)
    if lanes * slots > Y_THREADS_MAX:
        raise ValueError(f'snap_y: {lanes} x {slots} threads a block exceed '
                         f'{Y_THREADS_MAX}')
    tiles = max(1, math.ceil(n / y_atoms(size, lanes)))
    if groups is None:
        wave, waves = SMS * resident_blocks(smem, lanes * slots), 1
        groups = max(1, wave // tiles)
        while tiles * groups < SMS and groups < rows:
            waves += 1
            groups = waves * wave // tiles
        groups = min(groups, rows)
    if not 1 <= groups <= min(rows, 65535):
        raise ValueError(f'snap_y: groups {groups} outside 1..{rows}')
    return LaunchPlan('snap_y', lanes, slots, groups, (lanes, slots, 1),
                      (tiles, groups, 1), smem)


def y_row_groups(rowptr, groups: int) -> np.ndarray:
    """[groups + 1] row boundaries: group g owns the destination rows
    [b[g], b[g + 1]), cut where the running count of table entries
    (``rowptr``, CSR row pointers) first reaches g / groups of the total.
    Contiguous, in order, every row exactly once; a group's count exceeds
    the mean by less than the longest row."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    nrows, nnz = len(rowptr) - 1, int(rowptr[-1])
    if not 1 <= groups <= max(nrows, 1):
        raise ValueError(f'groups {groups} outside 1..{nrows}')
    cut = np.searchsorted(rowptr[:-1], (np.arange(1, groups) * nnz)
                          / groups, side='left')
    # no empty group: each boundary at least one row past the previous
    bounds = [0]
    for c in cut:
        bounds.append(min(max(int(c), bounds[-1] + 1),
                          nrows - (groups - len(bounds))))
    return np.asarray(bounds + [nrows], dtype=np.int32)


def y_segments(rowptr, groups: int, slots: int) -> np.ndarray:
    """[2, groups * slots + 1] int32: row 0 the first table entry of each
    slot, row 1 the first row it owns (``csrc/snap_y.cu`` walks them).

    Slot y of row group g (segment s = g * slots + y) sums the entries
    [e[s], e[s + 1]), an equal share of the group's entries, and owns (and
    writes) the rows [r[s], r[s + 1]): those whose first entry lies in its
    share, and, for the group's last slot, the group's trailing empty rows.
    The entries of a share before its first owned row belong to a row that
    an earlier slot of the same group owns and finishes."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    bounds = y_row_groups(rowptr, groups)
    e_lo, r_lo = [], []
    for g in range(groups):
        r0, r1 = int(bounds[g]), int(bounds[g + 1])
        a, b = int(rowptr[r0]), int(rowptr[r1])
        for y in range(slots):
            e = a + (y * (b - a)) // slots
            e_lo.append(e)
            r_lo.append(r0 + int(np.searchsorted(rowptr[r0:r1], e, 'left')))
    e_lo.append(int(rowptr[-1]))
    r_lo.append(len(rowptr) - 1)
    return np.asarray([e_lo, r_lo], dtype=np.int32)
