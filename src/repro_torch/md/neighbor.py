"""Neighbor lists under periodic boundary conditions (host builders).

Two builders with identical output contracts:
- ``brute_neighbors``: O(N^2) vectorized minimum-image search (numpy) —
  the oracle, fine for the paper's 2000-atom benchmark.
- ``cell_neighbors``: linked-cell O(N) search for larger boxes.

Output: padded per-atom lists
    nbr_idx [N, K] int32, mask [N, K] bool, disp [N, K, 3]  (r_k - r_i),
    shifts [N, K, 3]  (periodic image offsets, so that
                       disp = pos[nbr] + shift - pos[i] exactly).

Both are host-side (numpy) and fully vectorized: they serve as the A/B
oracle for the on-device engine in :mod:`repro.md.cell_list`, so they must
be correct first and reasonably fast second (no per-atom Python loops).
"""

from __future__ import annotations

import numpy as np


def suggest_capacity(observed, headroom: float = 1.3, pad: int = 4) -> int:
    """Regrown static capacity for an observed max count: ``headroom``
    multiplicative margin + ``pad`` slots, rounded up to a multiple of 4
    (so regrown list widths stay layout-friendly and a run that overflows
    once does not overflow again on the next density fluctuation)."""
    raw = int(np.ceil(int(observed) * float(headroom))) + int(pad)
    return -(-raw // 4) * 4


class NeighborOverflowError(RuntimeError):
    """An atom has more neighbors within rcut than the padded list holds.

    Silent truncation would drop force pairs asymmetrically (violating
    Newton's third law and energy conservation), so both builders count
    every in-range candidate and raise instead.
    """

    def __init__(self, max_count, max_nbors):
        self.max_count = int(max_count)
        self.max_nbors = int(max_nbors)
        self.suggested = suggest_capacity(self.max_count)
        super().__init__(
            f'neighbor list overflow: an atom has {self.max_count} '
            f'neighbors within the build cutoff but capacity '
            f'max_nbors={self.max_nbors}; retry with '
            f'max_nbors={self.suggested} '
            f'(observed max {self.max_count} + headroom)')


def _min_image(d, box):
    return d - box * np.round(d / box)


def dedup_stencil(nbins):
    """Distinct 27-stencil offsets modulo the bin counts.

    With fewer than 3 bins along an axis the raw {-1, 0, +1} offsets alias
    (e.g. -1 ≡ +1 mod 2), so the same cell would be visited — and its atoms
    double-counted — more than once.  Deduplicating per axis keeps each
    neighboring cell exactly once for any nbins >= 1.
    """
    per_axis = [sorted({o % int(n) for o in (-1, 0, 1)}) for n in nbins]
    return [(a, b, c) for a in per_axis[0] for b in per_axis[1]
            for c in per_axis[2]]


def _pack_rows(cand, within, disp_c, shift_c, max_nbors):
    """Compact per-row candidate matrices into padded [N, K] lists.

    cand [N, C] candidate indices, within [N, C] validity, disp_c/shift_c
    [N, C, 3].  Vectorized row packing: row-major ``nonzero`` preserves
    candidate order, and each hit's output slot is its rank within the row.
    """
    N = within.shape[0]
    counts = within.sum(1)
    K = int(max_nbors)
    nbr_idx = np.zeros((N, K), np.int32)
    mask = np.zeros((N, K), bool)
    disp = np.zeros((N, K, 3))
    shifts = np.zeros((N, K, 3))
    ii, kk = np.nonzero(within)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ii)) - np.repeat(row_start, counts)
    nbr_idx[ii, slot] = cand[ii, kk]
    mask[ii, slot] = True
    disp[ii, slot] = disp_c[ii, kk]
    shifts[ii, slot] = shift_c[ii, kk]
    return nbr_idx, mask, disp, shifts


def brute_neighbors(pos, box, rcut, max_nbors=None):
    pos = np.asarray(pos, np.float64)
    N = len(pos)
    d = pos[None, :, :] - pos[:, None, :]          # [i, j, 3] = r_j - r_i
    shift = -box * np.round(d / box)
    d = d + shift
    r2 = np.sum(d * d, axis=-1)
    np.fill_diagonal(r2, np.inf)
    within = r2 < rcut * rcut
    counts = within.sum(1)
    if max_nbors is not None and counts.max() > max_nbors:
        raise NeighborOverflowError(counts.max(), max_nbors)
    K = max_nbors or int(counts.max())
    cand = np.broadcast_to(np.arange(N, dtype=np.int32), (N, N))
    return _pack_rows(cand, within, d, shift, K)


def cell_neighbors(pos, box, rcut, max_nbors=64):
    """Linked-cell list: bins of edge >= rcut, deduplicated 27-stencil."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64)
    N = len(pos)
    nbins = np.maximum(1, np.floor(box / rcut).astype(int))
    frac = pos / box
    frac -= np.floor(frac)                          # wrap into [0, 1)
    bin_of = np.minimum((frac * nbins).astype(int), nbins - 1)
    flat = (bin_of[:, 0] * nbins[1] + bin_of[:, 1]) * nbins[2] + bin_of[:, 2]
    ncells = int(nbins.prod())
    order = np.argsort(flat, kind='stable').astype(np.int32)
    sorted_flat = flat[order]
    starts = np.searchsorted(sorted_flat, np.arange(ncells))
    ends = np.searchsorted(sorted_flat, np.arange(ncells), 'right')
    occ = int((ends - starts).max()) if N else 0    # max atoms in any cell

    # candidate matrix: for each (atom, stencil cell), up to `occ` atoms
    cols = []
    for off in dedup_stencil(nbins):
        nb = (bin_of + off) % nbins
        f = (nb[:, 0] * nbins[1] + nb[:, 1]) * nbins[2] + nb[:, 2]
        idx = starts[f][:, None] + np.arange(occ)[None, :]
        valid = idx < ends[f][:, None]
        c = order[np.minimum(idx, N - 1)]
        c[~valid] = N                               # sentinel: empty slot
        cols.append(c)
    cand = np.concatenate(cols, axis=1)             # [N, S*occ]
    pos_pad = np.vstack([pos, np.zeros(3)])
    d = pos_pad[cand] - pos[:, None, :]
    shift = -box * np.round(d / box)
    dd = d + shift
    r2 = np.einsum('ijk,ijk->ij', dd, dd)
    within = ((cand != np.arange(N)[:, None]) & (cand < N)
              & (r2 < rcut * rcut))
    counts = within.sum(1)
    if N and counts.max() > max_nbors:
        raise NeighborOverflowError(counts.max(), max_nbors)
    return _pack_rows(cand, within, dd, shift, max_nbors)
