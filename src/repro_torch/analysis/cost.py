"""Operation and byte counts of the port's kernels.

The reference's memory pass and budgets read optimized HLO text through
``repro/launch/hlo_cost.py``.  An eager PyTorch program has no HLO to
parse, so this module takes that role for the port: it counts the
operations of each kernel launch from its shapes (each kernel's arithmetic
per element), the padding pass (:mod:`repro_torch.analysis.memory_passes`)
weights dead lanes by these counts, and ``chip_smoke.py`` bounds each
kernel's time on the card with :func:`bound` from the same counts.
"""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): HBM3 3.35 TB/s,
# 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def _levels(twojmax):
    for j in range(1, twojmax + 1):
        rows = j // 2 + 1
        weighted = sum(1 for mb in range(rows) for ma in range(j + 1)
                       if 2 * mb < j or 2 * ma <= j)
        yield j, rows, weighted


def u_flops(twojmax, pairs, atoms=0, n_mirror=0):
    # geometry ~40; per recursion term 10 (conj mult, coefficient, add);
    # per half element 4 to accumulate sfac * u; the full layout adds the
    # mirror fill, 2 per mirror element per atom
    per = 40 + 1 + sum(10 * 2 * j * rows + 4 * rows * (j + 1)
                       for j, rows, _ in _levels(twojmax))
    return per * pairs + 2 * n_mirror * atoms


def y_flops(nnz, atoms):
    # 6 complex product, 2 coef, 2 add; sigma (+-1) is a sign-bit flip,
    # no multiply
    return 10 * nnz * atoms


def de_flops(twojmax, pairs):
    # geometry + gradient ~80; per term 10 for u and 3 x 18 for the
    # tangents; per weighted element 2 + 3 x 10 for the contraction (the
    # same in both layouts: the full kernel carries the left rows, the
    # weight is 0 on the others)
    per = 80 + 4 + sum((10 + 54) * 2 * j * rows + 32 * w
                       for j, rows, w in _levels(twojmax))
    return per * pairs


def bound(nbytes, flops, dtype):
    """(ms, 'bytes' or 'operations'): the least time the H100 could take
    to move ``nbytes`` and do ``flops`` operations in ``dtype``."""
    t_mem, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            'bytes' if t_mem >= t_ops else 'operations')


def launch_flops(rec) -> float:
    """Operations of one :class:`~repro_torch.analysis.launches.LaunchRecord`
    from its shapes: U, Y and fused dE by the counts above (pairs = nnbor x
    lanes; Y: the coefficient table's nnz x lanes), the by-destination
    CSR 4 a pair (its key, count, place and share of its segment's sort),
    the assembly 12 a pair (a mask multiply and an add for each component,
    on the own row and in the reaction), the cell bin 12 an atom, the cell build 20 a table slot it walks and
    the brute build 20 a pair of its B x N x N."""
    name, tj = rec.name, rec.meta.get('twojmax', 0)
    if name.startswith('snap_u_'):
        pairs = rec.in_shapes[0][0] * rec.lanes
        if name == 'snap_u_full':
            from ..core.indices import build_index
            idx = build_index(tj)
            return u_flops(tj, pairs, rec.lanes,
                           idx.idxu_max - idx.idxu_half_max)
        return u_flops(tj, pairs)
    if name.startswith('snap_y_'):
        return y_flops(rec.in_shapes[2][-1], rec.lanes)
    if name.startswith('snap_fused_de_'):
        return de_flops(tj, rec.in_shapes[0][0] * rec.lanes)
    if name == 'destination_csr':
        n_local, nnbor = rec.in_shapes[0]
        return 4 * n_local * nnbor
    if name == 'assemble_forces':
        n_local, nnbor, _ = rec.in_shapes[0]
        return 12 * n_local * nnbor
    if name == 'cell_bin':
        return 12 * rec.lanes
    if name == 'cell_build':
        return 20 * rec.meta.get('slots', 0)
    if name == 'brute_build':
        return 20 * rec.meta.get('pairs', 0)
    raise ValueError(f'no operation count for kernel {name!r}')
