"""Deterministic force assembly (Newton's third law) by destination.

Used by :func:`repro_torch.core.snap.assemble_forces`; the reference
(``repro/core/snap.py:assemble_forces``) scatters with jnp, no Pallas
kernel.  Each atom's force is its own row sum of the masked per-pair dE/dr
minus the rows that name it as neighbor, added in a fixed order, so the
result does not depend on thread timing (``index_add_`` on a CUDA tensor
accumulates with float atomics and does).  The rows of ``d`` may be one
rank's slice of the atoms (``offset``): the output then spans every atom,
the rank's partial of an atom-sharded assembly.

- :func:`destination_csr` — the flat neighbor index sorted by destination
  (stable) and CSR row pointers, on the device with fixed sizes: no host
  sync.
- :func:`assemble_forces_csr` — the wrapper: a CPU tensor runs
  :func:`assemble_forces_csr_plain`, a CUDA tensor launches
  ``csrc/assemble_forces.cu`` (one thread per output row), anything else
  raises.
"""

from __future__ import annotations

import torch

from . import _build
from ..analysis import launches

_ARGS = (_build.P,) * 4 + (_build.I,) * 4


def destination_csr(nbr_idx, natoms):
    """(order, rowptr): ``order`` [P] int64 lists the flat pair indices of
    ``nbr_idx`` [natoms, nnbor] sorted by destination atom (stable, so in
    pair order within one atom), ``rowptr`` [natoms + 1] int64 bounds each
    atom's segment.  Entries must lie in 0..natoms; those equal to natoms
    (pairs to leave out) sort past ``rowptr[natoms]``, in no segment."""
    # int32 keys: half the radix passes of int64
    dest, order = torch.sort(nbr_idx.reshape(-1).to(torch.int32),
                             stable=True)
    bounds = torch.arange(natoms + 1, device=dest.device, dtype=dest.dtype)
    return order, torch.searchsorted(dest, bounds)


def assemble_forces_csr_plain(d, order, rowptr, offset=0):
    """Plain version: ``d`` [n_local, nnbor, 3] masked dE/dr of the atoms
    ``offset ..`` -> forces [n_out, 3] (n_out = len(rowptr) - 1), own
    rows summed, then each incoming segment subtracted in sorted order."""
    n_local, n_out = d.shape[0], rowptr.numel() - 1
    counts = rowptr[1:] - rowptr[:-1]
    atom = torch.repeat_interleave(
        torch.arange(n_out, device=d.device), counts)
    f = d.new_zeros((n_out, 3))
    f[offset:offset + n_local] = d.sum(dim=1)
    return f.index_add(0, atom, -d.reshape(-1, 3)[order[:atom.numel()]])


def assemble_forces_csr(d, order, rowptr, offset=0):
    """Forces [n_out, 3] from ``d`` [n_local, nnbor, 3] (contiguous,
    float32 or float64), the masked dE/dr of atoms ``offset`` ..
    ``offset + n_local - 1``, and the :func:`destination_csr` of its
    neighbor index over ``n_out`` atoms (``rowptr`` [n_out + 1]).  Row i
    is atom i's own sum, when it lies in this slice, minus its incoming
    segment."""
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'd dtype must be float32/float64, got {d.dtype}')
    if d.ndim != 3 or d.shape[2] != 3 or not d.is_contiguous():
        raise ValueError(f'd must be contiguous [natoms, nnbor, 3], got '
                         f'{tuple(d.shape)}')
    n_local, nnbor, _ = d.shape
    n_out = rowptr.numel() - 1
    if not 0 <= offset <= n_out - n_local:
        raise ValueError(f'rows {offset}..{offset + n_local} of d do not '
                         f'lie in the {n_out} output rows')
    for name, t, n in (('order', order, n_local * nnbor),
                       ('rowptr', rowptr, n_out + 1)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n,) or \
                t.device != d.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous int64 [{n}] on '
                             f'{d.device}')
    meta = dict(lanes=n_local)
    if d.device.type == 'cpu':
        return launches.plain('assemble_forces', (d, order, rowptr), meta,
                              assemble_forces_csr_plain, d, order, rowptr,
                              offset)
    if d.device.type != 'cuda':
        raise RuntimeError(f'assemble_forces: no kernel for device '
                           f'{d.device}')
    f = torch.empty((n_out, 3), dtype=d.dtype, device=d.device)
    sym = 'assemble_forces_' + ('f32' if d.dtype == torch.float32 else 'f64')
    _build.launch('assemble_forces', sym, _ARGS, d, order, rowptr, f, n_out,
                  n_local, offset, nnbor)
    launches.record('assemble_forces', (d, order, rowptr), f, **meta)
    return f
