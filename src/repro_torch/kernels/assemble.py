"""Deterministic force assembly (Newton's third law) by destination.

Used by :func:`repro_torch.core.snap.assemble_forces`; the reference
(``repro/core/snap.py:assemble_forces``) scatters with jnp, no Pallas
kernel.  Each atom's force is its own row sum of the masked per-pair dE/dr
minus the rows that name it as neighbor, added in a fixed order, so the
result does not depend on thread timing (``index_add_`` on a CUDA tensor
accumulates with float atomics and does):

- :func:`destination_csr` — the flat neighbor index sorted by destination
  (stable) and CSR row pointers, on the device with fixed sizes: no host
  sync.
- :func:`assemble_forces_csr` — the wrapper: a CPU tensor runs
  :func:`assemble_forces_csr_plain`, a CUDA tensor launches
  ``csrc/assemble_forces.cu`` (one thread per atom), anything else raises.
"""

from __future__ import annotations

import torch

from . import _build

_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.I, _build.I)


def destination_csr(nbr_idx, natoms):
    """(order, rowptr): ``order`` [P] int64 lists the flat pair indices of
    ``nbr_idx`` [natoms, nnbor] sorted by destination atom (stable, so in
    pair order within one atom), ``rowptr`` [natoms + 1] int64 bounds each
    atom's segment.  Entries must lie in 0..natoms-1."""
    # int32 keys: half the radix passes of int64
    dest, order = torch.sort(nbr_idx.reshape(-1).to(torch.int32),
                             stable=True)
    bounds = torch.arange(natoms + 1, device=dest.device, dtype=dest.dtype)
    return order, torch.searchsorted(dest, bounds)


def assemble_forces_csr_plain(d, order, rowptr):
    """Plain version: ``d`` [natoms, nnbor, 3] masked dE/dr -> forces
    [natoms, 3], own rows summed, then each incoming segment subtracted
    in sorted order."""
    natoms = d.shape[0]
    counts = rowptr[1:] - rowptr[:-1]
    atom = torch.repeat_interleave(
        torch.arange(natoms, device=d.device), counts)
    return d.sum(dim=1).index_add(0, atom, -d.reshape(-1, 3)[order])


def assemble_forces_csr(d, order, rowptr):
    """Forces [natoms, 3] from ``d`` [natoms, nnbor, 3] (contiguous, float32
    or float64) and the :func:`destination_csr` of its neighbor index."""
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'd dtype must be float32/float64, got {d.dtype}')
    if d.ndim != 3 or d.shape[2] != 3 or not d.is_contiguous():
        raise ValueError(f'd must be contiguous [natoms, nnbor, 3], got '
                         f'{tuple(d.shape)}')
    natoms, nnbor, _ = d.shape
    for name, t, n in (('order', order, natoms * nnbor),
                       ('rowptr', rowptr, natoms + 1)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n,) or \
                t.device != d.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous int64 [{n}] on '
                             f'{d.device}')
    if d.device.type == 'cpu':
        return assemble_forces_csr_plain(d, order, rowptr)
    if d.device.type != 'cuda':
        raise RuntimeError(f'assemble_forces: no kernel for device '
                           f'{d.device}')
    f = torch.empty((natoms, 3), dtype=d.dtype, device=d.device)
    sym = 'assemble_forces_' + ('f32' if d.dtype == torch.float32 else 'f64')
    _build.launch('assemble_forces', sym, _ARGS, d, order, rowptr, f, natoms,
                  nnbor)
    _build.LAUNCHES['assemble_forces'] += 1
    return f
