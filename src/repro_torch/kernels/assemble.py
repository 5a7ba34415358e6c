"""Deterministic force assembly (Newton's third law) by destination.

Used by :func:`repro_torch.core.snap.assemble_forces`; the reference
(``repro/core/snap.py:assemble_forces``) scatters with jnp, no Pallas
kernel.  Each atom's force is its own row sum of the masked per-pair dE/dr
minus the rows that name it as neighbor, added in a fixed order, so the
result does not depend on thread timing (``index_add_`` on a CUDA tensor
accumulates with float atomics and does).  The rows of ``dedr`` may be one
rank's slice of the atoms (``offset``): the output then spans every atom,
the rank's partial of an atom-sharded assembly.

- :func:`destination_csr` — the flat neighbor index sorted by destination
  (stable) and CSR row pointers, on the device with fixed sizes and no host
  sync: a CPU tensor runs :func:`destination_csr_plain` (``torch.sort`` +
  ``searchsorted``), a CUDA tensor launches ``csrc/assemble_forces.cu``'s
  counting sort (count, place, sort each segment), bitwise the same.
- :func:`assemble_forces_csr` — the assembly: a CPU tensor runs
  :func:`assemble_forces_csr_plain`, a CUDA tensor launches
  ``csrc/assemble_forces.cu`` (a row's slots and incoming segment split
  over 16 threads, their partial sums met in a fixed tree), reading dE/dr
  through its strides, so the fused dE kernel's planes go in as they are.

Anything but a CPU or CUDA tensor raises.
"""

from __future__ import annotations

import torch

from . import _build
from ..analysis import launches

_P, _I, _L = _build.P, _build.I, _build.L
_CSR_ARGS = (_P,) * 5 + (_L, _I, _I)
_ASM_ARGS = (_P,) * 5 + (_I,) * 4 + (_L,) * 3
_CSR_SYMBOL = {torch.int32: 'destination_csr_i32',
               torch.int64: 'destination_csr_i64'}
_ASM_SYMBOL = {torch.float32: 'assemble_forces_f32',
               torch.float64: 'assemble_forces_f64'}
CSR_TILE = 2048     # csrc/assemble_forces.cu: pairs a block counts / places


def csr_words(pairs: int, n_out: int) -> int:
    """int32 words of the CSR kernels' scratch (``csr_words`` in the
    source): ``n_out`` counters, a ticket, two words a tile."""
    return n_out + 1 + 2 * max(1, -(-pairs // CSR_TILE))


def destination_csr_plain(nbr_idx, natoms):
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


def _csr_of_masked(nbr_idx, n_out, mask):
    return destination_csr_plain(torch.where(mask, nbr_idx, n_out), n_out)


def _check_index(nbr_idx, mask):
    if nbr_idx.dtype not in _CSR_SYMBOL or nbr_idx.ndim != 2 or \
            not nbr_idx.is_contiguous():
        raise ValueError(f'nbr_idx must be a contiguous int32/int64 '
                         f'[n_local, nnbor] tensor, got {nbr_idx.dtype} '
                         f'{tuple(nbr_idx.shape)}')
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool or \
            mask.shape != nbr_idx.shape or mask.device != nbr_idx.device or \
            not mask.is_contiguous():
        raise ValueError(f'mask must be a contiguous bool '
                         f'{list(nbr_idx.shape)} tensor on {nbr_idx.device}')


def destination_csr(nbr_idx, n_out, mask):
    """(order [P] int64, rowptr [n_out + 1] int64) of ``nbr_idx`` [n_local,
    nnbor] (int32/int64, entries in 0..n_out): the flat pair indices
    sorted by destination, stable, and each destination's segment.  Pairs
    where ``mask`` (bool, same shape) is False, and those naming ``n_out``,
    sort past ``rowptr[n_out]`` in pair order.  The result is
    :func:`destination_csr_plain`'s of ``where(mask, nbr_idx, n_out)``,
    bit for bit (on the card a kept entry outside 0..n_out - 1 also sorts
    past; the plain version takes none)."""
    _check_index(nbr_idx, mask)
    pairs, dev = nbr_idx.numel(), nbr_idx.device
    meta = dict(lanes=nbr_idx.shape[0])
    ins = (nbr_idx, mask)
    if dev.type == 'cpu':
        return launches.plain('destination_csr', ins, meta, _csr_of_masked,
                              nbr_idx, n_out, mask)
    if dev.type != 'cuda':
        raise RuntimeError(f'destination_csr: no kernel for device {dev}')
    if pairs >= 2 ** 31 or n_out >= 2 ** 31:
        raise ValueError(f'destination_csr: {pairs} pairs over {n_out} '
                         'rows do not fit the kernels\' int32 indices')
    words = csr_words(pairs, n_out)
    # one allocation: order, rowptr, then the int32 scratch
    buf = torch.empty(pairs + n_out + 1 + (words + 1) // 2,
                      dtype=torch.int64, device=dev)
    order, rowptr = buf[:pairs], buf[pairs:pairs + n_out + 1]
    _build.launcher('assemble_forces', _CSR_SYMBOL[nbr_idx.dtype],
                    _CSR_ARGS)(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        nbr_idx.data_ptr(), mask.data_ptr(), buf.data_ptr(),
        rowptr.data_ptr(),
        buf.data_ptr() + 8 * (pairs + n_out + 1), words, pairs, n_out)
    launches.record('destination_csr', ins, (order, rowptr), **meta)
    return order, rowptr


def assemble_forces_csr_plain(dedr, order, rowptr, offset, mask):
    """Plain version: ``dedr`` [n_local, nnbor, 3] dE/dr of the atoms
    ``offset ..``, masked by ``mask`` (a multiply) -> forces [n_out, 3]
    (n_out = len(rowptr) - 1), own rows summed, then each incoming segment
    subtracted in sorted order."""
    d = (dedr * mask[..., None].to(dedr.dtype)).contiguous()
    n_local, n_out = d.shape[0], rowptr.numel() - 1
    counts = rowptr[1:] - rowptr[:-1]
    atom = torch.repeat_interleave(
        torch.arange(n_out, device=d.device), counts)
    f = d.new_zeros((n_out, 3))
    f[offset:offset + n_local] = d.sum(dim=1)
    return f.index_add(0, atom, -d.reshape(-1, 3)[order[:atom.numel()]])


def _check_strides(dedr):
    """dedr's elements must not overlap: every extent > 1 on a positive
    stride, each stride past the span of the smaller ones."""
    span = 1
    for stride, size in sorted(zip(dedr.stride(), dedr.shape)):
        if size == 1:
            continue
        if stride < span:
            raise ValueError(f'dedr strides {dedr.stride()} overlap for '
                             f'shape {tuple(dedr.shape)}')
        span = stride * size


def assemble_forces_csr(dedr, order, rowptr, offset, mask):
    """Forces [n_out, 3] from ``dedr`` [n_local, nnbor, 3] (float32 or
    float64, any non-overlapping strides: the fused dE planes' view goes in
    as it is), the dE/dr of atoms ``offset`` .. ``offset + n_local - 1``,
    multiplied by ``mask`` [n_local, nnbor] (bool, contiguous), and the
    :func:`destination_csr` of its neighbor index over
    ``n_out`` atoms (``rowptr`` [n_out + 1]).  Row i is atom i's own sum,
    when it lies in this slice, minus its incoming segment."""
    if not isinstance(dedr, torch.Tensor) or dedr.dtype not in _ASM_SYMBOL:
        raise TypeError(f'dedr must be a float32/float64 tensor, got '
                        f'{getattr(dedr, "dtype", type(dedr).__name__)}')
    if dedr.ndim != 3 or dedr.shape[2] != 3:
        raise ValueError(f'dedr must be [n_local, nnbor, 3], got '
                         f'{tuple(dedr.shape)}')
    _check_strides(dedr)
    n_local, nnbor, _ = dedr.shape
    n_out, dev = rowptr.numel() - 1, dedr.device
    if not 0 <= offset <= n_out - n_local:
        raise ValueError(f'rows {offset}..{offset + n_local} of dedr do not '
                         f'lie in the {n_out} output rows')
    for name, t, n in (('order', order, n_local * nnbor),
                       ('rowptr', rowptr, n_out + 1)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n,) or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous int64 [{n}] on '
                             f'{dev}')
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool or \
            mask.shape != dedr.shape[:2] or mask.device != dev or \
            not mask.is_contiguous():
        raise ValueError(f'mask must be a contiguous bool [{n_local}, '
                         f'{nnbor}] tensor on {dev}')
    meta = dict(lanes=n_local)
    ins = (dedr, order, rowptr, mask)
    if dev.type == 'cpu':
        return launches.plain('assemble_forces', ins, meta,
                              assemble_forces_csr_plain, dedr, order, rowptr,
                              offset, mask)
    if dev.type != 'cuda':
        raise RuntimeError(f'assemble_forces: no kernel for device {dev}')
    f = torch.empty((n_out, 3), dtype=dedr.dtype, device=dev)
    _build.launcher('assemble_forces', _ASM_SYMBOL[dedr.dtype], _ASM_ARGS)(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        dedr.data_ptr(), mask.data_ptr(), order.data_ptr(),
        rowptr.data_ptr(), f.data_ptr(), n_out, n_local,
        offset, nnbor, *dedr.stride())
    launches.record('assemble_forces', ins, f, **meta)
    return f
