"""Linked-cell neighbor build, gated by a device flag (``csrc/cell_list.cu``).

The reference builds its lists with jnp (``repro/md/cell_list.py``:
``_bin_atoms`` and ``device_neighbors``, no Pallas kernel).  The port's MD
device loop needs a build that is decided on the card, deterministic and
free of host synchronization, so the build is two hand-written kernels:

- :func:`cell_bin` — the static ``[ncells, cell_cap]`` cell table (atom
  indices, N as the empty sentinel, atoms of a cell in increasing index),
  raising ``flags[FLAG_CELL_MAX]`` to the largest cell count;
- :func:`cell_build` — the padded ``[N, K]`` lists at rcut + skin
  (``nbr_idx`` int32, ``mask`` bool, ``shifts``), valid candidates packed
  to the front in stencil and slot order, raising ``flags[FLAG_NBR_MAX]``
  to the largest count and copying ``pos`` into ``pos_ref``.

Both take ``trigger``, a 0-d int32 tensor: when it is 0 the kernels return
at once and every buffer is left as it was.  Each wrapper runs its plain
PyTorch version (``*_plain``: the reference's arithmetic as torch ops,
which reads ``trigger`` on the host) on a CPU tensor, launches its kernel
on a CUDA tensor and raises otherwise.  :func:`neighbors_plain` is the
reference's ``device_neighbors`` line for line, with ``r2`` summed as
``(x² + y²) + z²`` like the kernel, so kernel and plain lists are bitwise
equal.

``grid`` is a :class:`repro_torch.md.cell_list.CellGrid` (read for its
``nbins``, ``cell_cap``, ``max_nbors``, ``rcut_build`` and ``stencil``;
the kernels derive the stencil from ``nbins`` and refuse any other).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _build
from ..analysis import launches
from ..md.neighbor import dedup_stencil

FLAG_NBR_MAX, FLAG_CELL_MAX = 0, 1    # md/cell_list.py's flag slots
_P, _I, _D = _build.P, _build.I, _build.D
_BIN_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I)
_BUILD_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
               _D)


@lru_cache(maxsize=64)
def _stencil_of(nbins):
    return tuple(dedup_stencil(nbins))


def _check(pos, box, grid, trigger, flags):
    if not isinstance(pos, torch.Tensor):
        raise TypeError(f'pos must be a tensor, got {type(pos).__name__}')
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'pos dtype must be float32/float64, got '
                        f'{pos.dtype}')
    if pos.ndim != 2 or pos.shape[1] != 3 or not pos.is_contiguous():
        raise ValueError(f'pos must be contiguous [N, 3], got '
                         f'{tuple(pos.shape)}')
    if box.dtype != pos.dtype or tuple(box.shape) != (3,) or \
            box.device != pos.device or not box.is_contiguous():
        raise ValueError(f'box must be a contiguous [3] {pos.dtype} tensor '
                         f'on {pos.device}')
    if trigger.dtype != torch.int32 or trigger.numel() != 1 or \
            trigger.device != pos.device:
        raise ValueError(f'trigger must be a 0-d int32 tensor on '
                         f'{pos.device}')
    if flags.dtype != torch.int32 or flags.ndim != 1 or \
            flags.shape[0] < 2 or flags.device != pos.device or \
            not flags.is_contiguous():
        raise ValueError(f'flags must be a contiguous int32 [>= 2] tensor '
                         f'on {pos.device}')
    if tuple(grid.stencil) != _stencil_of(tuple(grid.nbins)):
        raise ValueError('the cell kernels walk the deduplicated stencil '
                         f'of nbins={grid.nbins}; grid.stencil differs')


def _kernel_device(pos, name):
    if pos.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {pos.device}')


def _sfx(dtype):
    return 'f32' if dtype == torch.float32 else 'f64'


# ---------------------------------------------------------------------------
# plain versions (the reference's arithmetic as torch ops)
# ---------------------------------------------------------------------------

def atom_bins(pos, box, grid):
    """Bin coordinates [N, 3] int32: frac = pos / box wrapped into [0, 1),
    scaled by nbins, truncated, clamped to nbins - 1 (and to 0, where a
    non-finite position lands; the kernel does the same)."""
    nb = torch.tensor(grid.nbins, dtype=torch.int32, device=pos.device)
    frac = pos / box
    frac = frac - torch.floor(frac)
    return torch.minimum((frac * nb).to(torch.int32), nb - 1).clamp_min(0)


def _flat(b, nbins):
    return (b[..., 0] * nbins[1] + b[..., 1]) * nbins[2] + b[..., 2]


def bin_atoms_plain(pos, box, grid):
    """``_bin_atoms``: (table [ncells, cell_cap] int32, bins [N, 3] int32,
    largest cell count 0-d int32)."""
    N = pos.shape[0]
    dev = pos.device
    b = atom_bins(pos, box, grid)
    flat = _flat(b, grid.nbins)
    order = torch.argsort(flat, stable=True).to(torch.int32)
    sorted_flat = flat[order]
    starts = torch.searchsorted(
        sorted_flat, torch.arange(grid.ncells, dtype=torch.int32,
                                  device=dev)).to(torch.int32)
    rank = torch.arange(N, dtype=torch.int32, device=dev) - \
        starts[sorted_flat]
    cap = grid.cell_cap
    slot = torch.where(rank < cap, sorted_flat * cap + rank,
                       grid.ncells * cap)          # overflow -> discard slot
    table = torch.full((grid.ncells * cap + 1,), N, dtype=torch.int32,
                       device=dev)
    table[slot.long()] = order
    counts = torch.bincount(flat.long(), minlength=grid.ncells)
    return (table[:-1].reshape(grid.ncells, cap), b,
            counts.max().to(torch.int32))


def build_plain(pos, box, grid, table, b):
    """The lists from a cell table and the atoms' bins: (nbr_idx [N, K]
    int32, mask [N, K] bool, shifts [N, K, 3], largest count 0-d int32)."""
    N = pos.shape[0]
    dev = pos.device
    nbins = torch.tensor(grid.nbins, dtype=torch.int32, device=dev)
    cells = torch.stack([_flat(torch.remainder(
        b + torch.tensor(off, dtype=torch.int32, device=dev), nbins),
        grid.nbins) for off in grid.stencil], dim=1)             # [N, S]
    cand = table[cells.long()].reshape(N, -1)                    # [N, S*cap]
    K = grid.max_nbors
    if cand.shape[1] < K:   # fewer candidates than slots: pad with empties
        cand = torch.nn.functional.pad(cand, (0, K - cand.shape[1]),
                                       value=N)
    pos_pad = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype,
                                          device=dev)])
    d = pos_pad[cand.long()] - pos[:, None, :]
    shift = -box * torch.round(d / box)
    dd = d + shift
    r2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + \
        dd[..., 2] * dd[..., 2]
    rb2 = grid.rcut_build * grid.rcut_build
    valid = ((cand != torch.arange(N, dtype=torch.int32, device=dev)[:, None])
             & (cand < N) & (r2 < rb2))
    counts = valid.sum(dim=1)
    # pack valid candidates to the front: stable sort on the invalid flag
    key = torch.logical_not(valid).to(torch.int32)
    ordk = torch.argsort(key, dim=1, stable=True)[:, :K]
    mask = torch.take_along_dim(valid, ordk, dim=1)
    nbr_idx = torch.where(mask, torch.take_along_dim(cand, ordk, dim=1),
                          0).to(torch.int32)
    shifts = torch.where(mask[..., None],
                         torch.take_along_dim(shift, ordk[..., None], dim=1),
                         0.0)
    return nbr_idx, mask, shifts, counts.max().to(torch.int32)


def neighbors_plain(pos, box, grid):
    """``device_neighbors`` as torch ops: (nbr_idx, mask, shifts, flags [2]
    int32 = [largest neighbor count, largest cell count])."""
    table, b, cell_max = bin_atoms_plain(pos, box, grid)
    nbr_idx, mask, shifts, nbr_max = build_plain(pos, box, grid, table, b)
    return nbr_idx, mask, shifts, torch.stack([nbr_max, cell_max])


def cell_bin_plain(pos, box, grid, trigger, flags):
    """Plain :func:`cell_bin` (reads ``trigger`` on the host)."""
    if not int(trigger):
        return torch.full((grid.ncells, grid.cell_cap), pos.shape[0],
                          dtype=torch.int32, device=pos.device)
    table, _, cell_max = bin_atoms_plain(pos, box, grid)
    flags[FLAG_CELL_MAX] = torch.maximum(flags[FLAG_CELL_MAX], cell_max)
    return table


def cell_build_plain(pos, box, grid, table, trigger, nbr_idx, mask, shifts,
                     flags, pos_ref=None):
    """Plain :func:`cell_build` (reads ``trigger`` on the host)."""
    if not int(trigger):
        return
    ni, ms, sh, nbr_max = build_plain(pos, box, grid, table,
                                      atom_bins(pos, box, grid))
    nbr_idx.copy_(ni)
    mask.copy_(ms)
    shifts.copy_(sh)
    flags[FLAG_NBR_MAX] = torch.maximum(flags[FLAG_NBR_MAX], nbr_max)
    if pos_ref is not None:
        pos_ref.copy_(pos)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def cell_bin(pos, box, grid, trigger, flags):
    """The cell table [ncells, cell_cap] int32 of ``pos`` when ``trigger``
    is nonzero (else unwritten); raises ``flags[FLAG_CELL_MAX]`` in place
    to the largest cell count."""
    _check(pos, box, grid, trigger, flags)
    meta = dict(lanes=pos.shape[0])
    if pos.device.type == 'cpu':
        return launches.plain('cell_bin', (pos, box, trigger, flags), meta,
                              cell_bin_plain, pos, box, grid, trigger, flags)
    _kernel_device(pos, 'cell_bin')
    table = torch.empty((grid.ncells, grid.cell_cap), dtype=torch.int32,
                        device=pos.device)
    _build.launch('cell_list', f'cell_bin_{_sfx(pos.dtype)}', _BIN_ARGS,
                  pos, box, trigger, table, flags, pos.shape[0],
                  *grid.nbins, grid.cell_cap)
    launches.record('cell_bin', (pos, box, trigger, flags), table, **meta)
    return table


def cell_build(pos, box, grid, table, trigger, nbr_idx, mask, shifts, flags,
               pos_ref=None):
    """Write the lists of ``pos`` into ``nbr_idx`` [N, K] int32, ``mask``
    [N, K] bool and ``shifts`` [N, K, 3] when ``trigger`` is nonzero; raise
    ``flags[FLAG_NBR_MAX]`` to the largest count and copy ``pos`` into
    ``pos_ref`` (if given).  ``table`` comes from :func:`cell_bin`."""
    _check(pos, box, grid, trigger, flags)
    N, K = pos.shape[0], grid.max_nbors
    for name, t, shape, dtype in (
            ('table', table, (grid.ncells, grid.cell_cap), torch.int32),
            ('nbr_idx', nbr_idx, (N, K), torch.int32),
            ('mask', mask, (N, K), torch.bool),
            ('shifts', shifts, (N, K, 3), pos.dtype),
            ('pos_ref', pos_ref, (N, 3), pos.dtype)):
        if t is None and name == 'pos_ref':
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != pos.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous {dtype} '
                             f'{list(shape)} on {pos.device}')
    # the table slots the build walks: a stencil of cells an atom
    meta = dict(lanes=N, slots=N * len(grid.stencil) * grid.cell_cap)
    if pos.device.type == 'cpu':
        launches.plain('cell_build', (pos, box, table, trigger), meta,
                       cell_build_plain, pos, box, grid, table, trigger,
                       nbr_idx, mask, shifts, flags, pos_ref)
        return
    _kernel_device(pos, 'cell_build')
    _build.launch('cell_list', f'cell_build_{_sfx(pos.dtype)}', _BUILD_ARGS,
                  pos, box, trigger, table, nbr_idx, mask, shifts, pos_ref,
                  flags, N, *grid.nbins, grid.cell_cap, K,
                  grid.rcut_build * grid.rcut_build)
    # the lists are written in place: no output of its own
    launches.record('cell_build', (pos, box, table, trigger), None, **meta)
