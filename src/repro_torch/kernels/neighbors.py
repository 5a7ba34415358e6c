"""The neighbor builds on the card: the linked-cell build of the MD device
loop, gated by a device flag (``csrc/cell_list.cu``), and the serving
path's O(N^2) build (``csrc/brute_neighbors.cu``).

The reference builds its lists with jnp (``repro/md/cell_list.py``:
``_bin_atoms``, ``device_neighbors`` and ``brute_neighbors_device``, no
Pallas kernel).  The port's MD device loop needs a build that is decided
on the card, deterministic and free of host synchronization, so the cell
build is two hand-written kernels:

- :func:`cell_bin` — the static ``[ncells, cell_cap]`` cell table (atom
  indices, N as the empty sentinel, atoms of a cell in increasing index),
  raising ``flags[FLAG_CELL_MAX]`` to the largest cell count;
- :func:`cell_build` — the padded ``[N, K]`` lists at rcut + skin
  (``nbr_idx`` int32, ``mask`` bool, ``shifts``), valid candidates packed
  to the front in stencil and slot order, raising ``flags[FLAG_NBR_MAX]``
  to the largest count and copying ``pos`` into ``pos_ref``.

Both take ``trigger``, a 0-d int32 tensor: when it is 0 the kernels return
at once and every buffer is left as it was.  The force service's batched
step builds the lists of all its lanes with one more kernel:

- :func:`brute_build` — ``brute_neighbors_device`` of every lane of a
  batch at once: each atom below its lane's ``n_valid`` against every
  other, valid pairs packed to the front in index order, the lane's
  largest count in its row of ``flags``; into :func:`brute_outputs` kept
  by the caller (a bucket's step), or into outputs made at the call.

Each wrapper runs its plain PyTorch version (``*_plain``: the reference's
arithmetic as torch ops; the cell versions read ``trigger`` on the host)
on a CPU tensor, launches its kernel on a CUDA tensor and raises
otherwise.  :func:`neighbors_plain` is the reference's
``device_neighbors`` line for line, with ``r2`` summed as
``(x² + y²) + z²`` like the kernel, so kernel and plain lists are bitwise
equal; :func:`brute_build_plain` likewise.

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
_BRUTE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D)
_BRUTE_SYMBOL = {torch.float32: 'brute_build_f32',
                 torch.float64: 'brute_build_f64'}


@lru_cache(maxsize=64)
def _stencil_of(nbins):
    return tuple(dedup_stencil(nbins))


def _check_pos(pos, box, ndim):
    if not isinstance(pos, torch.Tensor):
        raise TypeError(f'pos must be a tensor, got {type(pos).__name__}')
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'pos dtype must be float32/float64, got '
                        f'{pos.dtype}')
    want = 'N, 3' if ndim == 2 else 'B, N, 3'
    if pos.ndim != ndim or pos.shape[-1] != 3 or not pos.is_contiguous():
        raise ValueError(f'pos must be contiguous [{want}], got '
                         f'{tuple(pos.shape)}')
    if box.dtype != pos.dtype or tuple(box.shape) != tuple(pos.shape[:-2]) + \
            (3,) or box.device != pos.device or not box.is_contiguous():
        raise ValueError(f'box must be a contiguous '
                         f'{list(pos.shape[:-2]) + [3]} {pos.dtype} tensor '
                         f'on {pos.device}')


def _check(pos, box, grid, trigger, flags):
    _check_pos(pos, box, 2)
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


def brute_build_plain(pos, box, rcut, max_nbors: int, n_valid):
    """Plain :func:`brute_build`: the reference's ``brute_neighbors_device``
    of every lane as torch ops (``jax.vmap`` written out as a batch axis;
    ``[B, N, N, 3]`` temporaries)."""
    B, N, dev = pos.shape[0], pos.shape[1], pos.device
    box = torch.as_tensor(box, dtype=pos.dtype, device=dev)[:, None, None, :]
    iota = torch.arange(N, dtype=torch.int32, device=dev)
    ok_atom = iota[None, :] < torch.as_tensor(n_valid, device=dev)[:, None]
    d = pos[:, None, :, :] - pos[:, :, None, :]
    dd = d - box * torch.round(d / box)
    r2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + \
        dd[..., 2] * dd[..., 2]
    within = ((iota[None, :] != iota[:, None])[None]
              & ok_atom[:, None, :] & ok_atom[:, :, None]
              & (r2 < rcut * rcut))
    counts = within.sum(dim=2)
    key = torch.logical_not(within).to(torch.int32)
    ordk = torch.argsort(key, dim=2, stable=True)[:, :, :max_nbors]
    mask = torch.take_along_dim(within, ordk, dim=2)
    nbr_idx = torch.where(mask, ordk, 0).to(torch.int32)
    disp = torch.where(mask[..., None],
                       torch.take_along_dim(dd, ordk[..., None], dim=2), 0.0)
    flags = torch.stack([counts.amax(dim=1).to(torch.int32),
                         torch.zeros(B, dtype=torch.int32, device=dev)],
                        dim=1)
    return nbr_idx, mask, disp, flags


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


class BruteLists(tuple):
    """``(nbr_idx [B, N, K] int32, mask [B, N, K] bool, disp [B, N, K, 3],
    flags [B, 2] int32)`` of :func:`brute_build`, with the ``shape`` (B,
    N, K), ``dtype`` and ``device`` they were made for."""

    def __new__(cls, tensors, shape, dtype, device):
        self = super().__new__(cls, tensors)
        self.shape, self.dtype, self.device = shape, dtype, device
        return self


def brute_outputs(B: int, N: int, max_nbors: int, dtype, device):
    """Unwritten :class:`BruteLists` for ``B`` lanes of ``N`` atoms, K =
    min(max_nbors, N).  A caller that builds one bucket's lists at every
    step makes them once and passes them to :func:`brute_build` as
    ``out``: then a step neither allocates nor checks them again."""
    K = min(int(max_nbors), N)
    out = (torch.empty((B, N, K), dtype=torch.int32, device=device),
           torch.empty((B, N, K), dtype=torch.bool, device=device),
           torch.empty((B, N, K, 3), dtype=dtype, device=device),
           torch.empty((B, 2), dtype=torch.int32, device=device))
    return BruteLists(out, (B, N, K), dtype, out[0].device)


def brute_build(pos, box, rcut, max_nbors: int, n_valid, out=None):
    """The O(N^2) lists of B configurations in one launch: ``pos`` [B, N, 3]
    float32/float64, ``box`` [B, 3] and ``n_valid`` [B] (integers, read on
    the device) on one device; atoms at or past a lane's ``n_valid`` have no
    pairs.  Returns ``(nbr_idx [B, N, K] int32, mask [B, N, K] bool, disp
    [B, N, K, 3], flags [B, 2] int32)`` with K = min(max_nbors, N), the
    pairs within ``rcut`` (a Python number) packed to the front in index
    order and ``flags[:, 0]`` each lane's largest count (past K).  ``out``
    (:func:`brute_outputs` of these shapes): written in place and
    returned."""
    if isinstance(pos, torch.Tensor):
        box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
        n_valid = torch.as_tensor(n_valid, device=pos.device)
    _check_pos(pos, box, 3)
    (B, N, _), dev = pos.shape, pos.device
    if n_valid.shape != (B,) or \
            n_valid.dtype not in (torch.int32, torch.int64):
        raise ValueError(f'n_valid must be an integer [{B}] tensor, got '
                         f'{n_valid.dtype} {tuple(n_valid.shape)}')
    K = min(int(max_nbors), N)
    if out is not None and not (type(out) is BruteLists
                                and out.shape == (B, N, K)
                                and out.dtype == pos.dtype
                                and out.device == dev):
        raise ValueError(f'out must be brute_outputs({B}, {N}, {K}, '
                         f'{pos.dtype}, {dev})')
    meta = dict(lanes=B * N, pairs=B * N * N)
    if dev.type == 'cpu':
        got = launches.plain('brute_build', (pos, box, n_valid), meta,
                             brute_build_plain, pos, box, rcut, max_nbors,
                             n_valid)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return out
    _kernel_device(pos, 'brute_build')
    if n_valid.dtype != torch.int32 or not n_valid.is_contiguous():
        n_valid = n_valid.to(torch.int32).contiguous()
    if out is None:
        out = brute_outputs(B, N, K, pos.dtype, dev)
    # the launcher zeroes flags on the stream; the f32 instance rounds
    # rcut * rcut (a double) to float, as PyTorch rounds the Python scalar
    # it compares an f32 tensor with
    rc = float(rcut)
    _build.launcher('brute_neighbors', _BRUTE_SYMBOL[pos.dtype],
                    _BRUTE_ARGS)(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        pos.data_ptr(), box.data_ptr(), n_valid.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), B, N, K, rc * rc)
    launches.record('brute_build', (pos, box, n_valid), out, **meta)
    return out
