"""On-device linked-cell neighbor engine (fixed shapes, no host sync).

Port of ``repro.md.cell_list``.  The host list builds in
:mod:`repro_torch.md.neighbor` are the oracle; this module is the MD
device loop's path: a rebuild is two kernel launches on the card
(:mod:`repro_torch.kernels.neighbors`, ``csrc/cell_list.cu``) whose shapes
are fixed by a :class:`CellGrid`, so the loop — integration, displacement
trigger and the rebuild itself — runs without reading anything back.

Fixed-shape layout
------------------
Atoms are binned into a static ``[ncells, cell_cap]`` table (atoms of a
cell in increasing index, N as the empty sentinel).  Candidates come from
a **deduplicated** 27-stencil (offsets collapse mod nbins, so boxes with
< 3 bins along an axis never revisit a cell); valid pairs are packed to
the front of the padded ``[N, K]`` lists in candidate order.

Overflow contract
-----------------
A kernel cannot raise, so capacity violations (cell_cap, max_nbors) come
back as *flags* — int32 ``[nbr_count_max, cell_count_max]`` — carried as
running maxima through the device loop and checked at chunk boundaries,
where :func:`check_flags` raises the same :class:`NeighborOverflowError`
the host list builds do (or :class:`CellOverflowError` for bin capacity).

Skin radius
-----------
Lists are built with cutoff ``rcut + skin``; they stay sufficient for the
exact ``rcut`` pair set until any atom has moved more than ``skin / 2``
since the build.  The consumer applies a per-step hard cut at ``rcut``
(see ``md/integrate.py``), which also keeps the ``theta0 = pi``
Cayley-Klein singularity just beyond ``rcut`` out of the force kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.snap import resolve_device
from ..kernels.neighbors import (brute_build, cell_bin, cell_build,
                                 neighbors_plain)
from .neighbor import NeighborOverflowError, dedup_stencil, suggest_capacity

# Health-flag lattice layout (int32 vector carried through the device
# loop; slots 0-1 are running max *counts* from the neighbor build, slots
# 2-5 are sticky 0/1 indicators set by the in-loop guards of
# md/integrate.py).  The host reads the whole vector once per chunk, in
# the same readback as the logging rows.
FLAG_NBR_MAX = 0      # max neighbors seen by any atom (vs grid.max_nbors)
FLAG_CELL_MAX = 1     # max cell occupancy seen (vs grid.cell_cap)
FLAG_NAN_FORCE = 2    # non-finite value in the force array
FLAG_NAN_STATE = 3    # non-finite value in positions or velocities
FLAG_ESCAPE = 4       # an atom left the box by > escape_factor box lengths
FLAG_DRIFT = 5        # |Etot - Eref| exceeded the watchdog bound
N_FLAGS = 6


class CellOverflowError(RuntimeError):
    """A cell holds more atoms than the static cell_cap slots."""

    def __init__(self, max_count, cell_cap):
        self.max_count = int(max_count)
        self.cell_cap = int(cell_cap)
        self.suggested = suggest_capacity(self.max_count)
        super().__init__(
            f'cell list overflow: a cell holds {self.max_count} atoms but '
            f'capacity cell_cap={self.cell_cap}; retry with '
            f'cell_cap={self.suggested} '
            f'(observed max {self.max_count} + headroom)')


@dataclass(frozen=True)
class CellGrid:
    """Static (hashable) configuration of the device cell list.

    Everything that determines tensor *shapes* lives here: bin counts,
    cell capacity, padded list width, and the deduplicated stencil.
    """
    nbins: tuple          # (nx, ny, nz) bins, each >= 1
    cell_cap: int         # atoms per cell slot count (static)
    max_nbors: int        # K: padded neighbor-list width (static)
    rcut: float           # force cutoff
    skin: float           # Verlet skin; build cutoff is rcut + skin
    stencil: tuple        # deduplicated 27-stencil offsets

    @property
    def ncells(self) -> int:
        return self.nbins[0] * self.nbins[1] * self.nbins[2]

    @property
    def rcut_build(self) -> float:
        return self.rcut + self.skin


def make_grid(box, rcut, skin=0.0, cell_cap=16, max_nbors=64) -> CellGrid:
    """Build the static grid config for a (fixed) box.

    Bin edges are >= rcut + skin so the deduplicated 27-stencil covers every
    candidate pair; degenerate boxes (< 3 bins along an axis) degrade
    gracefully to fewer, larger cells.
    """
    box = np.asarray(box, np.float64)
    rb = float(rcut) + float(skin)
    nbins = tuple(int(max(1, np.floor(b / rb))) for b in box)
    return CellGrid(nbins=nbins, cell_cap=int(cell_cap),
                    max_nbors=int(max_nbors), rcut=float(rcut),
                    skin=float(skin), stencil=tuple(dedup_stencil(nbins)))


def auto_cell_cap(pos, box, rcut_build, headroom=1.5, pad=4) -> int:
    """Host-side one-shot sizing of cell_cap from the initial configuration.

    O(N) numpy bincount; the returned capacity carries ``headroom`` +
    ``pad`` margin for density fluctuations during the run (violations are
    still caught by the overflow flags).
    """
    box = np.asarray(box, np.float64)
    nbins = np.maximum(1, np.floor(box / rcut_build).astype(int))
    frac = np.asarray(pos) / box
    frac -= np.floor(frac)
    b = np.minimum((frac * nbins).astype(int), nbins - 1)
    flat = (b[:, 0] * nbins[1] + b[:, 1]) * nbins[2] + b[:, 2]
    occ = int(np.bincount(flat, minlength=int(nbins.prod())).max())
    return int(np.ceil(occ * headroom)) + pad


def device_neighbors(pos, box, grid: CellGrid):
    """Fixed-shape neighbor build with no host sync.

    ``pos`` [N, 3] and ``box`` [3]: tensors on one device.  Returns
    ``(nbr_idx [N, K] int32, mask [N, K] bool, shifts [N, K, 3],
    flags [2] int32)`` with ``flags = [max neighbor count, max cell
    occupancy]`` — compare against ``grid.max_nbors`` / ``grid.cell_cap``
    via :func:`check_flags` at the next host boundary.

    ``shifts`` satisfy ``disp = pos[nbr_idx] + shifts - pos[:, None]``
    exactly for the *raw* (possibly unwrapped) positions, so the MD loop
    can recompute displacements on the device as atoms drift out of the
    box.  A CPU tensor runs the plain version
    (:func:`repro_torch.kernels.neighbors.neighbors_plain`), a CUDA tensor
    the two cell kernels; anything else raises.
    """
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    if pos.device.type == 'cpu':
        return neighbors_plain(pos, box, grid)
    if pos.device.type != 'cuda':
        raise RuntimeError(f'device_neighbors: no kernel for device '
                           f'{pos.device}')
    N, K, dev = pos.shape[0], grid.max_nbors, pos.device
    trigger = torch.ones((), dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    nbr_idx = torch.empty((N, K), dtype=torch.int32, device=dev)
    mask = torch.empty((N, K), dtype=torch.bool, device=dev)
    shifts = torch.empty((N, K, 3), dtype=pos.dtype, device=dev)
    table = cell_bin(pos, box, grid, trigger, flags)
    cell_build(pos, box, grid, table, trigger, nbr_idx, mask, shifts, flags)
    return nbr_idx, mask, shifts, flags


def rebuild_if(trigger, pos, box, grid: CellGrid, nbr_idx, shifts, mask,
               pos_ref, flags):
    """Rebuild the carried lists in place when ``trigger`` (a 0-d int32
    tensor on the device of ``pos``) is nonzero.

    Writes ``nbr_idx``, ``mask`` and ``shifts`` from ``pos``, copies
    ``pos`` into ``pos_ref`` and raises the two count slots of ``flags``
    (the ``[N_FLAGS]`` lattice or the bare ``[2]`` build flags) to their
    running maxima.  With ``trigger`` 0 every buffer is left untouched.
    On the card both kernels read ``trigger`` themselves, so the host
    never waits for the decision; on the CPU the plain versions branch on
    it.
    """
    table = cell_bin(pos, box, grid, trigger, flags)
    cell_build(pos, box, grid, table, trigger, nbr_idx, mask, shifts, flags,
               pos_ref)


def brute_neighbors_device(pos, box, rcut, max_nbors: int, n_valid=None):
    """Fixed-shape O(N^2) neighbor build for one configuration.

    The serving counterpart of :func:`device_neighbors`: no grid statics,
    ``n_valid`` (int or 0-d tensor) masks trailing padding atoms out of
    the pair set.  Capacity violations come back as count *flags* (slot
    ``FLAG_NBR_MAX``; the cell slot stays 0), never as silent truncation.
    Non-finite positions never produce pairs (NaN compares false).

    Returns ``(nbr_idx [N, K] int32, mask [N, K] bool, disp [N, K, 3],
    flags [2] int32)`` with ``disp = pos[nbr] - pos[i]`` minimum-imaged:
    lane 0 of :func:`brute_neighbors_batched`.
    """
    N, dev = pos.shape[0], pos.device
    n_valid = torch.as_tensor(N if n_valid is None else n_valid, device=dev)
    box = torch.as_tensor(box, dtype=pos.dtype, device=dev)
    out = brute_neighbors_batched(pos[None], box[None], rcut, max_nbors,
                                  n_valid.reshape(1))
    return tuple(t[0] for t in out)


def brute_neighbors_batched(pos, box, rcut, max_nbors: int, n_valid,
                            out=None):
    """The O(N^2) build of B configurations at once (the reference builds it
    as ``jax.vmap`` of its one-lane jnp build): one launch of the
    ``brute_build`` kernel on the card, its plain version on the CPU
    (:func:`repro_torch.kernels.neighbors.brute_build`).

    ``pos`` [B, N, 3], ``box`` [B, 3] and ``n_valid`` [B] are tensors on one
    device.  A lane's outputs depend on that lane alone, and nothing is
    read back to the host.  r^2 is (x^2 + y^2) + z^2 and the valid pairs
    are packed to the front of each row in index order, as the reference's
    stable sort packs them.  Returns ``(nbr_idx [B, N, K] int32, mask [B,
    N, K] bool, disp [B, N, K, 3], flags [B, 2] int32)``, written into
    ``out`` when it is given
    (:func:`repro_torch.kernels.neighbors.brute_outputs`).
    """
    return brute_build(pos, box, rcut, max_nbors, n_valid, out=out)


def check_flags(flags, grid: CellGrid):
    """Host-boundary overflow check, mirroring the host list builds' raises.

    Accepts either the bare ``[2]`` build flags or the full ``[N_FLAGS]``
    health vector (numpy or tensor; only the capacity slots are checked
    here — the sticky health slots are :mod:`repro_torch.md.resilience`'s
    business).
    """
    if isinstance(flags, torch.Tensor):
        flags = flags.cpu().numpy()
    f = np.asarray(flags)
    nbr_max = int(f[FLAG_NBR_MAX])
    cell_max = int(f[FLAG_CELL_MAX])
    if cell_max > grid.cell_cap:
        raise CellOverflowError(cell_max, grid.cell_cap)
    if nbr_max > grid.max_nbors:
        raise NeighborOverflowError(nbr_max, grid.max_nbors)


def cell_neighbors_device(pos, box, rcut, max_nbors=64, skin=0.0,
                          cell_cap=None, device='cuda'):
    """Host-facing wrapper with the same contract as the host list builds.

    Builds on ``device`` in float64, reads the result back once, raises on
    overflow.
    Returns numpy ``(nbr_idx, mask, disp, shifts)`` like
    ``brute_neighbors`` — the parity surface for tests.
    """
    device = resolve_device(device)
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64)
    if cell_cap is None:
        cell_cap = auto_cell_cap(pos, box, rcut + skin)
    grid = make_grid(box, rcut, skin, cell_cap, max_nbors)
    nbr_idx, mask, shifts, flags = device_neighbors(
        torch.as_tensor(pos, device=device),
        torch.as_tensor(box, device=device), grid)
    check_flags(flags, grid)
    nbr_idx = nbr_idx.cpu().numpy()
    mask = mask.cpu().numpy()
    shifts = shifts.cpu().numpy()
    disp = np.where(mask[..., None],
                    pos[nbr_idx] + shifts - pos[:, None, :], 0.0)
    return nbr_idx, mask, disp, shifts
