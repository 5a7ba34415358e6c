"""Public SNAP API: energy / force / descriptor pipelines (torch port).

Port of ``repro.core.snap``.  Three force implementations behind
:func:`energy_forces`:

- ``baseline`` — the pre-paper formulation (paper Listing 1/2): Zlist and
  dBlist per (atom, neighbor) are materialized, forces from
  F = -beta . dB.  O(J^5) Z storage per pair: the memory blow-up of the
  paper's Fig. 1, kept on purpose.
- ``adjoint`` — the paper's Sec. IV refactorization (Listing 5): the
  neighbor-independent adjoint Y = sum beta*Z on the fly (no Z storage),
  then the fused force contraction dE = 2 sum w Re(conj(dU) Y).
- ``kernel``  — the U -> Y -> fused dE pipeline of
  :mod:`repro_torch.kernels.ops` (hand-written CUDA kernels on the card),
  on half planes by default, on full planes with ``layout='full'``, with
  bfloat16 Y operands with ``mxu_dtype=torch.bfloat16``.

``energy_forces_autodiff`` (reverse mode through ``torch.autograd``) is the
independent oracle.  Each pipeline takes ``shard=(group, n_shards)`` to run
as one rank of an atom-sharded evaluation
(:func:`repro_torch.kernels.ops.make_sharded_force_fn`).

All pipelines consume padded per-atom neighbor lists:
    dx, dy, dz : [natoms, nnbor]   displacements r_k - r_i
    nbr_idx    : [natoms, nnbor]   global index of neighbor atom
    mask       : [natoms, nnbor]   True for real neighbor slots
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import bispectrum as bs
from ..kernels.assemble import assemble_forces_csr, destination_csr
from .geometry import (compute_geometry, compute_geometry_grad,
                       sanitize_displacements)
from .indices import SnapIndex, build_index
from .tables import device_table
from .ulist import compute_dulist, compute_ulist, compute_ulisttot


@dataclass(frozen=True)
class SnapConfig:
    """Hyperparameters of the SNAP descriptor (LAMMPS pair_style snap)."""
    twojmax: int = 8
    rcut: float = 4.67637
    rmin0: float = 0.0
    rfac0: float = 0.99363
    switch_flag: bool = True
    bzero_flag: bool = True
    wself: float = 1.0
    dtype: torch.dtype = torch.float64

    @property
    def index(self) -> SnapIndex:
        return build_index(self.twojmax, self.wself)

    @property
    def ncoeff(self) -> int:
        return self.index.idxb_max


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a card
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run the plain versions")
    return device


# ---------------------------------------------------------------------------
# shared front end
# ---------------------------------------------------------------------------

def _pair_geometry(cfg: SnapConfig, dx, dy, dz, mask, grad: bool):
    dx, dy, dz, ok = sanitize_displacements(dx, dy, dz, mask,
                                            safe_r=0.5 * cfg.rcut)
    kw = dict(rcut=cfg.rcut, rmin0=cfg.rmin0, rfac0=cfg.rfac0,
              switch_flag=cfg.switch_flag)
    if grad:
        geom, dgeom = compute_geometry_grad(dx, dy, dz, **kw)
    else:
        geom, dgeom = compute_geometry(dx, dy, dz, **kw), None
    # force masked slots out of the sums entirely
    geom = geom._replace(sfac=torch.where(ok, geom.sfac,
                                          torch.zeros_like(geom.sfac)))
    if dgeom is not None:
        dgeom = dgeom._replace(dsfac=torch.where(
            ok[..., None], dgeom.dsfac, torch.zeros_like(dgeom.dsfac)))
    return geom, dgeom, ok


def _inputs(cfg, dx, dy, dz, nbr_idx, mask, device):
    dx, dy, dz = (torch.as_tensor(v, device=device, dtype=cfg.dtype)
                  for v in (dx, dy, dz))
    return (dx, dy, dz,
            torch.as_tensor(nbr_idx, device=device, dtype=torch.long),
            torch.as_tensor(mask, device=device, dtype=torch.bool))


def compute_bispectrum(cfg: SnapConfig, dx, dy, dz, mask):
    """Descriptors B: real [natoms, ncoeff] — the fitting interface.

    dx, dy, dz, mask: tensors on one device (the caller's)."""
    idx = cfg.index
    geom, _, ok = _pair_geometry(cfg, dx, dy, dz, mask, grad=False)
    u = compute_ulist(geom, idx, cfg.dtype)
    ut = compute_ulisttot(u, geom.sfac, ok, idx, cfg.wself)
    z = bs.compute_zlist(ut, idx)
    return bs.compute_blist(ut, z, idx, cfg.bzero_flag)


def snap_energy(cfg: SnapConfig, beta, beta0, dx, dy, dz, mask):
    """(E_total, E_per_atom) from the linear model E_i = beta0 + beta . B_i."""
    b = compute_bispectrum(cfg, dx, dy, dz, mask)
    e_atom = beta0 + b @ beta.to(device=b.device, dtype=b.dtype)
    return torch.sum(e_atom), e_atom


def assemble_forces(dedr, nbr_idx, mask, natoms, group=None):
    """F_i += sum_k dE_i/dr_k ; F_k -= dE_i/dr_k (Newton's third law).

    group=None: single-shard assembly — ``dedr`` [natoms, nnbor, 3] rows
    span all atoms.

    group (a ``torch.distributed`` process group): atom-sharded assembly —
    ``dedr`` holds this rank's ``n_local`` rows (atoms ``rank * n_local``
    onwards), ``nbr_idx`` holds **global** indices and ``natoms`` is the
    global count.  The rank assembles a full-length partial (its own rows
    at its offset, its Newton reactions on any row) and a reduce-scatter
    over the group sums the partials and returns this rank's rows, as the
    reference's ``psum_scatter(tiled=True)`` does.

    Each sum runs in a fixed order (an atom's own row, then the rows that
    name it as neighbor, sorted by destination), so on the card two
    evaluations of the same inputs give the same bits; see
    :mod:`repro_torch.kernels.assemble`.
    """
    n_local = dedr.shape[0]
    world = 1 if group is None else dist.get_world_size(group)
    if n_local * world != natoms:
        raise ValueError(f'dedr has {n_local} atom rows on each of {world} '
                         f'rank(s), expected {natoms} atoms in all')
    offset = 0 if group is None else dist.get_rank(group) * n_local
    # masked slots name no atom: they sort past the last segment, so no
    # thread walks them (padded lists name atom 0 in every empty slot);
    # dedr is read where it lies (the fused dE planes' view on the card)
    nbr_idx, mask = nbr_idx.contiguous(), mask.contiguous()
    f = assemble_forces_csr(dedr, *destination_csr(nbr_idx, natoms, mask),
                            offset, mask)
    if group is None:
        return f
    out = f.new_empty((n_local, 3))
    dist.reduce_scatter_tensor(out, f, group=group)
    return out


# ---------------------------------------------------------------------------
# adjoint pipeline (paper Sec. IV / Listing 5)
# ---------------------------------------------------------------------------

def bzero_shift(cfg: SnapConfig, beta, dtype):
    """Per-atom energy shift from the bzero self-contribution: bzero . beta
    (beta [ncoeff]), or one a row of beta [L, ncoeff]: [L]."""
    if not cfg.bzero_flag:
        return 0.0
    bz = device_table(cfg.index, bs.bzero_table, dtype, beta.device)
    return bz @ beta.to(dtype) if beta.ndim == 1 else beta.to(dtype) @ bz


def energy_from_ylist(cfg: SnapConfig, ulisttot, ylist, beta, beta0):
    """Per-atom energy directly from the adjoint:

        sum_l beta_l B_l  ==  (2/3) sum_jju w_jju Re(conj(U) Y)
    """
    idx = cfg.index
    w = device_table(idx, 'dedr_weight', ulisttot.real.dtype,
                     ulisttot.device)
    e_raw = (2.0 / 3.0) * torch.sum(
        w * (ulisttot.real * ylist.real + ulisttot.imag * ylist.imag),
        dim=-1)
    return beta0 + e_raw - bzero_shift(cfg, beta, e_raw.dtype)


def energy_forces_adjoint(cfg: SnapConfig, beta, beta0, dx, dy, dz,
                          nbr_idx, mask, with_energy: bool = True,
                          energy_via_z: bool = False, shard=None,
                          device='cuda'):
    """The paper's refactored pipeline: U -> Y -> fused dE -> forces,
    in ``cfg.dtype`` on ``device``.

    shard: optional ``(group, n_shards)`` when running as one rank of an
    atom-sharded evaluation — rows are this rank's atoms, ``nbr_idx`` is
    global, and the force assembly reduce-scatters over ``group``.  The
    returned energy is then this rank's partial sum (the caller
    all-reduces it)."""
    device = resolve_device(device)
    idx = cfg.index
    dx, dy, dz, nbr_idx, mask = _inputs(cfg, dx, dy, dz, nbr_idx, mask,
                                        device)
    beta = torch.as_tensor(beta, device=device, dtype=cfg.dtype)
    natoms, nnbor = dx.shape
    group, n_shards = shard if shard is not None else (None, 1)
    geom, dgeom, ok = _pair_geometry(cfg, dx, dy, dz, mask, grad=True)
    u, du = compute_dulist(geom, dgeom, idx, cfg.dtype)
    ut = compute_ulisttot(u, geom.sfac, ok, idx, cfg.wself)
    y = bs.compute_ylist(ut, beta, idx)
    atom_of_pair = torch.arange(natoms, device=device).repeat_interleave(
        nnbor)
    dedr = bs.compute_dedr(du.reshape(-1, 3, idx.idxu_max), y, atom_of_pair,
                           idx)
    forces = assemble_forces(dedr.reshape(natoms, nnbor, 3), nbr_idx, ok,
                             natoms * n_shards, group)
    if not with_energy:
        return None, None, forces
    if energy_via_z:
        z = bs.compute_zlist(ut, idx)
        b = bs.compute_blist(ut, z, idx, cfg.bzero_flag)
        e_atom = beta0 + b @ beta
    else:
        e_atom = energy_from_ylist(cfg, ut, y, beta, beta0)
    return torch.sum(e_atom), e_atom, forces


# ---------------------------------------------------------------------------
# baseline pipeline (paper Listing 1/2: store Z, dU, dB)
# ---------------------------------------------------------------------------

def energy_forces_baseline(cfg: SnapConfig, beta, beta0, dx, dy, dz,
                           nbr_idx, mask, db_chunks: int = 8, shard=None,
                           device='cuda'):
    """Pre-refactorization formulation, in ``cfg.dtype`` on ``device``: Z
    is stored, gathered to every pair ([P, idxz_max]) and contracted with
    dU into dB [P, 3, ncoeff] in ``db_chunks`` slices of the COO table;
    then dE/dr = beta . dB and E_i = beta0 + beta . B_i.  ``shard`` as in
    :func:`energy_forces_adjoint`.

    The beta contractions are elementwise products summed over the
    coefficient axis (a reduction with a fixed order on the card), so two
    evaluations give the same bits."""
    device = resolve_device(device)
    idx = cfg.index
    dx, dy, dz, nbr_idx, mask = _inputs(cfg, dx, dy, dz, nbr_idx, mask,
                                        device)
    beta = torch.as_tensor(beta, device=device, dtype=cfg.dtype)
    natoms, nnbor = dx.shape
    group, n_shards = shard if shard is not None else (None, 1)
    geom, dgeom, ok = _pair_geometry(cfg, dx, dy, dz, mask, grad=True)
    u, du = compute_dulist(geom, dgeom, idx, cfg.dtype)
    ut = compute_ulisttot(u, geom.sfac, ok, idx, cfg.wself)
    zlist = bs.compute_zlist(ut, idx)                   # O(J^5) storage
    atom_of_pair = torch.arange(natoms, device=device).repeat_interleave(
        nnbor)
    # dBlist: [P, 3, ncoeff] — the memory blow-up of paper Fig. 1
    db = _compute_dblist_chunked(du.reshape(-1, 3, idx.idxu_max), zlist,
                                 atom_of_pair, idx, db_chunks)
    dedr = torch.sum(db * beta, dim=-1)
    forces = assemble_forces(dedr.reshape(natoms, nnbor, 3), nbr_idx, ok,
                             natoms * n_shards, group)
    b = bs.compute_blist(ut, zlist, idx, cfg.bzero_flag)
    e_atom = beta0 + torch.sum(b * beta, dim=-1)
    return torch.sum(e_atom), e_atom, forces


def _compute_dblist_chunked(du_flat, zlist, atom_of_pair, idx, nchunk):
    """dB over ``nchunk`` slices of the COO table
    (:func:`bispectrum.compute_dblist`)."""
    return bs.compute_dblist(du_flat, zlist, atom_of_pair, idx, nchunk)


# ---------------------------------------------------------------------------
# autodiff oracle
# ---------------------------------------------------------------------------

def energy_forces_autodiff(cfg: SnapConfig, beta, beta0, positions,
                           nbr_idx, shifts, mask, device='cuda'):
    """Independent oracle: F = -grad E via reverse-mode ``torch.autograd``.

    shifts: [natoms, nnbor, 3] constant image offsets such that
    r_k - r_i = positions[nbr_idx] + shifts - positions[:, None].
    """
    device = resolve_device(device)
    pos = torch.as_tensor(positions, device=device, dtype=cfg.dtype)
    pos = pos.clone().requires_grad_(True)
    nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
    shifts = torch.as_tensor(shifts, device=device, dtype=cfg.dtype)
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    beta = torch.as_tensor(beta, device=device, dtype=cfg.dtype)
    disp = pos[nbr_idx] + shifts - pos[:, None, :]
    e, _ = snap_energy(cfg, beta, beta0, disp[..., 0], disp[..., 1],
                       disp[..., 2], mask)
    (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


IMPLEMENTATIONS = ('baseline', 'adjoint', 'kernel')


def energy_forces(cfg: SnapConfig, beta, beta0, dx, dy, dz, nbr_idx, mask,
                  impl: str = 'adjoint', **kw):
    """Dispatch front-end used by MD.

    impl='kernel' forwards ``kw`` to
    :func:`repro_torch.kernels.ops.snap_force_pipeline`: ``dtype``,
    ``device``, ``with_energy``, ``layout`` ('half', the default, or
    'full': the full-plane U, Y and fused dE kernels) and ``mxu_dtype``
    (None, or ``torch.bfloat16`` to round the Y stage's operands to
    bfloat16; half layout only).  impl='adjoint' takes ``device``,
    ``with_energy`` and ``energy_via_z`` and runs in ``cfg.dtype``;
    impl='baseline' takes ``device`` and ``db_chunks`` and runs in
    ``cfg.dtype``.  Every impl takes ``shard=(group, n_shards)``.
    """
    if impl == 'adjoint':
        return energy_forces_adjoint(cfg, beta, beta0, dx, dy, dz,
                                     nbr_idx, mask, **kw)
    if impl == 'baseline':
        return energy_forces_baseline(cfg, beta, beta0, dx, dy, dz,
                                      nbr_idx, mask, **kw)
    if impl == 'kernel':
        from repro_torch.kernels import ops
        return ops.snap_force_pipeline(cfg, beta, beta0, dx, dy, dz,
                                       nbr_idx, mask, **kw)
    raise ValueError(f'unknown impl {impl!r}; choose from {IMPLEMENTATIONS}')
