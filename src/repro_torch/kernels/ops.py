"""The kernel-backed SNAP energy/force pipeline (``impl='kernel'`` in
:func:`repro_torch.core.snap.energy_forces`) and its per-stage wrappers.

Port of ``repro.kernels.ops``.  After one entry relayout ([natoms, nnbor]
-> [nnbor, 4, natoms_pad]), U -> Y -> fused dE run in plane layout with the
atom on the fast axis; the only exits are the force assembly and the
in-layout energy.  ``layout='half'`` (the default) keeps every plane at
``[idxu_half_max, natoms_pad]``; ``layout='full'`` runs the full-plane
stages on ``[idxu_max, natoms_pad]``, kept for A/B measurement of plane
traffic.  ``mxu_dtype=torch.bfloat16`` (half layout only) rounds the Y
stage's operands to bfloat16.  Each stage goes through its wrapper, which
launches the CUDA kernel on a CUDA tensor and runs the plain version on a
CPU tensor.

:func:`make_batched_force_fn` is the serving entry (port of the reference's
``jax.vmap`` over one request a lane): B requests side by side on one atom
axis, one launch of each stage a batch, the Y stage with one coefficient
row a lane.  :func:`make_sharded_force_fn` is the atom-sharded entry (port
of the reference's ``shard_map``): each rank of a process group runs a
pipeline on its own rows, and only the exit force assembly and the energy
cross ranks.

While a profiler records, each step of an evaluation is a span
(:mod:`repro_torch.runtime.trace`): ``snap.layout`` (the entry
relayout), ``snap.u``, ``snap.y``, ``snap.de``, ``snap.assemble`` and
``snap.energy``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from . import _build
from ..analysis.retrace import record_trace
from ..core.geometry import sanitize_displacements
from ..core.snap import (SnapConfig, assemble_forces, bzero_shift,
                         energy_forces, energy_forces_adjoint,
                         resolve_device)
from ..core.tables import device_table
from ..runtime.shard import group_of, rank_rows
from ..runtime.trace import span
from .common import LANES
from .snap_fused_de import snap_fused_de_full, snap_fused_de_full_plain
from .snap_fused_de_half import snap_fused_de_half, snap_fused_de_half_plain
from .snap_u import (snap_u_full, snap_u_full_plain, snap_u_half,
                     snap_u_half_plain)
from .snap_y import (check_mxu_dtype, snap_y_full, snap_y_full_plain,
                     snap_y_half, snap_y_half_plain, y_coef, y_coef_half)

LAYOUTS = ('half', 'full')
# every kernel entry, as counted in _build.LAUNCHES
KERNELS = ('snap_u_half', 'snap_y_half', 'snap_y_half_bf16',
           'snap_fused_de_half', 'snap_u_full', 'snap_y_full',
           'snap_fused_de_full', 'destination_csr', 'assemble_forces',
           'cell_bin', 'cell_build', 'brute_build')
# (U, Y, fused dE, Y coefficient) per layout: wrappers and plain versions
_STAGES = {
    'half': (snap_u_half, snap_y_half, snap_fused_de_half, y_coef_half),
    'full': (snap_u_full, snap_y_full, snap_fused_de_full, y_coef),
}
_PLAIN_STAGES = {
    'half': (snap_u_half_plain, snap_y_half_plain, snap_fused_de_half_plain,
             y_coef_half),
    'full': (snap_u_full_plain, snap_y_full_plain, snap_fused_de_full_plain,
             y_coef),
}


def launch_counts() -> dict:
    """Kernel launches per kernel entry since the last reset."""
    return {k: _build.LAUNCHES[k] for k in KERNELS}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()


def _check_options(layout, mxu_dtype):
    if layout not in LAYOUTS:
        raise ValueError(f'unknown layout {layout!r}; choose from {LAYOUTS}')
    check_mxu_dtype(mxu_dtype)
    if mxu_dtype is not None and layout != 'half':
        raise ValueError(
            "mxu_dtype is a half-layout option (the full-plane Y stage has "
            "no low-precision path); drop it or use layout='half'")


def _kernel_layout(cfg: SnapConfig, dx, dy, dz, mask, dtype):
    """[natoms, nnbor] displacement tensors -> [nnbor, 4, natoms_pad]."""
    dx, dy, dz, ok = sanitize_displacements(dx, dy, dz, mask,
                                            safe_r=0.5 * cfg.rcut)
    natoms = dx.shape[0]
    pad = (-natoms) % LANES
    disp = torch.stack([dx.T, dy.T, dz.T, ok.T.to(dx.dtype)], dim=1)
    disp = torch.nn.functional.pad(disp, (0, pad)).to(dtype)
    # dead lanes (atom padding) must still see a regular radius: the
    # Cayley-Klein map is singular at r = 0 even when masked out
    disp[:, 0, :] = torch.where(disp[:, 3, :] > 0, disp[:, 0, :],
                                torch.full_like(disp[:, 0, :],
                                                0.5 * cfg.rcut))
    return disp.contiguous(), ok, natoms


@lru_cache(maxsize=32)
def _self_planes(cfg: SnapConfig, dtype, device, layout='half'):
    """Wigner self-contribution as a lane-broadcastable [rows, 1] plane of
    ``layout`` (the U kernels leave it out).  Read-only, cached so an
    evaluation uploads no table."""
    idx = cfg.index
    if layout == 'half':
        v = np.zeros(idx.idxu_half_max)
        v[idx.self_diag_half] = cfg.wself
    else:
        v = np.zeros(idx.idxu_max)
        v[idx.self_diag] = cfg.wself
    return torch.as_tensor(v, dtype=dtype, device=device)[:, None]


def half_planes_to_full(cfg: SnapConfig, h_r, h_i):
    """Expand [idxu_half_max, *] half planes to full via the j-mirror:
    u_full = sign * conj^c(u_half[src]).  Test plumbing only."""
    idx = cfg.index
    t = dict(dtype=h_r.dtype, device=h_r.device)
    sgn = torch.as_tensor(idx.full_to_half_sign, **t)[:, None]
    sig = torch.as_tensor(np.where(idx.full_to_half_conj, -1.0, 1.0),
                          **t)[:, None]
    src = torch.as_tensor(idx.full_to_half, dtype=torch.long,
                          device=h_r.device)
    return sgn * h_r[src], sgn * sig * h_i[src]


def _energy_weights(cfg: SnapConfig, dtype, device, layout):
    """``dedr_weight_half`` or ``dedr_weight`` as a read-only [rows, 1]
    plane."""
    name = 'dedr_weight_half' if layout == 'half' else 'dedr_weight'
    return device_table(cfg.index, name, dtype, device)[:, None]


def energy_from_ylist_lanes(cfg: SnapConfig, ut_r, ut_i, y_r, y_i,
                            beta, beta0, lanes=None):
    """Per-atom energy in plane layout: (2/3) sum_jju w Re(conj(U) Y).

    Operands are half [idxu_half_max, N] or full [idxu_max, N] planes,
    told apart by their row count.  The half form is exact because
    ``dedr_weight`` is 0 on every mirrored row.  With ``lanes`` = L the N
    atoms are L lanes of N / L, ``beta`` [L, ncoeff] and ``beta0`` [L]
    hold each lane's potential, and the result is [L, N / L]."""
    layout = 'half' if ut_r.shape[0] == cfg.index.idxu_half_max else 'full'
    w = _energy_weights(cfg, ut_r.dtype, ut_r.device, layout)
    e_raw = (2.0 / 3.0) * torch.sum(w * (ut_r * y_r + ut_i * y_i), dim=0)
    shift = bzero_shift(cfg, beta, e_raw.dtype)
    if lanes is None:
        return beta0 + e_raw - shift
    if isinstance(shift, torch.Tensor):
        shift = shift[:, None]
    return beta0.to(e_raw.dtype)[:, None] + e_raw.view(lanes, -1) - shift


def _to_layout(cfg, dx, dy, dz, mask, dtype, device):
    """:func:`_kernel_layout` of arrays or tensors, on ``device``."""
    dx, dy, dz = (torch.as_tensor(v, device=device, dtype=dtype)
                  for v in (dx, dy, dz))
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    return _kernel_layout(cfg, dx, dy, dz, mask, dtype)


def _stages(stages, layout, cfg, beta, disp, dtype, device, mxu_dtype,
            lane_atoms=None):
    """U -> Y -> fused dE on [nnbor, 4, N] planes: (ut_r, ut_i, y_r, y_i,
    dedr).  ``lane_atoms``: beta is [L, ncoeff], a row a lane of
    ``lane_atoms`` atoms."""
    u_stage, y_stage, de_stage, coef_of = stages
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    with span('snap.u'):
        ut_r, ut_i = u_stage(disp, **geo)
        ut_r = ut_r + _self_planes(cfg, dtype, device, layout)
    with span('snap.y'):
        coef = coef_of(beta, cfg.twojmax).to(dtype)
        y_kw = {} if mxu_dtype is None else dict(mxu_dtype=mxu_dtype)
        if lane_atoms is not None:
            y_kw['lane_atoms'] = lane_atoms
        y_r, y_i = y_stage(ut_r, ut_i, coef, twojmax=cfg.twojmax, **y_kw)
    with span('snap.de'):
        dedr = de_stage(disp, y_r, y_i, **geo)
    return ut_r, ut_i, y_r, y_i, dedr


def _pipeline(stages, layout, cfg, beta, beta0, dx, dy, dz, nbr_idx, mask,
              dtype, device, with_energy, mxu_dtype=None, shard=None):
    group, n_shards = shard if shard is not None else (None, 1)
    with span('snap.layout'):
        disp, ok, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
        nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
        beta = torch.as_tensor(beta, device=device)
    ut_r, ut_i, y_r, y_i, dedr = _stages(stages, layout, cfg, beta, disp,
                                         dtype, device, mxu_dtype)
    with span('snap.assemble'):
        # pipeline exit: per-pair dE back to [natoms, nnbor, 3] force
        # assembly
        dedr_pairs = dedr[:, :3, :natoms].permute(2, 0, 1)
        forces = assemble_forces(dedr_pairs, nbr_idx, ok, natoms * n_shards,
                                 group)
    if not with_energy:
        return None, None, forces
    with span('snap.energy'):
        e_atom = energy_from_ylist_lanes(cfg, ut_r, ut_i, y_r, y_i, beta,
                                         beta0)[:natoms]
        return torch.sum(e_atom), e_atom, forces


def snap_force_pipeline(cfg: SnapConfig, beta, beta0, dx, dy, dz, nbr_idx,
                        mask, dtype=torch.float32, device='cuda',
                        with_energy=True, layout: str = 'half',
                        mxu_dtype=None, shard=None):
    """U -> Y -> fused dE on ``device`` in ``dtype``: (E, e_atom, forces).

    Inputs are [natoms, nnbor] arrays or tensors (``beta``: [ncoeff]).  On
    ``device='cuda'`` every stage is a hand-written CUDA kernel; with
    ``device='cpu'`` the same wrappers run their plain versions.
    ``layout``: 'half' (default) or 'full' planes.  ``mxu_dtype``: None or
    ``torch.bfloat16`` (half layout only), the Y stage's operand rounding.
    ``shard``: optional ``(group, n_shards)`` for one rank of the
    atom-sharded path — the stages run unchanged on this rank's rows
    (atoms already live on the lane axis), only the exit force assembly
    reduce-scatters over ``group``; the energy is the rank's partial sum.
    """
    _check_options(layout, mxu_dtype)
    device = resolve_device(device)
    return _pipeline(_STAGES[layout], layout, cfg, beta, beta0, dx, dy, dz,
                     nbr_idx, mask, dtype, device, with_energy, mxu_dtype,
                     shard)


def plain_force_pipeline(cfg: SnapConfig, beta, beta0, dx, dy, dz, nbr_idx,
                         mask, dtype=torch.float32, device='cuda',
                         with_energy=True, layout: str = 'half',
                         mxu_dtype=None):
    """The same pipeline built from the plain stage versions on any
    device: the yardstick the kernel pipeline is held against on the card
    (on the CPU, :func:`snap_force_pipeline` already runs these).  The
    force assembly is the same in both."""
    _check_options(layout, mxu_dtype)
    device = resolve_device(device)
    return _pipeline(_PLAIN_STAGES[layout], layout, cfg, beta, beta0, dx, dy,
                     dz, nbr_idx, mask, dtype, device, with_energy, mxu_dtype)


def make_sharded_force_fn(cfg: SnapConfig, beta, beta0, group=None,
                          impl: str = 'adjoint', device='cuda', **kw):
    """Atom-sharded force evaluation over the ranks of a process group
    (port of the reference's ``shard_map`` over an atom mesh).  Returns

        fn(dx, dy, dz, nbr_idx, mask) -> (e, e_atom_local, f_local)

    Every rank passes the global [natoms, nnbor] inputs (the MD state is
    replicated); ``natoms`` must divide by the group's size.  ``fn`` takes
    this rank's rows (:func:`repro_torch.runtime.shard.rank_rows`), runs
    ``energy_forces(impl=...)`` on them with ``shard=(group, world)`` — the
    pipeline stages see only local rows, the force assembly
    reduce-scatters the cross-rank Newton pairs — and all-reduces the
    energy.  ``e`` is the total, on every rank; ``e_atom_local`` and
    ``f_local`` are this rank's rows, which
    :func:`repro_torch.runtime.shard.gather_atoms` concatenates in rank
    order into the reference's global arrays.  ``group``: a process group,
    or None for the default one (it must be initialized).  ``kw`` goes to
    the pipeline (``dtype``, ``layout``, ``mxu_dtype`` for 'kernel').
    """
    device = resolve_device(device)
    group = group_of(group)
    world = dist.get_world_size(group)
    beta = torch.as_tensor(beta, device=device)

    def fn(dx, dy, dz, nbr_idx, mask):
        offset, n_local = rank_rows(dx.shape[0], group)
        rows = slice(offset, offset + n_local)
        e, e_atom, f = energy_forces(
            cfg, beta, beta0, dx[rows], dy[rows], dz[rows], nbr_idx[rows],
            mask[rows], impl=impl, shard=(group, world), device=device, **kw)
        e = e.reshape(1).clone()
        dist.all_reduce(e, group=group)
        return e[0], e_atom, f

    return fn


def _lanes_flat(t, lane_atoms):
    """[B, n, ...] -> [B * lane_atoms, ...]: each lane padded with zeros
    (False) to ``lane_atoms`` rows, lanes side by side."""
    out = t.new_zeros((t.shape[0], lane_atoms) + tuple(t.shape[2:]))
    out[:, :t.shape[1]] = t
    return out.reshape((-1,) + tuple(t.shape[2:]))


def _batched_kernel(cfg, beta, beta0, disp, nbr_idx, mask, dtype, device,
                    layout, mxu_dtype, lane_atoms):
    """One launch of each stage for all B lanes: (e_atom [B, n_pad],
    forces [B, n_pad, 3]) in ``dtype``."""
    B, n_pad = mask.shape[:2]
    with span('snap.layout'):
        # each lane's neighbor indices name atoms of its own lane; masked
        # slots get the sentinel B * lane_atoms in assemble_forces
        base = torch.arange(B, device=device) * lane_atoms
        nbr = _lanes_flat(nbr_idx.long() + base[:, None, None], lane_atoms)
        d = [_lanes_flat(disp[..., c], lane_atoms) for c in range(3)]
        planes, ok, natoms = _to_layout(cfg, *d,
                                        _lanes_flat(mask, lane_atoms),
                                        dtype, device)
    ut_r, ut_i, y_r, y_i, dedr = _stages(_STAGES[layout], layout, cfg, beta,
                                         planes, dtype, device, mxu_dtype,
                                         lane_atoms)
    with span('snap.assemble'):
        forces = assemble_forces(dedr[:, :3, :].permute(2, 0, 1), nbr, ok,
                                 natoms)
    with span('snap.energy'):
        e_atom = energy_from_ylist_lanes(cfg, ut_r, ut_i, y_r, y_i, beta,
                                         beta0, lanes=B)
    return e_atom[:, :n_pad], forces.view(B, lane_atoms, 3)[:, :n_pad]


def _batched_adjoint(cfg, beta, beta0, disp, nbr_idx, mask, device, kw):
    """The adjoint pipeline lane by lane, in ``cfg.dtype``."""
    outs = [energy_forces_adjoint(cfg, beta[b], beta0[b], disp[b, ..., 0],
                                  disp[b, ..., 1], disp[b, ..., 2],
                                  nbr_idx[b], mask[b], device=device, **kw)
            for b in range(mask.shape[0])]
    return (torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def make_batched_force_fn(cfg: SnapConfig, n_pad: int, max_nbors: int,
                          impl: str = 'kernel', dtype=torch.float32,
                          device='cuda', trace_counter=None, **kw):
    """Batched force entry of the serving front end (port of the
    reference's ``make_batched_force_fn``).  Returns

        fn(pos [B, n_pad, 3], box [B, 3], beta [B, ncoeff], beta0 [B],
           n_valid [B] int32) -> (e [B], forces [B, n_pad, 3],
                                  flags [B, N_FLAGS] int32)

    on ``device`` (inputs: tensors on it, or arrays).  Each lane is one
    configuration: the fixed-shape O(N^2) neighbor build
    (:func:`repro_torch.md.cell_list.brute_neighbors_batched`, one launch
    of the ``brute_build`` kernel for all lanes, in the positions' dtype),
    then the force pipeline.  Atoms at index >=
    ``n_valid`` are masked out of the energy and the forces.

    impl='kernel': the B lanes side by side on one atom axis, each padded
    to ``lane_atoms = round_up(n_pad, 128)`` atoms (the reference's
    per-lane padding), so U, Y, fused dE and the assembly launch once a
    batch whatever B is; the Y stage reads a coefficient row a lane (each
    lane's beta).  Computed in ``dtype``; ``kw``: ``layout`` and
    ``mxu_dtype`` as in :func:`snap_force_pipeline`.  The launch plans
    depend on the width B * lane_atoms, so a lane's bits are those of the
    same request in any lane of any batch of the same B and n_pad.
    impl='adjoint': ``energy_forces_adjoint`` lane by lane in
    ``cfg.dtype`` (the service's quarantine path; ``kw`` goes to it).

    Flags, reduced over each lane alone: ``FLAG_NBR_MAX`` the largest
    neighbor count (overflow above ``max_nbors``), ``FLAG_CELL_MAX`` 0,
    ``FLAG_NAN_FORCE`` non-finite forces or energy, ``FLAG_NAN_STATE``
    non-finite positions of valid atoms.  Building the function adds one
    to ``trace_counter['traces']``.  Nothing in ``fn`` reads the device
    back.
    """
    from ..md.cell_list import (FLAG_CELL_MAX, FLAG_NAN_FORCE,
                                FLAG_NAN_STATE, FLAG_NBR_MAX, N_FLAGS,
                                brute_neighbors_batched)
    from .neighbors import brute_outputs
    if impl not in ('kernel', 'adjoint'):
        raise ValueError(f"unknown impl {impl!r}; choose 'kernel' or "
                         "'adjoint'")
    device = resolve_device(device)
    if impl == 'kernel':
        layout = kw.pop('layout', 'half')
        mxu_dtype = kw.pop('mxu_dtype', None)
        if kw:
            raise TypeError(f'unknown kernel options {sorted(kw)}')
        _check_options(layout, mxu_dtype)
    lane_atoms = -(-n_pad // LANES) * LANES
    record_trace(trace_counter)
    lists = {}   # the card's neighbor lists a shape, rewritten each call

    def fn(pos, box, beta, beta0, n_valid):
        pos, box, beta, beta0 = (torch.as_tensor(v, device=device)
                                 for v in (pos, box, beta, beta0))
        n_valid = torch.as_tensor(n_valid, device=device)
        B = pos.shape[0]
        ok_atom = (torch.arange(n_pad, device=device)[None, :]
                   < n_valid[:, None])
        out = None
        if pos.device.type == 'cuda':
            key = (B, pos.shape[1], pos.dtype)
            out = lists.get(key)
            if out is None:
                out = lists[key] = brute_outputs(B, pos.shape[1], max_nbors,
                                                 pos.dtype, pos.device)
        nbr_idx, mask, disp, bflags = brute_neighbors_batched(
            pos, box, cfg.rcut, max_nbors, n_valid, out)
        nan_state = ~torch.isfinite(torch.where(
            ok_atom[..., None], pos, 0.0)).flatten(1).all(dim=1)
        if impl == 'kernel':
            e_atom, f = _batched_kernel(cfg, beta, beta0, disp, nbr_idx,
                                        mask, dtype, device, layout,
                                        mxu_dtype, lane_atoms)
        else:
            e_atom, f = _batched_adjoint(cfg, beta, beta0, disp, nbr_idx,
                                         mask, device, kw)
        # padded atoms see no neighbors but still carry the Wigner
        # self-energy: masked out of both outputs
        f = torch.where(ok_atom[..., None], f, 0.0)
        e = torch.where(ok_atom, e_atom, 0.0).sum(dim=1)
        nan_force = ~(torch.isfinite(f).flatten(1).all(dim=1)
                      & torch.isfinite(e))
        flags = torch.zeros((B, N_FLAGS), dtype=torch.int32, device=device)
        flags[:, FLAG_NBR_MAX] = bflags[:, 0]
        flags[:, FLAG_CELL_MAX] = bflags[:, 1]
        flags[:, FLAG_NAN_FORCE] = nan_force.to(torch.int32)
        flags[:, FLAG_NAN_STATE] = nan_state.to(torch.int32)
        return e, f, flags

    return fn


# ---------------------------------------------------------------------------
# per-stage wrappers (tests / measurements; each owns its layout plumbing)
# ---------------------------------------------------------------------------


def _planes(z, rows, dtype, pad):
    """Complex [natoms, idxu_max] -> re/im planes [rows, natoms + pad] of
    the chosen flat rows (None: all)."""
    z = z if rows is None else z[:, rows]
    return tuple(torch.nn.functional.pad(p.T.to(dtype), (0, pad)).contiguous()
                 for p in (z.real, z.imag))


def _half_rows(cfg, layout, device):
    """Full-space index of each half row, or None for the full layout."""
    if layout == 'full':
        return None
    return torch.as_tensor(cfg.index.half_to_full, dtype=torch.long,
                           device=device)


def snap_ui_kernel(cfg: SnapConfig, dx, dy, dz, mask, dtype=torch.float32,
                   device='cuda', layout: str = 'half'):
    """Ulisttot through the U stage: complex [natoms, idxu_max], self term
    included (the half layout's planes mirror-expanded)."""
    _check_options(layout, None)
    device = resolve_device(device)
    disp, _, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    u_stage = _STAGES[layout][0]
    ut_r, ut_i = u_stage(disp, twojmax=cfg.twojmax, rcut=cfg.rcut,
                         rmin0=cfg.rmin0, rfac0=cfg.rfac0,
                         switch_flag=cfg.switch_flag)
    ut_r = ut_r + _self_planes(cfg, dtype, device, layout)
    if layout == 'half':
        ut_r, ut_i = half_planes_to_full(cfg, ut_r, ut_i)
    return torch.complex(ut_r[:, :natoms], ut_i[:, :natoms]).T


def snap_yi_kernel(cfg: SnapConfig, ulisttot, beta, dtype=torch.float32,
                   device='cuda', layout: str = 'half', mxu_dtype=None):
    """Adjoint Y through the Y stage: complex [natoms, idxu_max].

    The half output is scattered back into the full index space (mirrored
    rows 0, like ``compute_ylist``); the dropped weight-0 middle-row
    columns also read 0, so compare on the ``dedr_weight > 0`` support.
    """
    _check_options(layout, mxu_dtype)
    device = resolve_device(device)
    idx = cfg.index
    ulisttot = torch.as_tensor(ulisttot, device=device)
    natoms = ulisttot.shape[0]
    rows = _half_rows(cfg, layout, device)
    ut_r, ut_i = _planes(ulisttot, rows, dtype, (-natoms) % LANES)
    _, y_stage, _, coef_of = _STAGES[layout]
    coef = coef_of(torch.as_tensor(beta, device=device),
                   cfg.twojmax).to(dtype)
    y_kw = {} if mxu_dtype is None else dict(mxu_dtype=mxu_dtype)
    y_r, y_i = y_stage(ut_r, ut_i, coef, twojmax=cfg.twojmax, **y_kw)
    y = torch.complex(y_r[:, :natoms], y_i[:, :natoms]).T
    if rows is None:
        return y
    out = torch.zeros((natoms, idx.idxu_max), dtype=y.dtype, device=device)
    out[:, rows] = y
    return out


def snap_dedr_kernel(cfg: SnapConfig, dx, dy, dz, mask, ylist,
                     dtype=torch.float32, device='cuda',
                     layout: str = 'half'):
    """Fused dE/dr per pair through the fused dE stage:
    [natoms, nnbor, 3].  ``ylist``: complex [natoms, idxu_max]."""
    _check_options(layout, None)
    device = resolve_device(device)
    disp, _, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    y_r, y_i = _planes(torch.as_tensor(ylist, device=device),
                       _half_rows(cfg, layout, device), dtype,
                       disp.shape[-1] - natoms)
    dedr = _STAGES[layout][2](disp, y_r, y_i, twojmax=cfg.twojmax,
                              rcut=cfg.rcut, rmin0=cfg.rmin0,
                              rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    return dedr[:, :3, :natoms].permute(2, 0, 1)
