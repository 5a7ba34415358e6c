"""The kernel-backed SNAP energy/force pipeline (``impl='kernel'`` in
:func:`repro_torch.core.snap.energy_forces`) and its per-stage wrappers.

Port of ``repro.kernels.ops``, half-plane layout only.  After one entry
relayout ([natoms, nnbor] -> [nnbor, 4, natoms_pad]), U -> Y -> fused dE
run in the plane layout ``[idxu_half_max, natoms_pad]`` with the atom on
the fast axis; the only exits are the force assembly and the in-layout
energy.  Each stage goes through its wrapper, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU tensor.

Not ported yet: ``layout='full'`` (ROADMAP Queue B, items 4-6), the bf16
``mxu_dtype`` option of the Y stage (Queue B, item 2), the sharded and the
batched (serving) force functions (Queue A, items 5 and 7).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.geometry import sanitize_displacements
from ..core.snap import (SnapConfig, assemble_forces, bzero_shift,
                         resolve_device)
from .common import LANES
from .snap_fused_de_half import snap_fused_de_half, snap_fused_de_half_plain
from .snap_u import snap_u_half, snap_u_half_plain
from .snap_y import snap_y_half, snap_y_half_plain, y_coef_half

LAYOUTS = ('half',)
KERNELS = (snap_u_half, snap_y_half, snap_fused_de_half)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _check_options(layout, mxu_dtype):
    if layout == 'full':
        raise NotImplementedError(
            "layout='full' is not ported yet (ROADMAP Queue B, items 4-6)")
    if layout not in LAYOUTS:
        raise ValueError(f'unknown layout {layout!r}; choose from {LAYOUTS}')
    if mxu_dtype is not None:
        raise NotImplementedError(
            'the low-precision Y operand option (mxu_dtype) is not ported '
            'yet (ROADMAP Queue B, item 2)')


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
def _self_planes(cfg: SnapConfig, dtype, device):
    """Wigner self-contribution as a lane-broadcastable [idxu_half_max, 1]
    plane (the U kernel leaves it out).  Read-only, cached so an evaluation
    uploads no table."""
    idx = cfg.index
    v = np.zeros(idx.idxu_half_max)
    v[idx.self_diag_half] = cfg.wself
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


@lru_cache(maxsize=32)
def _half_weights(cfg: SnapConfig, dtype, device):
    """``dedr_weight_half`` as a read-only [idxu_half_max, 1] plane."""
    return torch.as_tensor(cfg.index.dedr_weight_half, dtype=dtype,
                           device=device)[:, None]


def energy_from_ylist_lanes(cfg: SnapConfig, ut_r, ut_i, y_r, y_i,
                            beta, beta0):
    """Per-atom energy in plane layout: (2/3) sum_jju w Re(conj(U) Y) over
    the half rows (exact: ``dedr_weight`` is 0 on every mirrored row)."""
    w = _half_weights(cfg, ut_r.dtype, ut_r.device)
    e_raw = (2.0 / 3.0) * torch.sum(w * (ut_r * y_r + ut_i * y_i), dim=0)
    return beta0 + e_raw - bzero_shift(cfg, beta, e_raw.dtype)


def _to_layout(cfg, dx, dy, dz, mask, dtype, device):
    """:func:`_kernel_layout` of arrays or tensors, on ``device``."""
    dx, dy, dz = (torch.as_tensor(v, device=device, dtype=dtype)
                  for v in (dx, dy, dz))
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    return _kernel_layout(cfg, dx, dy, dz, mask, dtype)


def _pipeline(stages, cfg, beta, beta0, dx, dy, dz, nbr_idx, mask, dtype,
              device, with_energy):
    u_stage, y_stage, de_stage = stages
    disp, ok, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
    beta = torch.as_tensor(beta, device=device)
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    ut_r, ut_i = u_stage(disp, **geo)
    ut_r = ut_r + _self_planes(cfg, dtype, device)
    coef = y_coef_half(beta, cfg.twojmax).to(dtype)
    y_r, y_i = y_stage(ut_r, ut_i, coef, twojmax=cfg.twojmax)
    dedr = de_stage(disp, y_r, y_i, **geo)
    # pipeline exit: per-pair dE back to [natoms, nnbor, 3] force assembly
    dedr_pairs = dedr[:, :3, :natoms].permute(2, 0, 1)
    forces = assemble_forces(dedr_pairs, nbr_idx, ok, natoms)
    if not with_energy:
        return None, None, forces
    e_atom = energy_from_ylist_lanes(cfg, ut_r, ut_i, y_r, y_i, beta,
                                     beta0)[:natoms]
    return torch.sum(e_atom), e_atom, forces


def snap_force_pipeline(cfg: SnapConfig, beta, beta0, dx, dy, dz, nbr_idx,
                        mask, dtype=torch.float32, device='cuda',
                        with_energy=True, layout: str = 'half',
                        mxu_dtype=None):
    """U -> Y -> fused dE on ``device`` in ``dtype``: (E, e_atom, forces).

    Inputs are [natoms, nnbor] arrays or tensors (``beta``: [ncoeff]).  On
    ``device='cuda'`` every stage is a hand-written CUDA kernel; with
    ``device='cpu'`` the same wrappers run their plain versions.
    """
    _check_options(layout, mxu_dtype)
    device = resolve_device(device)
    return _pipeline((snap_u_half, snap_y_half, snap_fused_de_half), cfg,
                     beta, beta0, dx, dy, dz, nbr_idx, mask, dtype, device,
                     with_energy)


def plain_force_pipeline(cfg: SnapConfig, beta, beta0, dx, dy, dz, nbr_idx,
                         mask, dtype=torch.float32, device='cuda',
                         with_energy=True):
    """The same pipeline built from the plain stage versions on any
    device: the yardstick the kernel pipeline is held against on the card
    (on the CPU, :func:`snap_force_pipeline` already runs these)."""
    device = resolve_device(device)
    return _pipeline((snap_u_half_plain, snap_y_half_plain,
                      snap_fused_de_half_plain), cfg, beta, beta0, dx, dy,
                     dz, nbr_idx, mask, dtype, device, with_energy)


# ---------------------------------------------------------------------------
# per-stage wrappers (tests / measurements; each owns its layout plumbing)
# ---------------------------------------------------------------------------


def snap_ui_kernel(cfg: SnapConfig, dx, dy, dz, mask, dtype=torch.float32,
                   device='cuda', layout: str = 'half'):
    """Ulisttot through the U stage: complex [natoms, idxu_max] (the half
    planes mirror-expanded, self term included)."""
    _check_options(layout, None)
    device = resolve_device(device)
    disp, _, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    h_r, h_i = snap_u_half(disp, twojmax=cfg.twojmax, rcut=cfg.rcut,
                           rmin0=cfg.rmin0, rfac0=cfg.rfac0,
                           switch_flag=cfg.switch_flag)
    ut_r, ut_i = half_planes_to_full(
        cfg, h_r + _self_planes(cfg, dtype, device), h_i)
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
    pad = (-natoms) % LANES
    h2f = torch.as_tensor(idx.half_to_full, dtype=torch.long, device=device)
    ut = ulisttot[:, h2f]
    ut_r = torch.nn.functional.pad(ut.real.T.to(dtype), (0, pad)).contiguous()
    ut_i = torch.nn.functional.pad(ut.imag.T.to(dtype), (0, pad)).contiguous()
    beta = torch.as_tensor(beta, device=device)
    coef = y_coef_half(beta, cfg.twojmax).to(dtype)
    y_r, y_i = snap_y_half(ut_r, ut_i, coef, twojmax=cfg.twojmax)
    y_h = torch.complex(y_r[:, :natoms], y_i[:, :natoms]).T
    out = torch.zeros((natoms, idx.idxu_max), dtype=y_h.dtype, device=device)
    out[:, h2f] = y_h
    return out


def snap_dedr_kernel(cfg: SnapConfig, dx, dy, dz, mask, ylist,
                     dtype=torch.float32, device='cuda',
                     layout: str = 'half'):
    """Fused dE/dr per pair through the fused dE stage:
    [natoms, nnbor, 3].  ``ylist``: complex [natoms, idxu_max]."""
    _check_options(layout, None)
    device = resolve_device(device)
    idx = cfg.index
    disp, _, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    pad = disp.shape[-1] - natoms
    h2f = torch.as_tensor(idx.half_to_full, dtype=torch.long, device=device)
    yl = torch.as_tensor(ylist, device=device)[:, h2f]
    y_r = torch.nn.functional.pad(yl.real.T.to(dtype), (0, pad)).contiguous()
    y_i = torch.nn.functional.pad(yl.imag.T.to(dtype), (0, pad)).contiguous()
    dedr = snap_fused_de_half(disp, y_r, y_i, twojmax=cfg.twojmax,
                              rcut=cfg.rcut, rmin0=cfg.rmin0,
                              rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    return dedr[:, :3, :natoms].permute(2, 0, 1)
