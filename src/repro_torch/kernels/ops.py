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

Not ported yet: the sharded and the batched (serving) force functions
(ROADMAP Queue A, items 5 and 7).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from ..core.geometry import sanitize_displacements
from ..core.snap import (SnapConfig, assemble_forces, bzero_shift,
                         resolve_device)
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
           'snap_fused_de_full', 'assemble_forces')
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


@lru_cache(maxsize=32)
def _energy_weights(cfg: SnapConfig, dtype, device, layout):
    """``dedr_weight_half`` or ``dedr_weight`` as a read-only [rows, 1]
    plane."""
    idx = cfg.index
    w = idx.dedr_weight_half if layout == 'half' else idx.dedr_weight
    return torch.as_tensor(w, dtype=dtype, device=device)[:, None]


def energy_from_ylist_lanes(cfg: SnapConfig, ut_r, ut_i, y_r, y_i,
                            beta, beta0):
    """Per-atom energy in plane layout: (2/3) sum_jju w Re(conj(U) Y).

    Operands are half [idxu_half_max, N] or full [idxu_max, N] planes,
    told apart by their row count.  The half form is exact because
    ``dedr_weight`` is 0 on every mirrored row."""
    layout = 'half' if ut_r.shape[0] == cfg.index.idxu_half_max else 'full'
    w = _energy_weights(cfg, ut_r.dtype, ut_r.device, layout)
    e_raw = (2.0 / 3.0) * torch.sum(w * (ut_r * y_r + ut_i * y_i), dim=0)
    return beta0 + e_raw - bzero_shift(cfg, beta, e_raw.dtype)


def _to_layout(cfg, dx, dy, dz, mask, dtype, device):
    """:func:`_kernel_layout` of arrays or tensors, on ``device``."""
    dx, dy, dz = (torch.as_tensor(v, device=device, dtype=dtype)
                  for v in (dx, dy, dz))
    mask = torch.as_tensor(mask, device=device, dtype=torch.bool)
    return _kernel_layout(cfg, dx, dy, dz, mask, dtype)


def _pipeline(stages, layout, cfg, beta, beta0, dx, dy, dz, nbr_idx, mask,
              dtype, device, with_energy, mxu_dtype=None):
    u_stage, y_stage, de_stage, coef_of = stages
    disp, ok, natoms = _to_layout(cfg, dx, dy, dz, mask, dtype, device)
    nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
    beta = torch.as_tensor(beta, device=device)
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    ut_r, ut_i = u_stage(disp, **geo)
    ut_r = ut_r + _self_planes(cfg, dtype, device, layout)
    coef = coef_of(beta, cfg.twojmax).to(dtype)
    y_kw = {} if mxu_dtype is None else dict(mxu_dtype=mxu_dtype)
    y_r, y_i = y_stage(ut_r, ut_i, coef, twojmax=cfg.twojmax, **y_kw)
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
    ``layout``: 'half' (default) or 'full' planes.  ``mxu_dtype``: None or
    ``torch.bfloat16`` (half layout only), the Y stage's operand rounding.
    """
    _check_options(layout, mxu_dtype)
    device = resolve_device(device)
    return _pipeline(_STAGES[layout], layout, cfg, beta, beta0, dx, dy, dz,
                     nbr_idx, mask, dtype, device, with_energy, mxu_dtype)


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
