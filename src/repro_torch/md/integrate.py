"""Velocity-Verlet NVE integration driving the SNAP force pipelines.

Port of ``repro.md.integrate`` with two step loops:

- ``loop='scan'``: neighbor lists rebuild on the host every
  ``rebuild_every`` steps (fixed-shape padded lists); between rebuilds a
  plain Python loop runs the velocity-Verlet steps with positions,
  velocities and forces kept on the device, and the host reads the stacked
  (PE, KE) rows once per segment.
- ``loop='host'``: the per-step loop (state on the host, one force call
  per step), kept as the A/B reference.

Both evaluate the force exactly once per step, plus once at step 0.  The
on-device neighbor engine (``loop='device'``), resilience and checkpoints
are not ported yet (ROADMAP Queue A, items 3, 4 and 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..core.snap import SnapConfig, energy_forces, resolve_device
from .neighbor import brute_neighbors

KB = 8.617333262e-5      # eV/K
# mass in LAMMPS 'metal' units: grams/mole; time ps; conversion for
# a = F/m: 1 eV/(A*g/mol) = 9648.53 A/ps^2
ACC_CONV = 9648.533212331
W_MASS = 183.84


@dataclass
class MDState:
    pos: np.ndarray
    vel: np.ndarray
    box: np.ndarray
    step: int = 0


def init_velocities(n, temp, mass=W_MASS, seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(KB * temp / (mass / ACC_CONV))
    v = rng.normal(scale=sigma, size=(n, 3))
    return v - v.mean(0)


def temperature(vel, mass=W_MASS):
    ke = 0.5 * (mass / ACC_CONV) * float(np.sum(vel * vel))
    return 2.0 * ke / (3.0 * len(vel) * KB), ke


def make_force_fn(cfg: SnapConfig, beta, beta0, impl='adjoint', **kw):
    """fn(dx, dy, dz, nbr_idx, mask) -> (E, forces) with the physics
    parameters bound; ``kw`` goes to :func:`energy_forces`."""
    def force_fn(dx, dy, dz, nbr_idx, mask):
        e, _, f = energy_forces(cfg, beta, beta0, dx, dy, dz, nbr_idx, mask,
                                impl=impl, **kw)
        return e, f
    return force_fn


def run_nve(cfg: SnapConfig, beta, beta0, state: MDState, n_steps: int,
            dt: float = 0.0005, mass: float = W_MASS,
            impl: str = 'adjoint', rebuild_every: int = 10,
            max_nbors: int = 40, log_every: int = 10, loop: str = 'scan',
            force_kwargs: Dict | None = None, device='cuda',
            dtype=torch.float64):
    """NVE loop; returns (state, list of thermo dicts).

    ``device`` holds the MD state and runs the forces; ``dtype`` is the
    state's precision and, for impl='kernel', the pipeline's (unless
    ``force_kwargs`` names another).  impl='adjoint' runs in ``cfg.dtype``.
    """
    device = resolve_device(device)
    kw = dict(force_kwargs or {}, device=device)
    if impl == 'kernel':
        kw.setdefault('dtype', dtype)
    force_fn = make_force_fn(cfg, torch.as_tensor(beta, device=device),
                             beta0, impl, **kw)
    if loop == 'scan':
        return _run_nve_scan(cfg, force_fn, state, n_steps, dt, mass,
                             rebuild_every, max_nbors, log_every, device,
                             dtype)
    if loop == 'host':
        return _run_nve_host(cfg, force_fn, state, n_steps, dt, mass,
                             rebuild_every, max_nbors, log_every, device,
                             dtype)
    if loop == 'device':
        raise NotImplementedError(
            "loop='device' is not ported yet (ROADMAP Queue A, item 4)")
    raise ValueError(f"unknown loop {loop!r}; choose 'scan' or 'host'")


def _log_rows(thermo, seg_pe, seg_ke, first_step, base_step, n_atoms,
              n_steps, log_every):
    """Append thermo dicts for the logged steps of one segment."""
    for k, (pe, ke) in enumerate(zip(seg_pe, seg_ke)):
        it = first_step + k
        if it % log_every == 0 or it == n_steps - 1:
            ke = float(ke)
            T = 2.0 * ke / (3.0 * n_atoms * KB)
            thermo.append(dict(step=base_step + it + 1, T=T, ke=ke,
                               pe=float(pe), etot=float(pe) + ke))


def _run_nve_scan(cfg, force_fn, state, n_steps, dt, mass, rebuild_every,
                  max_nbors, log_every, device, dtype):
    acc_scale = ACC_CONV / mass
    n_atoms = len(state.pos)
    thermo = []
    pos = vel = f = None
    it = 0
    while it < n_steps:
        n_sub = min(rebuild_every, n_steps - it)
        # host boundary: rebuild topology at current positions
        pos_h = pos.cpu().numpy() if pos is not None else state.pos
        nbr_idx, mask, disp, shifts = brute_neighbors(
            pos_h, state.box, cfg.rcut, max_nbors)
        nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
        mask = torch.as_tensor(mask, device=device)
        shifts = torch.as_tensor(shifts, device=device, dtype=dtype)
        if f is None:   # first segment: seed the force carry once
            disp = torch.as_tensor(disp, device=device, dtype=dtype)
            _, f = force_fn(disp[..., 0], disp[..., 1], disp[..., 2],
                            nbr_idx, mask)
            pos = torch.as_tensor(pos_h, device=device, dtype=dtype)
            vel = torch.as_tensor(state.vel, device=device, dtype=dtype)
        rows = []
        for _ in range(n_sub):
            vel = vel + (0.5 * dt * acc_scale) * f
            pos = pos + dt * vel
            d = pos[nbr_idx] + shifts - pos[:, None, :]
            e, f = force_fn(d[..., 0], d[..., 1], d[..., 2], nbr_idx, mask)
            vel = vel + (0.5 * dt * acc_scale) * f
            ke = (0.5 * mass / ACC_CONV) * torch.sum(vel * vel)
            rows.append(torch.stack([e.to(ke.dtype), ke]))
        seg = torch.stack(rows).cpu().numpy()     # one read per segment
        _log_rows(thermo, seg[:, 0], seg[:, 1], it, state.step, n_atoms,
                  n_steps, log_every)
        it += n_sub
    if pos is not None:
        state.pos = pos.cpu().numpy()
        state.vel = vel.cpu().numpy()
    state.step += n_steps
    return state, thermo


def _run_nve_host(cfg, force_fn, state, n_steps, dt, mass, rebuild_every,
                  max_nbors, log_every, device, dtype):
    def force(disp, nbr_idx, mask):
        d = torch.as_tensor(disp, device=device, dtype=dtype)
        nbr = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
        e, fj = force_fn(d[..., 0], d[..., 1], d[..., 2], nbr,
                         torch.as_tensor(mask, device=device))
        return float(e), fj.cpu().numpy().astype(np.float64)

    thermo = []
    nbr = None
    f = None
    e = None
    for it in range(n_steps):
        if it % rebuild_every == 0 or nbr is None:
            nbr_idx, mask, disp, _ = brute_neighbors(
                state.pos, state.box, cfg.rcut, max_nbors)
            nbr = (nbr_idx, mask)
            if f is None:   # only step 0 lacks a force; rebuilds keep the
                # carried force (same positions, refreshed topology)
                e, f = force(disp, nbr_idx, mask)
        acc = f / mass * ACC_CONV
        state.vel = state.vel + 0.5 * dt * acc
        state.pos = state.pos + dt * state.vel
        nbr_idx, mask = nbr
        e, f = force(_recompute_disp(state.pos, state.box, nbr_idx),
                     nbr_idx, mask)
        acc = f / mass * ACC_CONV
        state.vel = state.vel + 0.5 * dt * acc
        state.step += 1
        if it % log_every == 0 or it == n_steps - 1:
            T, ke = temperature(state.vel, mass)
            thermo.append(dict(step=state.step, T=T, ke=ke, pe=e,
                               etot=e + ke))
    return state, thermo


def _recompute_disp(pos, box, nbr_idx):
    d = pos[nbr_idx] - pos[:, None, :]
    return d - box * np.round(d / box)
