"""Plain neighbour pairs and velocity-Verlet NVE on the reference forces.

Written for the benchmark, in float64: the pairs within a cutoff come from
an all-pairs minimum-image search in blocks of rows, and the integrator is
the one the port states (``repro_torch.md.integrate``: half kick, drift,
force, half kick; LAMMPS ``metal`` units).
"""

from __future__ import annotations

import torch

KB = 8.617333262e-5          # eV/K
ACC_CONV = 9648.533212331    # (eV/A) / (g/mol) in A/ps^2
F64 = torch.float64


def pairs_within(pos, box, cutoff: float, rows: int = 1024):
    """Every ordered pair (i, k), i != k, whose minimum-image distance is
    below ``cutoff``: (i [P], k [P], image offset [P, 3]) such that the
    displacement is ``pos[k] + offset - pos[i]``.  ``box`` [3] must exceed
    twice the cutoff."""
    pos = pos.to(F64)
    box = torch.as_tensor(box, dtype=F64, device=pos.device)
    n = pos.shape[0]
    out_i, out_k, out_s = [], [], []
    for lo in range(0, n, rows):
        d = pos[None, :, :] - pos[lo:lo + rows, None, :]
        img = torch.round(d / box)
        d = d - img * box
        near = torch.sum(d * d, dim=-1) < cutoff * cutoff
        r = torch.arange(near.shape[0], device=pos.device)
        near[r, lo + r] = False
        ii, kk = near.nonzero(as_tuple=True)
        out_i.append(ii + lo)
        out_k.append(kk)
        out_s.append(-img[ii, kk] * box)
    return torch.cat(out_i), torch.cat(out_k), torch.cat(out_s)


def count_pairs(pos, box, cutoff: float) -> int:
    """The number of ordered pairs within ``cutoff`` (the work the inputs
    need; :mod:`snapbench.cost` reads it)."""
    return int(pairs_within(pos, box, cutoff)[0].shape[0])


def forces_of(snap, pos, box, energy: bool = True, forces: bool = True):
    """(E, F) of one configuration on all its pairs within rcut."""
    i, k, s = pairs_within(pos, box, snap.rcut)
    d = pos.to(F64)[k] + s - pos.to(F64)[i]
    return snap.energy_forces(d, i, k, pos.shape[0], energy=energy,
                              forces=forces)


def follow_nve(snap, pos, vel, box, steps: int, dt: float, mass: float,
               rows_at, skin: float = 1.0):
    """Integrate ``steps`` velocity-Verlet steps from (pos, vel) and return
    (pos, vel, {step: (PE, KE)}) with a row after each step in ``rows_at``
    (1-based, as the port's thermo rows count them).

    The pairs come from a list built at rcut + ``skin`` and rebuilt once
    any atom has moved skin / 2 since the build; each step keeps the pairs
    below rcut."""
    acc = ACC_CONV / mass
    pos = torch.as_tensor(pos, dtype=F64, device=snap.dev).clone()
    vel = torch.as_tensor(vel, dtype=F64, device=snap.dev).clone()
    n = pos.shape[0]
    rc2 = snap.rcut * snap.rcut
    lists = {}

    def build():
        lists['i'], lists['k'], lists['s'] = pairs_within(
            pos, box, snap.rcut + skin)
        lists['ref'] = pos.clone()

    def force(energy):
        i, k, s = lists['i'], lists['k'], lists['s']
        d = pos[k] + s - pos[i]
        keep = torch.sum(d * d, dim=-1) < rc2
        return snap.energy_forces(d[keep], i[keep], k[keep], n,
                                  energy=energy)

    build()
    _, f = force(False)
    rows = {}
    for step in range(1, steps + 1):
        vel = vel + (0.5 * dt * acc) * f
        pos = pos + dt * vel
        moved = torch.max(torch.sum((pos - lists['ref']) ** 2, dim=-1))
        if float(moved) > (0.5 * skin) ** 2:
            build()
        e, f = force(step in rows_at)
        vel = vel + (0.5 * dt * acc) * f
        if step in rows_at:
            ke = (0.5 * mass / ACC_CONV) * torch.sum(vel * vel)
            rows[step] = (float(e), float(ke))
    return pos, vel, rows
