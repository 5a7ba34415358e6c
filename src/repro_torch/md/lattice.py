"""Crystal lattice generation for MD benchmarks (bcc tungsten by default,
matching the paper's 2000-atom benchmark box)."""

from __future__ import annotations

import numpy as np


def bcc_lattice(nx: int, ny: int, nz: int, a: float):
    """Body-centered cubic lattice: 2 atoms per cell -> (positions, box).

    Returns positions [2*nx*ny*nz, 3] (float64 numpy) and the periodic box
    edge lengths [3].
    """
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    cells = np.array([(i, j, k)
                      for i in range(nx) for j in range(ny)
                      for k in range(nz)], dtype=np.float64)
    pos = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * a
    box = np.array([nx * a, ny * a, nz * a])
    return pos, box


def paper_box(natoms: int = 2000, a: float = 3.1652):
    """A bcc box with ~natoms atoms (the paper uses 2000 W atoms)."""
    n_cells = natoms // 2
    nx = round(n_cells ** (1 / 3))
    ny = nx
    nz = max(1, n_cells // (nx * ny))
    pos, box = bcc_lattice(nx, ny, nz, a)
    return pos[:natoms] if len(pos) >= natoms else pos, box


def perturb(pos, scale: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    return pos + rng.normal(scale=scale, size=pos.shape)
