"""The inputs of every cell, made from ``--seed``: lattices, perturbations,
velocities and the potential's coefficients.

Each stream of random numbers is named by the seed and a tuple of indices
(segment, client, request), so the same seed gives the same inputs and two
parts of a run never share a stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.md import ACC_CONV, KB

W_MASS = 183.84              # g/mol, tungsten


def rng(seed: int, *key: int) -> np.random.Generator:
    """A numpy generator for (seed, key...); seeds of any size and sign."""
    return np.random.default_rng([seed % (1 << 64), *key])


def bcc(cells: int, a: float):
    """A cubic bcc lattice of cells^3 unit cells: (positions [2 cells^3, 3],
    box [3]), both float64."""
    g = np.arange(cells, dtype=np.float64)
    corner = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    pos = np.concatenate([corner[:, None], corner[:, None] + 0.5], 1)
    return pos.reshape(-1, 3) * a, np.full(3, cells * a)


def cells_for(natoms: int) -> int:
    """The cube of bcc cells that holds exactly ``natoms`` atoms."""
    cells = round((natoms / 2) ** (1 / 3))
    if 2 * cells ** 3 != natoms:
        raise ValueError(f'{natoms} atoms is no cube of bcc cells')
    return cells


def velocities(n: int, temp: float, gen: np.random.Generator,
               mass: float = W_MASS) -> np.ndarray:
    """Maxwell-Boltzmann velocities (A/ps) at ``temp`` K, zero momentum."""
    sigma = np.sqrt(KB * temp / (mass / ACC_CONV))
    v = gen.normal(scale=sigma, size=(n, 3))
    return v - v.mean(0)


def beta(ncoeff: int, scale: float, seed: int, device) -> np.ndarray:
    """The potential's linear coefficients, drawn on ``device`` from the
    seed (one call), returned as float64 on the host for both sides."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    b = torch.randn(ncoeff, generator=g, device=device, dtype=torch.float64)
    return (b * scale).cpu().numpy()


def ncoeff(twojmax: int) -> int:
    """The number of bispectrum components of 2J = ``twojmax``."""
    return sum(1 for j1 in range(twojmax + 1) for j2 in range(j1 + 1)
               for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2)
               if j >= j1)
