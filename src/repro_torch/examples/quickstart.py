"""Quickstart: SNAP bispectrum descriptors, energies and forces of a small
tungsten cluster through three interchangeable implementations (the
baseline with Z and dB stored, the paper's adjoint, and the CUDA kernel
pipeline in float32).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--twojmax 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.snap import (IMPLEMENTATIONS, SnapConfig,
                                   compute_bispectrum, energy_forces,
                                   resolve_device)
from repro_torch.md.lattice import paper_box, perturb
from repro_torch.md.neighbor import brute_neighbors


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='python -m repro_torch.examples.'
                                      'quickstart')
    ap.add_argument('--twojmax', type=int, default=8)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SnapConfig(twojmax=args.twojmax, rcut=4.7)
    print(f'SNAP 2J={cfg.twojmax}: {cfg.ncoeff} bispectrum components')

    pos, box = paper_box(natoms=54)
    pos = perturb(pos, scale=0.05)
    nbr_idx, mask, disp, _ = brute_neighbors(pos, box, cfg.rcut,
                                             max_nbors=40)
    mean_nbors = float(mask.sum(1).mean())
    print(f'{len(pos)} atoms, mean neighbors {mean_nbors:.1f} (paper '
          'benchmark: 26)')

    d = [torch.as_tensor(disp[..., c], device=dev) for c in range(3)]
    b = compute_bispectrum(cfg, *d, torch.as_tensor(mask, device=dev))
    b0 = b[0, :5].cpu().numpy()
    print('B[0,:5] =', b0.round(4))

    rng = np.random.default_rng(0)
    beta = rng.normal(size=cfg.ncoeff) * 1e-2
    out = dict(ncoeff=cfg.ncoeff, natoms=len(pos), mean_nbors=mean_nbors,
               b0=b0, energy={}, max_force={})
    for impl in IMPLEMENTATIONS:
        e, _, f = energy_forces(cfg, beta, 0.0, *d, nbr_idx, mask,
                                impl=impl, device=dev)
        out['energy'][impl] = float(e)
        out['max_force'][impl] = float(f.abs().max())
        tag = impl + (' (f32)' if impl == 'kernel' else '')
        print(f'{tag:>14}: E = {float(e):+.6f} eV, '
              f'max|F| = {out["max_force"][impl]:.6f} eV/A')
    return out


if __name__ == '__main__':
    main()
