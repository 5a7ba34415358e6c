"""Fit SNAP coefficients to reference data (the "machine-learned" part).

Generates reference energies and forces from a known SNAP model (a
self-consistency fit), then refits from scratch by energy+force weighted
linear least squares, FitSNAP-style, and checks the fitted model's
predictions on a held-out configuration: relative energy error < 1e-6
and max |dF| < 1e-4 eV/A.

    PYTHONPATH=src python -m repro_torch.examples.fit_snap [--twojmax 4]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.snap import SnapConfig, energy_forces_adjoint
from repro_torch.fit import FitData, fit_snap_linear
from repro_torch.md.lattice import paper_box, perturb
from repro_torch.md.neighbor import brute_neighbors

N_CELLS, MAX_NBORS, BETA0 = 4, 40, -8.9
HELD_OUT = (99, 0.08)          # seed, perturbation (A) of the held-out cell
MAX_REL_E, MAX_DF = 1e-6, 1e-4


def make_cell(cfg, beta, beta0, seed, scale, natoms, device):
    """A perturbed bcc cell labelled by the adjoint pipeline."""
    pos, box = paper_box(natoms=natoms)
    pos = perturb(pos, scale, seed=seed)
    nbr_idx, mask, disp, _ = brute_neighbors(pos, box, cfg.rcut, MAX_NBORS)
    e, _, f = energy_forces_adjoint(cfg, beta, beta0, disp[..., 0],
                                    disp[..., 1], disp[..., 2], nbr_idx,
                                    mask, device=device)
    return FitData(disp=disp, nbr_idx=nbr_idx, mask=mask, e_ref=float(e),
                   f_ref=f.cpu().numpy())


def fit(cfg, natoms=54, device='cuda'):
    """The example's fit: N_CELLS training cells (seed s, perturbation
    0.05 + 0.04 s A) of a random model (beta of seed 7 x 1e-2, beta0
    -8.9), the ridge refit, the held-out cell.  Returns the training
    cells, the fitted (beta0, beta), the fit's rms errors and the held-out
    errors ``rel_e`` and ``max_df``."""
    beta_true = np.random.default_rng(7).normal(size=cfg.ncoeff) * 1e-2
    data = [make_cell(cfg, beta_true, BETA0, s, 0.05 + 0.04 * s, natoms,
                      device) for s in range(N_CELLS)]
    beta0, beta, diag = fit_snap_linear(cfg, data, device=device)
    # held-out validation: a fresh configuration never seen by the fit
    # (exact coefficient recovery is ill-posed — near-lattice descriptors
    # are collinear — but the fitted model must predict)
    held = make_cell(cfg, beta_true, BETA0, *HELD_OUT, natoms, device)
    hat = make_cell(cfg, beta, beta0, *HELD_OUT, natoms, device)
    return dict(data=data, beta0=beta0, beta=beta, **diag,
                rel_e=abs(hat.e_ref - held.e_ref) / abs(held.e_ref),
                max_df=float(np.max(np.abs(hat.f_ref - held.f_ref))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog='python -m repro_torch.examples.fit_snap')
    ap.add_argument('--twojmax', type=int, default=4)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    out = fit(SnapConfig(twojmax=args.twojmax, rcut=4.7), device=args.device)
    print(f'fit rms: energy {out["rms_e"]:.3e} eV, '
          f'force {out["rms_f"]:.3e} eV/A')
    print(f'held-out: relE err = {out["rel_e"]:.3e}, '
          f'max|dF| = {out["max_df"]:.3e} eV/A')
    if not (out['rel_e'] < MAX_REL_E and out['max_df'] < MAX_DF):
        raise RuntimeError('held-out prediction failed: relE '
                           f'{out["rel_e"]:.3e} (bar {MAX_REL_E:.0e}), '
                           f'max|dF| {out["max_df"]:.3e} (bar '
                           f'{MAX_DF:.0e})')
    print('OK: fitted SNAP model generalizes to unseen configurations.')
    return out


if __name__ == '__main__':
    main()
