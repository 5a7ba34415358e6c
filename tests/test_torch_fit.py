"""The port's linear SNAP fitting (``repro_torch.fit``) against the
reference's ``repro.fit.linear`` and ``examples/fit_snap.py``.

The example is a self-consistency fit: reference energies and forces from
a known random model (2J = 4, 54 bcc atoms, beta of seed 7 x 1e-2, beta0
-8.9) on 4 perturbed configurations, a weighted ridge refit, then a
held-out configuration.  Near-lattice descriptors are collinear, so the
coefficients are not recovered; the fitted model is held to its
predictions (relative energy error < 1e-6, max |dF| < 1e-4 eV/A), as the
example does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro.fit import linear as rfit
from repro_torch.core import snap as tsnap
from repro_torch.fit import FitData, descriptor_rows, fit_snap_linear
from repro_torch.md.lattice import paper_box, perturb
from repro_torch.md.neighbor import brute_neighbors

TWOJMAX, RCUT, NATOMS, BETA0 = 4, 4.7, 54, -8.9
HELD_OUT = (99, 0.08)       # seed, perturbation (A) of the held-out cell


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tsnap.SnapConfig(twojmax=TWOJMAX, rcut=RCUT)
BETA = np.random.default_rng(7).normal(size=CFG.ncoeff) * 1e-2


def _cell(seed, scale):
    pos, box = paper_box(NATOMS)
    pos = perturb(pos, scale, seed=seed)
    nbr_idx, mask, disp, _ = brute_neighbors(pos, box, RCUT, 40)
    return disp, nbr_idx, mask


def _port_adjoint(beta, beta0, disp, nbr_idx, mask):
    e, _, f = tsnap.energy_forces_adjoint(
        CFG, beta, beta0, disp[..., 0], disp[..., 1], disp[..., 2], nbr_idx,
        mask, device='cpu')
    return float(e), f.numpy()


@functools.lru_cache(maxsize=1)
def _reference_fn():
    # jitted: one compile for every cell (all share their shapes)
    return jax.jit(functools.partial(
        rsnap.energy_forces_adjoint,
        rsnap.SnapConfig(twojmax=TWOJMAX, rcut=RCUT)))


def _reference_adjoint(beta, beta0, disp, nbr_idx, mask):
    e, _, f = _reference_fn()(jnp.asarray(np.asarray(beta)), beta0,
                              *(jnp.asarray(a) for a in (
                                  disp[..., 0], disp[..., 1], disp[..., 2],
                                  nbr_idx, mask)))
    return float(e), np.asarray(f)


def _dataset(label):
    out = []
    for seed in range(4):                       # the example's 4 cells
        cell = _cell(seed, 0.05 + 0.04 * seed)
        e, f = label(BETA, BETA0, *cell)
        out.append(FitData(disp=cell[0], nbr_idx=cell[1], mask=cell[2],
                           e_ref=e, f_ref=f))
    return out


def _held_out_errors(predict, label, beta0, beta):
    cell = _cell(*HELD_OUT)
    e_ref, f_ref = label(BETA, BETA0, *cell)
    e_hat, f_hat = predict(beta, beta0, *cell)
    return (abs(e_hat - e_ref) / abs(e_ref),
            float(np.max(np.abs(f_hat - f_ref))))


def test_descriptor_rows_match_reference():
    disp, nbr_idx, mask = _cell(0, 0.05)
    args = dict(disp=disp, nbr_idx=nbr_idx, mask=mask, e_ref=0.0,
                f_ref=np.zeros((NATOMS, 3)))
    e_row, f_rows = descriptor_rows(CFG, FitData(**args), device='cpu')
    r_e, r_f = rfit.descriptor_rows(
        rsnap.SnapConfig(twojmax=TWOJMAX, rcut=RCUT), rfit.FitData(**args))
    assert e_row.dtype == f_rows.dtype == np.float64
    assert f_rows.shape == (3 * NATOMS, CFG.ncoeff + 1)
    np.testing.assert_allclose(e_row, r_e, rtol=1e-10)
    np.testing.assert_allclose(f_rows, r_f, rtol=1e-10,
                               atol=1e-10 * np.abs(r_f).max())


def test_held_out_fit():
    """The example, on the port alone: port labels, port fit, port
    prediction."""
    beta0, beta, diag = fit_snap_linear(CFG, _dataset(_port_adjoint),
                                        device='cpu')
    assert beta.dtype == torch.float64 and beta.shape == (CFG.ncoeff,)
    assert diag['rms_e'] < 1e-6 and diag['rms_f'] < 1e-4, diag
    rel_e, max_df = _held_out_errors(_port_adjoint, _port_adjoint, beta0,
                                     beta)
    assert rel_e < 1e-6 and max_df < 1e-4, (rel_e, max_df)


def test_port_fit_predicts_reference():
    """Coefficients fitted by the port to the reference's labels predict
    the reference's energies and forces on the held-out cell."""
    beta0, beta, _ = fit_snap_linear(CFG, _dataset(_reference_adjoint),
                                     device='cpu')
    rel_e, max_df = _held_out_errors(_reference_adjoint, _reference_adjoint,
                                     beta0, beta.numpy())
    assert rel_e < 1e-6 and max_df < 1e-4, (rel_e, max_df)
