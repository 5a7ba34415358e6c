"""The port's baseline pipeline (paper Listing 1/2: Z and dB stored) against
the reference and the port's own oracles.

``test_pipelines_agree`` is the reference's case of the same name
(``tests/test_snap_correctness.py``, 2J = 2, 4, 6, 8): baseline, adjoint
and autodiff agree to float64 round-off, here with the reference's
``energy_forces_baseline`` as a fourth party.  ``compute_dblist`` is held
against the reference's at 1e-12 relative, and the baseline must not
depend on how its dB scatter is chunked.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cluster
from repro.core import bispectrum as rbs
from repro.core import snap as rsnap
from repro.core.ulist import compute_dulist as r_dulist
from repro.core.ulist import compute_ulisttot as r_ulisttot
from repro_torch.core import bispectrum as tbs
from repro_torch.core import snap as tsnap
from repro_torch.core.ulist import compute_dulist as t_dulist
from repro_torch.core.ulist import compute_ulisttot as t_ulisttot
from repro_torch.md import integrate as tmd
from repro_torch.md.lattice import paper_box, perturb


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(twojmax):
    pos, disp, nbr_idx, mask, shifts = make_cluster(seed=twojmax)
    beta = np.random.default_rng(1).normal(
        size=tsnap.SnapConfig(twojmax=twojmax).ncoeff)
    return pos, (disp[..., 0], disp[..., 1], disp[..., 2], nbr_idx,
                 mask), shifts, beta


def _reference_baseline(twojmax, beta, args):
    # jitted: one compile instead of one a jnp op
    fn = jax.jit(functools.partial(rsnap.energy_forces_baseline,
                                   rsnap.SnapConfig(twojmax=twojmax,
                                                    rcut=3.0)))
    e, e_atom, f = fn(jnp.asarray(beta), 0.3,
                      *(jnp.asarray(a) for a in args))
    return float(e), np.asarray(e_atom), np.asarray(f)


@pytest.mark.parametrize('twojmax', [2, 4, 6, 8])
def test_pipelines_agree(twojmax):
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0)
    pos, args, shifts, beta = _case(twojmax)
    e_b, ea_b, f_b = tsnap.energy_forces(cfg, beta, 0.3, *args,
                                         impl='baseline', device='cpu')
    e_a, _, f_a = tsnap.energy_forces(cfg, beta, 0.3, *args,
                                      impl='adjoint', device='cpu')
    e_g, f_g = tsnap.energy_forces_autodiff(cfg, beta, 0.3, pos, args[3],
                                            shifts, args[4], device='cpu')
    e_r, ea_r, f_r = _reference_baseline(twojmax, beta, args)
    scale = float(f_g.abs().max())
    for e, f in ((e_b, f_b), (e_a, f_a)):
        np.testing.assert_allclose(float(e), float(e_g), rtol=1e-12)
        np.testing.assert_allclose(f.numpy(), f_g.numpy(),
                                   atol=1e-11 * scale)
    np.testing.assert_allclose(float(e_b), e_r, rtol=1e-12)
    np.testing.assert_allclose(ea_b.numpy(), ea_r, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(f_b.numpy(), f_r, rtol=1e-12,
                               atol=1e-12 * scale)


def test_compute_dblist_matches_reference():
    twojmax = 6
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0)
    rcfg = rsnap.SnapConfig(twojmax=twojmax, rcut=3.0)
    _, (dx, dy, dz, _, mask), _, _ = _case(twojmax)
    natoms, nnbor = dx.shape

    @jax.jit
    def reference(dx, dy, dz, mask):
        idx = rcfg.index
        geom, dgeom, ok = rsnap._pair_geometry(rcfg, dx, dy, dz, mask,
                                               grad=True)
        u, du = r_dulist(geom, dgeom, idx, rcfg.dtype)
        z = rbs.compute_zlist(r_ulisttot(u, geom.sfac, ok, idx, rcfg.wself),
                              idx)
        return rbs.compute_dblist(du.reshape(-1, 3, idx.idxu_max), z,
                                  jnp.repeat(jnp.arange(natoms), nnbor), idx)

    want = np.asarray(reference(*(jnp.asarray(a) for a in (dx, dy, dz,
                                                            mask))))
    idx = cfg.index
    t = [torch.as_tensor(a) for a in (dx, dy, dz, mask)]
    geom, dgeom, ok = tsnap._pair_geometry(cfg, *t, grad=True)
    u, du = t_dulist(geom, dgeom, idx, cfg.dtype)
    z = tbs.compute_zlist(t_ulisttot(u, geom.sfac, ok, idx, cfg.wself), idx)
    got = tbs.compute_dblist(
        du.reshape(-1, 3, idx.idxu_max), z,
        torch.arange(natoms).repeat_interleave(nnbor), idx)
    assert got.shape == (natoms * nnbor, 3, idx.idxb_max)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    # the chunked form of the baseline gives the same dB
    chunked = tsnap._compute_dblist_chunked(
        du.reshape(-1, 3, idx.idxu_max), z,
        torch.arange(natoms).repeat_interleave(nnbor), idx, 5)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-14,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize('db_chunks', [1, 3, 64])
def test_baseline_does_not_depend_on_db_chunks(db_chunks):
    """Each destination sums its terms in COO order whatever the chunking:
    equal to the default 8 chunks to round-off."""
    cfg = tsnap.SnapConfig(twojmax=4, rcut=3.0)
    _, args, _, beta = _case(4)
    e8, _, f8 = tsnap.energy_forces_baseline(cfg, beta, 0.3, *args,
                                             device='cpu')
    e, _, f = tsnap.energy_forces_baseline(cfg, beta, 0.3, *args,
                                           db_chunks=db_chunks, device='cpu')
    scale = float(f8.abs().max())
    np.testing.assert_allclose(f.numpy(), f8.numpy(), rtol=1e-14,
                               atol=1e-14 * scale)
    np.testing.assert_allclose(float(e), float(e8), rtol=1e-14)


def test_baseline_float32_matches_float64_adjoint():
    cfg = tsnap.SnapConfig(twojmax=4, rcut=3.0)
    _, args, _, beta = _case(4)
    e64, _, f64 = tsnap.energy_forces(cfg, beta, 0.3, *args, device='cpu')
    e32, _, f32 = tsnap.energy_forces(
        tsnap.SnapConfig(twojmax=4, rcut=3.0, dtype=torch.float32), beta,
        0.3, *args, impl='baseline', device='cpu')
    assert f32.dtype == torch.float32
    err = float((f32.double() - f64).abs().max() / f64.abs().max())
    assert err <= 1e-5, err
    assert abs(float(e32) - float(e64)) <= 1e-5 * abs(float(e64))


def test_run_nve_baseline_matches_adjoint():
    """run_nve(impl='baseline') goes through make_force_fn: 4 device-loop
    steps, PE within 1e-9 relative of impl='adjoint'."""
    cfg = tsnap.SnapConfig(twojmax=4, rcut=4.7)
    beta = np.random.default_rng(1).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(54)
    pos = perturb(pos, 0.02, seed=2)
    pe = {}
    for impl in ('baseline', 'adjoint'):
        state = tmd.MDState(pos=pos.copy(), vel=tmd.init_velocities(
            54, 300.0), box=box)
        _, thermo = tmd.run_nve(cfg, beta, 0.0, state, 4, impl=impl,
                                loop='device', skin=0.4, log_every=2,
                                device='cpu')
        pe[impl] = np.array([t['pe'] for t in thermo])
    np.testing.assert_allclose(pe['baseline'], pe['adjoint'], rtol=1e-9)
