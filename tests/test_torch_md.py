"""The port's NVE loop and its numpy helpers against the reference.

The MD case is the reference's verification method (paper Sec. VI):
the same lattice, velocities and random linear model go through the
reference ``run_nve(loop='host', impl='adjoint')`` and the port's
``run_nve(impl='kernel')`` on the CPU in float64; the thermo rows must
agree to 1e-9 relative (both sides integrate the same forces, which agree
to ~1e-13, for 10 steps).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro.md import integrate as rmd
from repro.md import lattice as rlat
from repro.md import neighbor as rnbr
from repro_torch import convert
from repro_torch.core import snap as tsnap
from repro_torch.md import integrate as tmd
from repro_torch.md import lattice as tlat
from repro_torch.md import neighbor as tnbr

NATOMS, TWOJMAX, STEPS = 54, 4, 10


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start():
    pos, box = tlat.paper_box(NATOMS)
    pos = tlat.perturb(pos, 0.02, seed=2)
    beta = np.random.default_rng(1).normal(
        size=tsnap.SnapConfig(twojmax=TWOJMAX).ncoeff) * 5e-3
    return pos, box, tmd.init_velocities(len(pos), temp=300.0), beta


@pytest.fixture(scope='module')
def reference_thermo():
    pos, box, vel, beta = _start()
    state = rmd.MDState(pos=pos.copy(), vel=vel.copy(), box=box)
    _, thermo = rmd.run_nve(rsnap.SnapConfig(twojmax=TWOJMAX, rcut=4.7),
                            jnp.asarray(beta), 0.0, state, STEPS,
                            impl='adjoint', loop='host', log_every=2,
                            rebuild_every=5)
    return thermo, state


@pytest.mark.parametrize('loop', ['scan', 'host'])
def test_run_nve_kernel_matches_reference_thermo(reference_thermo, loop):
    thermo_r, state_r = reference_thermo
    pos, box, vel, beta = _start()
    state = tmd.MDState(pos=pos.copy(), vel=vel.copy(), box=box)
    _, thermo = tmd.run_nve(tsnap.SnapConfig(twojmax=TWOJMAX, rcut=4.7),
                            beta, 0.0, state, STEPS, impl='kernel',
                            loop=loop, log_every=2, rebuild_every=5,
                            device='cpu', dtype=torch.float64)
    assert [t['step'] for t in thermo] == [t['step'] for t in thermo_r]
    for got, want in zip(thermo, thermo_r):
        for k in ('T', 'ke', 'pe', 'etot'):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                       err_msg=f'{loop} step '
                                               f'{got["step"]} {k}')
    assert state.step == state_r.step == STEPS
    np.testing.assert_allclose(state.pos, state_r.pos, rtol=0, atol=1e-11)
    etot = [t['etot'] for t in thermo]
    assert abs(etot[-1] - etot[0]) / abs(etot[0]) < 1e-5


def test_run_nve_float32_kernel_conserves_energy():
    pos, box, vel, beta = _start()
    state = tmd.MDState(pos=pos, vel=vel, box=box)
    _, thermo = tmd.run_nve(tsnap.SnapConfig(twojmax=TWOJMAX, rcut=4.7),
                            beta, 0.0, state, 6, impl='kernel',
                            loop='scan', log_every=1, rebuild_every=3,
                            device='cpu', dtype=torch.float32)
    etot = np.array([t['etot'] for t in thermo])
    assert np.isfinite(etot).all()
    assert np.abs(etot - etot[0]).max() / abs(etot[0]) < 1e-5


def test_run_nve_rejects_unported_loops():
    pos, box, vel, beta = _start()
    state = tmd.MDState(pos=pos, vel=vel, box=box)
    cfg = tsnap.SnapConfig(twojmax=2, rcut=4.7)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tmd.run_nve(cfg, beta[:cfg.ncoeff], 0.0, state, 1, loop='device',
                    device='cpu')
    with pytest.raises(ValueError):
        tmd.run_nve(cfg, beta[:cfg.ncoeff], 0.0, state, 1, loop='nope',
                    device='cpu')


def test_lattice_neighbor_and_velocity_copies_match_reference():
    pos_r, box_r = rlat.paper_box(128)
    pos_t, box_t = tlat.paper_box(128)
    np.testing.assert_array_equal(pos_t, pos_r)
    np.testing.assert_array_equal(box_t, box_r)
    pos = tlat.perturb(pos_t, 0.05, seed=3)
    np.testing.assert_array_equal(pos, rlat.perturb(pos_r, 0.05, seed=3))
    for build in ('brute_neighbors', 'cell_neighbors'):
        want = getattr(rnbr, build)(pos, box_r, 4.7, 40)
        got = getattr(tnbr, build)(pos, box_t, 4.7, 40)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(tnbr.NeighborOverflowError):
        tnbr.brute_neighbors(pos, box_t, 4.7, 8)
    v = tmd.init_velocities(54, 300.0, seed=4)
    np.testing.assert_array_equal(v, rmd.init_velocities(54, 300.0, seed=4))
    assert tmd.temperature(v) == rmd.temperature(v)


def test_from_reference_converts_parameters():
    cfg_r = rsnap.SnapConfig(twojmax=4, rcut=3.0, rfac0=0.98,
                             bzero_flag=False)
    rng = np.random.default_rng(6)
    beta = rng.normal(size=cfg_r.ncoeff)
    cfg, beta_t, beta0 = convert.from_reference(
        dataclasses.asdict(cfg_r), beta, 0.25, device='cpu',
        dtype=torch.float64)
    assert (cfg.twojmax, cfg.rcut, cfg.rfac0, cfg.bzero_flag) == \
        (4, 3.0, 0.98, False)
    assert cfg.dtype == torch.float64 and beta_t.dtype == torch.float64
    assert beta0 == 0.25
    from conftest import make_cluster
    _, disp, nbr_idx, mask, _ = make_cluster(seed=6)
    d = disp.transpose(2, 0, 1)
    e_r, _, f_r = rsnap.energy_forces_adjoint(cfg_r, jnp.asarray(beta), 0.25,
                                              *d, nbr_idx, mask)
    e_t, _, f_t = tsnap.energy_forces_adjoint(cfg, beta_t, beta0, *d,
                                              nbr_idx, mask, device='cpu')
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_r), atol=1e-12)
    with pytest.raises(ValueError, match='unknown'):
        convert.from_reference(dict(twojmax=4, nope=1), beta, 0.0,
                               device='cpu')
    with pytest.raises(ValueError, match='beta'):
        convert.from_reference(dict(twojmax=2), beta, 0.0, device='cpu')
