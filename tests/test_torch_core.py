"""Parity of the torch port's core SNAP pipeline with ``repro.core``.

The same numpy-seeded inputs (``conftest.make_cluster``) go through the
JAX reference and the port on the CPU.  Bars: float64 <= 1e-10 and float32
<= 2e-5 (the reference's kernel-test TOL), relative to the largest
magnitude of the compared quantity.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bispectrum as rbs
from repro.core import snap as rsnap
from repro.core.geometry import compute_geometry_grad as r_geometry_grad
from repro.core.indices import build_index as r_build_index
from repro.core.ulist import compute_dulist as r_dulist
from repro.core.ulist import compute_ulisttot as r_ulisttot
from repro_torch.core import bispectrum as tbs
from repro_torch.core import snap as tsnap
from repro_torch.core.geometry import compute_geometry_grad
from repro_torch.core.indices import build_index
from repro_torch.core.ulist import (compute_dulist, compute_ulist,
                                    compute_ulisttot)

from conftest import make_cluster

DTYPES = {'f64': (jnp.float64, torch.float64, 1e-10),
          'f32': (jnp.float32, torch.float32, 2e-5)}
CPU = 'cpu'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (err, tol)


def _inputs(twojmax, seed=None):
    _, disp, nbr_idx, mask, _ = make_cluster(natoms=12, nnbor=8,
                                             seed=twojmax if seed is None
                                             else seed)
    beta = np.random.default_rng(1).normal(
        size=build_index(twojmax).idxb_max)
    return disp, nbr_idx, mask, beta


@pytest.fixture(scope='module')
def reference():
    """JAX results per (twojmax, dtype key), computed once per module."""
    cache = {}

    def get(twojmax, key):
        if (twojmax, key) in cache:
            return cache[(twojmax, key)]
        jdt = DTYPES[key][0]
        cfg = rsnap.SnapConfig(twojmax=twojmax, rcut=3.0, dtype=jdt)
        disp, nbr_idx, mask, beta = _inputs(twojmax)
        d = [jnp.asarray(disp[..., c], jdt) for c in range(3)]
        geom, dgeom, ok = rsnap._pair_geometry(cfg, *d, jnp.asarray(mask),
                                               grad=True)
        u, du = r_dulist(geom, dgeom, cfg.index, jdt)
        ut = r_ulisttot(u, geom.sfac, ok, cfg.index, cfg.wself)
        y = rbs.compute_ylist(ut, jnp.asarray(beta, jdt), cfg.index)
        e, e_atom, f = rsnap.energy_forces_adjoint(
            cfg, jnp.asarray(beta, jdt), 0.2, *d, nbr_idx, mask)
        cache[(twojmax, key)] = dict(u=u, du=du, ut=ut, y=y, e=e,
                                     e_atom=e_atom, f=f)
        return cache[(twojmax, key)]
    return get


def _port_geometry(twojmax, tdt):
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0, dtype=tdt)
    disp, nbr_idx, mask, beta = _inputs(twojmax)
    d = [torch.as_tensor(disp[..., c], dtype=tdt) for c in range(3)]
    geom, dgeom, ok = tsnap._pair_geometry(cfg, *d, torch.as_tensor(mask),
                                           grad=True)
    return cfg, geom, dgeom, ok, beta


@pytest.mark.parametrize('twojmax', [2, 4, 8, 14])
def test_build_index_matches_reference(twojmax):
    """The port's copy of build_index gives the reference's tables."""
    ref, port = r_build_index(twojmax), build_index(twojmax)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == 'ulevels':
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                for g in dataclasses.fields(la):
                    np.testing.assert_array_equal(getattr(la, g.name),
                                                  getattr(lb, g.name))
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize('key', ['f64', 'f32'])
def test_geometry_matches_reference(key):
    jdt, tdt, tol = DTYPES[key]
    disp, *_ = _inputs(4)
    d = disp.reshape(-1, 3) + 0.01      # keep r > 0 on every row
    ref_g, ref_dg = r_geometry_grad(*(jnp.asarray(d[:, c], jdt)
                                      for c in range(3)), rcut=3.0)
    g, dg = compute_geometry_grad(*(torch.as_tensor(d[:, c], dtype=tdt)
                                    for c in range(3)), rcut=3.0)
    for a, b in zip(ref_g + ref_dg, g + dg):
        _close(b.numpy(), a, tol)


@pytest.mark.parametrize('key', ['f64', 'f32'])
def test_sanitize_displacements_matches_reference(key):
    from repro.core.geometry import sanitize_displacements as r_sanitize
    from repro_torch.core.geometry import sanitize_displacements
    jdt, tdt, _ = DTYPES[key]
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3, 6, 5))
    d[:, 0, :2] = 0.0                   # degenerate r = 0 slots
    mask = rng.uniform(size=(6, 5)) > 0.3
    want = r_sanitize(*(jnp.asarray(x, jdt) for x in d), jnp.asarray(mask),
                      safe_r=1.5)
    got = sanitize_displacements(*(torch.as_tensor(x, dtype=tdt)
                                   for x in d), torch.as_tensor(mask),
                                 safe_r=1.5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [4, 8])
def test_ulist_matches_reference(reference, twojmax, key):
    """U, dU (product rule included) and Ulisttot per pair/atom."""
    ref = reference(twojmax, key)
    cfg, geom, dgeom, ok, _ = _port_geometry(twojmax, DTYPES[key][1])
    tol = DTYPES[key][2]
    u, du = compute_dulist(geom, dgeom, cfg.index, cfg.dtype)
    _close(u.numpy(), ref['u'], tol)
    _close(du.numpy(), ref['du'], tol)
    _close(compute_ulist(geom, cfg.index, cfg.dtype).numpy(), ref['u'], tol)
    ut = compute_ulisttot(u, geom.sfac, ok, cfg.index, cfg.wself)
    _close(ut.numpy(), ref['ut'], tol)


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [4, 8])
def test_ylist_and_dedr_match_reference(reference, twojmax, key):
    ref = reference(twojmax, key)
    cfg, geom, dgeom, ok, beta = _port_geometry(twojmax, DTYPES[key][1])
    tol = DTYPES[key][2]
    u, du = compute_dulist(geom, dgeom, cfg.index, cfg.dtype)
    ut = compute_ulisttot(u, geom.sfac, ok, cfg.index, cfg.wself)
    y = tbs.compute_ylist(ut, torch.as_tensor(beta, dtype=cfg.dtype),
                          cfg.index)
    _close(y.numpy(), ref['y'], tol)
    natoms, nnbor = ok.shape
    atom_of_pair = torch.arange(natoms).repeat_interleave(nnbor)
    dedr = tbs.compute_dedr(du.reshape(-1, 3, cfg.index.idxu_max), y,
                            atom_of_pair, cfg.index)
    ref_dedr = rbs.compute_dedr(
        ref['du'].reshape(-1, 3, cfg.index.idxu_max), ref['y'],
        jnp.repeat(jnp.arange(natoms), nnbor), cfg.index)
    _close(dedr.numpy(), ref_dedr, tol)


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [4, 8])
def test_adjoint_matches_reference(reference, twojmax, key):
    """E, e_atom and F of the adjoint pipeline."""
    ref = reference(twojmax, key)
    _, tdt, tol = DTYPES[key]
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0, dtype=tdt)
    disp, nbr_idx, mask, beta = _inputs(twojmax)
    e, e_atom, f = tsnap.energy_forces_adjoint(
        cfg, beta, 0.2, disp[..., 0], disp[..., 1], disp[..., 2], nbr_idx,
        mask, device=CPU)
    assert e.dtype == tdt and f.dtype == tdt
    np.testing.assert_allclose(float(e), float(ref['e']), rtol=tol)
    _close(e_atom.numpy(), ref['e_atom'], tol)
    scale = float(np.abs(np.asarray(ref['f'])).max())
    assert float(np.abs(f.numpy() - np.asarray(ref['f'])).max()) <= \
        tol * scale


def test_bispectrum_and_energy_via_z_match_reference():
    """Z/B descriptors, snap_energy, and the energy_via_z path (2J=4)."""
    cfg_r = rsnap.SnapConfig(twojmax=4, rcut=3.0)
    cfg_t = tsnap.SnapConfig(twojmax=4, rcut=3.0)
    disp, nbr_idx, mask, beta = _inputs(4, seed=3)
    d_r = [jnp.asarray(disp[..., c]) for c in range(3)]
    d_t = [torch.as_tensor(disp[..., c]) for c in range(3)]
    b_r = rsnap.compute_bispectrum(cfg_r, *d_r, jnp.asarray(mask))
    b_t = tsnap.compute_bispectrum(cfg_t, *d_t, torch.as_tensor(mask))
    _close(b_t.numpy(), b_r, 1e-10)
    e_r, _ = rsnap.snap_energy(cfg_r, jnp.asarray(beta), 0.3, *d_r,
                               jnp.asarray(mask))
    e_t, _ = tsnap.snap_energy(cfg_t, torch.as_tensor(beta), 0.3, *d_t,
                               torch.as_tensor(mask))
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=1e-12)
    e_z, _, _ = tsnap.energy_forces_adjoint(
        cfg_t, beta, 0.3, *disp.transpose(2, 0, 1), nbr_idx, mask,
        energy_via_z=True, device=CPU)
    np.testing.assert_allclose(float(e_z), float(e_r), rtol=1e-11)


def test_autodiff_matches_jax_autodiff():
    """The torch.autograd oracle == jax.grad of the same energy (2J=4)."""
    cfg_r = rsnap.SnapConfig(twojmax=4, rcut=3.0)
    cfg_t = tsnap.SnapConfig(twojmax=4, rcut=3.0)
    pos, disp, nbr_idx, mask, shifts = make_cluster(seed=5)
    beta = np.random.default_rng(5).normal(size=cfg_t.ncoeff)
    e_r, f_r = rsnap.energy_forces_autodiff(
        cfg_r, jnp.asarray(beta), 0.1, jnp.asarray(pos), nbr_idx, shifts,
        mask)
    e_t, f_t = tsnap.energy_forces_autodiff(cfg_t, beta, 0.1, pos, nbr_idx,
                                            shifts, mask, device=CPU)
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=1e-12)
    _close(f_t.numpy(), f_r, 1e-10)
    # and the port's own adjoint agrees with its autodiff oracle
    _, _, f_a = tsnap.energy_forces_adjoint(
        cfg_t, beta, 0.1, *disp.transpose(2, 0, 1), nbr_idx, mask,
        device=CPU)
    _close(f_a.numpy(), f_t.numpy(), 1e-10)


def test_energy_forces_dispatch():
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    disp, nbr_idx, mask, beta = _inputs(2)
    args = (cfg, beta, 0.0, *disp.transpose(2, 0, 1), nbr_idx, mask)
    e_a, _, f_a = tsnap.energy_forces(*args, impl='adjoint', device=CPU)
    e_k, _, f_k = tsnap.energy_forces(*args, impl='kernel', device=CPU,
                                      dtype=torch.float64)
    np.testing.assert_allclose(float(e_k), float(e_a), rtol=1e-12)
    _close(f_k.numpy(), f_a.numpy(), 1e-12)
    e_b, _, f_b = tsnap.energy_forces(*args, impl='baseline', device=CPU)
    np.testing.assert_allclose(float(e_b), float(e_a), rtol=1e-12)
    _close(f_b.numpy(), f_a.numpy(), 1e-12)
    with pytest.raises(ValueError):
        tsnap.energy_forces(*args, impl='nope', device=CPU)


@pytest.mark.parametrize('key', ['f64', 'f32'])
def test_assemble_forces_deterministic_by_destination(key):
    """The by-destination assembly against the reference's scatter on a
    make_cluster neighbor list with masked slots and one isolated atom (no
    neighbors, named only by masked slots); two calls give equal bits, and
    the CSR order is numpy's stable sort of the flat neighbor index."""
    from repro_torch.kernels.assemble import destination_csr_plain
    jdt, tdt, _ = DTYPES[key]
    natoms, nnbor = 12, 8
    _, _, nbr_idx, mask, _ = make_cluster(natoms=natoms, nnbor=nnbor,
                                          seed=5)
    mask[3] = False
    mask[nbr_idx == 3] = False
    assert (~mask).any(axis=1).sum() > 1
    dedr = np.random.default_rng(5).normal(size=(natoms, nnbor, 3))
    want = rsnap.assemble_forces(jnp.asarray(dedr, jdt), jnp.asarray(nbr_idx),
                                 jnp.asarray(mask), natoms)
    args = (torch.as_tensor(dedr, dtype=tdt), torch.as_tensor(nbr_idx),
            torch.as_tensor(mask), natoms)
    got = tsnap.assemble_forces(*args)
    assert got.dtype == tdt
    _close(got.numpy(), want, 1e-14 if key == 'f64' else 1e-6)
    assert not got[3].any()
    assert torch.equal(got, tsnap.assemble_forces(*args))
    order, rowptr = destination_csr_plain(torch.as_tensor(nbr_idx), natoms)
    np.testing.assert_array_equal(
        order.numpy(), np.argsort(nbr_idx.reshape(-1), kind='stable'))
    np.testing.assert_array_equal(
        np.diff(rowptr.numpy()), np.bincount(nbr_idx.reshape(-1),
                                             minlength=natoms))


def test_destination_csr_leaves_masked_pairs_out():
    """Padded lists name atom 0 in every empty slot; the assembly gives
    those slots the sentinel natoms, so they fall in no atom's incoming
    segment (one thread walked them all before) and forces still match the
    reference's scatter."""
    from repro_torch.kernels.assemble import destination_csr
    natoms, nnbor = 9, 6
    rng = np.random.default_rng(8)
    mask = rng.uniform(size=(natoms, nnbor)) > 0.4
    nbr_idx = np.where(mask, rng.integers(0, natoms, (natoms, nnbor)), 0)
    order, rowptr = destination_csr(torch.as_tensor(nbr_idx), natoms,
                                    torch.as_tensor(mask))
    np.testing.assert_array_equal(
        np.diff(rowptr.numpy()), np.bincount(nbr_idx[mask], minlength=natoms))
    assert int(rowptr[-1]) == mask.sum()
    np.testing.assert_array_equal(
        order.numpy()[:mask.sum()],
        np.flatnonzero(mask)[np.argsort(nbr_idx[mask], kind='stable')])
    dedr = rng.normal(size=(natoms, nnbor, 3))
    want = rsnap.assemble_forces(jnp.asarray(dedr), jnp.asarray(nbr_idx),
                                 jnp.asarray(mask), natoms)
    got = tsnap.assemble_forces(torch.as_tensor(dedr),
                                torch.as_tensor(nbr_idx),
                                torch.as_tensor(mask), natoms)
    _close(got.numpy(), want, 1e-14)


def test_assemble_forces_newton_third_law():
    """Assembly sums to zero net force, as the reference's does."""
    rng = np.random.default_rng(4)
    natoms, nnbor = 7, 3
    dedr = rng.normal(size=(natoms, nnbor, 3))
    nbr_idx = rng.integers(0, natoms, size=(natoms, nnbor))
    mask = rng.uniform(size=(natoms, nnbor)) > 0.2
    want = rsnap.assemble_forces(jnp.asarray(dedr), jnp.asarray(nbr_idx),
                                 jnp.asarray(mask), natoms)
    got = tsnap.assemble_forces(torch.as_tensor(dedr),
                                torch.as_tensor(nbr_idx),
                                torch.as_tensor(mask), natoms)
    _close(got.numpy(), want, 1e-14)
    assert float(got.sum(0).abs().max()) < 1e-12
    with pytest.raises(ValueError):
        tsnap.assemble_forces(torch.as_tensor(dedr), torch.as_tensor(
            nbr_idx), torch.as_tensor(mask), natoms + 1)
