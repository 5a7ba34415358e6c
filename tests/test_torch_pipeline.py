"""The port's half-plane force pipeline on the CPU against the reference's
pipeline (Pallas in interpret mode) and the reference's jnp adjoint.

Bars: float64 1e-10 on forces (relative to max |F|) and 1e-11 on the
energy, as the reference's own pipeline tests; float32 5e-5 against the
float64 adjoint, the reference's bar for its float32 pipeline.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro.kernels import ops as rops
from repro_torch.core import snap as tsnap
from repro_torch.core import bispectrum as tbs
from repro_torch.core.ulist import compute_ulist, compute_ulisttot
from repro_torch.kernels import ops

from conftest import make_cluster

CPU = 'cpu'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(twojmax, natoms=12, nnbor=8, seed=None):
    _, disp, nbr_idx, mask, _ = make_cluster(
        natoms=natoms, nnbor=nnbor, seed=twojmax if seed is None else seed)
    beta = np.random.default_rng(1).normal(
        size=tsnap.SnapConfig(twojmax=twojmax).ncoeff)
    return (disp[..., 0], disp[..., 1], disp[..., 2]), nbr_idx, mask, beta


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_pipeline_matches_pallas_pipeline():
    """snap_force_pipeline(device='cpu') == the reference's
    snap_force_pipeline (Pallas, interpret mode): E, e_atom, F (2J=4)."""
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(4, natoms=8, nnbor=6)
    e_r, ea_r, f_r = rops.snap_force_pipeline(
        rsnap.SnapConfig(twojmax=4, rcut=3.0), jnp.asarray(beta), 0.2, dx,
        dy, dz, nbr_idx, mask, dtype=jnp.float64, interpret=True)
    e_t, ea_t, f_t = ops.snap_force_pipeline(
        tsnap.SnapConfig(twojmax=4, rcut=3.0), beta, 0.2, dx, dy, dz,
        nbr_idx, mask, dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=1e-11)
    np.testing.assert_allclose(ea_t.numpy(), np.asarray(ea_r), rtol=1e-11)
    assert _rel(f_t.numpy(), f_r) <= 1e-10


@pytest.mark.parametrize('twojmax', [4, 8])
def test_pipeline_matches_adjoint(twojmax):
    """Port pipeline == the reference's float64 jnp adjoint; float32 stays
    within 5e-5; the plain yardstick pipeline gives the same numbers."""
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(twojmax)
    e_r, ea_r, f_r = rsnap.energy_forces_adjoint(
        rsnap.SnapConfig(twojmax=twojmax, rcut=3.0), jnp.asarray(beta), 0.2,
        dx, dy, dz, nbr_idx, mask)
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0)
    args = (cfg, beta, 0.2, dx, dy, dz, nbr_idx, mask)
    e, ea, f = ops.snap_force_pipeline(*args, dtype=torch.float64,
                                       device=CPU)
    np.testing.assert_allclose(float(e), float(e_r), rtol=1e-11)
    np.testing.assert_allclose(ea.numpy(), np.asarray(ea_r), rtol=1e-11,
                               atol=1e-11)
    assert _rel(f.numpy(), f_r) <= 1e-10
    e32, _, f32 = ops.snap_force_pipeline(*args, dtype=torch.float32,
                                          device=CPU)
    assert f32.dtype == torch.float32
    assert _rel(f32.numpy(), f_r) < 5e-5
    assert abs(float(e32) - float(e_r)) < 5e-5 * abs(float(e_r))
    e_p, _, f_p = ops.plain_force_pipeline(*args, dtype=torch.float64,
                                           device=CPU)
    assert float(e_p) == float(e) and torch.equal(f_p, f)


@pytest.mark.parametrize('twojmax', [4, 8])
def test_stage_wrappers_match_port_core(twojmax):
    """snap_ui_kernel / snap_yi_kernel / snap_dedr_kernel against the
    port's core pipeline (Y on the dedr_weight > 0 support)."""
    cfg = tsnap.SnapConfig(twojmax=twojmax, rcut=3.0)
    idx = cfg.index
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(twojmax, natoms=9, nnbor=6)
    d = [torch.as_tensor(v) for v in (dx, dy, dz)]
    m = torch.as_tensor(mask)
    geom, dgeom, ok = tsnap._pair_geometry(cfg, *d, m, grad=True)
    ut = compute_ulisttot(compute_ulist(geom, idx), geom.sfac, ok, idx)
    got = ops.snap_ui_kernel(cfg, dx, dy, dz, mask, dtype=torch.float64,
                             device=CPU)
    assert _rel(got.numpy(), ut.numpy()) <= 1e-12
    y = tbs.compute_ylist(ut, torch.as_tensor(beta), idx)
    y_k = ops.snap_yi_kernel(cfg, ut, beta, dtype=torch.float64, device=CPU)
    sup = idx.dedr_weight > 0
    assert _rel(y_k.numpy()[:, sup], y.numpy()[:, sup]) <= 1e-12
    from repro_torch.core.ulist import compute_dulist
    _, du = compute_dulist(geom, dgeom, idx)
    natoms, nnbor = mask.shape
    want = tbs.compute_dedr(du.reshape(-1, 3, idx.idxu_max), y,
                            torch.arange(natoms).repeat_interleave(nnbor),
                            idx).reshape(natoms, nnbor, 3)
    got = ops.snap_dedr_kernel(cfg, dx, dy, dz, mask, y,
                               dtype=torch.float64, device=CPU)
    assert _rel(got.numpy() * mask[..., None],
                want.numpy() * mask[..., None]) <= 1e-12


def test_pipeline_2j14_matches_adjoint():
    """The deepest index space the kernels take (2J=14, snap-2j14):
    the pipeline against the port's float64 adjoint on a small cluster."""
    cfg = tsnap.SnapConfig(twojmax=14, rcut=3.0)
    (dx, dy, dz), nbr_idx, mask, _ = _inputs(14, natoms=4, nnbor=3)
    beta = np.random.default_rng(14).normal(size=cfg.ncoeff) * 1e-2
    args = (cfg, beta, 0.1, dx, dy, dz, nbr_idx, mask)
    e_a, _, f_a = tsnap.energy_forces_adjoint(*args, device=CPU)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        e, _, f = ops.snap_force_pipeline(*args, dtype=dtype, device=CPU)
        assert _rel(f.numpy(), f_a.numpy()) < tol
        np.testing.assert_allclose(float(e), float(e_a),
                                   rtol=max(tol, 1e-11))


def test_unported_options_raise():
    """The option rules of the reference's pipeline: an unknown layout, an
    unknown Y operand dtype, and the low-precision option on full planes
    raise ValueError."""
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(2)
    args = (cfg, beta, 0.0, dx, dy, dz, nbr_idx, mask)
    with pytest.raises(ValueError, match='layout'):
        ops.snap_force_pipeline(*args, device=CPU, layout='quarter')
    with pytest.raises(ValueError, match='half-layout'):
        ops.snap_force_pipeline(*args, device=CPU, layout='full',
                                mxu_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='mxu_dtype'):
        ops.snap_force_pipeline(*args, device=CPU, mxu_dtype=torch.float16)


def test_cpu_path_launches_no_kernel():
    """Launch counters count kernel launches only: the CPU path runs the
    plain versions and leaves them unchanged."""
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(2)
    before = ops.launch_counts()
    ops.snap_force_pipeline(cfg, beta, 0.0, dx, dy, dz, nbr_idx, mask,
                            device=CPU)
    assert ops.launch_counts() == before
    assert set(before) == {'snap_u_half', 'snap_y_half',
                           'snap_y_half_bf16', 'snap_fused_de_half',
                           'snap_u_full', 'snap_y_full',
                           'snap_fused_de_full', 'assemble_forces',
                           'cell_bin', 'cell_build', 'brute_build'}
