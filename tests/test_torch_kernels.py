"""The port's kernel stages (plain versions, as run on the CPU) against the
reference's Pallas kernels in interpret mode (2J <= 4, few atoms) and
against the reference's ``kernels/ref.py`` oracles (2J = 8).

Inputs are the same numpy-seeded clusters (``conftest.make_cluster``) in
the same plane layout.  Bars: float64 1e-12 (the reference's kernel TOL)
where both sides do the same arithmetic, 1e-10 against the oracles;
float32 2e-5; all relative to max(1, max |reference|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.snap import SnapConfig as RConfig
from repro.kernels import ops as rops
from repro.kernels.ref import ref_snap_fused_de as r_ref_fused_de
from repro.kernels.ref import ref_snap_u as r_ref_u
from repro.kernels.snap_fused_de_half import snap_fused_de_half_pallas
from repro.kernels.snap_u import snap_u_half_pallas
from repro.kernels.snap_y import snap_y_half_pallas
from repro.kernels.snap_y import y_coef_half as r_y_coef_half
from repro_torch.core.snap import SnapConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_snap_fused_de, ref_snap_u
from repro_torch.kernels.snap_fused_de_half import snap_fused_de_half
from repro_torch.kernels.snap_u import snap_u_half
from repro_torch.kernels.snap_y import snap_y_half, y_coef_half, y_half_csr

from conftest import make_cluster

DT = {'f64': (jnp.float64, torch.float64, 1e-12),
      'f32': (jnp.float32, torch.float32, 2e-5)}


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
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (err, tol)


def _layouts(twojmax, natoms, nnbor, seed, key):
    """The same cluster in both packages' plane layout [nnbor, 4, N]."""
    jdt, tdt, _ = DT[key]
    _, disp, _, mask, _ = make_cluster(natoms=natoms, nnbor=nnbor,
                                       seed=seed, rcut=3.0)
    d_r, _, _ = rops._kernel_layout(
        RConfig(twojmax=twojmax, rcut=3.0),
        *(jnp.asarray(disp[..., c]) for c in range(3)), jnp.asarray(mask),
        jdt)
    d_t, _, _ = ops._kernel_layout(
        SnapConfig(twojmax=twojmax, rcut=3.0),
        *(torch.as_tensor(disp[..., c]) for c in range(3)),
        torch.as_tensor(mask), tdt)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_r))
    return d_r, d_t


def _half_y(twojmax, n, key, seed):
    """Random half Y planes, zero off the weighted support (as in use)."""
    cfg = SnapConfig(twojmax=twojmax)
    idx = cfg.index
    rng = np.random.default_rng(seed)
    sup = (idx.dedr_weight_half > 0)[:, None]
    y = [rng.normal(size=(idx.idxu_half_max, n)) * sup for _ in range(2)]
    jdt, tdt, _ = DT[key]
    return ([jnp.asarray(a, jdt) for a in y],
            [torch.as_tensor(a, dtype=tdt) for a in y])


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [2, 4])
def test_u_half_matches_pallas(twojmax, key):
    d_r, d_t = _layouts(twojmax, 9, 6, 3 * twojmax + 1, key)
    want = snap_u_half_pallas(d_r, twojmax=twojmax, rcut=3.0,
                              interpret=True)
    got = snap_u_half(d_t, twojmax=twojmax, rcut=3.0)
    for g, w in zip(got, want):
        _close(g.numpy(), w, DT[key][2])


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [2, 4])
def test_y_half_matches_pallas(twojmax, key):
    """Same U planes and beta through both Y stages; the port's CSR table
    and coefficient order give the Pallas result."""
    jdt, tdt, tol = DT[key]
    d_r, d_t = _layouts(twojmax, 9, 6, twojmax, key)
    cfg = SnapConfig(twojmax=twojmax, rcut=3.0)
    ut = [t + (ops._self_planes(cfg, tdt, 'cpu') if i == 0 else 0)
          for i, t in enumerate(snap_u_half(d_t, twojmax=twojmax,
                                            rcut=3.0))]
    beta = np.random.default_rng(twojmax).normal(size=cfg.ncoeff)
    want = snap_y_half_pallas(
        *(jnp.asarray(t.numpy()) for t in ut),
        r_y_coef_half(jnp.asarray(beta), twojmax).astype(jdt),
        twojmax=twojmax, interpret=True)
    coef = y_coef_half(torch.as_tensor(beta), twojmax).to(tdt)
    got = snap_y_half(ut[0].contiguous(), ut[1].contiguous(), coef,
                      twojmax=twojmax)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12 if key == 'f64' else tol)


@pytest.mark.parametrize('twojmax,key', [(2, 'f64'), (2, 'f32'),
                                         (4, 'f64')])
def test_fused_de_half_matches_pallas(twojmax, key):
    d_r, d_t = _layouts(twojmax, 9, 4, twojmax, key)
    y_r, y_t = _half_y(twojmax, d_t.shape[-1], key, twojmax)
    want = snap_fused_de_half_pallas(d_r, *y_r, twojmax=twojmax, rcut=3.0,
                                     interpret=True)
    got = snap_fused_de_half(d_t, *y_t, twojmax=twojmax, rcut=3.0)
    _close(got.numpy(), want, DT[key][2])


def test_stages_match_reference_oracles_2j8():
    """At 2J=8 in float64: the plain U and fused dE stages against the
    reference's ``kernels/ref.py`` oracles (full planes), and the port's
    ``ref.py`` against the reference's."""
    key = 'f64'
    jdt, tdt, tol = DT[key][0], DT[key][1], 1e-10
    idx = SnapConfig(twojmax=8).index
    d_r, d_t = _layouts(8, 9, 6, 8, key)
    ru = r_ref_u(d_r, twojmax=8, rcut=3.0)
    tu = ref_snap_u(d_t, twojmax=8, rcut=3.0)
    hu = snap_u_half(d_t, twojmax=8, rcut=3.0)
    for r, t, h in zip(ru, tu, hu):
        _close(t.numpy(), r, tol)
        _close(h.numpy(), np.asarray(r)[idx.half_to_full], tol)
    y_r, y_t = _half_y(8, d_t.shape[-1], key, 8)
    full = [np.zeros((idx.idxu_max, d_t.shape[-1])) for _ in range(2)]
    for f, h in zip(full, y_t):
        f[idx.half_to_full] = h.numpy()
    want = r_ref_fused_de(d_r, *(jnp.asarray(f, jdt) for f in full),
                          twojmax=8, rcut=3.0)
    _close(ref_snap_fused_de(d_t, *(torch.as_tensor(f, dtype=tdt)
                                    for f in full), twojmax=8,
                             rcut=3.0).numpy(), want, tol)
    _close(snap_fused_de_half(d_t, *y_t, twojmax=8, rcut=3.0).numpy(),
           want, tol)


def test_u_half_multiblock_matches_pallas():
    """natoms > 128: three lane tiles of the reference grid."""
    d_r, d_t = _layouts(2, 300, 6, 0, 'f32')
    assert d_t.shape[-1] == 384
    want = snap_u_half_pallas(d_r, twojmax=2, rcut=3.0, interpret=True)
    got = snap_u_half(d_t, twojmax=2, rcut=3.0)
    for g, w in zip(got, want):
        _close(g.numpy(), w, DT['f32'][2])


def test_isolated_atoms_no_nan():
    """Fully masked atoms (zero neighbors) must not poison lanes: the half
    and the full layout, and the bfloat16 Y operand option."""
    cfg = SnapConfig(twojmax=4, rcut=3.0)
    natoms, nnbor = 9, 5
    dx = np.zeros((natoms, nnbor))
    mask = np.zeros((natoms, nnbor), bool)
    idx = cfg.index
    expect = np.zeros(idx.idxu_max)
    expect[idx.self_diag] = cfg.wself
    beta = np.random.default_rng(0).normal(size=cfg.ncoeff)
    for layout, mxu_dtype in (('half', None), ('full', None),
                              ('half', torch.bfloat16)):
        ut = ops.snap_ui_kernel(cfg, dx, dx, dx, mask, dtype=torch.float32,
                                device='cpu', layout=layout)
        assert torch.isfinite(ut.real).all() and torch.isfinite(ut.imag).all()
        np.testing.assert_allclose(ut[0].real.numpy(), expect, atol=1e-6)
        e, _, f = ops.snap_force_pipeline(
            cfg, beta, 0.0, dx, dx, dx, np.zeros((natoms, nnbor), int), mask,
            device='cpu', layout=layout, mxu_dtype=mxu_dtype)
        assert torch.isfinite(e) and bool((f == 0).all()), (layout,
                                                            mxu_dtype)


@pytest.mark.parametrize('twojmax', [2, 8])
def test_y_half_csr_and_coef_match_reference(twojmax):
    """The CSR table is the reference's half COO table sorted by
    destination, and y_coef_half is the reference's coefficient in that
    order (f32 beta stays f32)."""
    from repro.core.indices import build_index as r_build_index
    ridx = r_build_index(twojmax)
    t = y_half_csr(twojmax)
    nnz = len(ridx.z_half_dest)
    assert sorted(t.order.tolist()) == list(range(nnz))
    assert (np.diff(t.dest) >= 0).all()
    np.testing.assert_array_equal(t.dest, ridx.z_half_dest[t.order])
    np.testing.assert_array_equal(t.src1, ridx.z_half_src1[t.order])
    np.testing.assert_array_equal(t.src2, ridx.z_half_src2[t.order])
    np.testing.assert_array_equal(t.rowptr[1:] - t.rowptr[:-1],
                                  np.bincount(t.dest,
                                              minlength=ridx.idxu_half_max))
    beta = np.random.default_rng(twojmax).normal(size=ridx.idxb_max)
    want = np.asarray(r_y_coef_half(jnp.asarray(beta), twojmax))
    got = y_coef_half(torch.as_tensor(beta), twojmax)
    np.testing.assert_allclose(got.numpy(),
                               want.reshape(-1)[:nnz][t.order], rtol=1e-15)
    assert y_coef_half(torch.as_tensor(beta, dtype=torch.float32),
                       twojmax).dtype == torch.float32


def test_half_planes_to_full_and_energy_match_reference():
    rcfg, tcfg = RConfig(twojmax=4, rcut=3.0), SnapConfig(twojmax=4,
                                                          rcut=3.0)
    rng = np.random.default_rng(2)
    nh = tcfg.index.idxu_half_max
    planes = [rng.normal(size=(nh, 128)) for _ in range(4)]
    beta = rng.normal(size=tcfg.ncoeff)
    want = rops.half_planes_to_full(rcfg, *map(jnp.asarray, planes[:2]))
    got = ops.half_planes_to_full(tcfg, *map(torch.as_tensor, planes[:2]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = rops.energy_from_ylist_lanes(rcfg, *map(jnp.asarray, planes),
                                        jnp.asarray(beta), 0.4)
    got = ops.energy_from_ylist_lanes(tcfg, *map(torch.as_tensor, planes),
                                      torch.as_tensor(beta), 0.4)
    _close(got.numpy(), want, 1e-13)


def test_wrappers_check_inputs():
    d = torch.zeros((3, 4, 8))
    with pytest.raises(TypeError):
        snap_u_half(d.to(torch.float16), twojmax=2, rcut=3.0)
    with pytest.raises(ValueError):
        snap_u_half(torch.zeros((3, 3, 8)), twojmax=2, rcut=3.0)
    with pytest.raises(ValueError):
        snap_u_half(torch.zeros((3, 8, 4)).transpose(1, 2), twojmax=2,
                    rcut=3.0)
    with pytest.raises(ValueError):
        snap_u_half(d, twojmax=15, rcut=3.0)
    with pytest.raises(RuntimeError, match='no kernel for device'):
        snap_u_half(torch.zeros((3, 4, 8), device='meta'), twojmax=2,
                    rcut=3.0)
    nh = SnapConfig(twojmax=2).index.idxu_half_max
    u = torch.zeros((nh, 8))
    nnz = len(y_half_csr(2).dest)
    with pytest.raises(ValueError):
        snap_y_half(u, u, torch.zeros(nnz + 1), twojmax=2)
    with pytest.raises(TypeError):
        snap_y_half(u, u, torch.zeros(nnz, dtype=torch.float64), twojmax=2)
    with pytest.raises(ValueError):
        snap_fused_de_half(torch.zeros((3, 4, 8)), u[:-1], u[:-1],
                           twojmax=2, rcut=3.0)
