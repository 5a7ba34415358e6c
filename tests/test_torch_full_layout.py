"""The port's full-plane pipeline (``layout='full'``) and the bfloat16 Y
operand option (``mxu_dtype``) on the CPU, against the reference.

Stages: the plain full U, Y and fused dE against the reference's Pallas
kernels in interpret mode (2J = 2, 4) at the reference's kernel bars,
float64 1e-12 and float32 1e-5 relative to max(1, max |reference|), both
against the float64 reference kernel; the full CSR table and coefficients against the reference's COO tiles; the
bfloat16 half Y against the reference's ``mxu_dtype=jnp.bfloat16`` kernel
at 1e-3.  Paths: the full pipeline against the reference's full kernel
pipeline (2J = 4) and the port's float64 adjoint (2J = 8; float64 1e-10,
float32 5e-5), the bfloat16 pipeline against the float64 adjoint (1e-2),
and NVE MD with ``layout='full'`` against ``layout='half'``.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.snap import SnapConfig as RConfig
from repro.kernels import ops as rops
from repro.kernels.snap_fused_de import snap_fused_de_pallas
from repro.kernels.snap_u import snap_u_pallas
from repro.kernels.snap_y import _y_coo_tiles, snap_y_half_pallas, \
    snap_y_pallas
from repro.kernels.snap_y import y_coef as r_y_coef
from repro.kernels.snap_y import y_coef_half as r_y_coef_half
from repro_torch.core import snap as tsnap
from repro_torch.core.snap import SnapConfig
from repro_torch.kernels import ops
from repro_torch.kernels.snap_fused_de import snap_fused_de_full
from repro_torch.kernels.snap_u import snap_u_full
from repro_torch.kernels.snap_y import (snap_y_full, snap_y_half_plain,
                                        y_coef, y_coef_half, y_full_csr)
from repro_torch.md import integrate as tmd
from repro_torch.md import lattice as tlat

from conftest import make_cluster

DT = {'f64': (jnp.float64, torch.float64, 1e-12),
      'f32': (jnp.float32, torch.float32, 1e-5)}
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
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (err, tol)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


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


def _inputs(twojmax, natoms=12, nnbor=8, seed=None):
    _, disp, nbr_idx, mask, _ = make_cluster(
        natoms=natoms, nnbor=nnbor, seed=twojmax if seed is None else seed)
    beta = np.random.default_rng(1).normal(
        size=SnapConfig(twojmax=twojmax).ncoeff)
    return (disp[..., 0], disp[..., 1], disp[..., 2]), nbr_idx, mask, beta


# --- stages ----------------------------------------------------------------

# Each interpret-mode reference call recompiles its kernel (seconds), so the
# float64 and float32 cases of a stage share one float64 reference call: the
# float32 port is held to its bar against the float64 reference kernel.

@lru_cache(maxsize=None)
def _u_ref(twojmax):
    d_r, _ = _layouts(twojmax, 9, 2, 3 * twojmax + 2, 'f64')
    return tuple(np.asarray(w) for w in
                 snap_u_pallas(d_r, twojmax=twojmax, rcut=3.0,
                               interpret=True))


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [2, 4])
def test_u_full_matches_pallas(twojmax, key):
    _, d_t = _layouts(twojmax, 9, 2, 3 * twojmax + 2, key)
    got = snap_u_full(d_t, twojmax=twojmax, rcut=3.0)
    for g, w in zip(got, _u_ref(twojmax)):
        _close(g.numpy(), w, DT[key][2])


@lru_cache(maxsize=None)
def _y_ref(twojmax):
    """(float64 full U planes with the self term, beta, reference Y)."""
    cfg = SnapConfig(twojmax=twojmax, rcut=3.0)
    _, d_t = _layouts(twojmax, 9, 5, twojmax, 'f64')
    ut = snap_u_full(d_t, twojmax=twojmax, rcut=3.0)
    ut = ((ut[0] + ops._self_planes(cfg, torch.float64, CPU,
                                    'full')).contiguous(), ut[1])
    beta = np.random.default_rng(twojmax).normal(size=cfg.ncoeff)
    want = snap_y_pallas(*(jnp.asarray(t.numpy()) for t in ut),
                         r_y_coef(jnp.asarray(beta), twojmax),
                         twojmax=twojmax, interpret=True)
    return ut, beta, tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [2, 4])
def test_y_full_matches_pallas(twojmax, key):
    """Same full U planes and beta through both Y stages; the mirror rows
    come out 0 on both sides."""
    _, tdt, tol = DT[key]
    cfg = SnapConfig(twojmax=twojmax, rcut=3.0)
    ut, beta, want = _y_ref(twojmax)
    coef = y_coef(torch.as_tensor(beta), twojmax).to(tdt)
    got = snap_y_full(*(t.to(tdt) for t in ut), coef, twojmax=twojmax)
    mirror = cfg.index.idxu_mb * 2 > cfg.index.idxu_j
    for g, w in zip(got, want):
        _close(g.numpy(), w, tol)
        assert not g[mirror].any()
        assert not w[mirror].any()


def _de_slots(twojmax):
    # the reference kernel's compile time grows with the neighbor slots:
    # 2J = 2 covers two slots, 2J = 4 (per pair, no sum over slots) one
    return 2 if twojmax == 2 else 1


@lru_cache(maxsize=None)
def _de_ref(twojmax):
    """(full Y planes, reference dE/dr), float64."""
    d_r, _ = _layouts(twojmax, 9, _de_slots(twojmax), twojmax, 'f64')
    idx = SnapConfig(twojmax=twojmax).index
    rng = np.random.default_rng(twojmax)
    y = [rng.normal(size=(idx.idxu_max, d_r.shape[-1])) for _ in range(2)]
    want = snap_fused_de_pallas(d_r, *map(jnp.asarray, y),
                                twojmax=twojmax, rcut=3.0, interpret=True)
    return y, np.asarray(want)


@pytest.mark.parametrize('key', ['f64', 'f32'])
@pytest.mark.parametrize('twojmax', [2, 4])
def test_fused_de_full_matches_pallas(twojmax, key):
    _, tdt, tol = DT[key]
    _, d_t = _layouts(twojmax, 9, _de_slots(twojmax), twojmax, key)
    y, want = _de_ref(twojmax)
    got = snap_fused_de_full(d_t, *(torch.as_tensor(a, dtype=tdt)
                                    for a in y), twojmax=twojmax, rcut=3.0)
    _close(got.numpy(), want, tol)


@pytest.mark.parametrize('twojmax', [2, 8])
def test_y_full_csr_and_coef_match_reference(twojmax):
    """The full CSR table is the reference's padded COO tiles without the
    padding, sorted by destination; y_coef is the reference's coefficient
    in that order (f32 beta stays f32)."""
    src1, src2, dest, cg, jjz = (a.reshape(-1)
                                 for a in _y_coo_tiles(twojmax, 512))
    t = y_full_csr(twojmax)
    nnz = len(t.dest)
    assert nnz == len(SnapConfig(twojmax=twojmax).index.z_coo_dest)
    assert sorted(t.order.tolist()) == list(range(nnz))
    assert (np.diff(t.dest) >= 0).all() and t.sig1 is None
    for got, want in ((t.dest, dest), (t.src1, src1), (t.src2, src2),
                      (t.cg, cg), (t.jjz, jjz)):
        np.testing.assert_array_equal(got, want[:nnz][t.order])
    idx = SnapConfig(twojmax=twojmax).index
    np.testing.assert_array_equal(np.diff(t.rowptr),
                                  np.bincount(t.dest,
                                              minlength=idx.idxu_max))
    beta = np.random.default_rng(twojmax).normal(size=idx.idxb_max)
    want = np.asarray(r_y_coef(jnp.asarray(beta), twojmax))
    got = y_coef(torch.as_tensor(beta), twojmax)
    np.testing.assert_allclose(got.numpy(),
                               want.reshape(-1)[:nnz][t.order], rtol=1e-15)
    assert y_coef(torch.as_tensor(beta, dtype=torch.float32),
                  twojmax).dtype == torch.float32


def test_y_half_bf16_matches_pallas():
    """bfloat16 operands, float32 planes: the plain half Y against the
    reference's ``mxu_dtype=jnp.bfloat16`` kernel (1e-3: the two sum the
    rounded products in different orders)."""
    twojmax = 4
    cfg = SnapConfig(twojmax=twojmax, rcut=3.0)
    rng = np.random.default_rng(11)
    nh = cfg.index.idxu_half_max
    ut = [rng.normal(size=(nh, 128)).astype(np.float32) for _ in range(2)]
    beta = rng.normal(size=cfg.ncoeff)
    want = snap_y_half_pallas(
        *map(jnp.asarray, ut),
        r_y_coef_half(jnp.asarray(beta), twojmax).astype(jnp.float32),
        twojmax=twojmax, mxu_dtype=jnp.bfloat16, interpret=True)
    coef = y_coef_half(torch.as_tensor(beta), twojmax).float()
    got = snap_y_half_plain(*map(torch.as_tensor, ut), coef,
                            twojmax=twojmax, mxu_dtype=torch.bfloat16)
    exact = snap_y_half_plain(*map(torch.as_tensor, ut), coef,
                              twojmax=twojmax)
    for g, w, e in zip(got, want, exact):
        _close(g.numpy(), w, 1e-3)
        assert not torch.equal(g, e)        # the option does round


@pytest.mark.parametrize('twojmax', [4])
def test_stage_wrappers_full_match_port_core(twojmax):
    """snap_ui_kernel / snap_yi_kernel / snap_dedr_kernel with
    layout='full' against the half layout's (held against the port's core
    pipeline in test_torch_pipeline.py): U on every row, Y and dE/dr on
    the dedr_weight > 0 support."""
    cfg = SnapConfig(twojmax=twojmax, rcut=3.0)
    (dx, dy, dz), _, mask, beta = _inputs(twojmax, natoms=9, nnbor=6)
    kw = dict(dtype=torch.float64, device=CPU)
    ut = {lay: ops.snap_ui_kernel(cfg, dx, dy, dz, mask, layout=lay, **kw)
          for lay in ('half', 'full')}
    assert _rel(ut['full'].numpy(), ut['half'].numpy()) <= 1e-13
    y = {lay: ops.snap_yi_kernel(cfg, ut['half'], beta, layout=lay, **kw)
         for lay in ('half', 'full')}
    sup = cfg.index.dedr_weight > 0
    assert _rel(y['full'].numpy()[:, sup], y['half'].numpy()[:, sup]) <= 1e-13
    de = {lay: ops.snap_dedr_kernel(cfg, dx, dy, dz, mask, y['half'],
                                    layout=lay, **kw)
          for lay in ('half', 'full')}
    assert _rel(de['full'].numpy(), de['half'].numpy()) <= 1e-13


# --- paths -----------------------------------------------------------------

def test_full_pipeline_matches_pallas_pipeline():
    """snap_force_pipeline(layout='full') on the CPU == the reference's
    full kernel pipeline (Pallas, interpret mode): E, e_atom, F (2J=4).
    The reference runs jitted, as its MD loop runs it: one compile of the
    whole pipeline costs less than its eager calls."""
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(4, natoms=6, nnbor=2)
    ref = jax.jit(partial(rops.snap_force_pipeline,
                          RConfig(twojmax=4, rcut=3.0), dtype=jnp.float64,
                          interpret=True, layout='full'))
    e_r, ea_r, f_r = ref(jnp.asarray(beta), 0.2, dx, dy, dz, nbr_idx, mask)
    e_t, ea_t, f_t = ops.snap_force_pipeline(
        SnapConfig(twojmax=4, rcut=3.0), beta, 0.2, dx, dy, dz, nbr_idx,
        mask, dtype=torch.float64, device=CPU, layout='full')
    np.testing.assert_allclose(float(e_t), float(e_r), rtol=1e-11)
    np.testing.assert_allclose(ea_t.numpy(), np.asarray(ea_r), rtol=1e-11)
    assert _rel(f_t.numpy(), f_r) <= 1e-10


def test_full_and_bf16_pipelines_match_adjoint():
    """At 2J=8 against the port's float64 adjoint: the full layout at the
    reference's bars (float64 1e-10, float32 5e-5), and the bfloat16 Y
    operands at 1e-2 on forces and energy (the reference's
    test_kernel_pipeline_mxu_bf16 case)."""
    cfg = SnapConfig(twojmax=8, rcut=3.0)
    (dx, dy, dz), nbr_idx, mask, beta = _inputs(8, natoms=12, nnbor=8)
    args = (cfg, beta, 0.2, dx, dy, dz, nbr_idx, mask)
    e_a, ea_a, f_a = tsnap.energy_forces_adjoint(*args, device=CPU)
    e, ea, f = ops.snap_force_pipeline(*args, dtype=torch.float64,
                                       device=CPU, layout='full')
    np.testing.assert_allclose(float(e), float(e_a), rtol=1e-11)
    np.testing.assert_allclose(ea.numpy(), ea_a.numpy(), rtol=1e-11,
                               atol=1e-11)
    assert _rel(f.numpy(), f_a.numpy()) <= 1e-10
    e32, _, f32 = ops.snap_force_pipeline(*args, dtype=torch.float32,
                                          device=CPU, layout='full')
    assert f32.dtype == torch.float32
    assert _rel(f32.numpy(), f_a.numpy()) < 5e-5
    assert abs(float(e32) - float(e_a)) < 5e-5 * abs(float(e_a))
    e_b, _, f_b = tsnap.energy_forces(*args, impl='kernel',
                                      dtype=torch.float32, device=CPU,
                                      mxu_dtype=torch.bfloat16)
    assert _rel(f_b.numpy(), f_a.numpy()) < 1e-2
    assert abs(float(e_b) - float(e_a)) < 1e-2 * abs(float(e_a))
    assert not torch.equal(f_b, f32)


def test_run_nve_full_layout_matches_half():
    """run_nve forwards force_kwargs={'layout': 'full'}: 16 bcc atoms,
    2J=4, 5 float64 steps give the half layout's thermo to 1e-10."""
    pos, box = tlat.paper_box(16)
    pos = tlat.perturb(pos, 0.02, seed=2)
    vel = tmd.init_velocities(len(pos), temp=300.0)
    cfg = SnapConfig(twojmax=4, rcut=3.0)
    beta = np.random.default_rng(1).normal(size=cfg.ncoeff) * 5e-3
    thermo = {}
    for layout in ('half', 'full'):
        state = tmd.MDState(pos=pos.copy(), vel=vel.copy(), box=box)
        _, thermo[layout] = tmd.run_nve(
            cfg, beta, 0.0, state, 5, impl='kernel', loop='scan',
            log_every=1, rebuild_every=5, max_nbors=16, device=CPU,
            dtype=torch.float64, force_kwargs={'layout': layout})
    assert len(thermo['full']) == len(thermo['half']) == 5
    for got, want in zip(thermo['full'], thermo['half']):
        assert got['step'] == want['step']
        for k in ('T', 'ke', 'pe', 'etot'):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
    assert thermo['half'][0]['pe'] != 0.0
