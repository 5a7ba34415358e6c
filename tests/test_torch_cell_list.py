"""The port's device neighbor engine and MD device loop against the reference.

Same inputs, made with numpy from a seed, go through ``repro.md.cell_list``
/ ``repro.md.integrate`` and their ports on the CPU (the plain versions of
the cell kernels): grids and capacities equal, the lists and flags of the
device build equal exactly (shifts to 1e-12) for boxes of 1, 2 and 2 bins
an axis at skin 1.0 and of 3 bins at skin 0.4, overflow flags equal at
equal capacities, the per-lane O(N^2) build equal, a gated rebuild with
trigger 0 leaving every buffer alone, and ``run_nve(loop='device')``'s
float64 thermo rows within 1e-9 of the reference's ``loop='device'`` and
of the port's own ``loop='scan', rebuild_every=1`` with rebuilds firing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro.md import cell_list as rcl
from repro.md import integrate as rmd
from repro.md import neighbor as rnbr
from repro_torch.core import snap as tsnap
from repro_torch.kernels import neighbors as tkn
from repro_torch.kernels import ops
from repro_torch.md import cell_list as tcl
from repro_torch.md import integrate as tmd
from repro_torch.md import neighbor as tnbr
from repro_torch.md.lattice import paper_box, perturb


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(natoms, amp=0.08, seed=1):
    pos, box = paper_box(natoms)
    return perturb(pos, amp, seed=seed), box


def _grids(pos, box, rcut, skin, cell_cap=None, max_nbors=64):
    cap = cell_cap or rcl.auto_cell_cap(pos, box, rcut + skin)
    return (rcl.make_grid(box, rcut, skin, cap, max_nbors),
            tcl.make_grid(box, rcut, skin, cap, max_nbors))


def _both(pos, box, g_r, g_t):
    ref = rcl.device_neighbors(jnp.asarray(pos), jnp.asarray(box), g_r)
    got = tcl.device_neighbors(torch.as_tensor(pos), torch.as_tensor(box),
                               g_t)
    return [np.asarray(r) for r in ref], [t.numpy() for t in got]


@pytest.mark.parametrize('box', [(2.0, 9.0, 40.0), (31.652,) * 3,
                                 (9.5, 12.7, 6.3)])
def test_grid_and_cell_cap_match_reference(box):
    box = np.array(box)
    for skin in (0.0, 0.4, 1.0):
        g_r = rcl.make_grid(box, 3.0, skin, 12, 40)
        g_t = tcl.make_grid(box, 3.0, skin, 12, 40)
        assert g_t.nbins == g_r.nbins and g_t.stencil == g_r.stencil
        assert (g_t.ncells, g_t.rcut_build) == (g_r.ncells, g_r.rcut_build)
        assert hash(g_t) == hash(tcl.make_grid(box, 3.0, skin, 12, 40))
    pos = np.random.default_rng(3).uniform(0, 1, (200, 3)) * box
    for rb in (3.0, 4.1):
        assert tcl.auto_cell_cap(pos, box, rb) == \
            rcl.auto_cell_cap(pos, box, rb)


@pytest.mark.parametrize('natoms,skin,bins', [(54, 1.0, 1), (128, 1.0, 2),
                                              (250, 1.0, 2), (250, 0.4, 3)])
def test_device_neighbors_match_reference(natoms, skin, bins):
    pos, box = _lattice(natoms)
    g_r, g_t = _grids(pos, box, 4.7, skin)
    assert g_t.nbins == (bins,) * 3
    (ni_r, m_r, sh_r, fl_r), (ni_t, m_t, sh_t, fl_t) = _both(pos, box, g_r,
                                                             g_t)
    assert ni_t.dtype == np.int32 and m_t.dtype == bool
    np.testing.assert_array_equal(ni_t, ni_r)
    np.testing.assert_array_equal(m_t, m_r)
    np.testing.assert_array_equal(fl_t, fl_r)
    np.testing.assert_allclose(sh_t, sh_r, rtol=0, atol=1e-12)
    # and the pair sets of the port's host oracle at rcut + skin
    b_idx, b_mask, _, _ = tnbr.brute_neighbors(pos, box, 4.7 + skin, 64)
    for i in range(natoms):
        assert set(ni_t[i, m_t[i]]) == set(b_idx[i, b_mask[i]])


@pytest.mark.parametrize('natoms,skin', [(54, 1.0), (128, 1.0)])
def test_device_neighbors_signed_zeros_match_reference(natoms, skin):
    """Atoms at +0.0 and -0.0, two atoms at one place, -0.0 coordinates and
    an atom 2.5 boxes out: the shifts -box * round(d / box) keep the
    reference's bits, the sign of a zero included (the cell kernel's
    minimum image skips the division and must give these bits)."""
    pos, box = _lattice(natoms, seed=5)
    pos[0] = 0.0
    pos[1] = -0.0
    pos[3] = pos[2]
    pos[4, [0, 2]] = -0.0
    pos[5] += 2.5 * box
    g_r, g_t = _grids(pos, box, 4.7, skin)
    (ni_r, m_r, sh_r, fl_r), (ni_t, m_t, sh_t, fl_t) = _both(pos, box, g_r,
                                                             g_t)
    np.testing.assert_array_equal(ni_t, ni_r)
    np.testing.assert_array_equal(m_t, m_r)
    np.testing.assert_array_equal(fl_t, fl_r)
    assert np.array_equal(sh_t.view(np.uint64), sh_r.view(np.uint64))
    # d = -0.0 (atom 1 seen from atom 0) shifts by +0.0, d = +0.0 by -0.0
    k = list(ni_t[0, m_t[0]]).index(1)
    assert (sh_t[0, k] == 0).all() and not np.signbit(sh_t[0, k]).any()
    k = list(ni_t[1, m_t[1]]).index(0)
    assert (sh_t[1, k] == 0).all() and np.signbit(sh_t[1, k]).all()
    assert 3 in ni_t[2, m_t[2]] and 2 in ni_t[3, m_t[3]]
    assert m_t[5].any()   # the atom out of the box has its neighbors


def test_overflow_flags_and_errors_match_reference():
    pos, box = _lattice(250)
    g_r, g_t = _grids(pos, box, 4.0, 0.4, cell_cap=3, max_nbors=6)
    (ni_r, m_r, _, fl_r), (ni_t, m_t, _, fl_t) = _both(pos, box, g_r, g_t)
    np.testing.assert_array_equal(fl_t, fl_r)
    np.testing.assert_array_equal(ni_t, ni_r)
    np.testing.assert_array_equal(m_t, m_r)
    assert fl_t[0] > 6 and fl_t[1] > 3
    for mod, err in ((rcl, rcl.CellOverflowError),
                     (tcl, tcl.CellOverflowError)):
        with pytest.raises(err, match='cell list overflow'):
            mod.check_flags(fl_r, g_r if mod is rcl else g_t)
    with pytest.raises(tnbr.NeighborOverflowError, match='retry with'):
        tcl.check_flags(torch.tensor([7, 3], dtype=torch.int32), g_t)
    tcl.check_flags(np.array([6, 3, 1, 1, 1, 1]), g_t)   # exactly full
    with pytest.raises(tcl.CellOverflowError):
        tcl.cell_neighbors_device(pos, box, 4.0, max_nbors=40, cell_cap=2,
                                  device='cpu')
    with pytest.raises(tnbr.NeighborOverflowError):
        tcl.cell_neighbors_device(pos, box, 4.7, max_nbors=10, device='cpu')


def test_cell_neighbors_device_matches_host_build():
    pos, box = _lattice(250, seed=3)
    b = rnbr.brute_neighbors(pos, box, 4.7, max_nbors=60)
    nbr_idx, mask, disp, shifts = tcl.cell_neighbors_device(
        pos, box, 4.0, max_nbors=60, skin=0.7, device='cpu')
    for i in range(len(pos)):
        assert set(nbr_idx[i, mask[i]]) == set(b[0][i, b[1][i]])
    recon = pos[nbr_idx] + shifts - pos[:, None, :]
    np.testing.assert_allclose(recon[mask], disp[mask], atol=1e-12)
    assert (shifts[~mask] == 0).all()


@pytest.mark.parametrize('n_valid', [None, 40])
def test_brute_neighbors_device_matches_reference(n_valid):
    pos, box = _lattice(54, seed=4)
    ref = rcl.brute_neighbors_device(jnp.asarray(pos), jnp.asarray(box),
                                     4.7, 32, n_valid=n_valid)
    got = tcl.brute_neighbors_device(torch.as_tensor(pos),
                                     torch.as_tensor(box), 4.7, 32,
                                     n_valid=n_valid)
    for g, r, exact in zip(got, ref, (True, True, False, True)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)


def test_rebuild_if_gated_by_trigger():
    """trigger 0 leaves the topology, pos_ref and flags untouched; trigger 1
    writes device_neighbors' lists, copies pos and raises the counts."""
    pos, box = _lattice(128, seed=5)
    _, g = _grids(pos, box, 4.7, 0.4, max_nbors=52)
    pos_t, box_t = torch.as_tensor(pos), torch.as_tensor(box)
    want = tcl.device_neighbors(pos_t, box_t, g)
    N, K = len(pos), g.max_nbors
    bufs = dict(nbr_idx=torch.full((N, K), 7, dtype=torch.int32),
                shifts=torch.full((N, K, 3), 0.5, dtype=torch.float64),
                mask=torch.ones((N, K), dtype=torch.bool),
                pos_ref=torch.zeros((N, 3), dtype=torch.float64),
                flags=torch.tensor([1, 2, 0, 1, 0, 0], dtype=torch.int32))
    before = {k: v.clone() for k, v in bufs.items()}
    tcl.rebuild_if(torch.zeros((), dtype=torch.int32), pos_t, box_t, g,
                   **bufs)
    for k, v in bufs.items():
        assert torch.equal(v, before[k]), k
    tcl.rebuild_if(torch.ones((), dtype=torch.int32), pos_t, box_t, g,
                   **bufs)
    assert torch.equal(bufs['nbr_idx'], want[0])
    assert torch.equal(bufs['mask'], want[1])
    assert torch.equal(bufs['shifts'], want[2])
    assert torch.equal(bufs['pos_ref'], pos_t)
    assert bufs['flags'].tolist() == [*want[3].tolist(), 0, 1, 0, 0]


def test_cell_wrappers_refuse_bad_inputs():
    pos, box = _lattice(54)
    _, g = _grids(pos, box, 4.7, 1.0)
    pos_t, box_t = torch.as_tensor(pos), torch.as_tensor(box)
    one = torch.ones((), dtype=torch.int32)
    flags = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match='box'):
        tkn.cell_bin(pos_t, box_t.float(), g, one, flags)
    with pytest.raises(ValueError, match='trigger'):
        tkn.cell_bin(pos_t, box_t, g, one.long(), flags)
    with pytest.raises(ValueError, match='stencil'):
        tkn.cell_bin(pos_t, box_t, tcl.CellGrid(
            g.nbins, g.cell_cap, g.max_nbors, g.rcut, g.skin, ()), one,
            flags)
    with pytest.raises(RuntimeError, match='no kernel'):
        tcl.device_neighbors(pos_t.to('meta'), box_t.to('meta'), g)
    table = tkn.cell_bin(pos_t, box_t, g, one, flags)
    with pytest.raises(ValueError, match='nbr_idx'):
        tkn.cell_build(pos_t, box_t, g, table, one,
                       torch.zeros((54, 3), dtype=torch.int32),
                       torch.zeros((54, g.max_nbors), dtype=torch.bool),
                       torch.zeros((54, g.max_nbors, 3),
                                   dtype=torch.float64), flags)


def _md_start(natoms=54, temp=2000.0):
    cfg = tsnap.SnapConfig(twojmax=4, rcut=4.7)
    beta = np.random.default_rng(2).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(natoms)
    return cfg, beta, perturb(pos, 0.03, seed=7), box, \
        tmd.init_velocities(natoms, temp, seed=8)


def _rows(thermo):
    return np.array([[t['T'], t['pe'], t['etot']] for t in thermo])


def test_device_loop_matches_reference_device_loop():
    """f64, impl='adjoint' on both sides, skin 0.05 so rebuilds fire: the
    thermo rows agree to 1e-9 and both packages rebuild at the same
    steps."""
    cfg, beta, pos, box, vel = _md_start()
    cache_r, cache_t = {}, {}
    _, th_r = rmd.run_nve(rsnap.SnapConfig(twojmax=4, rcut=4.7),
                          jnp.asarray(beta), 0.0,
                          rmd.MDState(pos.copy(), vel.copy(), box), 10,
                          dt=0.002, log_every=2, loop='device', skin=0.05,
                          fn_cache=cache_r)
    state = tmd.MDState(pos.copy(), vel.copy(), box)
    _, th_t = tmd.run_nve(cfg, beta, 0.0, state, 10, dt=0.002, log_every=2,
                          loop='device', skin=0.05, fn_cache=cache_t,
                          device='cpu')
    assert [t['step'] for t in th_t] == [t['step'] for t in th_r]
    np.testing.assert_allclose(_rows(th_t), _rows(th_r), rtol=1e-9)
    assert cache_t['device_rebuilds'] == cache_r['device_rebuilds'] > 0
    assert cache_t['device_trace_count']['traces'] == 1
    assert state.step == 10


def test_device_loop_kernel_matches_exact_rebuild():
    """impl='kernel' (the plain stage versions on the CPU): the device loop
    with rebuilds firing reproduces the port's rebuild-every-step scan loop
    to 1e-9, and on the CPU launches no kernel."""
    cfg, beta, pos, box, vel = _md_start()
    ops.reset_launch_counts()
    out, caches = {}, {}
    for name, loop, kwa in (('device', 'device', dict(skin=0.05)),
                            ('exact', 'scan', dict(rebuild_every=1))):
        caches[name] = {}
        _, thermo = tmd.run_nve(cfg, beta, 0.0,
                                tmd.MDState(pos.copy(), vel.copy(), box),
                                10, dt=0.002, log_every=2, loop=loop,
                                impl='kernel', fn_cache=caches[name],
                                device='cpu', **kwa)
        out[name] = _rows(thermo)
    assert caches['device']['device_rebuilds'] > 0
    np.testing.assert_allclose(out['device'], out['exact'], rtol=1e-9,
                               atol=1e-9)
    assert not any(ops.launch_counts().values())


def test_device_loop_builds_one_chunk_function():
    """Several chunks of one length share one chunk function (the
    reference's one-trace contract)."""
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    beta = np.random.default_rng(0).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(128)
    state = tmd.MDState(perturb(pos, 0.02, seed=1),
                        tmd.init_velocities(128, 300.0, seed=2), box)
    cache = {}
    _, thermo = tmd.run_nve(cfg, beta, 0.0, state, 6, log_every=2,
                            loop='device', skin=0.5, max_nbors=16,
                            fn_cache=cache, device='cpu')
    assert cache['device_trace_count']['traces'] == 1
    assert len(cache['device_chunks']) == 1
    e = [t['etot'] for t in thermo]
    assert abs(e[-1] - e[0]) < 1e-6 * max(abs(e[0]), 1.0)


def test_device_cache_rejects_mismatched_grid_and_physics():
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    beta = np.zeros(cfg.ncoeff)
    cache = {}
    for natoms, should_raise in ((250, False), (54, True)):
        pos, box = paper_box(natoms)
        state = tmd.MDState(perturb(pos, 0.02, seed=1),
                            tmd.init_velocities(natoms, 100.0, seed=2), box)
        kw = dict(n_steps=1, loop='device', skin=0.4, max_nbors=16,
                  fn_cache=cache, device='cpu')
        if should_raise:
            with pytest.raises(ValueError, match='device grid'):
                tmd.run_nve(cfg, beta, 0.0, state, **kw)
            with pytest.raises(ValueError, match='fn_cache'):
                tmd.run_nve(cfg, beta, 0.0, state, **dict(kw, skin=0.3))
        else:
            tmd.run_nve(cfg, beta, 0.0, state, **kw)
    with pytest.raises(ValueError, match='device-loop'):
        tmd.run_nve(cfg, beta, 0.0, state, 1, loop='scan', restore=True,
                    device='cpu')
