"""The port's batched force entry against the reference's, on the CPU.

Same packed batches (B = 4 lanes, each with its own beta, made with numpy
from seeds; a partial lane, a NaN-poisoned or an overflowing lane and a
dead lane among them) go through ``repro.kernels.ops.make_batched_force_fn``
(``impl='adjoint'``, float64, one call a bucket shared by the cases) and
the port's ``make_batched_force_fn`` (``impl='kernel'`` on half and full
planes and with bfloat16 Y operands, the plain versions of the kernels, and
``impl='adjoint'``) at 2J = 2: energies and forces within 1e-10 relative
in float64, 1e-5 in float32 and 1e-2 with bfloat16 operands, flags
equal.  The batched neighbor build is held against the reference's
``jax.vmap(brute_neighbors_device)`` (pair sets and flags) and, lane by
lane, bitwise against the port's one-lane build; the per-lane Y plain
version against ``jax.vmap(snap_y_half_pallas)`` over per-lane
coefficients in interpret mode (1e-10, float64).  A one-row coefficient
gives bitwise the output it gave before rows a lane existed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.snap import SnapConfig as RConfig
from repro.kernels import ops as rops
from repro.kernels.snap_y import snap_y_half_pallas
from repro.kernels.snap_y import y_coef_half as r_y_coef_half
from repro.md import cell_list as rcl
from repro_torch.core.snap import SnapConfig
from repro_torch.kernels import ops
from repro_torch.kernels.snap_y import (snap_y_half, snap_y_half_plain,
                                        y_coef_half)
from repro_torch.md import cell_list as tcl
from repro_torch.md.fault_inject import poison_request_positions
from repro_torch.md.lattice import paper_box, perturb

TWOJ, RCUT, K, B = 2, 3.0, 12, 4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(n, seed, keep=None):
    pos, box = paper_box(n)
    pos = perturb(pos, 0.03, seed=seed)
    return (pos if keep is None else pos[:keep]), box


def _dense(seed):
    """16 atoms in a 2.5 A box: every atom sees all 15 others (> K)."""
    return (np.random.default_rng(seed).uniform(0.0, 2.5, size=(16, 3)),
            np.full(3, 2.5))


# bucket n_pad -> lanes (pos, box), None a dead lane
LANES_OF = {
    16: lambda: [_lattice(16, 1), _lattice(16, 2, keep=12), _dense(3), None],
    64: lambda: [_lattice(54, 4), _lattice(54, 5, keep=40),
                 (poison_request_positions(_lattice(54, 6)[0]),
                  _lattice(54, 6)[1]), None],
}


def _pack(n_pad):
    """The server's packing: dead lanes n_valid 0 and a unit box."""
    ncoeff = SnapConfig(twojmax=TWOJ).ncoeff
    pos, box = np.zeros((B, n_pad, 3)), np.ones((B, 3))
    beta, beta0 = np.zeros((B, ncoeff)), np.zeros(B)
    n_valid = np.zeros(B, np.int32)
    for i, lane in enumerate(LANES_OF[n_pad]()):
        rng = np.random.default_rng(100 + i)
        beta[i] = rng.normal(size=ncoeff) * 5e-3
        beta0[i] = rng.normal() * 0.1
        if lane is None:
            continue
        p, b = lane
        pos[i, :len(p)], box[i], n_valid[i] = p, b, len(p)
    return dict(pos=pos, box=box, beta=beta, beta0=beta0, n_valid=n_valid)


@pytest.fixture(scope='module', params=[16, 64], ids=['n16', 'n64'])
def bucket(request):
    """(n_pad, packed batch, the reference's adjoint outputs): one
    reference call a bucket."""
    n_pad = request.param
    arrays = _pack(n_pad)
    fn = rops.make_batched_force_fn(RConfig(twojmax=TWOJ, rcut=RCUT), n_pad,
                                    K, impl='adjoint')
    out = fn(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return n_pad, arrays, [np.asarray(o) for o in out]


def _close(got, want, bar):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    err = np.abs(got[ok] - want[ok]).max() / max(1.0, np.abs(want[ok]).max())
    assert err <= bar, (err, bar)


@pytest.mark.parametrize('impl,dtype,kw,bar', [
    ('kernel', torch.float64, {}, 1e-10),
    ('kernel', torch.float32, {}, 1e-5),
    ('kernel', torch.float64, {'layout': 'full'}, 1e-10),
    ('kernel', torch.float32, {'mxu_dtype': torch.bfloat16}, 1e-2),
    ('adjoint', torch.float64, {}, 1e-10)],
    ids=['kernel-f64', 'kernel-f32', 'kernel-full-f64', 'kernel-bf16',
         'adjoint-f64'])
def test_batched_matches_reference(bucket, impl, dtype, kw, bar):
    """Bars: the reference's (tests/test_kernels.py): f64 1e-10, f32
    1e-5, bfloat16 Y operands 1e-2."""
    n_pad, arrays, (e_ref, f_ref, flags_ref) = bucket
    fn = ops.make_batched_force_fn(
        SnapConfig(twojmax=TWOJ, rcut=RCUT, dtype=dtype), n_pad, K,
        impl=impl, dtype=dtype, device='cpu', **kw)
    e, f, flags = fn(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    assert e.dtype == f.dtype == dtype and flags.dtype == torch.int32
    assert np.array_equal(flags.numpy(), flags_ref), (flags, flags_ref)
    assert flags_ref[:, rcl.FLAG_NBR_MAX].max() > 0   # live lanes present
    _close(e.numpy(), e_ref, bar)
    _close(f.numpy(), f_ref, bar)


def test_batched_neighbors_match_reference(bucket):
    """Pair sets and flags of the batched build equal the reference's
    vmapped build, and each lane is bitwise the port's one-lane build.
    The one-lane build is the batched one at B = 1, so the second check
    holds lane independence (a lane's lists do not depend on its peers),
    not a second implementation."""
    n_pad, arrays, _ = bucket
    args = [arrays[k] for k in ('pos', 'box')]
    ref = jax.vmap(lambda p, b, n: rcl.brute_neighbors_device(
        p, b, RCUT, K, n))(*(jnp.asarray(a) for a in args),
                           jnp.asarray(arrays['n_valid']))
    ref = [np.asarray(r) for r in ref]
    pos, box, n_valid = (torch.as_tensor(arrays[k])
                         for k in ('pos', 'box', 'n_valid'))
    got = tcl.brute_neighbors_batched(pos, box, RCUT, K, n_valid)
    assert np.array_equal(got[3].numpy(), ref[3])
    ni, m = got[0].numpy(), got[1].numpy()
    for b in range(B):
        for i in range(n_pad):
            assert set(ni[b, i, m[b, i]]) == \
                set(ref[0][b, i, ref[1][b, i]]), (b, i)
    np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0, atol=1e-12)
    for b in range(B):
        one = tcl.brute_neighbors_device(pos[b], box[b], RCUT, K,
                                         n_valid[b])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o), b


def _u_planes(seed, n, dtype=torch.float64):
    rows = SnapConfig(twojmax=TWOJ).index.idxu_half_max
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(rows, n)), dtype=dtype)
                 for _ in range(2))


def _betas(seed, lanes):
    ncoeff = SnapConfig(twojmax=TWOJ).ncoeff
    return np.random.default_rng(seed).normal(size=(lanes, ncoeff))


def test_y_rows_a_lane_match_vmapped_pallas():
    """A coefficient row a lane through the plain Y against the TPU
    kernel vmapped over the lanes (interpret mode, one call)."""
    L, lane_atoms = B, 128
    ut_r, ut_i = _u_planes(7, L * lane_atoms)
    beta = _betas(8, L)
    per_lane = [t.numpy().reshape(-1, L, lane_atoms).transpose(1, 0, 2)
                for t in (ut_r, ut_i)]
    coef_r = jnp.stack([r_y_coef_half(jnp.asarray(b), TWOJ) for b in beta])
    want = jax.vmap(lambda ur, ui, c: snap_y_half_pallas(
        ur, ui, c, twojmax=TWOJ, interpret=True))(
            *(jnp.asarray(p) for p in per_lane), coef_r)
    coef = y_coef_half(torch.as_tensor(beta), TWOJ)
    assert coef.shape == (L, coef.shape[1])
    got = snap_y_half_plain(ut_r, ut_i, coef, twojmax=TWOJ,
                            lane_atoms=lane_atoms)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(1, 0, 2).reshape(g.shape)
        _close(g.numpy(), w, 1e-10)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_y_one_row_unchanged_and_lanes_bitwise(dtype):
    """A one-row coefficient gives the bits it gave before rows a lane
    existed (the MD path's Y); equal rows a lane give those bits too, and
    each lane of distinct rows is bitwise the one-row call on its own
    atoms."""
    L, lane_atoms = 3, 128
    ut_r, ut_i = _u_planes(9, L * lane_atoms, dtype)
    beta = torch.as_tensor(_betas(10, L))
    coef1 = y_coef_half(beta[0], TWOJ).to(dtype)
    one = snap_y_half(ut_r, ut_i, coef1, twojmax=TWOJ)
    # the sum as the one-row plain version computed it before rows a lane
    from repro_torch.kernels.snap_y import y_tables
    dest, src1, src2, sig1, sig2 = y_tables(TWOJ, dtype, 'cpu')
    i1, i2, d = src1.long(), src2.long(), dest.long()
    v1i, v2i = ut_i[i1] * sig1[:, None], ut_i[i2] * sig2[:, None]
    p_r = ut_r[i1] * ut_r[i2] - v1i * v2i
    p_i = ut_r[i1] * v2i + v1i * ut_r[i2]
    old = (torch.zeros_like(ut_r).index_add_(0, d, coef1[:, None] * p_r),
           torch.zeros_like(ut_i).index_add_(0, d, coef1[:, None] * p_i))
    assert all(torch.equal(a, b) for a, b in zip(one, old))
    same = snap_y_half(ut_r, ut_i, coef1.expand(L, -1).contiguous(),
                       twojmax=TWOJ, lane_atoms=lane_atoms)
    assert all(torch.equal(a, b) for a, b in zip(same, one))
    rows = y_coef_half(beta, TWOJ).to(dtype)
    lanes = snap_y_half(ut_r, ut_i, rows, twojmax=TWOJ,
                        lane_atoms=lane_atoms)
    for b in range(L):
        s = slice(b * lane_atoms, (b + 1) * lane_atoms)
        solo = snap_y_half(ut_r[:, s].contiguous(), ut_i[:, s].contiguous(),
                           rows[b].contiguous(), twojmax=TWOJ)
        assert all(torch.equal(g[:, s], w) for g, w in zip(lanes, solo)), b


def test_y_rows_a_lane_checks():
    """No tile may straddle two lanes, and the rows must cover the atom
    axis."""
    ut_r, ut_i = _u_planes(11, 256)
    rows = y_coef_half(torch.as_tensor(_betas(12, 2)), TWOJ)
    with pytest.raises(ValueError, match='lane_atoms'):
        snap_y_half(ut_r, ut_i, rows[0].contiguous(), twojmax=TWOJ,
                    lane_atoms=256)
    with pytest.raises(ValueError, match='L \\* lane_atoms'):
        snap_y_half(ut_r, ut_i, rows, twojmax=TWOJ, lane_atoms=64)
    with pytest.raises(ValueError, match='multiple of the Y tile'):
        snap_y_half(*_u_planes(13, 2 * 3), rows, twojmax=TWOJ,
                    lane_atoms=3)
    with pytest.raises(ValueError, match='needs lane_atoms'):
        snap_y_half(ut_r, ut_i, rows, twojmax=TWOJ)
