"""The serving path's O(N^2) neighbor build against the reference, on the CPU.

``kernels/neighbors.brute_build`` launches ``csrc/brute_neighbors.cu`` on
a CUDA tensor and runs ``brute_build_plain`` on a CPU one; the plain
version is the kernel's yardstick (``chip_smoke.py`` holds the kernel
bitwise against it on the card).  Here the plain version is held against
the reference's ``jax.vmap(repro.md.cell_list.brute_neighbors_device)`` on
one batch made with numpy from a seed, in float64 and float32: nbr_idx,
mask and flags exact, disp within 1e-12 (float64) and 1e-6 (float32).
The batch (``md/edge_cases.brute_edge_batch``) holds the inputs where a
kernel would most likely split from it: pairs exactly half a box apart on
one axis (``rint`` of +-0.5), pairs whose r^2 is rcut^2 exactly and just
below it after rounding, a pair that is in only when r^2 is rounded a
step at a time (no FMA), a NaN coordinate on a valid atom, a lane with
``n_valid = 0`` and one with ``n_valid = N``, and a lane whose atoms see
more than K neighbors; and signed zeros (atoms at +0.0 and -0.0, two atoms
at one place, an atom more than 1.5 boxes out), where the kernel's minimum
image, which skips the division where rint's value is certain, must give
the division's bits, the sign of a zero included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import cell_list as rcl
from repro_torch.analysis import launches
from repro_torch.analysis.registry import default_registry
from repro_torch.analysis.runner import analyze_entry
from repro_torch.kernels import neighbors as tkn
from repro_torch.md import cell_list as tcl
from repro_torch.md.edge_cases import (EDGE_K as K, EDGE_N as N,
                                       EDGE_RCUT as RCUT, HALF_BOX,
                                       brute_edge_batch)

BARS = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(pos, box, n_valid):
    out = jax.vmap(lambda p, b, n: rcl.brute_neighbors_device(
        p, b, RCUT, K, n))(jnp.asarray(pos), jnp.asarray(box),
                           jnp.asarray(n_valid))
    return [np.asarray(o) for o in out]


def _plain(pos, box, n_valid):
    out = tkn.brute_build_plain(torch.as_tensor(pos), torch.as_tensor(box),
                                RCUT, K, torch.as_tensor(n_valid))
    return [o.numpy() for o in out]


@pytest.fixture(scope='module', params=[np.float64, np.float32],
                ids=['f64', 'f32'])
def edge_case(request):
    dtype = request.param
    pos, box, n_valid = brute_edge_batch(dtype)
    return dtype, (pos, box, n_valid), _plain(pos, box, n_valid)


def test_plain_matches_vmapped_reference(edge_case):
    dtype, args, got = edge_case
    ref = _reference(*args)
    for name, g, r in zip(('nbr_idx', 'mask', 'flags'),
                          (got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    assert got[2].dtype == dtype
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=BARS[dtype])


def test_plain_edge_cases(edge_case):
    """What each lane of the batch was built to show, on the plain version
    (and so, through the first test, on the reference)."""
    dtype, (pos, box, n_valid), (ni, m, disp, flags) = edge_case
    nv = n_valid.tolist()
    assert nv[0] == N and nv[2] == 0
    assert ni.shape == m.shape == (4, N, K) and disp.shape == (4, N, K, 3)
    assert flags.dtype == np.int32 and (flags[:, 1] == 0).all()

    def pairs(b, i):
        return list(ni[b, i, m[b, i]])

    # half a box: rint(+-0.5) is 0 (half to even), so the displacement
    # keeps the sign of pos[j] - pos[i]
    for axis, j in enumerate((1, 2, 3)):
        k = pairs(0, 0).index(j)
        want = np.zeros(3)
        want[axis] = HALF_BOX / 2
        assert np.array_equal(disp[0, 0, k], want.astype(dtype))
        k = pairs(0, j).index(0)
        assert np.array_equal(disp[0, j, k], -want.astype(dtype))
    # rcut^2 edge: r^2 == rc2 is out, the square one ulp below is in
    assert 1 not in pairs(1, 0) and 0 not in pairs(1, 1)
    assert {2, 3, 5} <= set(pairs(1, 0))
    # NaN: no pair of the poisoned atom, none with it; padding never pairs
    assert pairs(1, 4) == [] and all(4 not in pairs(1, i) for i in range(N))
    assert not m[1, nv[1]:].any() and all(
        max(pairs(1, i), default=0) < nv[1] for i in range(N))
    # the inert lane: empty rows, flag 0
    assert not m[2].any() and (ni[2] == 0).all() and (disp[2] == 0).all()
    assert flags[2, 0] == 0 and flags[0, 0] == m[0].sum(1).max()
    # past K: every valid atom sees all 15 others; the first K in index
    # order are kept and the flag counts past K
    assert flags[3, 0] == nv[3] - 1 > K
    for i in range(nv[3]):
        assert pairs(3, i) == [j for j in range(nv[3]) if j != i][:K]
    # empty slots: index 0, displacement +0.0
    assert (ni[~m] == 0).all()
    assert not np.signbit(disp[~m]).any() and (disp[~m] == 0).all()


def test_plain_signed_zeros_match_reference(edge_case):
    """Lane 3's signed zeros: d = -0.0 and +0.0 give a +0.0 displacement
    (-0.0 - box * rint(-0.0 / box) is +0.0), as in the reference, bit for
    bit over the whole batch; the atom 1.5 boxes out gets its minimum
    image."""
    dtype, args, (ni, m, disp, _) = edge_case
    ref = _reference(*args)
    assert np.array_equal(np.signbit(disp), np.signbit(ref[2]))
    assert np.array_equal(disp.view(np.uint8), ref[2].view(np.uint8))

    def d(i, j):
        return disp[3, i, list(ni[3, i, m[3, i]]).index(j)]
    for i, j in ((0, 1), (1, 0), (2, 3), (3, 2)):
        assert (d(i, j) == 0).all() and not np.signbit(d(i, j)).any()
    assert not np.signbit(d(0, 4)[0]) and not np.signbit(d(4, 0)[0])
    np.testing.assert_allclose(d(0, 5), [0.4, 0.9, 1.0], rtol=0,
                               atol=BARS[dtype] * 10)


def test_batched_build_dispatches_to_plain_on_the_cpu():
    """``brute_neighbors_batched`` is ``brute_build``, which on a CPU tensor
    is its plain version, recorded as one launch of the kernel."""
    pos, box, n_valid = (torch.as_tensor(a)
                         for a in brute_edge_batch(np.float64))
    with launches.record_launches() as rec:
        got = tcl.brute_neighbors_batched(pos, box, RCUT, K, n_valid)
    assert [r.name for r in rec.records] == ['brute_build']
    assert rec.records[0].meta['pairs'] == 4 * N * N
    want = tkn.brute_build_plain(pos, box, RCUT, K, n_valid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_brute_build_writes_into_bucket_outputs():
    """``out`` from ``brute_outputs`` is written in place and returned (a
    bucket's steps allocate nothing); outputs of other shapes are
    refused."""
    pos, box, n_valid = (torch.as_tensor(a)
                         for a in brute_edge_batch(np.float64))
    out = tkn.brute_outputs(4, N, K, torch.float64, 'cpu')
    assert isinstance(out, tkn.BruteLists) and out.shape == (4, N, K)
    want = tkn.brute_build_plain(pos, box, RCUT, K, n_valid)
    for _ in range(2):
        got = tkn.brute_build(pos, box, RCUT, K, n_valid, out=out)
        assert got is out
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in (tkn.brute_outputs(4, N, K - 1, torch.float64, 'cpu'),
                tkn.brute_outputs(4, N, K, torch.float32, 'cpu'),
                tuple(out)):
        with pytest.raises(ValueError, match='out must be brute_outputs'):
            tkn.brute_build(pos, box, RCUT, K, n_valid, out=bad)


def test_brute_build_raises_off_cpu_and_cuda():
    pos, box, n_valid = (torch.as_tensor(a, device='meta')
                         for a in brute_edge_batch(np.float64))
    with pytest.raises(RuntimeError, match='brute_build: no kernel for '
                                           'device meta'):
        tkn.brute_build(pos, box, RCUT, K, n_valid)


@pytest.mark.parametrize('bad, match', [
    (dict(pos=lambda p: p[..., :2]), 'pos must be contiguous'),
    (dict(pos=lambda p: p.transpose(0, 1)), 'pos must be contiguous'),
    (dict(box=lambda b: b[:2]), 'box must be'),
    (dict(n_valid=lambda n: n.double()), 'n_valid must be'),
    (dict(n_valid=lambda n: n[:3]), 'n_valid must be'),
])
def test_brute_build_checks_its_inputs(bad, match):
    args = dict(zip(('pos', 'box', 'n_valid'), (
        torch.as_tensor(a) for a in brute_edge_batch(np.float64))))
    for k, f in bad.items():
        args[k] = f(args[k])
    with pytest.raises(ValueError, match=match):
        tkn.brute_build(args['pos'], args['box'], RCUT, K, args['n_valid'])


def test_serve_analysis_entry_records_one_brute_build():
    """The static analysis's ``serve.bucket_step`` entry: one batched step
    records one ``brute_build`` launch among its five, with no finding."""
    ep, = [e for e in default_registry('cpu')
           if e.name == 'serve.bucket_step']
    assert ep.launches['brute_build'] == 1
    built = ep.build(0)
    with launches.record_launches() as rec:
        built.fn(*built.args)
    names = [r.name for r in rec.records]
    assert names.count('brute_build') == 1 and len(names) == 5
    er = analyze_entry(ep)
    assert er.findings == [] and er.metrics['launches'] == 5
