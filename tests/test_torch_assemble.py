"""The port's force assembly and its by-destination index on the CPU.

The plain versions (what a CPU tensor runs; a CUDA tensor launches
``csrc/assemble_forces.cu``) against the reference's jnp scatter
(``repro.core.snap.assemble_forces``, jitted once a dtype, no Pallas), on
dE/dr given as the fused dE kernel leaves it: ``[nnbor, 4, natoms_pad]``
planes viewed as ``[natoms, nnbor, 3]``.  Bars: float64 1e-10 and float32
1e-5, relative to the largest force.  Also: the view against a contiguous
copy (bitwise), a NaN in a masked slot, the offset (atom-sharded) form
against the unsharded reference, the source's constants, and the
wrappers' refusals.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro_torch.core import snap as tsnap
from repro_torch.kernels import assemble, neighbors

CSRC = Path(assemble.__file__).resolve().parent / 'csrc'
N, K, NPAD = 100, 12, 128
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
_reference = jax.jit(rsnap.assemble_forces, static_argnums=3)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(dtype, seed=0):
    """(planes [K, 4, NPAD], their [N, K, 3] view, nbr [N, K], mask): a
    random list with masked slots naming atom 0 (as padded lists do) and
    atom 5 named by 40 rows."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (N, K))
    mask = rng.random((N, K)) < 0.8
    nbr[:40, 3] = 5
    mask[:40, 3] = True
    nbr[~mask] = 0
    planes = torch.as_tensor(rng.normal(size=(K, 4, NPAD)), dtype=dtype)
    return (planes, planes[:, :3, :N].permute(2, 0, 1),
            torch.as_tensor(nbr), torch.as_tensor(mask))


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_plane_view_matches_reference(dtype):
    """The core assembly on the planes' view against the reference's
    scatter; the view and a contiguous copy give the same bits; the
    wrapper's CSR is the plain one of the sentinel-masked index."""
    _, view, nbr, mask = _case(dtype)
    assert not view.is_contiguous()
    want = _reference(jnp.asarray(view.numpy()), jnp.asarray(nbr.numpy()),
                      jnp.asarray(mask.numpy()), N)
    got = tsnap.assemble_forces(view, nbr, mask, N)
    assert got.dtype == dtype and got.shape == (N, 3)
    _close(got.numpy(), want, TOL[dtype])
    assert torch.equal(got, tsnap.assemble_forces(view.contiguous(), nbr,
                                                  mask, N))
    order, rowptr = assemble.destination_csr(nbr, N, mask)
    want_o, want_r = assemble.destination_csr_plain(
        torch.where(mask, nbr, N), N)
    assert torch.equal(order, want_o) and torch.equal(rowptr, want_r)
    assert int(rowptr[6] - rowptr[5]) >= 40 > K
    flat = assemble.assemble_forces_csr(view.contiguous(), order, rowptr,
                                        0, mask)
    assert torch.equal(flat, got)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_offset_form_sums_to_reference(dtype):
    """Two ranks' partials of the offset form (their rows of the planes'
    view, the global index, n_out = N) sum to the reference's unsharded
    forces."""
    _, view, nbr, mask = _case(dtype, seed=1)
    want = _reference(jnp.asarray(view.numpy()), jnp.asarray(nbr.numpy()),
                      jnp.asarray(mask.numpy()), N)
    half = N // 2
    parts = []
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        csr = assemble.destination_csr(nbr[rows], N, mask[rows])
        parts.append(assemble.assemble_forces_csr(view[rows], *csr,
                                                  r * half, mask[rows]))
        assert parts[-1].shape == (N, 3)
    _close((parts[0] + parts[1]).numpy(), want, TOL[dtype])


def test_masked_nan_stays_as_before():
    """A NaN dE/dr in a masked slot: the mask is a multiply, as before
    the planes were read in place (masked copy, then the sums), so the
    slot's own row is NaN and no other row is."""
    planes, view, nbr, mask = _case(torch.float64, seed=2)
    i, k = (~mask).nonzero()[0].tolist()
    planes[k, 1, i] = float('nan')
    got = tsnap.assemble_forces(view, nbr, mask, N)
    d = (view * mask[..., None].to(view.dtype)).contiguous()
    before = assemble.assemble_forces_csr_plain(
        d, *assemble.destination_csr_plain(torch.where(mask, nbr, N), N), 0,
        torch.ones_like(mask))
    assert torch.equal(got.isnan(), before.isnan())
    assert got.isnan().any(dim=1).tolist() == [r == i for r in range(N)]
    fin = ~got.isnan()
    assert torch.equal(got[fin], before[fin])


def test_source_constants_match_the_wrappers():
    """The scratch the wrappers allocate follows the sources' constants."""
    src = (CSRC / 'assemble_forces.cu').read_text()
    items = int(re.search(r'#define CSR_ITEMS (\d+)', src).group(1))
    threads = int(re.search(r'#define CSR_THREADS (\d+)', src).group(1))
    assert assemble.CSR_TILE == items * threads
    assert assemble.csr_words(0, 7) == 7 + 1 + 2
    assert assemble.csr_words(2 * assemble.CSR_TILE + 1, 7) == 7 + 1 + 6
    common = (CSRC / 'snap_common.cuh').read_text()
    smem = int(re.search(r'#define SNAP_SMEM_MAX (\d+)', common).group(1))
    cell = (CSRC / 'cell_list.cu').read_text()
    assert '#define BIN_SMEM_MAX (SNAP_SMEM_MAX - 1024)' in cell
    assert neighbors._BIN_SMEM_MAX == smem - 1024


def _bad_assembly_calls():
    _, view, nbr, mask = _case(torch.float64)
    csr = assemble.destination_csr(nbr, N, mask)
    base = view[:, :, :1].expand(N, K, 3)          # a zero stride
    lap = torch.zeros(N * K + 2, dtype=torch.float64).as_strided(
        (N, K, 3), (K, 1, 1))                      # overlapping elements
    return {
        'zero stride': (ValueError, (base, *csr, 0, mask)),
        'overlap': (ValueError, (lap, *csr, 0, mask)),
        'dtype': (TypeError, (view.to(torch.float16), *csr, 0, mask)),
        'shape': (ValueError, (view[..., :2], *csr, 0, mask)),
        'mask dtype': (ValueError, (view, *csr, 0, mask.int())),
        'order dtype': (ValueError, (view, csr[0].int(), csr[1], 0, mask)),
        'offset': (ValueError, (view, *csr, 1, mask)),
        'device': (RuntimeError, (view.to('meta'), csr[0].to('meta'),
                                  csr[1].to('meta'), 0, mask.to('meta'))),
    }


@pytest.mark.parametrize('what', ['zero stride', 'overlap', 'dtype', 'shape',
                                  'mask dtype', 'order dtype', 'offset',
                                  'device'])
def test_assembly_refuses_bad_inputs(what):
    err, args = _bad_assembly_calls()[what]
    with pytest.raises(err):
        assemble.assemble_forces_csr(*args)


@pytest.mark.parametrize('what', ['dtype', 'shape', 'mask', 'no mask',
                                  'device'])
def test_destination_csr_refuses_bad_inputs(what):
    _, _, nbr, mask = _case(torch.float64)
    args = {'dtype': (nbr.double(), N, mask),
            'shape': (nbr.reshape(-1), N, mask.reshape(-1)),
            'mask': (nbr, N, mask[:, :3]),
            'no mask': (nbr, N, None),
            'device': (nbr.to('meta'), N, mask.to('meta'))}[what]
    with pytest.raises(RuntimeError if what == 'device' else ValueError):
        assemble.destination_csr(*args)
