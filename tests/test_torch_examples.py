"""The port's examples (``repro_torch.examples``) on the CPU, each held to
the bars its reference counterpart in ``examples/`` prints or checks:

- quickstart at 2J = 2, 54 atoms: the adjoint and baseline energies equal
  the reference's ``energy_forces`` on the same inputs within 1e-10
  relative (one jitted reference call for both), the float32 kernel path
  within 1e-5;
- md_nve: 5 device-loop steps at 2J = 2, relative NVE drift <= 1e-5;
- serve_forces: 6 requests, every request reaches an outcome, the
  poisoned ones a typed error, the others finite results;
- fit_snap at 2J = 2: held-out relE < 1e-6, max |dF| < 1e-4 eV/A;
- and, without a card and without ``--device cpu``, each one raises
  instead of running on the CPU.

torch runs on one thread; nothing is spawned.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snap_2j8 as r2j8, snap_2j14 as r2j14
from repro.core import snap as rsnap
from repro.md.lattice import paper_box, perturb
from repro.md.neighbor import brute_neighbors
from repro_torch.configs import get_snap_config
from repro_torch.examples import fit_snap, md_nve, quickstart, serve_forces
from repro_torch.launch.request_queue import ServiceError
from repro_torch.launch.serve_forces import ForceResult

CPU = ['--device', 'cpu']


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _reference_quickstart(twojmax):
    """The reference's baseline and adjoint energies on quickstart's
    inputs, from one jitted call."""
    cfg = rsnap.SnapConfig(twojmax=twojmax, rcut=4.7)
    pos, box = paper_box(natoms=54)
    pos = perturb(pos, scale=0.05)
    nbr_idx, mask, disp, _ = brute_neighbors(pos, box, cfg.rcut,
                                             max_nbors=40)
    beta = jnp.asarray(np.random.default_rng(0).normal(size=cfg.ncoeff)
                       * 1e-2)

    @jax.jit
    def both(dx, dy, dz, nbr_idx, mask):
        return tuple(rsnap.energy_forces(cfg, beta, 0.0, dx, dy, dz, nbr_idx,
                                         mask, impl=impl)[0]
                     for impl in ('baseline', 'adjoint'))
    e_base, e_adj = both(disp[..., 0], disp[..., 1], disp[..., 2], nbr_idx,
                         mask)
    return dict(baseline=float(e_base), adjoint=float(e_adj))


def test_quickstart_energies_match_reference():
    out = quickstart.main(['--twojmax', '2'] + CPU)
    ref = _reference_quickstart(2)
    assert out['ncoeff'] == 5 and out['natoms'] == 54
    for impl, bar in (('baseline', 1e-10), ('adjoint', 1e-10)):
        assert abs(out['energy'][impl] - ref[impl]) <= bar * abs(ref[impl])
    assert abs(out['energy']['kernel'] - ref['adjoint']) <= \
        1e-5 * abs(ref['adjoint'])
    assert np.all(np.isfinite(out['b0']))


def test_md_nve_device_loop_conserves_energy():
    out = md_nve.main(['--steps', '5', '--natoms', '54', '--twojmax', '2',
                       '--loop', 'device'] + CPU)
    assert [t['step'] for t in out['thermo']] == [1, 5]
    assert np.isfinite(out['rel_drift']) and out['rel_drift'] <= 1e-5
    assert out['recovery_events'] == []


def test_serve_forces_every_request_reaches_an_outcome():
    out = serve_forces.main(['--requests', '6'] + CPU)
    assert len(out['outcomes']) == 6 and set(out['plan']) == {3, 4}
    for i, res in enumerate(out['outcomes'].values()):
        if i in out['plan']:
            assert isinstance(res, ServiceError), res
        else:
            assert isinstance(res, ForceResult), res
            assert np.isfinite(res.energy) and np.all(
                np.isfinite(res.forces))
    assert out['health']['served'] == 4 and out['health']['failed'] == 2


def test_fit_snap_predicts_held_out_cell():
    out = fit_snap.main(['--twojmax', '2'] + CPU)
    assert out['rel_e'] < fit_snap.MAX_REL_E
    assert out['max_df'] < fit_snap.MAX_DF


@pytest.mark.parametrize('example, argv', [
    (quickstart, ['--twojmax', '2']),
    (md_nve, ['--steps', '1', '--natoms', '54', '--twojmax', '2']),
    (serve_forces, ['--requests', '1']),
    (fit_snap, ['--twojmax', '2']),
], ids=['quickstart', 'md_nve', 'serve_forces', 'fit_snap'])
def test_examples_default_to_the_card(example, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        example.main(argv)


def test_snap_configs_are_the_papers():
    """Each config is the reference's, field by field (the dtype aside:
    jnp's and torch's); 2J=14's index, seconds to build, is not built."""
    for name, ref in (('snap_2j8', r2j8.CONFIG), ('snap-2j14', r2j14.CONFIG)):
        port = get_snap_config(name)
        assert port.keys() == ref.keys()
        assert all(port[k] == ref[k] for k in ref if k != 'snap')
        for f in dataclasses.fields(ref['snap']):
            if f.name != 'dtype':
                assert getattr(port['snap'], f.name) == \
                    getattr(ref['snap'], f.name), (name, f.name)
    c8 = get_snap_config('snap_2j8')
    assert (c8['snap'].twojmax, c8['snap'].ncoeff, c8['natoms'],
            c8['nnbor']) == (8, 55, 2000, 26)
    assert get_snap_config('snap-2j14')['snap'].twojmax == 14
    with pytest.raises(ValueError):
        get_snap_config('gemma2-2b')
