"""The port's atom-sharded force pipeline against the unsharded one and the
reference (the two cases of ``tests/test_sharded_forces.py``).

The reference runs its shards as two forced host devices under
``shard_map``; the port runs them as two spawned processes of a gloo
group on the CPU (:func:`repro_torch.launch.sharding.spawn_ranks`).  One
spawn serves every case: both ranks evaluate the adjoint, kernel (plain
versions on the CPU) and baseline pipelines sharded, run
``run_nve(loop='device', shards=2)``, continue a ``shards=1`` checkpoint
from rank slices, and restore rank slices of its leaves.  The parent
holds the gathered results against the unsharded port, the reference's
unsharded adjoint, and the single-rank device loop.

Bars: the reference's — sharded vs unsharded adjoint at rtol 1e-12, atol
1e-12 (the halo sum adds in another order, so not bitwise); the device
loop's T, PE and Etot rows at 1e-9; two sharded evaluations bitwise equal.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro_torch.core import snap as tsnap
from repro_torch.kernels import ops
from repro_torch.kernels.assemble import (assemble_forces_csr_plain,
                                          destination_csr)
from repro_torch.md import integrate as tmd
from repro_torch.md.lattice import paper_box, perturb
from repro_torch.md.neighbor import brute_neighbors
from repro_torch.runtime import checkpoint as ckpt

NATOMS, SHARDS, BETA0 = 54, 2, 0.1
# the reference's MD case: 6 steps, chunks of 2, skin 0.6; the checkpoint
# at step 4 of the single-rank run is continued for 2 steps on 2 ranks
MD = dict(n_steps=6, dt=0.0005, log_every=2, loop='device', skin=0.6)
CKPT_STEP = 4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _force_case():
    cfg = tsnap.SnapConfig(twojmax=4, rcut=4.0)
    pos, box = paper_box(NATOMS)
    pos = perturb(pos, 0.05, seed=1)
    nbr, mask, disp, _ = brute_neighbors(pos, box, 4.0, max_nbors=30)
    beta = np.random.default_rng(0).normal(size=cfg.ncoeff) * 5e-3
    return cfg, beta, (disp[..., 0], disp[..., 1], disp[..., 2], nbr, mask)


def _md_case():
    cfg = tsnap.SnapConfig(twojmax=4, rcut=4.7)
    beta = np.random.default_rng(2).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(NATOMS)
    pos = perturb(pos, 0.03, seed=7)
    state = tmd.MDState(pos=pos, vel=tmd.init_velocities(NATOMS, 200.0,
                                                         seed=8), box=box)
    return cfg, beta, state


def _rows(thermo):
    return {t['step']: (t['T'], t['pe'], t['etot']) for t in thermo}


def _rank_work(rank, ckpt_root):
    """Everything the parent checks, on one rank of the 2-rank group."""
    import torch.distributed as dist

    from repro_torch.runtime.shard import atom_slices, gather_atoms
    torch.set_num_threads(1)
    out = {'rank': rank}
    cfg, beta, args = _force_case()
    for tag, kw in (('adjoint', {}), ('adjoint_again', {}),
                    ('kernel', dict(dtype=torch.float64)), ('baseline', {})):
        fn = ops.make_sharded_force_fn(cfg, beta, BETA0,
                                       impl=tag.split('_')[0], device='cpu',
                                       **kw)
        e, e_atom, f = fn(*(torch.as_tensor(a) for a in args))
        out[tag] = (float(e), gather_atoms(e_atom).numpy(),
                    gather_atoms(f).numpy(), tuple(f.shape))

    cfg, beta, state = _md_case()
    _, thermo = tmd.run_nve(cfg, beta, 0.0, dataclasses.replace(state),
                            shards=SHARDS, device='cpu', **MD)
    out['md'] = _rows(thermo)
    # a shards=1 checkpoint at step 4, continued on both ranks from their
    # rank slices; and a sharded run's own checkpoint (rank 0 writes)
    _, tail = tmd.run_nve(cfg, beta, 0.0, dataclasses.replace(state),
                          **dict(MD, n_steps=MD['n_steps'] - CKPT_STEP),
                          shards=SHARDS, device='cpu',
                          checkpoint_dir=ckpt_root / 'single', restore=True)
    out['tail'] = _rows(tail)
    tmd.run_nve(cfg, beta, 0.0, dataclasses.replace(state),
                **dict(MD, n_steps=2), shards=SHARDS, device='cpu',
                checkpoint_dir=ckpt_root / 'sharded', checkpoint_every=2)
    out['sharded_ckpt'] = sorted(p.name for p in
                                 (ckpt_root / 'sharded').iterdir())
    # rank slices of the leaves with an atom axis, the rest whole
    path = ckpt.step_dir(ckpt_root / 'single', CKPT_STEP)
    leaves, _ = ckpt.restore_named(path)
    sharded, replicated = atom_slices()
    slices = {k: (replicated if k in ('flags', 'box') else sharded)
              for k in leaves}
    out['restored'] = {k: v.numpy() for k, v in
                       ckpt.restore(path, leaves, slices=slices).items()}
    dist.barrier()
    return out


@pytest.fixture(scope='module')
def single_md(tmp_path_factory):
    """The single-rank device loop: 6 straight steps, and 4 steps that
    write the checkpoint the ranks continue."""
    root = tmp_path_factory.mktemp('sharded_md')
    cfg, beta, state = _md_case()
    _, thermo = tmd.run_nve(cfg, beta, 0.0, dataclasses.replace(state),
                            device='cpu', **MD)
    tmd.run_nve(cfg, beta, 0.0, dataclasses.replace(state),
                **dict(MD, n_steps=CKPT_STEP), device='cpu',
                checkpoint_dir=root / 'single', checkpoint_every=CKPT_STEP)
    return _rows(thermo), root


@pytest.fixture(scope='module')
def ranks(single_md):
    from repro_torch.launch.sharding import spawn_ranks
    return spawn_ranks(_rank_work, SHARDS, single_md[1])


@pytest.fixture(scope='module')
def unsharded():
    cfg, beta, args = _force_case()
    out = {}
    for impl, kw in (('adjoint', {}), ('kernel', dict(dtype=torch.float64)),
                     ('baseline', {})):
        e, e_atom, f = tsnap.energy_forces(cfg, beta, BETA0, *args,
                                           impl=impl, device='cpu', **kw)
        out[impl] = (float(e), e_atom.numpy(), f.numpy())
    return out


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize('impl', ['adjoint', 'kernel', 'baseline'])
def test_sharded_matches_unsharded(ranks, unsharded, impl):
    for r in ranks:
        assert r[impl][3] == (NATOMS // SHARDS, 3)    # local rows
        _close(r[impl], unsharded[impl])


def test_sharded_adjoint_matches_reference(ranks):
    cfg, beta, args = _force_case()
    rcfg = rsnap.SnapConfig(twojmax=4, rcut=4.0)
    # jitted: one compile instead of one a jnp op
    e, e_atom, f = jax.jit(functools.partial(
        rsnap.energy_forces_adjoint, rcfg))(
        jnp.asarray(beta), BETA0, *(jnp.asarray(a) for a in args))
    want = (float(e), np.asarray(e_atom), np.asarray(f))
    _close(ranks[0]['adjoint'], want)
    # the kernel path at the reference's kernel bars
    _close(ranks[0]['kernel'], want, rtol=1e-8, atol=1e-10)


def test_sharded_evaluations_bitwise(ranks):
    a, b = ranks
    for r in ranks:
        for x, y in zip(r['adjoint'][1:3], r['adjoint_again'][1:3]):
            assert np.array_equal(x, y)
        assert r['adjoint'][0] == r['adjoint_again'][0]
    # every rank holds the same gathered result
    for tag in ('adjoint', 'kernel', 'baseline'):
        for x, y in zip(a[tag][:3], b[tag][:3]):
            assert np.array_equal(x, y)


def test_device_loop_sharded_matches_single(ranks, single_md):
    want = single_md[0]
    for r in ranks:
        assert sorted(r['md']) == sorted(want)
        np.testing.assert_allclose([r['md'][s] for s in sorted(want)],
                                   [want[s] for s in sorted(want)],
                                   rtol=1e-9, atol=1e-9)


def test_sharded_restore_continues_single_rank_run(ranks, single_md):
    want = single_md[0]
    for r in ranks:
        steps = sorted(r['tail'])
        assert steps == [s for s in sorted(want) if s > CKPT_STEP]
        np.testing.assert_allclose([r['tail'][s] for s in steps],
                                   [want[s] for s in steps],
                                   rtol=1e-9, atol=1e-9)
    # the sharded run's checkpoint: one step dir, written once
    assert ranks[0]['sharded_ckpt'] == ['step_00000002']


def test_restore_rank_slices(ranks, single_md):
    leaves, _ = ckpt.restore_named(ckpt.step_dir(single_md[1] / 'single',
                                                 CKPT_STEP))
    n = NATOMS // SHARDS
    for rank, r in enumerate(ranks):
        for k, v in leaves.items():
            want = v if k in ('flags', 'box') else v[rank * n:(rank + 1) * n]
            assert np.array_equal(r['restored'][k], want), k


def test_rank_slice_load_falls_back_to_old_in_swap_window(single_md,
                                                         tmp_path):
    """A rank-slice load of an MD checkpoint whose re-save died inside the
    swap window (only '<dir>.old' is complete) reads the '.old' copy, as
    the whole load does, and gets that copy's rows of the atom leaves."""
    from repro_torch.md.resilience import ATOM_KEYS, load_md_checkpoint
    src = ckpt.step_dir(single_md[1] / 'single', CKPT_STEP)
    dst = ckpt.step_dir(tmp_path, CKPT_STEP)
    shutil.copytree(src, dst.parent / (dst.name + '.old'))
    whole, box, _, manifest = load_md_checkpoint(tmp_path, CKPT_STEP)
    assert manifest['step'] == CKPT_STEP
    n = NATOMS // SHARDS
    for rank in range(SHARDS):
        carry, box_r, _, _ = load_md_checkpoint(
            tmp_path, CKPT_STEP, rank_slice=ckpt.RankSlice(rank, SHARDS))
        assert np.array_equal(box_r, box)
        for k, v in whole.items():
            want = v[rank * n:(rank + 1) * n] if k in ATOM_KEYS else v
            assert np.array_equal(carry[k], want), k


def test_rank_slice_rejects_uneven_split(tmp_path):
    ckpt.save(tmp_path / 'c', {'pos': np.zeros((5, 3))}, step=0)
    with pytest.raises(ValueError, match='equal slices'):
        ckpt.restore(tmp_path / 'c', {'pos': np.zeros((5, 3))},
                     slices=ckpt.RankSlice(0, 2))


def test_offset_assembly_partials_match_reference_sharded_semantics():
    """Both ranks' partials of the plain offset assembly, summed in one
    process, give the reference's sharded ``assemble_forces`` (its
    ``psum_scatter``, run here under ``jax.vmap`` with a named axis)."""
    rng = np.random.default_rng(0)
    k, n_local = 7, NATOMS // SHARDS
    d = rng.normal(size=(NATOMS, k, 3))
    nbr = rng.integers(0, NATOMS, (NATOMS, k))
    mask = rng.random((NATOMS, k)) < 0.8
    want = jax.vmap(
        lambda a, b, c: rsnap.assemble_forces(a, b, c, NATOMS,
                                              axis_name='i'),
        axis_name='i')(*(jnp.asarray(x.reshape((SHARDS, n_local) +
                                               x.shape[1:]))
                         for x in (d, nbr, mask)))
    parts = []
    for r in range(SHARDS):
        rows = slice(r * n_local, (r + 1) * n_local)
        m = torch.as_tensor(mask[rows])
        dl = (torch.as_tensor(d[rows]) * m[..., None]).contiguous()
        dest = torch.where(m, torch.as_tensor(nbr[rows]), NATOMS)
        parts.append(assemble_forces_csr_plain(
            dl, *destination_csr(dest, NATOMS), r * n_local))
        assert parts[-1].shape == (NATOMS, 3)
    np.testing.assert_allclose(sum(parts).numpy(),
                               np.asarray(want).reshape(NATOMS, 3),
                               rtol=1e-12, atol=1e-12)


def test_sharded_entry_points_need_a_group():
    cfg, beta, args = _force_case()
    with pytest.raises(RuntimeError, match='process group'):
        ops.make_sharded_force_fn(cfg, beta, BETA0, device='cpu')
    cfg, beta, state = _md_case()
    with pytest.raises(RuntimeError, match='process group'):
        tmd.run_nve(cfg, beta, 0.0, state, shards=2, device='cpu', **MD)
    with pytest.raises(ValueError, match="loop='device'"):
        tmd.run_nve(cfg, beta, 0.0, state, 2, loop='scan', shards=2,
                    device='cpu')
