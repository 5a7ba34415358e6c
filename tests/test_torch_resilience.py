"""The port's resilient MD device loop, MD checkpoints and checkpoint format
against the reference.

The cases of ``tests/test_resilience.py`` run on the port
(``repro_torch.md``, on the CPU, float64): the health-flag lattice, regrow +
rollback, dt-halving retries, typed errors, bitwise split-run restore and
crash + restore, each driven by the port's deterministic fault injector.
Beside them: the port's ``runtime/checkpoint`` (round trip, the swap-window
``.old`` fallback, ``latest_step``), and checkpoints crossing packages — a
reference MD checkpoint restored by the port continues within 1e-9 of the
reference's own continuation, and a port checkpoint reads back through the
reference with the same leaf names and dtypes.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snap as rsnap
from repro.md import integrate as rmd
from repro.md import resilience as rres
from repro.runtime import checkpoint as rckpt
from repro_torch.core.snap import SnapConfig
from repro_torch.md.cell_list import CellOverflowError
from repro_torch.md.fault_inject import Fault, FaultInjector, SimulatedCrash
from repro_torch.md.integrate import MDState, init_velocities, run_nve
from repro_torch.md.lattice import paper_box, perturb
from repro_torch.md.neighbor import NeighborOverflowError, suggest_capacity
from repro_torch.md.resilience import (CARRY_KEYS, AtomEscapeError,
                                       EnergyDriftError, HealthReport,
                                       NumericalBlowupError, RecoveryPolicy,
                                       load_md_checkpoint, regrow_grid)
from repro_torch.runtime import checkpoint as ckpt

CFG = SnapConfig(twojmax=2, rcut=3.0)
BETA = np.random.default_rng(0).normal(size=CFG.ncoeff) * 5e-3


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_state():
    pos, box = paper_box(natoms=54)
    return MDState(pos=perturb(pos, 0.02, seed=1).copy(),
                   vel=init_velocities(54, 300.0, seed=2),
                   box=box.copy())


def _run(n_steps=12, **kw):
    kw.setdefault('dt', 0.0005)
    kw.setdefault('log_every', 3)
    kw.setdefault('loop', 'device')
    kw.setdefault('skin', 0.4)
    kw.setdefault('max_nbors', 16)
    kw.setdefault('device', 'cpu')
    return run_nve(CFG, BETA, 0.0, _fresh_state(), n_steps, **kw)


def test_overflow_error_messages_suggest_capacity():
    e = NeighborOverflowError(27, 24)
    assert e.max_count == 27 and e.max_nbors == 24
    assert e.suggested == suggest_capacity(27)
    assert f'max_nbors={e.suggested}' in str(e)
    assert 'retry with' in str(e) and '27' in str(e) and '24' in str(e)
    c = CellOverflowError(19, 16)
    assert c.suggested == suggest_capacity(19)
    assert f'cell_cap={c.suggested}' in str(c)
    assert 'retry with' in str(c)


def test_health_report_and_regrow_match_reference():
    """Flag decoding and capacity regrowth: the same numbers as the
    reference's for the same flag vectors."""
    from repro.md.cell_list import make_grid as rmake
    from repro_torch.md.cell_list import make_grid as tmake
    box = np.array([20.0, 20.0, 20.0])
    g_r, g_t = rmake(box, 3.0, 0.4, 8, 24), tmake(box, 3.0, 0.4, 8, 24)
    pol_r, pol_t = rres.RecoveryPolicy(), RecoveryPolicy()
    for flags in ([30, 9, 0, 0, 0, 0], [3, 2, 1, 0, 1, 0], [24, 8],
                  [0, 0, 0, 1, 0, 1]):
        rep_r = rres.HealthReport.from_flags(np.array(flags), g_r)
        rep_t = HealthReport.from_flags(torch.tensor(flags,
                                                     dtype=torch.int32), g_t)
        assert rep_t.issues() == rep_r.issues()
        assert (rep_t.ok, rep_t.overflow, rep_t.numeric) == \
            (rep_r.ok, rep_r.overflow, rep_r.numeric)
        if rep_r.overflow:
            new_r = rres.regrow_grid(g_r, rep_r, pol_r)
            new_t = regrow_grid(g_t, rep_t, pol_t)
            assert (new_t.cell_cap, new_t.max_nbors) == \
                (new_r.cell_cap, new_r.max_nbors)


def test_guards_do_not_change_trajectory():
    """Arming the health lattice is trajectory-neutral: the guards are
    pure observers (reductions into the flag carry)."""
    _, plain = _run()
    _, guarded = _run(policy=RecoveryPolicy(drift_tol=1.0))
    assert plain == guarded


def test_nan_injection_rolls_back_to_identical_trajectory():
    """An injected non-finite force flags the chunk; rollback discards it
    and the retry (from the untouched carry) reproduces the fault-free run
    bitwise."""
    _, ref = _run(policy=RecoveryPolicy())
    inj = FaultInjector([Fault(step=3, kind='nan_force')])
    cache = {}
    _, th = _run(policy=RecoveryPolicy(), fault_hook=inj, fn_cache=cache)
    assert inj.fired and inj.fired[0]['kind'] == 'nan_force'
    kinds = [e.kind for e in cache['recovery_events']]
    assert 'rollback' in kinds
    assert th == ref


def test_overflow_regrows_once_and_matches_oversized_reference():
    """An injected neighbor-capacity overflow completes via regrow +
    rollback, with one new chunk function for the regrown shapes (count 1
    -> 2), and the trajectory matches an oversized-capacity run."""
    _, ref = _run(max_nbors=32, policy=RecoveryPolicy())
    inj = FaultInjector([Fault(step=6, kind='overflow_nbr')])
    cache = {}
    _, th = _run(policy=RecoveryPolicy(), fault_hook=inj, fn_cache=cache)
    regrows = [e for e in cache['recovery_events'] if e.kind == 'regrow']
    assert len(regrows) == 1, cache['recovery_events']
    old_k, new_k = regrows[0].detail['max_nbors']
    assert new_k > old_k
    assert cache['device_trace_count']['traces'] == 2
    a = np.array([[t['T'], t['pe'], t['etot']] for t in th])
    b = np.array([[t['T'], t['pe'], t['etot']] for t in ref])
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_cell_overflow_injection_recovers():
    inj = FaultInjector([Fault(step=3, kind='overflow_cell')])
    cache = {}
    _, th = _run(policy=RecoveryPolicy(), fault_hook=inj, fn_cache=cache)
    regrows = [e for e in cache['recovery_events'] if e.kind == 'regrow']
    assert len(regrows) == 1
    old_c, new_c = regrows[0].detail['cell_cap']
    assert new_c > old_c
    assert len(th) >= 4


def test_persistent_nan_exhausts_retries_with_typed_error():
    """A fault that survives rollback halves dt a bounded number of times
    and then surfaces a typed error with diagnostics."""
    inj = FaultInjector([Fault(step=3, kind='nan_force', persistent=True)])
    cache = {}
    policy = RecoveryPolicy(max_numeric_retries=2,
                            retries_before_dt_halve=1)
    with pytest.raises(NumericalBlowupError) as ei:
        _run(policy=policy, fault_hook=inj, fn_cache=cache)
    assert ei.value.diagnostics['retries'] == 2
    assert 'nan' in str(ei.value)
    kinds = [e.kind for e in cache['recovery_events']]
    assert kinds.count('rollback') == 2 and 'dt_halve' in kinds
    assert ei.value.diagnostics['dt'] == pytest.approx(0.00025)


def test_drift_watchdog_raises_typed_error():
    policy = RecoveryPolicy(drift_tol=1e-300, max_numeric_retries=1)
    with pytest.raises(EnergyDriftError):
        _run(policy=policy)


def test_escape_flag_raises_typed_error():
    """An atom far outside the box latches the escape flag; retries cannot
    fix it, so the typed AtomEscapeError surfaces."""
    policy = RecoveryPolicy(escape_factor=0.4, max_numeric_retries=1)
    with pytest.raises(AtomEscapeError, match='escape'):
        _run(policy=policy)


def test_checkpoint_restore_bitwise_identical(tmp_path):
    """2k straight vs k + checkpoint + restore + k: the continuation is
    bitwise identical (full device-carry snapshots, aligned chunks)."""
    st0, straight = _run(n_steps=24, log_every=6, policy=RecoveryPolicy())
    d = str(tmp_path / 'ckpt')
    _, head = _run(n_steps=12, log_every=6, policy=RecoveryPolicy(),
                   checkpoint_dir=d, checkpoint_every=6)
    st2, tail = run_nve(CFG, BETA, 0.0, _fresh_state(), 12, dt=0.0005,
                        log_every=6, loop='device', skin=0.4, max_nbors=16,
                        policy=RecoveryPolicy(), checkpoint_dir=d,
                        restore=True, device='cpu')
    assert st2.step == 24
    assert np.array_equal(st2.pos, st0.pos)
    assert np.array_equal(st2.vel, st0.vel)
    merged = {t['step']: t for t in head + tail}
    for row in straight:
        assert merged[row['step']] == row, (merged[row['step']], row)
    # the reference's leaf names and dtypes
    carry, box, grid, manifest = load_md_checkpoint(d)
    assert manifest['step'] == 12 and manifest['extra']['kind'] == \
        'md_carry'
    assert {k: carry[k].dtype.name for k in CARRY_KEYS} == dict(
        pos='float64', vel='float64', f='float64', nbr_idx='int32',
        shifts='float64', mask='bool', pos_ref='float64', flags='int32')


def test_crash_then_restore_continues(tmp_path):
    d = str(tmp_path / 'ckpt')
    _, straight = _run(n_steps=12, policy=RecoveryPolicy())
    inj = FaultInjector([Fault(step=9, kind='crash')])
    with pytest.raises(SimulatedCrash):
        _run(n_steps=12, policy=RecoveryPolicy(), fault_hook=inj,
             checkpoint_dir=d, checkpoint_every=3)
    st, tail = run_nve(CFG, BETA, 0.0, _fresh_state(), 3, dt=0.0005,
                       log_every=3, loop='device', skin=0.4, max_nbors=16,
                       policy=RecoveryPolicy(), checkpoint_dir=d,
                       restore=True, device='cpu')
    assert tail == [t for t in straight if t['step'] > 9]


def test_legacy_no_policy_still_raises():
    """Without a policy the first overflow raises at the chunk boundary."""
    inj = FaultInjector([Fault(step=3, kind='overflow_nbr')])
    with pytest.raises(NeighborOverflowError, match='retry with'):
        _run(fault_hook=inj)


def test_fault_injector_does_not_write_the_carry():
    """The injector poisons clones: the carry it was handed (the rollback
    target) keeps its values."""
    from repro_torch.md.cell_list import make_grid
    carry = dict(f=torch.zeros(4, 3), vel=torch.ones(4, 3),
                 flags=torch.zeros(6, dtype=torch.int32))
    grid = make_grid(np.full(3, 10.0), 3.0, 0.4, 8, 16)
    inj = FaultInjector([Fault(0, 'nan_force'), Fault(0, 'nan_vel'),
                         Fault(0, 'overflow_nbr'), Fault(0, 'overflow_cell')])
    out = inj(0, carry, grid)
    assert torch.isnan(out['f'][0, 0]) and torch.isnan(out['vel'][0, 0])
    assert out['flags'].tolist()[:2] == [19, 10]
    assert not torch.isnan(carry['f']).any()
    assert not torch.isnan(carry['vel']).any()
    assert not carry['flags'].any()
    with pytest.raises(ValueError, match='unknown fault kind'):
        Fault(0, 'nope')


def _tree():
    rng = np.random.default_rng(0)
    return {'params': {'w': rng.normal(size=(8, 16)),
                       'b': np.arange(16, dtype=np.float32)},
            'opt': {'m': torch.zeros(8, 16, dtype=torch.float64),
                    'count': np.asarray(3, np.int32)}}


def test_checkpoint_roundtrip_matches_reference_layout(tmp_path):
    """Same files and manifest as the reference's writer for the same tree;
    each package reads the other's checkpoint by name."""
    tree = _tree()
    ckpt.save(tmp_path / 'port', tree, step=5, extra={'data_step': 5})
    host = {'params': tree['params'],
            'opt': {'m': tree['opt']['m'].numpy(),
                    'count': tree['opt']['count']}}
    rckpt.save(tmp_path / 'ref', host, step=5, extra={'data_step': 5})
    assert json.loads((tmp_path / 'port' / 'manifest.json').read_text()) \
        == json.loads((tmp_path / 'ref' / 'manifest.json').read_text())
    for src, reader in (('port', rckpt.restore_named),
                        ('ref', ckpt.restore_named)):
        leaves, manifest = reader(tmp_path / src)
        assert manifest['step'] == 5
        assert list(leaves) == ['opt.count', 'opt.m', 'params.b',
                                'params.w']
        np.testing.assert_array_equal(leaves['params.w'],
                                      tree['params']['w'])
        assert leaves['params.b'].dtype == np.float32


def test_restore_named_falls_back_to_old_in_swap_window(tmp_path,
                                                        monkeypatch):
    """A crash after the live dir was renamed to '<dir>.old' and before the
    tmp dir was renamed into place: restore_named reads the '.old' copy,
    and a completed re-save takes precedence again."""
    tree = _tree()
    d = tmp_path / 'snap'
    ckpt.save(d, tree, step=1, extra=dict(kind='probe'))
    real_rename = os.rename

    def crashing_rename(src, dst):
        if str(src) == str(d.with_suffix('.tmp')):   # tmp -> final
            raise OSError('simulated crash mid-swap')
        return real_rename(src, dst)

    monkeypatch.setattr(os, 'rename', crashing_rename)
    with pytest.raises(OSError, match='simulated crash'):
        ckpt.save(d, dict(tree, extra=np.ones(2)), step=2,
                  extra=dict(kind='probe'))
    monkeypatch.undo()
    assert not (d / 'manifest.json').exists()
    leaves, manifest = ckpt.restore_named(d)
    assert manifest['step'] == 1 and 'extra' not in leaves
    ckpt.save(d, tree, step=2, extra=dict(kind='probe'))
    assert ckpt.restore_named(d)[1]['step'] == 2
    assert not (d.parent / 'snap.old').exists()


def test_latest_step_ignores_partial_dirs(tmp_path):
    assert ckpt.latest_step(tmp_path / 'none') is None
    for s in (5, 3):
        ckpt.save(ckpt.step_dir(tmp_path, s), _tree(), step=s)
    for name in ('step_00000009.old', 'step_00000011.tmp'):
        (tmp_path / name).mkdir()
        (tmp_path / name / 'manifest.json').write_text('{}')
    assert ckpt.latest_step(tmp_path) == 5


def test_reference_checkpoint_restores_into_port(tmp_path):
    """A checkpoint written by the reference's device loop (f64, adjoint)
    restores into the port, which continues within 1e-9 of the reference's
    own continuation; the port's next checkpoint reads back through the
    reference's loader."""
    cfg_r = rsnap.SnapConfig(twojmax=2, rcut=3.0)
    d = str(tmp_path / 'ckpt')
    kw = dict(dt=0.0005, log_every=3, loop='device', skin=0.4,
              max_nbors=16, policy=None)
    st = _fresh_state()
    rmd.run_nve(cfg_r, jnp.asarray(BETA), 0.0,
                rmd.MDState(st.pos, st.vel, st.box), 6, checkpoint_dir=d,
                checkpoint_every=6, **kw)
    st = _fresh_state()
    _, want = rmd.run_nve(cfg_r, jnp.asarray(BETA), 0.0,
                          rmd.MDState(st.pos, st.vel, st.box), 6,
                          checkpoint_dir=d, restore=True, **kw)
    st, got = run_nve(CFG, BETA, 0.0, _fresh_state(), 6, checkpoint_dir=d,
                      restore=True, checkpoint_every=6, device='cpu', **kw)
    assert st.step == 12 and [t['step'] for t in got] == \
        [t['step'] for t in want]
    for g, w in zip(got, want):
        for k in ('T', 'ke', 'pe', 'etot'):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9)
    # the port wrote step 12 under the same root; the reference reads it
    carry_r, _, grid_r, manifest = rres.load_md_checkpoint(d)
    assert manifest['step'] == 12
    carry_t, _, grid_t, _ = load_md_checkpoint(d)
    assert dataclasses.astuple(grid_r) == dataclasses.astuple(grid_t)
    for k in CARRY_KEYS:
        assert carry_r[k].dtype == carry_t[k].dtype
        np.testing.assert_array_equal(carry_r[k], carry_t[k])
