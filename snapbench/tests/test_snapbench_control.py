"""The check that decides ``correct``, at a size a CPU test holds: the
program passes, its lower-precision control fails, and each fault planted
in the timed path underneath the harness fails.

The same controls run on the card at each cell's own size with
``python3 snapbench/calibrate.py --workload <cell>`` (PERF.md, PR 28).
"""

import numpy as np
import pytest
import torch

from .conftest import run_tiny


def test_md_program_passes_and_reads_near_rounding(tiny):
    res, checks = run_tiny(*tiny, 'tiny-md')
    assert res['correct'], checks
    vals = {n: v for n, v, _ in checks}
    assert vals['failed_segments'] == 0
    assert vals['pos_err_A'] < 1e-13 and vals['pe_err_eV_atom'] < 1e-13


def test_md_float32_control_fails(tiny):
    bench, files = tiny
    res, checks = run_tiny(bench, files, 'tiny-md',
                           control=dict(dtype='float32'))
    assert not res['correct']
    vals = {n: v for n, v, _ in checks}
    assert vals['pos_err_A'] > 1e-9 and vals['pe_err_eV_atom'] > 1e-9


def _unchanged(real):
    """A segment that returns its start state unchanged."""
    def run_nve(cfg, beta, beta0, state, *a, **kw):
        pos, vel = state.pos.copy(), state.vel.copy()
        st, thermo = real(cfg, beta, beta0, state, *a, **kw)
        st.pos, st.vel = pos, vel
        return st, thermo
    return run_nve


def _altered(real):
    """One atom's end position altered where the segment produces it."""
    def run_nve(*a, **kw):
        st, thermo = real(*a, **kw)
        st.pos = np.array(st.pos)
        st.pos[7, 1] += 1e-6
        return st, thermo
    return run_nve


def _half_forces(real):
    """The force of half the atoms left out of every step."""
    def make_force_fn(*a, **kw):
        fn = real(*a, **kw)

        def force(*args):
            e, f = fn(*args)
            f = f.clone()
            f[f.shape[0] // 2:] = 0
            return e, f
        return force
    return make_force_fn


@pytest.mark.parametrize('fault', ['unchanged', 'altered', 'half_forces'])
def test_md_planted_fault_fails(tiny, monkeypatch, fault):
    import repro_torch.md.integrate as integrate
    if fault == 'half_forces':
        monkeypatch.setattr(integrate, 'make_force_fn',
                            _half_forces(integrate.make_force_fn))
    else:
        wrap = _unchanged if fault == 'unchanged' else _altered
        monkeypatch.setattr(integrate, 'run_nve', wrap(integrate.run_nve))
    res, checks = run_tiny(*tiny, 'tiny-md')
    assert not res['correct'], checks


def test_serve_program_passes(tiny):
    res, checks = run_tiny(*tiny, 'tiny-serve')
    assert res['correct'], checks
    assert res['failed'] == 0 and res['attempted'] >= 8


def test_serve_bfloat16_control_fails(tiny):
    bench, files = tiny
    res, checks = run_tiny(bench, files, 'tiny-serve',
                           control=dict(mxu_dtype='bfloat16'))
    assert not res['correct']
    assert {n: v for n, v, _ in checks}['force_err_rel'] > 1e-3


def _batched(real, fault):
    """The batched entry with a fault in what it returns: half the lanes
    left out (zero forces and energies), one force altered in each lane,
    or the first batch's answers returned again for every later batch."""
    def make(*a, **kw):
        fn = real(*a, **kw)
        first = []

        def call(*args, **kws):
            e, f, flags = fn(*args, **kws)
            e, f = e.clone(), f.clone()
            if fault == 'half_batch':
                e[e.shape[0] // 2:] = 0
                f[f.shape[0] // 2:] = 0
            elif fault == 'altered':
                f[:, 0, 0] += 0.05 * torch.max(torch.abs(f))
            elif fault == 'stale':
                if not first:
                    first.append((e, f))
                e, f = first[0]
            return e, f, flags
        return call
    return make


@pytest.mark.parametrize('fault', ['half_batch', 'altered', 'stale'])
def test_serve_planted_fault_fails(tiny, monkeypatch, fault):
    import repro_torch.launch.serve_forces as sf
    monkeypatch.setattr(sf, 'make_batched_force_fn',
                        _batched(sf.make_batched_force_fn, fault))
    res, checks = run_tiny(*tiny, 'tiny-serve')
    assert not res['correct'], checks


def test_serve_lost_requests_fail(tiny, monkeypatch):
    """A step that loses its batch: the requests never come back."""
    import repro_torch.launch.serve_forces as sf
    real = sf.ForceServer.step
    calls = []

    def step(self, now=0.0, **kw):
        finished, dt = real(self, now, **kw)
        calls.append(1)
        return (finished if len(calls) != 3 else []), dt
    monkeypatch.setattr(sf.ForceServer, 'step', step)
    res, checks = run_tiny(*tiny, 'tiny-serve')
    assert not res['correct']
    assert {n: v for n, v, _ in checks}['failed_requests'] > 0


@pytest.mark.parametrize('name', ['tiny-md', 'tiny-serve'])
def test_tiny_cells_pass_on_the_card(tiny, card, name):
    """The same tiny cells through the kernels (the chip's own run)."""
    from snapbench import harness
    bench, files = tiny
    cell = harness.load_cell(name, bench, files)
    res, checks, _ = harness.run_cell(cell, 2 ** 31 + 5, 0.01, False,
                                      card, files=files)
    assert res['correct'], checks
