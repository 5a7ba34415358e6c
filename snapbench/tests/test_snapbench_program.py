"""The program's own spans and counters, and the per-layer readers that
read them: one traced run of each tiny cell, shared by the module, and a
tiny device-loop run under the profiler."""

import math

import numpy as np
import pytest
import torch

from snapbench import harness, program, trace

from .conftest import run_tiny, tiny

BENCH = harness.read_json(harness.ROOT / 'BENCHMARK.json')
PROGRAM_METRICS = {
    'tiny-md': ['md_enqueue_ms_per_step', 'md_launch_us_per_step',
                'md_boundary_idle_ms_per_kstep', 'md_rebuilds_per_kstep'],
    'tiny-serve': ['serve_queue_wait_ms', 'serve_pack_ms_per_step',
                   'serve_upload_ms_per_step',
                   'serve_readback_idle_ms_per_step',
                   'serve_triage_ms_per_step', 'serve_atom_fill'],
}
CASES = [(c, m) for c, ms in PROGRAM_METRICS.items() for m in ms]


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """{cell: (result, record)} of one traced run of each tiny cell."""
    bench, files = tiny.__wrapped__(tmp_path_factory.mktemp('tiny'))
    records = []
    finish = trace.Tracer.finish
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace.Tracer, 'finish',
                   lambda self: records.append(finish(self)) or records[-1])
        out = {name: (run_tiny(bench, files, name, trace=True)[0],
                      records[-1]) for name in PROGRAM_METRICS}
    torch.set_num_threads(n)
    return out


def without_program(rec):
    """The record with the program's spans taken out of its host
    operations."""
    keep = [i for i, n in enumerate(rec.host_names)
            if not n.startswith(program.PREFIX)]
    host = [(rec.host_names[i], int(rec.host_start[i]),
             int(rec.host_end[i])) for i in keep]
    device = [(rec.names[o], int(s), int(e))
              for o, s, e in zip(rec.op, rec.start, rec.end)]
    return trace.Record(device, rec.spans, host, rec.window, rec.counters)


def test_the_program_metrics_are_in_the_benchmark():
    entries = {m['name']: m for m in BENCH['per_layer']}
    for cell, names in PROGRAM_METRICS.items():
        real = ['md-2j8-16k', 'md-2j14-2k'] if cell == 'tiny-md' \
            else ['serve-2j8-c64']
        for name in names:
            assert entries[name]['workloads'] == real
            assert entries[name]['source'] == 'device_trace'


@pytest.mark.parametrize('cell,name', CASES)
def test_every_program_metric_reads_a_number(traced, cell, name):
    res, _ = traced[cell]
    assert res['correct']
    v = res['metrics'][name]['value']
    assert isinstance(v, float) and math.isfinite(v) and v >= 0


@pytest.mark.parametrize('cell,name', CASES)
def test_a_reader_reads_nothing_without_program_spans(traced, cell, name):
    rec = without_program(traced[cell][1])
    assert rec.counters.get('steps') or rec.counters.get('device_steps')
    assert harness.load_reader(name).read(rec) is None


def test_the_spans_nest_as_documented(traced):
    rec = traced['tiny-serve'][1]
    step = program.spans(rec, 'serve.step')
    pack = program.spans(rec, 'serve.pack')
    upload = program.spans(rec, 'serve.upload')
    assert len(step[0]) and len(pack[0]) == len(upload[0])
    assert program.inside(*upload, pack).all()
    assert program.inside(*pack, step).all()
    for phase in ('next_batch', 'call', 'readback', 'triage'):
        s, e = program.spans(rec, 'serve.' + phase)
        assert len(s) and program.inside(s, e, step).all(), phase
    rec = traced['tiny-md'][1]
    chunk, steps = (program.spans(rec, n) for n in ('md.chunk', 'md.step'))
    assert len(chunk[0]) and program.inside(*steps, chunk).all()
    assert len(steps[0]) == rec.counters['steps']
    for stage in ('layout', 'u', 'y', 'de', 'assemble', 'energy'):
        s, e = program.spans(rec, 'snap.' + stage)
        assert program.inside(s, e, steps).sum() == len(steps[0]), stage
    for name in ('md.seed', 'md.readback', 'md.triage', 'md.finish'):
        s, e = program.spans(rec, name)
        assert len(s) and not program.inside(s, e, chunk).any(), name


def test_profiler_off_records_nothing():
    from repro_torch.kernels import _build
    from repro_torch.runtime import trace as pt
    assert _build.LAUNCHES is pt.COUNTS
    assert not torch.autograd._profiler_enabled()
    before, total = pt.profiled_counts(), pt.COUNTS['test.off']
    assert pt.span('test.off') is pt.NULL
    with pt.span('test.off'):
        pt.count('test.off', 3)
    assert pt.profiled_counts() == before
    assert pt.COUNTS['test.off'] == total + 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with pt.span('test.on'):
            pt.count('test.on', 2)
    assert pt.profiled_counts() == {'test.on': 2}
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count('repro_torch.test.on') == 1
    with pt.span('test.off'):
        pt.count('test.on')
    assert pt.profiled_counts() == {'test.on': 2}


def test_rebuild_counter_equals_the_loops_count():
    from repro_torch.core.snap import SnapConfig
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    from repro_torch.md.lattice import paper_box, perturb
    from repro_torch.runtime import trace as pt
    cfg = SnapConfig(twojmax=2, rcut=4.7)
    beta = np.random.default_rng(1).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(54)
    cache = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            run_nve(cfg, beta, 0.0, MDState(perturb(pos, 0.02, seed=2),
                                            init_velocities(54, 300.0), box),
                    12, impl='kernel', loop='device', skin=0.02,
                    log_every=4, fn_cache=cache, device='cpu')
    finally:
        torch.set_num_threads(n)
    assert cache['device_rebuilds'] > 0
    assert pt.profiled_counts()['md.rebuilds'] == cache['device_rebuilds']
