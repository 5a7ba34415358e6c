"""Fixtures of the benchmark's CPU tests: tiny cells written as new files,
and the card, decided inside a fixture."""

import json
import shutil

import pytest
import torch

from snapbench import harness

TINY_CONFIG = 'tiny-2j4'


@pytest.fixture(autouse=True)
def one_thread():
    """Several test workers share the cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; runs on the chip')
    return 'cuda'


def write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def tiny(tmp_path):
    """A files folder holding the benchmark's files plus two tiny cells at
    2J=4 (54 atoms), each added as new files only, and the benchmark dict
    that names them.  Returns (bench, files)."""
    files = tmp_path / 'snapbench'
    shutil.copytree(harness.HERE, files,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    cfg = harness.read_json(files / 'configs' / 'snap-2j8.json')
    cfg['snap']['twojmax'] = 4
    cfg['ncoeff'] = 14
    write(files / 'configs' / f'{TINY_CONFIG}.json', cfg)
    md = harness.read_json(files / 'traffic' / 'nve-16000-f64.json')
    md.update(natoms=54, segment_steps=20, log_every=10, warmup_steps=10)
    write(files / 'traffic' / 'tiny-nve.json', md)
    sv = harness.read_json(files / 'traffic' / 'closed-c64-f32.json')
    sv.update(clients=4, cells_per_side=[3], n_pads=[128], nbor_ladder=[32],
              structures_per_client=4,
              batch=4, queue_depth=8, warmup_steps=1, check_requests=4)
    write(files / 'traffic' / 'tiny-closed.json', sv)
    # limits for these sizes, between the program's readings (f64: ~1e-16;
    # f32 forces ~1e-5) and its controls' (f32: ~1e-7; bf16: ~1e-2)
    write(files / 'limits' / 'tiny-md.json', dict(
        control=dict(dtype='float32'),
        limits=dict(failed_segments=0, pos_err_A=1e-11, vel_err_rel=1e-11,
                    pe_err_eV_atom=1e-11, ke_err_rel=1e-11,
                    end_pe_err_eV_atom=1e-11)))
    write(files / 'limits' / 'tiny-serve.json', dict(
        control=dict(mxu_dtype='bfloat16'),
        limits=dict(failed_requests=0, force_err_rel=1e-3,
                    energy_err_eV_atom=1e-4)))
    bench = harness.read_json(harness.ROOT / 'BENCHMARK.json')
    bench['workloads'] += [
        dict(name='tiny-md', config=TINY_CONFIG, traffic='tiny-nve',
             chips=1, why='test'),
        dict(name='tiny-serve', config=TINY_CONFIG, traffic='tiny-closed',
             chips=1, why='test')]
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'].append('tiny-md' if 'md-2j8-16k' in m['workloads']
                                  else 'tiny-serve')
    return bench, files


def run_tiny(bench, files, name, seed=2 ** 31 + 11, trace=False,
             control=None):
    cell = harness.load_cell(name, bench, files)
    res, checks, _ = harness.run_cell(cell, seed, 0.01, trace, 'cpu',
                                      control=control, files=files)
    return res, checks
