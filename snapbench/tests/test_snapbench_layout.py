"""The benchmark's files: every cell, configuration, traffic mix, limits
file and per-layer reader loads by the name ``BENCHMARK.json`` gives it;
the file keeps to its contract; a cell added as new files only runs."""

import json
import re
import subprocess
import sys

import pytest

from snapbench import harness, trace
from snapbench.run import main

from .conftest import run_tiny

BENCH = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = [m['name'] for m in BENCH['per_layer']]


def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['snapbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in BENCH[group]:
            assert NAME.match(e['name']), e['name']
            names.append(e['name'])
    assert len(names) == len(set(names))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and '\n' not in m['layer']
    for w in BENCH['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200
    for c in BENCH['configs']:
        assert c['file'].startswith('snapbench/') and c['reduced'] == []


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert harness.load_driver(cell.traffic['driver']).run
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m['moves'] in e2e
    assert set(cell.limits['limits']) and cell.limits['control']
    assert cell.config['name'] == cell.entry['config']
    assert len(cell.config['source']) <= 200


@pytest.mark.parametrize('name', METRICS)
def test_every_reader_loads_and_reads_nothing_from_nothing(name):
    rec = trace.Record([], {}, [], (0, 10 ** 9), {})
    assert harness.load_reader(name).read(rec) is None


def test_config_files_match_the_port_configs():
    from repro_torch.configs import snap_2j8, snap_2j14
    for mod in (snap_2j8, snap_2j14):
        c = mod.CONFIG
        mine = harness.read_json(harness.HERE / 'configs' /
                                 f"{c['name']}.json")
        for k in ('twojmax', 'rcut', 'rfac0', 'rmin0', 'switch_flag',
                  'bzero_flag', 'wself'):
            assert mine['snap'][k] == getattr(c['snap'], k)
        assert mine['lattice_a'] == c['lattice_a']
        assert mine['ncoeff'] == c['snap'].ncoeff


def test_a_cell_added_as_new_files_runs(tiny):
    res, _ = run_tiny(*tiny, 'tiny-md')
    assert res['correct'] and list(res)[-1] == 'checks'
    assert set(res['metrics']) == {'md_grind_us', 'setup_s'}
    assert res['device']['platform'] == 'cpu'
    res, _ = run_tiny(*tiny, 'tiny-serve', trace=True)
    assert res['correct'] and 'busy_s' in res['device']
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}


def test_no_card_means_no_result(capsys):
    if __import__('torch').cuda.is_available():
        pytest.skip('a card is present')
    assert main(['--workload', CELLS[0], '--seed', '1', '--seconds', '1',
                 '--trace', '0']) == 2
    assert capsys.readouterr().out == ''


def test_a_folder_of_only_the_benchmark_fails(tmp_path):
    """Without the program beside it the harness prints no result."""
    import shutil
    shutil.copytree(harness.HERE, tmp_path / 'snapbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(harness.ROOT / 'BENCHMARK.json', tmp_path)
    p = subprocess.run([sys.executable, 'snapbench/run.py', '--workload',
                        CELLS[0], '--seed', '5', '--seconds', '1',
                        '--trace', '0'], cwd=tmp_path, capture_output=True,
                       text=True, env={'PATH': '/usr/bin:/bin'}, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ''
