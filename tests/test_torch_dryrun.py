"""The port's dry run (``python -m repro_torch.launch.dryrun``): per-device
FLOP and collective bytes exact on unit cases, a full-width decode cell
``ok`` with exact argument bytes and no real allocation, the reference's
skip of ``long_500k`` for a full-attention arch, a reduced train cell
through the lower-level helper on a (2, 2) mesh, and three train cells at
full width, their depth cut, against the reference's own dry run of the
same cut configs (per-device peak at most twice the reference's).

The port's checks run in one subprocess: a fake process group is global
to its process (the dry run makes this process rank 0 of 256 ranks, then
of 4, then of 256 again).  The reference's dry run runs beside it in a
second one (it forces 512 host devices before jax starts); each replaces
its dry run's ``get_config`` in that process only.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

CHECKS = r'''
import json, math, resource
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import Replicate
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.compat import make_auto_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (P, NamedSharding, batch_shardings,
                                         cache_shardings, local_shape,
                                         param_shardings, place)
from repro_torch.models import specs
from repro_torch.models.transformer import tree_leaves
out = {}

dryrun.fake_world(256)
mesh = make_production_mesh(device_type='cpu')
x = place(torch.empty(4096, 1024, device='meta'),
          NamedSharding(mesh, P(('data', 'model'), None)))
w = place(torch.empty(1024, 512, device='meta'), NamedSharding(mesh, P()))
cm = dryrun.CostMode()
with cm:
    y = x @ w
out['matmul'] = dict(flops=cm.flops, want=2 * 4096 * 1024 * 512 // 256,
                     local=list(y.to_local().shape))

t = place(torch.empty(1024, 64, device='meta'),
          NamedSharding(mesh, P('data', None)))
cm = dryrun.CostMode()
with cm:
    t.redistribute(mesh, [Replicate(), Replicate()])
out['gather'] = cm.collective_stats()

rec = dryrun.lower_cell('gemma3-1b', 'decode_32k', multi_pod=False)
cfg = get_config('gemma3-1b')
sp = specs.input_specs(cfg, 'decode_32k')
params = specs.params_specs(cfg)
want = 0
for tree, shard, size in ((params, param_shardings(params, mesh), 2),
                          (sp['cache'], cache_shardings(sp['cache'], mesh),
                           None),
                          ({'t': sp['tokens']},
                           batch_shardings({'t': sp['tokens']}, mesh), None)):
    for (_, leaf), (_, ns) in zip(tree_leaves(tree), tree_leaves(shard)):
        want += math.prod(local_shape(leaf.shape, ns)) * (
            size or leaf.element_size())
out['decode'] = dict(rec=rec, want_args=want)
out['skip'] = dryrun.lower_cell('deepseek-7b', 'long_500k', multi_pod=False)

dryrun.fake_world(4)
small = make_auto_mesh((2, 2), ('data', 'model'), 'cpu')
cfg = get_config('granite-moe-1b-a400m').reduced(
    d_model=64, vocab=512, n_heads=4, n_kv=2)
out['train'] = dryrun.lower(cfg, small, 'train', 32, 8)
out['maxrss_gb'] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

import dataclasses
whole_config = dryrun.get_config
dryrun.get_config = lambda a: dataclasses.replace(whole_config(a),
                                                  n_layers=CUT[a])
out['cut'] = {}
for arch in CUT:
    rec = dryrun.lower_cell(arch, 'train_4k', multi_pod=False)
    out['cut'][arch] = dict(
        peak=rec['memory']['peak_size_in_bytes'],
        all_to_all=rec['collectives']['all-to-all']['count'])
import sys
out['forbidden'] = sorted(m for m in sys.modules if m.split('.')[0] in
                          ('jax', 'jaxlib', 'repro', 'benchmarks'))
print('RESULT ' + json.dumps(out))
'''


# train_4k cells at full width on 16 x 16, depth cut to a multiple of the
# pattern's period, for the port's dry run and the reference's
CUT = {'arctic-480b': 2, 'falcon-mamba-7b': 2, 'gemma3-1b': 6}

# the reference's own dry run of the same cut cells, in its own process
# (it forces 512 host devices before jax starts): its per-device peak,
# argument + output + temp - alias bytes of the compiled step.  XLA's
# LLVM codegen runs at its least effort: the memory analysis is made
# before codegen (the same bytes), at half the CPU time
REFERENCE = r'''
import dataclasses, json, os
import repro.launch.dryrun as d
os.environ['XLA_FLAGS'] += (' --xla_backend_optimization_level=0'
                            ' --xla_llvm_disable_expensive_passes=true')
whole_config = d.get_config
d.get_config = lambda a: dataclasses.replace(whole_config(a), n_layers=CUT[a])
out = {}
for arch in CUT:
    m = d.lower_cell(arch, 'train_4k', False)['memory']
    out[arch] = (m['argument_size_in_bytes'] + m['output_size_in_bytes']
                 + m['temp_size_in_bytes'] - m['alias_size_in_bytes'])
print('RESULT ' + json.dumps(out))
'''


def _run(code, env):
    return subprocess.Popen([sys.executable, '-c', code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(p):
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr[-4000:]
    line = next(x for x in stdout.splitlines() if x.startswith('RESULT '))
    return json.loads(line[len('RESULT '):])


@pytest.fixture(scope='module')
def runs():
    """The port's checks and the reference's cut cells, run at once."""
    cut = f'CUT = {CUT!r}\n'
    port = _run(cut + CHECKS, dict(os.environ, PYTHONPATH=str(REPO / 'src')))
    ref = _run(cut + REFERENCE, dict(os.environ, JAX_PLATFORMS='cpu',
                                      PYTHONPATH=str(REPO / 'src')))
    return _result(port), _result(ref)


@pytest.fixture(scope='module')
def result(runs):
    return runs[0]


def test_sharded_matmul_flops_per_device(result):
    """[4096, 1024] sharded 256 ways along its rows times a replicated
    [1024, 512]: each device counts exactly the global FLOP / 256, on its
    [16, 512] rows (the mode sees the local op, not the global one)."""
    m = result['matmul']
    assert m['flops'] == m['want'] and m['local'] == [16, 512]


def test_all_gather_bytes(result):
    """Shard(0) -> Replicate() of a [1024, 64] float32 tensor on the
    16-way 'data' axis: one all-gather of 1024 * 64 * 4 output bytes."""
    c = result['gather']
    assert c['all-gather'] == dict(count=1, bytes=1024 * 64 * 4)
    assert c['total_bytes'] == 1024 * 64 * 4
    assert all(c[k]['count'] == 0 for k in ('all-reduce', 'reduce-scatter',
                                            'all-to-all',
                                            'collective-permute'))


def test_full_width_decode_cell(result):
    """gemma3-1b decode_32k on 16 x 16 is ``ok``: its argument bytes are
    the local bytes that ``param_shardings`` (bf16 at rest),
    ``cache_shardings`` and ``batch_shardings`` give, added up here
    independently; no real allocation (the process stays under 4 GB)."""
    rec, want = result['decode']['rec'], result['decode']['want_args']
    assert rec['status'] == 'ok' and rec['mesh'] == '16x16'
    assert rec['n_devices'] == 256 and rec['kind'] == 'decode'
    mem = rec['memory']
    assert mem['argument_size_in_bytes'] == want
    assert mem['temp_size_in_bytes'] > 0
    assert rec['cost']['flops'] > 0 and rec['cost']['bytes accessed'] > 0
    assert set(rec['collectives']) == {
        'all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
        'collective-permute', 'total_bytes'}
    assert 'hlo_file' not in rec
    assert result['maxrss_gb'] < 4.0


def test_long_context_skipped_for_full_attention(result):
    assert result['skip'] == dict(
        status='skipped', reason='long_500k inapplicable: full-attention '
                                 'arch (see DESIGN.md long-context policy)')


def test_reduced_train_cell_on_small_mesh(result):
    """granite-moe reduced, B=8, S=32 on a fake (2, 2) mesh through
    ``lower``: FLOP, bytes, memory and collectives recorded."""
    t = result['train']
    assert t['cost']['flops'] > 0 and t['memory']['peak_size_in_bytes'] > \
        t['memory']['argument_size_in_bytes'] > 0
    assert t['collectives']['total_bytes'] > 0


def test_dry_run_imports_no_jax(result):
    """The dry run's process (the mesh, specs, shardings and steps all
    imported and run) holds no jax or repro module."""
    assert result['forbidden'] == []


@pytest.mark.parametrize('arch', sorted(CUT))
def test_cut_train_peak_within_twice_reference(runs, arch):
    """train_4k at full width on 16 x 16, depth cut to ``CUT``: the port's
    per-device peak at most twice the reference's dry run of the same cut
    config (the port runs eagerly and fuses nothing, so it may hold more
    transients than XLA); arctic's expert-parallel MoE runs all-to-alls."""
    port, ref = runs[0]['cut'][arch], runs[1][arch]
    assert port['peak'] <= 2 * ref, (port['peak'] / 1e9, ref / 1e9)
    if arch == 'arctic-480b':
        assert port['all_to_all'] > 0
