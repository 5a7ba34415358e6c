"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the reference package or the reference's
benchmarks, and an entry point asked for the card without one raises
instead of running on the CPU."""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import snap as tsnap
from repro_torch.kernels import ops
from repro_torch.md import integrate as tmd

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / 'src' / 'repro_torch').rglob('*.py')) + \
    [ROOT / 'chip_smoke.py']


def _forbidden(name):
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'repro', 'benchmarks')


@pytest.mark.parametrize('path', FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f'{path}: imports {bad}'


def test_isolation_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {'ops.py', 'snap.py', 'integrate.py', 'chip_smoke.py',
            'serve_forces.py', 'request_queue.py', 'journal.py',
            'chaos.py', 'checkpoint.py', 'sharding.py', 'shard.py',
            'linear.py', 'registry.py', 'runner.py', 'op_passes.py',
            'memory_passes.py', 'budgets.py', 'launches.py', 'cost.py',
            'quickstart.py', 'md_nve.py', 'fit_snap.py',
            'snap_2j8.py', 'transformer.py', 'attention.py', 'moe.py',
            'ssm.py', 'layers.py', 'serve.py', 'gemma3_1b.py',
            'flash_vjp.py', 'adamw.py', 'compression.py', 'steps.py',
            'train.py', 'pipeline.py', 'resilience.py'} <= names
    assert {'optim', 'data'} <= {p.parent.name for p in FILES}


def test_isolation_scan_covers_the_mesh_modules():
    """The mesh slice's modules are in the scan above: the mesh, its
    ambient setter, the dry run, the input specs and the constraints."""
    rel = {str(p.relative_to(ROOT / 'src' / 'repro_torch')) for p in FILES
           if p.is_relative_to(ROOT / 'src' / 'repro_torch')}
    assert {'launch/compat.py', 'launch/mesh.py', 'launch/dryrun.py',
            'launch/sharding.py', 'models/specs.py',
            'models/shard_utils.py'} <= rel


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _args():
    cfg = tsnap.SnapConfig(twojmax=2, rcut=3.0)
    dx = np.full((2, 1), 1.0)
    return (cfg, np.zeros(cfg.ncoeff), 0.0, dx, dx, dx,
            np.zeros((2, 1), int), np.ones((2, 1), bool))


def test_default_device_without_card_raises(no_card):
    """Entry points default to the card and never fall back to the CPU."""
    with pytest.raises(RuntimeError, match='cuda'):
        ops.snap_force_pipeline(*_args())
    with pytest.raises(RuntimeError, match='cuda'):
        tsnap.energy_forces_adjoint(*_args())
    with pytest.raises(RuntimeError, match='cuda'):
        tsnap.energy_forces(*_args(), impl='kernel')
    state = tmd.MDState(pos=np.zeros((2, 3)), vel=np.zeros((2, 3)),
                        box=np.ones(3) * 10)
    with pytest.raises(RuntimeError, match='cuda'):
        tmd.run_nve(_args()[0], _args()[1], 0.0, state, 1, impl='kernel')


def test_md_device_engine_without_card_raises(no_card):
    """The device loop and the host-facing neighbor build default to the
    card too."""
    from repro_torch.md import cell_list as tcl
    pos = np.random.default_rng(0).uniform(0, 10, (8, 3))
    with pytest.raises(RuntimeError, match='cuda'):
        tcl.cell_neighbors_device(pos, np.full(3, 10.0), 3.0)
    state = tmd.MDState(pos=pos, vel=np.zeros((8, 3)), box=np.full(3, 10.0))
    with pytest.raises(RuntimeError, match='cuda'):
        tmd.run_nve(_args()[0], _args()[1], 0.0, state, 1, loop='device')


def test_force_service_without_card_raises(no_card):
    """The batched force entry and the server default to the card too."""
    from repro_torch.launch.request_queue import BucketTable
    from repro_torch.launch.serve_forces import ForceServer
    with pytest.raises(RuntimeError, match='cuda'):
        ForceServer(BucketTable())
    with pytest.raises(RuntimeError, match='cuda'):
        ForceServer(BucketTable(), impl='jnp')
    for impl in ('kernel', 'adjoint'):
        with pytest.raises(RuntimeError, match='cuda'):
            ops.make_batched_force_fn(_args()[0], 16, 12, impl=impl)


def test_explicit_cpu_runs_plain_versions(no_card):
    e, _, f = ops.snap_force_pipeline(*_args(), device='cpu')
    assert torch.isfinite(e) and f.device.type == 'cpu'


def test_durable_service_without_card_raises(no_card, tmp_path):
    """The chaos soak and a server's restore default to the card too, and
    run on the CPU only when asked."""
    from repro_torch.launch.chaos import run_chaos_soak
    from repro_torch.launch.request_queue import BucketTable
    from repro_torch.launch.serve_forces import ForceServer
    from repro_torch.md.fault_inject import ChaosPlan
    plan = ChaosPlan(n_requests=2, kernel_fault_step=None,
                     crash_dispatches=(), overload_burst_n=0)
    with pytest.raises(RuntimeError, match='cuda'):
        run_chaos_soak(plan, tmp_path / 'soak')
    jp = str(tmp_path / 'j.jsonl')
    with pytest.raises(RuntimeError, match='cuda'):
        ForceServer.restore(BucketTable(), jp)
    srv = ForceServer.restore(BucketTable(), jp, device='cpu')
    assert srv.device.type == 'cpu' and srv.health().replayed == 0
    rep = run_chaos_soak(plan, tmp_path / 'soak', device='cpu')
    assert rep.ok and rep.n_requests == 2, rep.violations


def test_sharded_baseline_and_fit_without_card_raise(no_card):
    """The baseline, the sharded force and fitting default to the card
    too."""
    from repro_torch.fit import FitData, descriptor_rows, fit_snap_linear
    with pytest.raises(RuntimeError, match='cuda'):
        tsnap.energy_forces(*_args(), impl='baseline')
    with pytest.raises(RuntimeError, match='cuda'):
        ops.make_sharded_force_fn(*_args()[:3])
    data = FitData(disp=np.full((2, 1, 3), 1.0), nbr_idx=np.zeros((2, 1)),
                   mask=np.ones((2, 1), bool), e_ref=0.0,
                   f_ref=np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match='cuda'):
        descriptor_rows(_args()[0], data)
    with pytest.raises(RuntimeError, match='cuda'):
        fit_snap_linear(_args()[0], [data])


def test_lm_serving_without_card_raises(no_card):
    """The language-model entry points default to the card too: the
    serving loop asked for 'cuda' raises instead of running on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tt
    cfg = get_config('gemma3-1b').reduced(n_layers=6)
    with pytest.raises(RuntimeError, match='cuda'):
        tt.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match='cuda'):
        tt.init_cache(cfg, 1, 4)
    params = tt.init_params(cfg, torch.Generator(), device='cpu')
    prompts = torch.zeros((1, 8), dtype=torch.long)   # the window: 8
    with pytest.raises(RuntimeError, match='cuda'):
        serve.generate(cfg, params, prompts, 2)
    with pytest.raises(RuntimeError, match='cuda'):
        serve.main(['--arch', 'gemma3-1b'])
    out = serve.generate(cfg, params, prompts, 2, device='cpu')
    assert out['tokens'].shape == (1, 2)


def test_lm_training_without_card_raises(no_card):
    """The training entry points default to the card too: the state, the
    step and ``train.main`` raise without one, and run on the CPU only when
    asked."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    cfg = get_config('deepseek-7b').reduced(n_layers=2, vocab=64)
    with pytest.raises(RuntimeError, match='cuda'):
        steps.init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match='cuda'):
        steps.make_train_step(cfg)
    with pytest.raises(RuntimeError, match='cuda'):
        train.main(['--arch', 'gemma3-1b', '--reduced', '--steps', '1'])
    params, opt = steps.init_train_state(cfg, torch.Generator(),
                                         device='cpu')
    tokens = torch.zeros((2, 8), dtype=torch.long)
    _, _, m = steps.make_train_step(cfg, device='cpu')(
        params, opt, {'tokens': tokens, 'labels': tokens})
    assert m['loss'].device.type == 'cpu' and torch.isfinite(m['loss'])


def test_train_debug_mesh_without_card_raises(no_card, tmp_path):
    """``launch/train.py --debug-mesh`` asks for the card by default and
    raises without one, before it makes a process group or a mesh; with
    ``--device cpu`` it trains on a one-rank debug mesh."""
    import torch.distributed as dist
    from repro_torch.launch import train
    argv = ['--arch', 'deepseek-7b', '--reduced', '--steps', '1', '--batch',
            '2', '--seq', '8', '--debug-mesh']
    with pytest.raises(RuntimeError, match='cuda'):
        train.main(argv)
    assert not dist.is_initialized()
    out = train.main(argv + ['--device', 'cpu'])
    assert len(out['losses']) == 1 and np.isfinite(out['losses']).all()
    assert out['params']['embed'].device.type == 'cpu'
    assert not dist.is_initialized()


def _isolated_rank(rank):
    """One rank of a fresh process group: the new entry points imported
    and run on the CPU, then the modules this process holds."""
    from repro_torch.fit import FitData, descriptor_rows
    from repro_torch.md.lattice import paper_box, perturb
    torch.set_num_threads(1)
    cfg = tsnap.SnapConfig(twojmax=2, rcut=4.7)
    beta = np.random.default_rng(1).normal(size=cfg.ncoeff) * 5e-3
    pos, box = paper_box(54)
    pos = perturb(pos, 0.02, seed=2)
    state = tmd.MDState(pos=pos, vel=tmd.init_velocities(54, 300.0), box=box)
    _, thermo = tmd.run_nve(cfg, beta, 0.0, state, 2, impl='baseline',
                            loop='device', skin=0.4, log_every=1, shards=2,
                            device='cpu')
    dx = np.full((2, 1), 1.0)
    e, _, f = ops.make_sharded_force_fn(cfg, beta, 0.0, device='cpu')(
        torch.as_tensor(dx), torch.as_tensor(dx), torch.as_tensor(dx),
        torch.zeros((2, 1), dtype=torch.long),
        torch.ones((2, 1), dtype=torch.bool))
    rows = descriptor_rows(cfg, FitData(
        disp=np.full((2, 1, 3), 1.0), nbr_idx=np.array([[1], [0]]),
        mask=np.ones((2, 1), bool), e_ref=0.0, f_ref=np.zeros((2, 3))),
        device='cpu')
    assert len(thermo) == 2 and np.isfinite(float(e)) and f.shape == (1, 3)
    assert np.isfinite(rows[1]).all()
    # the language-model serving loop
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_params
    lm = get_config('falcon-mamba-7b').reduced()
    out = generate(lm, init_params(lm, torch.Generator(), device='cpu'),
                   torch.zeros((1, 4), dtype=torch.long), 2, device='cpu')
    assert torch.isfinite(out['logits']).all()
    # the int8-compressed gradient sum, in this group of 2 ranks
    from repro_torch.optim.compression import quantized_psum
    total = quantized_psum(torch.full((3,), float(rank + 1)))
    assert torch.allclose(total, torch.full((3,), 3.0))
    # the analysis registry's sharded entry, inside this group of 2 ranks,
    # as `python -m repro_torch.analysis --ranks 2` runs it a rank
    from repro_torch.analysis.budgets import DEFAULT_PATH, load_budgets
    from repro_torch.analysis.runner import rank_report
    report = rank_report(rank, 'repro_torch.analysis.registry:'
                         'default_registry', 'cpu', ['force.torch.sharded'],
                         load_budgets(DEFAULT_PATH, 'cpu'))
    (entry,) = report.entries
    assert report.ok and entry.entry == 'force.torch.sharded' and \
        entry.metrics['launches'] == 2, report.table()
    return sorted(m for m in sys.modules if _forbidden(m))


def test_new_entry_points_import_nothing_of_the_reference():
    """fit, make_sharded_force_fn, run_nve(shards=2, impl='baseline'), the
    analysis suite's sharded entry (its gloo collectives allowlisted by
    name), the language-model serving loop and the compressed gradient
    sum, run in two spawned ranks (fresh processes that import only this
    module and the port), leave no jax or repro module in
    ``sys.modules``."""
    from repro_torch.launch.sharding import spawn_ranks
    assert spawn_ranks(_isolated_rank, 2) == [[], []]
