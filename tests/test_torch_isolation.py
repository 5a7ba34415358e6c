"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and an entry point
asked for the card without one raises instead of running on the CPU."""
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
    return top in ('jax', 'jaxlib', 'repro')


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
            'linear.py'} <= names


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
    return sorted(m for m in sys.modules if _forbidden(m))


def test_new_entry_points_import_nothing_of_the_reference():
    """fit, make_sharded_force_fn and run_nve(shards=2, impl='baseline'),
    run in two spawned ranks (fresh processes that import only this module
    and the port), leave no jax or repro module in ``sys.modules``."""
    from repro_torch.launch.sharding import spawn_ranks
    assert spawn_ranks(_isolated_rank, 2) == [[], []]
