"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and an entry point
asked for the card without one raises instead of running on the CPU."""
import ast
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
    assert {'ops.py', 'snap.py', 'integrate.py', 'chip_smoke.py'} <= names


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


def test_explicit_cpu_runs_plain_versions(no_card):
    e, _, f = ops.snap_force_pipeline(*_args(), device='cpu')
    assert torch.isfinite(e) and f.device.type == 'cpu'
