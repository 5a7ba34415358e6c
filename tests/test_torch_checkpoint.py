"""The port's checkpoints (``repro_torch.runtime.checkpoint``): the cases
of the reference's tests/test_checkpoint.py that need the asynchronous
writer and the placing ``restore``, carried over; a snapshot that no later
in-place change reaches; list leaves named and ordered as jax names them;
and checkpoints written by either package restored by the other."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as rckpt
from repro_torch.runtime import checkpoint as ckpt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        'params': {'w': torch.as_tensor(rng.normal(size=(8, 16))),
                   'b': torch.arange(16, dtype=torch.float32)},
        'opt': {'m': torch.zeros((8, 16)), 'count': torch.tensor(3)},
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_async_checkpointer(tmp_path):
    tree = _tree()
    c = ckpt.AsyncCheckpointer()
    c.save_async(tmp_path / 'step_00000002', tree, 2)
    # mutate source AFTER snapshot: saved values must be the originals
    mutated = {k: {n: x * 0 for n, x in v.items()} for k, v in tree.items()}
    c.wait()
    out = ckpt.restore(tmp_path / 'step_00000002', mutated)
    np.testing.assert_allclose(out['params']['w'].numpy(),
                               tree['params']['w'].numpy())
    assert out['opt']['count'].item() == 3


def test_async_snapshot_is_a_copy_of_cpu_tensors(tmp_path, monkeypatch):
    """``.cpu()`` of a CPU tensor is the tensor itself: an in-place change
    after ``save_async`` must not reach the checkpoint (the writer is held
    until the change is made)."""
    go = threading.Event()
    save = ckpt.save

    def held_save(*args, **kw):
        assert go.wait(timeout=30)
        save(*args, **kw)
    monkeypatch.setattr(ckpt, 'save', held_save)
    tree = _tree()
    want = [x.clone() for x in _leaves(tree)]
    arr = np.zeros(3)
    c = ckpt.AsyncCheckpointer()
    c.save_async(tmp_path / 'step_00000004', dict(t=tree, a=arr), 4)
    for x in _leaves(tree):
        x.zero_()
    arr += 1.0
    go.set()
    c.wait()
    got = ckpt.restore(tmp_path / 'step_00000004', dict(t=tree, a=arr))
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got['t']), want))
    assert not got['a'].any()


def test_async_checkpointer_reraises_worker_error(tmp_path):
    (tmp_path / 'file').write_text('not a directory')
    c = ckpt.AsyncCheckpointer()
    c.save_async(tmp_path / 'file' / 'step_00000001', _tree(), 1)
    with pytest.raises(OSError):
        c.wait()
    c.wait()                                     # the error is raised once


def test_structure_mismatch_rejected(tmp_path):
    tree = _tree()
    d = tmp_path / 'step_00000003'
    ckpt.save(d, tree, step=3)
    bad = {'params': tree['params']}  # missing opt
    with pytest.raises(ValueError, match='structure mismatch'):
        ckpt.restore(d, bad)
    wrong = dict(tree, opt=dict(tree['opt'], m=torch.zeros((4, 4))))
    with pytest.raises(ValueError, match='opt.m: checkpoint shape'):
        ckpt.restore(d, wrong)


def test_reshard_on_restore(tmp_path):
    """Restore onto other dtypes and a tree of devices (the port's form of
    the reference's resharding restore).  With only the CPU, the
    placements are trivial; the structural path is still exercised."""
    tree = _tree()
    d = tmp_path / 'step_00000009'
    ckpt.save(d, tree, step=9)
    target = dict(params=dict(w=np.zeros((8, 16), np.float32),
                              b=torch.zeros(16, dtype=torch.float64)),
                  opt=dict(m=torch.zeros((8, 16)),
                           count=np.zeros((), np.int32)))
    devices = dict(params=dict(w='cpu', b=torch.device('cpu')),
                   opt=dict(m='cpu', count='cpu'))
    out = ckpt.restore(d, target, devices)
    assert out['params']['w'].dtype == torch.float32      # numpy dtype
    assert out['params']['b'].dtype == torch.float64      # torch dtype
    assert out['opt']['count'].dtype == torch.int32
    assert all(x.device.type == 'cpu' for x in _leaves(out))
    np.testing.assert_allclose(out['params']['w'].numpy(),
                               tree['params']['w'].numpy(), rtol=1e-7)
    assert torch.equal(out['params']['b'], tree['params']['b'].double())
    one = ckpt.restore(d, tree, 'cpu')                    # one device
    assert all(torch.equal(a, b) for a, b in zip(_leaves(one),
                                                 _leaves(tree)))
    with pytest.raises(ValueError, match='structure mismatch'):
        ckpt.restore(d, tree, dict(params='cpu'))


def test_list_leaves_named_and_ordered_as_jax(tmp_path):
    """Twelve list items: ``forces.0`` .. ``forces.11`` in numeric order
    (``forces.10`` after ``forces.9``), files and names as jax writes
    them."""
    forces = [np.full((2, 3), i, np.float32) for i in range(12)]
    tree = dict(forces=forces, reservoir=np.arange(4.0))
    jax_names = ['.'.join(str(getattr(p, 'key', getattr(p, 'idx', p)))
                          for p in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [n for n, _ in ckpt._flatten(tree)] == jax_names
    ckpt.save(tmp_path / 'mine', tree, step=1)
    rckpt.save(tmp_path / 'ref', tree, step=1)
    mine = json.loads((tmp_path / 'mine' / 'manifest.json').read_text())
    ref = json.loads((tmp_path / 'ref' / 'manifest.json').read_text())
    assert mine['leaves'] == ref['leaves']
    out = ckpt.restore(tmp_path / 'mine', tree)
    assert [int(f[0, 0]) for f in out['forces']] == list(range(12))
    assert isinstance(out['forces'], list)


def test_reference_checkpoint_restores_in_port_and_back(tmp_path):
    # 32-bit leaves: jax keeps them as they are without x64 mode
    rng = np.random.default_rng(4)
    tree = dict(params=dict(w=rng.normal(size=(8, 16)).astype(np.float32)),
                forces=[rng.normal(size=(3, 3)).astype(np.float32)
                        for _ in range(11)],
                count=np.asarray(7, np.int32))
    jtree = jax.tree.map(jnp.asarray, tree)
    rckpt.save(tmp_path / 'ref', jtree, step=2)
    out = ckpt.restore(tmp_path / 'ref', tree)
    for (n, a), (_, b) in zip(ckpt._flatten(out), ckpt._flatten(tree)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes(), n

    ttree = dict(params=dict(w=torch.as_tensor(tree['params']['w'])),
                 forces=[torch.as_tensor(f) for f in tree['forces']],
                 count=torch.tensor(7, dtype=torch.int32))
    ckpt.save(tmp_path / 'mine', ttree, step=3)
    back = rckpt.restore(tmp_path / 'mine', tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
