"""The port's partition specs against the reference's, on the production
mesh geometry (16 x 16 and 2 x 16 x 16), as shape arithmetic: no device
and no process group (``FakeMesh`` objects, as
``tests/test_specs_sharding.py`` does).

Held entry for entry: every parameter leaf's spec for all ten archs, the
parameter tree's paths and shapes, ``auto_spec``, the input specs of all
40 cells (token ids are int64 in the port, int32 in the reference), the
decode caches' specs, the int8 optimizer state's specs and the activation
specs.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config as ref_config
from repro.launch import sharding as rsh
from repro.launch.steps import act_partition_spec as ref_act_spec
from repro.models import specs as rspecs
from repro.models.config import LONG_CONTEXT_OK, SHAPES
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch.steps import act_partition_spec
from repro_torch.models import specs as tspecs
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim.adamw import adamw_init


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    axis_names = ('data', 'model')
    shape = {'data': 16, 'model': 16}


class FakeMultiPod:
    axis_names = ('pod', 'data', 'model')
    shape = {'pod': 2, 'data': 16, 'model': 16}


MESHES = (FakeMesh(), FakeMultiPod())


def _spec(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (trailing Nones filled)."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {'.'.join(str(getattr(p, 'key', getattr(p, 'name', p)))
                     for p in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return _jax_leaves(rspecs.params_specs(ref_config(arch)))


@pytest.mark.parametrize('arch', ARCHS)
def test_param_specs_equal_reference(arch):
    """Every leaf of the reference's ``params_specs``: the port's
    ``_spec_for_param`` gives the reference's spec on both meshes, and
    the port's ``params_specs`` has the same paths and shapes (float32)."""
    ref = _ref_params(arch)
    mine = dict(tree_leaves(tspecs.params_specs(get_config(arch))))
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        shape = tuple(leaf.shape)
        assert tuple(mine[path].shape) == shape, path
        assert mine[path].dtype == torch.float32 and mine[path].is_meta
        names = tuple(path.split('.'))
        for mesh in MESHES:
            want = _spec(rsh._spec_for_param(names, shape, mesh), len(shape))
            got = _spec(tsh._spec_for_param(names, shape, mesh), len(shape))
            assert got == want, (path, mesh.axis_names, got, want)


@pytest.mark.parametrize('arch', ARCHS)
def test_big_params_are_sharded(arch):
    """No parameter over 64 MB stays fully replicated, on either mesh."""
    for path, leaf in tree_leaves(tspecs.params_specs(get_config(arch))):
        if int(np.prod(leaf.shape)) * 4 < 64e6:
            continue
        for mesh in MESHES:
            spec = tsh._spec_for_param(tuple(path.split('.')),
                                       tuple(leaf.shape), mesh)
            assert any(ax is not None for ax in spec), (path, leaf.shape)


def test_auto_spec_greedy():
    """The reference's four cases, and the same shapes (plus more) against
    the reference's ``auto_spec`` on both meshes."""
    mesh = FakeMesh()
    assert tsh.auto_spec((32, 64), mesh) == tsh.P('data', 'model')
    assert tsh.auto_spec((7, 64), mesh) == tsh.P(None, 'model')
    assert tsh.auto_spec((7, 5), mesh) == tsh.P(None, None)
    assert tsh.auto_spec((4, 32, 16), mesh, skip_leading=1) == \
        tsh.P(None, 'model', 'data')
    shapes = [((32, 64), 0), ((7, 64), 0), ((7, 5), 0), ((4, 32, 16), 1),
              ((16,), 0), ((48, 16, 32), 0), ((2, 128, 8, 256), 1)]
    for m in MESHES:
        for shape, lead in shapes:
            assert _spec(tsh.auto_spec(shape, m, skip_leading=lead),
                         len(shape)) == _spec(rsh.auto_spec(
                             shape, m, skip_leading=lead), len(shape))


_TOKEN_IDS = ('tokens', 'labels')


def _dtype_name(x):
    return str(x.dtype).replace('torch.', '')


@pytest.mark.parametrize('arch', ARCHS)
@pytest.mark.parametrize('shape', list(SHAPES))
def test_input_specs_cells(arch, shape):
    """Shapes and dtypes of every input equal the reference's (token ids:
    int64 here, int32 there), ``None`` for the same cells; a decode cell's
    cache leaves equal the reference's, and ``cache_shardings`` gives the
    reference's ``auto_spec(..., skip_leading=1)`` on both meshes."""
    ref = rspecs.input_specs(ref_config(arch), shape)
    mine = tspecs.input_specs(get_config(arch), shape)
    if shape == 'long_500k' and arch not in LONG_CONTEXT_OK:
        assert ref is None and mine is None
        return
    rl, ml = _jax_leaves(ref), dict(tree_leaves(mine))
    assert sorted(rl) == sorted(ml)
    for path, leaf in rl.items():
        assert tuple(ml[path].shape) == tuple(leaf.shape), path
        assert ml[path].is_meta, path
        if path in _TOKEN_IDS:
            assert str(leaf.dtype) == 'int32'
            assert ml[path].dtype == torch.int64
        else:
            assert _dtype_name(ml[path]) == str(leaf.dtype), path
    if SHAPES[shape]['kind'] != 'decode':
        return
    rcache = _jax_leaves(ref['cache'])
    for mesh in MESHES:
        got = dict(tree_leaves(tsh.cache_shardings(mine['cache'], mesh)))
        for path, leaf in rcache.items():
            want = rsh.auto_spec(leaf.shape, mesh, skip_leading=1)
            assert _spec(got[path].spec, leaf.ndim) == \
                _spec(want, leaf.ndim), (path, mesh.axis_names)


def test_opt_shardings_int8_equal_reference():
    """arctic-480b's int8 AdamW state: ``opt_shardings`` gives each
    QTensor's ``q`` and ``scale`` the reference's ``auto_spec`` of the
    reference's int8 state, on both meshes; plain moments and the count
    keep the parameter's and the replicated spec."""
    arch = 'arctic-480b'
    ref_opt = _jax_leaves(jax.eval_shape(
        lambda p: ref_adamw_init(p, 'int8'),
        rspecs.params_specs(ref_config(arch))))
    params = tspecs.params_specs(get_config(arch))
    opt = adamw_init(params, 'int8')
    mine = dict(tree_leaves({k: v for k, v in opt.items()
                             if k != 'count'}))
    for mesh in MESHES:
        pshard = tsh.param_shardings(params, mesh)
        oshard = tsh.opt_shardings(opt, pshard, mesh)
        assert oshard['count'].spec == tsh.P()
        for path, qt in mine.items():
            for field in ('q', 'scale'):
                leaf = ref_opt[f'{path}.{field}']
                assert tuple(getattr(qt, field).shape) == tuple(leaf.shape)
                got = getattr(_at(oshard, path), field).spec
                want = rsh.auto_spec(leaf.shape, mesh)
                assert _spec(got, leaf.ndim) == _spec(want, leaf.ndim), \
                    (path, field, mesh.axis_names)


def _at(tree, path):
    for k in path.split('.'):
        tree = tree[k]
    return tree


@pytest.mark.parametrize('arch', ARCHS)
def test_act_partition_spec_equal_reference(arch):
    """``act_partition_spec`` at train_4k equals the reference's on both
    meshes (None for the same archs)."""
    seq = SHAPES['train_4k']['seq']
    for mesh in MESHES:
        want = ref_act_spec(ref_config(arch), mesh, seq)
        got = act_partition_spec(get_config(arch), mesh, seq)
        if want is None:
            assert got is None
            continue
        assert [_spec(g, 3) for g in got] == [_spec(w, 3) for w in want]


def test_named_sharding_placements():
    """A spec's placements on a mesh: ``Shard(d)`` on each mesh dim the
    spec names at tensor dim ``d`` (a tuple entry names several),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    ns = tsh.NamedSharding(FakeMultiPod(), tsh.P(('pod', 'data'), None,
                                                 'model'))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    ns = tsh.NamedSharding(FakeMesh(), tsh.P(None, 'data'))
    assert ns.placements == (Shard(1), Replicate())
    assert tsh.local_shape((32, 64), ns) == (32, 4)


def test_all_40_cells_enumerated():
    assert len([(a, s) for a in ARCHS for s in SHAPES]) == 40
