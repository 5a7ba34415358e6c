"""The port's mesh path on gloo CPU ranks (the cases of the reference's
``tests/test_distributed.py``, at its sizes): the sharded train step, the
int8 state, the activation spec, the checkpoint reshard across meshes,
the compressed reduction over a mesh axis, and the train driver's
restart on a debug mesh.

The reference runs them on 8 forced host devices; the port runs them as
spawned processes of one gloo group (``launch.sharding.spawn_ranks``),
each a rank of a ``DeviceMesh``.  One spawn of 4 ranks serves the step,
state and reduction checks, one of 2 ranks the driver; the parent holds
the results against the port's unsharded step (itself held against the
reference in ``tests/test_torch_train.py``) and the reference's
``restore``.

Bars: the sharded step's parameters within 1e-5 of the unsharded step's,
relative to each leaf's largest value, after each of 3 steps; the loss
and gradients with the activation spec within 1e-5 of those without it;
decode on sharded caches within 1e-5; the reshard and
the driver's restart bitwise; the compressed gradient within 2e-2 of the
exact one (the reference's bar).
"""
import numpy as np
import pytest
import torch

N_RANKS = 4
ARCH = 'granite-moe-1b-a400m'
SMALL = dict(d_model=64, vocab=512, n_heads=4, n_kv=2)   # the reference's
STEPS, TOL = 3, 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (8, 32), generator=g)
    return {'tokens': tokens, 'labels': tokens}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _steps(rank, mesh):
    """3 sharded steps (float32 state) against the unsharded step; 3 with
    int8 state; zamba2-7b's loss and gradients with and without the
    activation spec."""
    from repro_torch.configs import get_config
    from repro_torch.launch.compat import set_mesh
    from repro_torch.launch.sharding import (NamedSharding,
                                             batch_shardings, opt_shardings,
                                             param_shardings, place)
    from repro_torch.launch.steps import act_partition_spec, make_train_step
    from repro_torch.models.transformer import (init_params, train_loss,
                                                tree_leaves, tree_map,
                                                value_and_grad)
    from repro_torch.optim.adamw import adamw_init
    out = {}
    cfg = get_config(ARCH).reduced(**SMALL)
    batch = _tokens(cfg)
    for state_dtype in ('float32', 'int8'):
        params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
        ref_p = tree_map(torch.clone, params)
        ref_o = adamw_init(ref_p, state_dtype)
        opt = adamw_init(params, state_dtype)
        pshard = param_shardings(params, mesh)
        oshard = opt_shardings(opt, pshard, mesh)
        p, o = place(params, pshard), place(opt, oshard)
        step = make_train_step(cfg, state_dtype=state_dtype, device='cpu')
        errs, losses = [], []
        for _ in range(STEPS):
            with set_mesh(mesh):
                p, o, m = step(p, o, batch)
            losses.append(float(m['loss'].full_tensor()))
            if state_dtype == 'float32':
                ref_p, ref_o, _ = step(ref_p, ref_o, batch)
                whole = {k: v.full_tensor() for k, v in tree_leaves(p)}
                errs.append(max(_rel(whole[k], v)
                                for k, v in tree_leaves(ref_p)))
        out[state_dtype] = dict(
            errs=errs, losses=losses,
            params_placed=all(t.placements == ns.placements for (_, t), (
                _, ns) in zip(tree_leaves(p), tree_leaves(pshard))),
            opt_placed=_same_placements(o, oshard))
    cfg = get_config('zamba2-7b').reduced()
    act = act_partition_spec(cfg, mesh, 32)
    params = init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    p = place(params, param_shardings(params, mesh))
    runs = {}
    with set_mesh(mesh):
        b = place(_tokens(cfg, seed=2), batch_shardings(_tokens(cfg, seed=2),
                                                        mesh))
        for name, spec in (('act', tuple(NamedSharding(mesh, a)
                                         for a in act)), ('plain', None)):
            loss, grads = value_and_grad(
                lambda q: train_loss(cfg, q, b, act_sharding=spec), p)
            runs[name] = (float(loss.full_tensor()),
                          {k: g.full_tensor() for k, g in grads.items()})
    out['act'] = dict(
        spec=[tuple(a) for a in act],
        loss_diff=abs(runs['act'][0] - runs['plain'][0]),
        grad_err=max(_rel(runs['act'][1][k], v)
                     for k, v in runs['plain'][1].items()))
    return out


def _same_placements(tree, shardings):
    from repro_torch.runtime.checkpoint import _flatten
    a, b = _flatten(tree), _flatten(shardings)
    return len(a) == len(b) and all(
        ka == kb and t.placements == ns.placements
        for (ka, t), (kb, ns) in zip(a, b))


def _reshard(rank, ckpt_dir):
    """Saved from a (4,) ('data',) mesh, restored onto (2, 2) with
    P('model', 'data')."""
    from repro_torch.launch.compat import make_auto_mesh
    from repro_torch.launch.sharding import NamedSharding, P, place
    from repro_torch.runtime import checkpoint as ckpt
    tree = {'w': torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh1 = make_auto_mesh((4,), ('data',), 'cpu')
    sharded = place(tree, {'w': NamedSharding(mesh1, P('data'))})
    ckpt.save(f'{ckpt_dir}/step_00000001', sharded, 1)
    mesh2 = make_auto_mesh((2, 2), ('data', 'model'), 'cpu')
    sh2 = {'w': NamedSharding(mesh2, P('model', 'data'))}
    out = ckpt.restore(f'{ckpt_dir}/step_00000001', tree, sh2)
    return dict(bitwise=torch.equal(out['w'].full_tensor(), tree['w']),
                placed=out['w'].placements == sh2['w'].placements,
                local=tuple(out['w'].to_local().shape))


def _compressed(rank):
    """The reference's case: ``make_dp_compressed_grad(loss_fn, mesh,
    axis='pod')`` on a (2, 2) ('pod', 'data') mesh against the exact
    gradient of the whole batch."""
    from repro_torch.launch.compat import make_auto_mesh
    from repro_torch.models.transformer import value_and_grad
    from repro_torch.optim.compression import make_dp_compressed_grad
    mesh = make_auto_mesh((2, 2), ('pod', 'data'), 'cpu')

    def loss_fn(params, batch):
        return torch.mean((batch['x'] @ params['w'] - batch['y']) ** 2)

    rng = np.random.default_rng(0)
    params = {'w': torch.as_tensor(rng.standard_normal((16, 4)),
                                   dtype=torch.float32)}
    batch = {k: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
             for k, s in (('x', (32, 16)), ('y', (32, 4)))}
    exact_loss, exact = value_and_grad(lambda p: loss_fn(p, batch), params)
    loss, grads = make_dp_compressed_grad(loss_fn, mesh, axis='pod')(
        params, batch)
    return dict(rel=_rel(grads['w'], exact['w']),
                loss_rel=abs(float(loss) - float(exact_loss))
                / float(exact_loss))


def _decode(rank, mesh):
    """gemma3-1b reduced (local ring caches and a global cache), 10 greedy
    decode steps from an empty 32-slot cache, the cache placed by
    ``cache_shardings`` (sequence over 'model', head_dim over 'data'):
    each step's logits and the final cache against the same steps
    unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.launch.compat import set_mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             cache_shardings,
                                             param_shardings, place)
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, tree_leaves)
    cfg = get_config('gemma3-1b').reduced()
    params = init_params(cfg, torch.Generator().manual_seed(5), 'cpu')
    cache = init_cache(cfg, 4, 32, device='cpu')
    p = place(params, param_shardings(params, mesh))
    c = place(cache, cache_shardings(cache, mesh))
    tok = torch.arange(4)[:, None] % cfg.vocab
    errs = []
    for pos in range(10):
        want, cache = decode_step(cfg, params, cache, tok, pos)
        with set_mesh(mesh):
            t = place({'t': tok}, batch_shardings({'t': tok}, mesh))['t']
            got, c = decode_step(cfg, p, c, t, pos)
        errs.append(_rel(got.full_tensor(), want))
        tok = torch.argmax(want, -1)
    whole = dict(tree_leaves({k: v for k, v in c.items()}))
    cache_err = max(_rel(whole[k].full_tensor(), v) if v.abs().max() > 0
                    else float(whole[k].full_tensor().abs().max())
                    for k, v in tree_leaves(cache))
    return dict(errs=errs, cache_err=cache_err,
                split_dims=[pl.dim for pl in c['sub0']['k'].placements
                            if pl.is_shard()])


def _rank_work(rank, ckpt_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.compat import make_auto_mesh
    mesh = make_auto_mesh((2, 2), ('data', 'model'), 'cpu')
    return dict(steps=_steps(rank, mesh), reshard=_reshard(rank, ckpt_dir),
                compressed=_compressed(rank), decode=_decode(rank, mesh))


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from repro_torch.launch.sharding import spawn_ranks
    d = tmp_path_factory.mktemp('mesh_ckpt')
    return spawn_ranks(_rank_work, N_RANKS, str(d)), d


def test_sharded_train_step_matches_unsharded(ranks):
    """3 steps on a (2, 2) ('data', 'model') mesh, float32 state: every
    parameter within 1e-5 of the unsharded step after each step, the
    loss falls, and each leaf keeps ``param_shardings``' placements."""
    for r in ranks[0]:
        got = r['steps']['float32']
        assert len(got['errs']) == STEPS and max(got['errs']) <= TOL, got
        assert got['losses'][-1] < got['losses'][0], got['losses']
        assert got['params_placed'] and got['opt_placed']


def test_sharded_train_step_int8_state(ranks):
    """int8 moments: the step runs, the loss falls, and the moments keep
    ``opt_shardings``' placements (the QTensor fields by ``auto_spec``)."""
    for r in ranks[0]:
        got = r['steps']['int8']
        assert np.isfinite(got['losses']).all()
        assert got['losses'][-1] < got['losses'][0], got['losses']
        assert got['params_placed'] and got['opt_placed']


def test_activation_spec_changes_no_value(ranks):
    """zamba2-7b (hybrid: the reference's ``wants_sp`` holds) at S=32:
    ``train_loss`` and every gradient leaf with ``act_partition_spec``
    within 1e-5 of the same without it (relative to each leaf's largest
    value).  The gradients, not the parameters after AdamW: AdamW divides
    each update by |g| + 1e-8, so where a gradient element is near that
    eps the reduction order's rounding alone moves its update."""
    for r in ranks[0]:
        got = r['steps']['act']
        assert got['spec'] == [('data', 'model', None),
                               ('data', None, None)]
        assert got['loss_diff'] <= TOL and got['grad_err'] <= TOL, got


def test_checkpoint_reshard_across_meshes(ranks):
    """Saved from (4,) ('data',), restored onto (2, 2) with P('model',
    'data'): bitwise, with the target placements; the reference's
    ``restore`` reads the same directory bitwise."""
    from repro.runtime import checkpoint as rckpt
    for r in ranks[0]:
        assert r['reshard'] == dict(bitwise=True, placed=True, local=(4, 4))
    want = np.arange(64, dtype=np.float32).reshape(8, 8)
    out = rckpt.restore(ranks[1] / 'step_00000001',
                        {'w': np.zeros((8, 8), np.float32)})
    assert np.array_equal(np.asarray(out['w']), want)


def test_compressed_reduction_over_mesh_axis(ranks):
    """``make_dp_compressed_grad(loss_fn, mesh, axis='pod')``: within
    2e-2 of the exact gradient on every rank, the loss the whole batch's."""
    for r in ranks[0]:
        assert r['compressed']['rel'] < 2e-2, r['compressed']
        assert r['compressed']['loss_rel'] <= 1e-6, r['compressed']


def test_sharded_decode_matches_unsharded(ranks):
    """Decode on the mesh, caches sharded as ``cache_shardings`` gives
    (written on the rank that holds the slot; the softmax combined across
    the sequence's ranks): logits of 10 steps and the final cache within
    1e-5 of the unsharded decode."""
    for r in ranks[0]:
        got = r['decode']
        assert max(got['errs']) <= TOL and got['cache_err'] <= TOL, got
        assert 2 in got['split_dims'], got['split_dims']   # the sequence


DRIVER = ['--arch', 'deepseek-7b', '--reduced', '--batch', '4', '--seq',
          '16', '--log-every', '100', '--device', 'cpu']


def _driver_rank(rank, root):
    """The train driver on this rank's debug mesh: 4 steps with a
    checkpoint every 2, the same command to 6, and 6 straight."""
    torch.set_num_threads(1)
    from repro_torch.launch import train
    from repro_torch.runtime.checkpoint import _flatten, latest_step
    ck = ['--ckpt', f'{root}/run', '--ckpt-every', '2']
    train.main(DRIVER + ['--steps', '4'] + ck)
    resumed = train.main(DRIVER + ['--steps', '6'] + ck)
    straight = train.main(DRIVER + ['--steps', '6'])

    def whole(r):
        return {k: v.full_tensor().numpy() for k, v in
                _flatten({'p': r['params'], 'o': r['opt']})}
    return dict(latest=latest_step(f'{root}/run'),
                start=resumed['start_step'],
                mesh=tuple(resumed['params']['embed'].device_mesh.shape),
                resumed=whole(resumed), straight=whole(straight))


def test_train_driver_restart_on_debug_mesh(tmp_path):
    """``python -m repro_torch.launch.train`` (``--debug-mesh``, on by
    default) on 2 gloo ranks: a (1, 2) mesh; 4 steps and a checkpoint,
    then the same command resumes at 4 and ends at 6, its parameters and
    AdamW state bitwise those of 6 straight steps."""
    from repro_torch.launch.sharding import spawn_ranks
    for r in spawn_ranks(_driver_rank, 2, str(tmp_path)):
        assert r['latest'] == 6 and r['start'] == 4 and r['mesh'] == (1, 2)
        assert sorted(r['resumed']) == sorted(r['straight'])
        for k, v in r['resumed'].items():
            assert np.array_equal(v, r['straight'][k]), k
