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


MOE = dict(B=8, S=16, d=16, E=4, ff=24, top_k=2, capacity_factor=0.5)
# a constant input feature whose router row favours experts 1 and 3 over 0
# and 2: data rank 0 (the first 64 tokens) overfills experts 1 and 3 (its
# own pairs dropped, all of rank 1's), leaves expert 0 part full (rank 1's
# pairs kept in the slots of data rank 1) and expert 2 under half full
# (rank 1's pairs kept in both data ranks' slots)
MOE_BIAS = (-1.0, 0.0, -3.0, 0.0)


def _moe_inputs():
    """x, router, e_in, e_gate, e_out of the expert-parallel case, float32
    numpy arrays drawn from a seed (the parent draws the same); x's first
    feature is 1 and the router's first row ``MOE_BIAS``."""
    rng = np.random.default_rng(7)
    c = MOE
    shapes = ((c['B'], c['S'], c['d']), (c['d'], c['E']),
              (c['E'], c['d'], c['ff']), (c['E'], c['d'], c['ff']),
              (c['E'], c['ff'], c['d']))
    x, router, *experts = [(rng.standard_normal(s) * (1.0 if i < 2 else 0.2))
                           .astype(np.float32) for i, s in enumerate(shapes)]
    x[..., 0] = 1.0
    router[0] = MOE_BIAS
    return [x, router, *experts]


def _moe(rank, mesh):
    """``moe_ffn`` on the mesh: x's rows over 'data', the expert weights
    placed as ``param_shardings`` places a block's, a capacity that drops
    pairs; its output, probabilities and the kept (token, choice) pairs
    (from ``_moe_on_mesh``, whose call says it ran the expert-parallel
    path) whole, this rank's data rank, and the rows of each exchange
    that are not zero, by the data rank they are sent to."""
    from repro_torch.launch.compat import set_mesh
    from repro_torch.launch.sharding import (NamedSharding, P,
                                             param_shardings, place)
    from repro_torch.models import moe, shard_utils
    x, router, e_in, e_gate, e_out = (torch.as_tensor(a)
                                      for a in _moe_inputs())
    w = {'router': router, 'e_in': e_in, 'e_gate': e_gate, 'e_out': e_out}
    w = place(w, param_shardings(w, mesh))
    xd = place(x, NamedSharding(mesh, P('data', None, None)))
    sent, kept = [], []
    a2a, on_mesh = shard_utils._all_to_all, moe._moe_on_mesh

    def count(t, *a):
        sent.append((t != 0).any(-1).reshape(t.shape[0], -1).sum(1).tolist())
        return a2a(t, *a)

    def spy(*a):
        out = on_mesh(*a)
        kept.append(out[2])
        return out
    shard_utils._all_to_all, moe._moe_on_mesh = count, spy
    try:
        with set_mesh(mesh):
            y, probs = moe.moe_ffn(
                xd, w['router'], w['e_in'], w['e_gate'], w['e_out'],
                top_k=MOE['top_k'], capacity_factor=MOE['capacity_factor'])
    finally:
        shard_utils._all_to_all, moe._moe_on_mesh = a2a, on_mesh
    return dict(y=y.full_tensor().numpy(), probs=probs.full_tensor().numpy(),
                kept=[k.full_tensor().numpy() for k in kept], sent=sent,
                data_rank=mesh.get_local_rank(0),
                local_rows=tuple(y.to_local().shape))


def _mixers(rank, mesh):
    """falcon-mamba-7b and zamba2-7b reduced (their channels split over the
    2 'model' ranks) and gemma3-1b reduced (503 words: an uneven vocabulary
    split): ``train_loss`` and every gradient on the mesh against the same
    on one rank; for the two SSM archs also the prefill logits and cache
    and one decode step from that cache."""
    from repro_torch.configs import get_config
    from repro_torch.launch.compat import set_mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             param_shardings, place)
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill, train_loss,
                                                tree_leaves, value_and_grad)
    out = {}
    for arch in ('falcon-mamba-7b', 'zamba2-7b', 'gemma3-1b'):
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(11), 'cpu')
        batch = _tokens(cfg, seed=4)
        p = place(params, param_shardings(params, mesh))
        loss1, g1 = value_and_grad(lambda q: train_loss(cfg, q, batch),
                                   params)
        with set_mesh(mesh):
            b = place(batch, batch_shardings(batch, mesh))
            loss2, g2 = value_and_grad(lambda q: train_loss(cfg, q, b), p)
        got = dict(loss=abs(float(loss2.full_tensor()) - float(loss1))
                   / abs(float(loss1)),
                   grads=max(_rel(g2[k].full_tensor(), v)
                             for k, v in g1.items()))
        if cfg.family in ('ssm', 'hybrid'):
            tok = batch['tokens'][:, :16]
            want, cache = prefill(cfg, params, tok)
            with set_mesh(mesh):
                t = place({'t': tok}, batch_shardings({'t': tok}, mesh))['t']
                have, c = prefill(cfg, p, t)
            nxt = torch.argmax(want, -1)
            want2, cache = decode_step(cfg, params, cache, nxt, 16)
            with set_mesh(mesh):
                t = place({'t': nxt}, batch_shardings({'t': nxt}, mesh))['t']
                have2, c = decode_step(cfg, p, c, t, 16)
            whole = dict(tree_leaves(c))
            got.update(prefill=_rel(have.full_tensor(), want),
                       decode=_rel(have2.full_tensor(), want2),
                       cache=max(_rel(whole[k].full_tensor(), v)
                                 for k, v in tree_leaves(cache)
                                 if v.abs().max() > 0))
        out[arch] = got
    return out


def _microbatched(rank, mesh):
    """One step of granite-moe (``SMALL``) with ``microbatches=2`` on the
    mesh and on one rank: the parameters after it, and, for every
    gradient that reaches AdamW (the float32 accumulator divided by the
    microbatches), whether its placements and dtype are its parameter's
    and float32."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.compat import set_mesh
    from repro_torch.launch.sharding import (opt_shardings, param_shardings,
                                             place)
    from repro_torch.models.transformer import (init_params, tree_leaves,
                                                tree_map)
    from repro_torch.optim.adamw import adamw_init
    cfg = get_config(ARCH).reduced(**SMALL)
    params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    ref_p = tree_map(torch.clone, params)
    ref_o = adamw_init(ref_p)
    opt = adamw_init(params)
    pshard = param_shardings(params, mesh)
    p, o = place(params, pshard), place(opt, opt_shardings(opt, pshard,
                                                           mesh))
    step = steps.make_train_step(cfg, microbatches=2, device='cpu')
    seen, update = {}, steps.adamw_update

    def spy(grads, state, params, **kw):
        for (k, g), (_, q) in zip(tree_leaves(grads), tree_leaves(params)):
            seen[k] = (str(g.placements), str(q.placements),
                       g.dtype == torch.float32)
        return update(grads, state, params, **kw)
    steps.adamw_update = spy
    try:
        with set_mesh(mesh):
            p, o, m = step(p, o, _tokens(cfg))
    finally:
        steps.adamw_update = update
    ref_p, ref_o, _ = step(ref_p, ref_o, _tokens(cfg))
    whole = {k: v.full_tensor() for k, v in tree_leaves(p)}
    return dict(seen=seen, err=max(_rel(whole[k], v)
                                   for k, v in tree_leaves(ref_p)))


def _rank_work(rank, ckpt_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.compat import make_auto_mesh
    mesh = make_auto_mesh((2, 2), ('data', 'model'), 'cpu')
    return dict(steps=_steps(rank, mesh), reshard=_reshard(rank, ckpt_dir),
                compressed=_compressed(rank), decode=_decode(rank, mesh),
                moe=_moe(rank, mesh), mixers=_mixers(rank, mesh),
                micro=_microbatched(rank, mesh))


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


def test_expert_parallel_moe_matches_reference(ranks):
    """The expert-parallel ``moe_ffn`` on the (2, 2) mesh (each rank
    routes its own rows; the kept pairs exchanged with all-to-alls) against
    ``repro.models.moe.moe_ffn`` on the same inputs, with a capacity that
    drops pairs of both data ranks and keeps pairs of both: output and
    probabilities within 1e-5 relative, the dropped pairs the same as the
    reference's (its own routing lines on its probabilities: a stable sort
    by expert, each pair's rank in its expert below the capacity), and
    data rank 1's pairs carried to the slots of both data ranks and back."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_ffn
    c = MOE
    args = [jnp.asarray(a) for a in _moe_inputs()]
    y, probs = jax.jit(lambda *a: moe_ffn(
        *a, top_k=c['top_k'], capacity_factor=c['capacity_factor']))(*args)
    T = c['B'] * c['S']
    C = max(8, min(int(c['capacity_factor'] * T * c['top_k'] / c['E']), T))
    flat = np.asarray(jax.lax.top_k(probs, c['top_k'])[1]).reshape(-1)
    order = np.argsort(flat, kind='stable')
    counts = np.bincount(flat, minlength=c['E'])
    rank_in = np.arange(flat.size) - (np.cumsum(counts) - counts)[
        flat[order]]
    kept = np.empty(flat.size, bool)
    kept[order] = rank_in < C
    kept = kept.reshape(T, c['top_k'])
    assert (~kept[:T // 2]).any() and kept[T // 2:].any()
    assert (~kept[T // 2:]).any() and kept[:T // 2].any()
    for r in ranks[0]:
        got = r['moe']
        assert len(got['kept']) == 1 and len(got['sent']) == 2
        assert got['local_rows'] == (c['B'] // 2, c['S'], c['d'])
        assert _rel(torch.as_tensor(got['y']),
                    torch.as_tensor(np.array(y))) <= TOL
        assert _rel(torch.as_tensor(got['probs']),
                    torch.as_tensor(np.array(probs))) <= TOL
        assert np.array_equal(got['kept'][0], kept)
    # dispatch: data rank 1's pairs sent to the slots of data ranks 0 and 1;
    # return: data rank 0 sends rank 1's results back
    by = {d: [r['moe']['sent'] for r in ranks[0]
              if r['moe']['data_rank'] == d] for d in (0, 1)}
    assert all(sum(s[0][j] for s in by[1]) > 0 for j in (0, 1)), by
    assert sum(s[1][1] for s in by[0]) > 0, by


def test_channel_sharded_mixers_match_one_rank(ranks):
    """falcon-mamba-7b and zamba2-7b reduced, each rank on its own rows and
    its half of the SSM channels (Mamba-2: heads): the loss and every
    gradient, the prefill logits and caches, and a decode step from them
    within 1e-5 of one rank."""
    for r in ranks[0]:
        for arch in ('falcon-mamba-7b', 'zamba2-7b'):
            got = r['mixers'][arch]
            assert max(got.values()) <= TOL, (arch, got)


def test_sharded_loss_matches_one_rank(ranks):
    """gemma3-1b reduced (its 503-word table split 252 / 251 over 'model'):
    the loss, each rank on its own rows and vocabulary slice, and every
    gradient within 1e-5 of one rank."""
    for r in ranks[0]:
        got = r['mixers']['gemma3-1b']
        assert got['loss'] <= TOL and got['grads'] <= TOL, got


def test_microbatched_step_keeps_parameter_placements(ranks):
    """A ``microbatches=2`` step on the mesh: every gradient reaching AdamW
    (its float32 accumulator over the parts) has its parameter's
    placements, so no gradient is whole where its parameter is sharded;
    the parameters after the step within 1e-5 of one rank's."""
    for r in ranks[0]:
        got = r['micro']
        assert got['err'] <= TOL, got['err']
        assert got['seen'] and all(g == q and f32 for g, q, f32
                                   in got['seen'].values()), got['seen']


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
