"""The port's optimizer, gradient compression, token streams, resilience
policies and checkpoints of optimizer state, against the reference on the
CPU: ``optim.adamw`` (int8 block quantization, one AdamW update with
float32 and int8 moments, the global norm), ``optim.compression`` on two
spawned gloo ranks, ``data.pipeline``, ``runtime.resilience``, and
``runtime.checkpoint`` with ``QTensor`` and bfloat16 leaves.

Bars: float32 parameters and moments 1e-6 relative to the leaf's largest
|value|; int8 values equal except where the value before rounding lies
within 1e-6 (relative) of a half step, which the test checks; scales
1e-6; ``quantized_psum`` 1e-6 against the reference's (run under
``jax.vmap`` with a named axis), the compressed gradient < 0.02 relative
to the exact one (``tests/test_distributed.py``'s bar); tokens and
policy outcomes exactly the reference's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data import pipeline as rpipe
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro.runtime import checkpoint as rckpt
from repro.runtime import resilience as rres
from repro_torch.configs import get_config
from repro_torch.convert import lm_opt_state_from_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.sharding import spawn_ranks
from repro_torch.models.transformer import (param_shapes, tree_from_paths,
                                            tree_leaves)
from repro_torch.optim import adamw, compression
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import resilience as tres

TOL = 1e-6
SHAPES = {'w': (6, 200), 'b': (200,), 'blk': {'e': (2, 3, 130),
                                              'f': (4, 128)}}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref):
    port = np.asarray(port.detach().double().numpy() if
                      isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)),
                                                   1e-30))


def _tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        x = rng.standard_normal(shape) * scale
        return (np.square(x) + 1e-4 * scale ** 2 if positive
                else x).astype(np.float32)
    return jax.tree.map(leaf, SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _half_step_ok(got_q, want_q, pre):
    """Equal int8 values, except elements whose value before rounding
    (``pre``, float64) lies within 1e-6 relative of a half step."""
    diff = np.asarray(got_q) != np.asarray(want_q)
    frac = np.abs(np.abs(pre) - np.floor(np.abs(pre)) - 0.5)
    near = frac <= TOL * np.maximum(np.abs(pre), 1.0)
    return bool(np.all(near[diff])), int(diff.sum())


# ---------------------------------------------------------------------------
# int8 quantization, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(5, 300), (3, 128), (7,), (2, 2, 129)])
def test_quantize_i8_matches_reference(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    x.flat[3] = 0.0
    rq, rs, rn = radamw.quantize_i8(jnp.asarray(x))
    q, s, n = adamw.quantize_i8(torch.from_numpy(x))
    assert n == rn and q.dtype == torch.int8 and q.shape == rq.shape
    assert rel(s, rs) <= TOL
    pre = np.pad(x.astype(np.float64), [(0, 0)] * (x.ndim - 1)
                 + [(0, q.shape[-2] * 128 - shape[-1])]).reshape(
                     q.shape) / np.asarray(rs, np.float64)
    ok, n_diff = _half_step_ok(q.numpy(), rq, pre)
    assert ok, n_diff
    back = adamw.dequantize_i8(q, s, n)
    assert back.shape == shape
    assert rel(back, radamw.dequantize_i8(rq, rs, rn)) <= TOL


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 122])
    q, s, _ = adamw.quantize_i8(x)
    assert float(s.flatten()[0]) == 1.0
    assert q.flatten()[:6].tolist() == [127, 0, 2, 2, 0, -2]


def _reference_update(grads, state, params, state_dtype):
    fn = jax.jit(lambda g, s, p: radamw.adamw_update(
        g, s, p, lr=1e-2, state_dtype=state_dtype))
    return jax.tree.map(np.asarray, fn(grads, state, params))


def test_adamw_update_float32_matches_reference():
    """One update from a warm state (count 4, nonzero moments), the
    gradients clipped (norm > 1), decay on the >= 2-D leaves only."""
    params, grads = _tree(0, 0.1), _tree(1, 0.3)
    state = {'m': _tree(2, 1e-2), 'v': _tree(3, 1e-2, positive=True),
             'count': np.int32(4)}
    rp, rs, rm = _reference_update(*(jax.tree.map(jnp.asarray, t) for t in
                                     (grads, state, params)), 'float32')
    tstate = {'m': _torch(state['m']), 'v': _torch(state['v']),
              'count': torch.tensor(4, dtype=torch.int32)}
    tp, ts, tm = adamw.adamw_update(_torch(grads), tstate, _torch(params),
                                    lr=1e-2)
    assert float(rm['grad_norm']) > 1.0
    assert rel(tm['grad_norm'], rm['grad_norm']) <= TOL
    assert rel(adamw.global_norm(_torch(grads)),
               radamw.global_norm(jax.tree.map(jnp.asarray, grads))) <= TOL
    for port, ref in ((tp, rp), (ts['m'], rs['m']), (ts['v'], rs['v'])):
        ref = dict(tree_leaves(ref))
        for path, t in tree_leaves(port):
            assert rel(t, ref[path]) <= TOL, path
    assert int(ts['count']) == int(rs['count']) == 5
    # the update wrote into the tensors it was given
    assert tp is not None and ts is tstate


def test_adamw_update_int8_matches_reference():
    """One update with int8 moments from a warm int8 state (the
    reference's quantization of random moments, converted): parameters
    1e-6, int8 values equal but at half steps, scales 1e-6."""
    params, grads = _tree(4, 0.1), _tree(5, 0.3)
    m, v = _tree(6, 1e-2), _tree(7, 1e-2, positive=True)

    def q8(t):
        return jax.tree.map(lambda a: radamw.QTensor(
            *radamw.quantize_i8(jnp.asarray(a))[:2]), t)
    state = {'m': q8(m), 'v': q8(v), 'count': jnp.asarray(4, jnp.int32)}
    cfg_state = jax.tree.map(np.asarray, state)
    rp, rs, _ = _reference_update(jax.tree.map(jnp.asarray, grads), state,
                                  jax.tree.map(jnp.asarray, params), 'int8')

    def port_q8(tree):
        return tree_from_paths({p: adamw.QTensor(*(torch.from_numpy(
            np.array(a)) for a in qt)) for p, qt in tree_leaves(tree)})
    tstate = {'m': port_q8(cfg_state['m']), 'v': port_q8(cfg_state['v']),
              'count': torch.tensor(4, dtype=torch.int32)}
    tp, ts, _ = adamw.adamw_update(_torch(grads), tstate, _torch(params),
                                   lr=1e-2, state_dtype='int8')
    ref_p = dict(tree_leaves(rp))
    for path, t in tree_leaves(tp):
        assert rel(t, ref_p[path]) <= TOL, path
    # the moments before rounding, recomputed in float64 from the inputs
    gn = np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                     for _, a in tree_leaves(grads)))
    clip = min(1.0, 1.0 / gn)
    flat_g = dict(tree_leaves(grads))
    n_diff = 0
    for key, b in (('m', 0.9), ('v', 0.95)):
        ref_q = dict(tree_leaves(rs[key]))
        old_q = dict(tree_leaves(cfg_state[key]))
        for path, qt in tree_leaves(ts[key]):
            rq, rsc = ref_q[path]
            assert isinstance(qt, adamw.QTensor)
            assert rel(qt.scale, rsc) <= TOL, path
            g = flat_g[path].astype(np.float64) * clip
            g = g if key == 'm' else np.square(g)
            old = np.asarray(radamw.dequantize_i8(
                *old_q[path], g.shape[-1]), np.float64)
            new = b * old + (1 - b) * g
            pre = np.pad(new, [(0, 0)] * (new.ndim - 1)
                         + [(0, rq.shape[-2] * 128 - new.shape[-1])]
                         ).reshape(rq.shape) / np.asarray(rsc, np.float64)
            ok, k = _half_step_ok(qt.q.numpy(), rq, pre)
            assert ok, (key, path, k)
            n_diff += k
    assert n_diff <= 4


# ---------------------------------------------------------------------------
# checkpoints of optimizer state
# ---------------------------------------------------------------------------

def test_checkpoint_holds_int8_state(tmp_path):
    """``adamw_init(..., 'int8')``'s tree (``QTensor`` leaves) saves with the
    reference's leaf names (``m.w.q``, ``m.w.scale``) and restores into a
    fresh state, bitwise; the reference reads the file by name."""
    params = _torch(_tree(8, 0.1))
    state = adamw.adamw_init(params, 'int8')
    adamw.adamw_update(_torch(_tree(9, 0.3)), state, params,
                       state_dtype='int8')
    ref_names = [n for n, _ in rckpt._flatten_with_paths(radamw.adamw_init(
        jax.tree.map(jnp.asarray, _tree(8, 0.1)), 'int8'))[0]]
    names = [n for n, _ in ckpt._flatten(state)]
    assert names == ref_names
    assert 'm.w.q' in names and 'v.blk.e.scale' in names
    ckpt.save(tmp_path / 'step_00000001', {'opt': state}, 1)
    fresh = adamw.adamw_init(_torch(_tree(8, 0.1)), 'int8')
    out = ckpt.restore(tmp_path / 'step_00000001', {'opt': fresh})['opt']
    assert isinstance(out['m']['w'], adamw.QTensor)
    got, want = ckpt._flatten(out), ckpt._flatten(state)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    leaves, _ = rckpt.restore_named(tmp_path / 'step_00000001')
    assert np.array_equal(leaves['opt.m.w.q'], state['m']['w'].q.numpy())


def test_checkpoint_bfloat16_leaves_across_packages(tmp_path):
    """bfloat16 leaves: the port writes the reference's file format (raw
    2-byte values, 'bfloat16' in the manifest) and restores a file the
    reference wrote, bitwise."""
    x = np.random.default_rng(10).standard_normal((3, 5)).astype(np.float32)
    ref = jnp.asarray(x, jnp.bfloat16)
    rckpt.save(tmp_path / 'ref', {'p': ref}, 1)
    out = ckpt.restore(tmp_path / 'ref', {'p': torch.zeros(
        (3, 5), dtype=torch.bfloat16)})['p']
    port = torch.from_numpy(x).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, port)
    ckpt.save(tmp_path / 'port', {'p': port}, 1)
    for d in ('ref', 'port'):
        leaves, manifest = rckpt.restore_named(tmp_path / d)
        assert manifest['leaves'][0]['dtype'] == 'bfloat16'
        assert leaves['p'].tobytes() == np.asarray(ref).tobytes()


def test_opt_state_converter_checks_shapes():
    cfg = get_config('gemma3-1b').reduced(n_layers=6, vocab=211)
    w = tree_from_paths({p: np.zeros(s, np.float32)
                         for p, s in tree_leaves(param_shapes(cfg))})
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p: radamw.adamw_init(p, 'int8'))(w))
    state = lm_opt_state_from_reference(cfg, ref, device='cpu')
    assert isinstance(state['m']['embed'], adamw.QTensor)
    assert state['count'].dtype == torch.int32
    bad = dict(ref, m=dict(ref['m'], embed=ref['m']['final_ln']))
    with pytest.raises(ValueError, match='embed'):
        lm_opt_state_from_reference(cfg, bad, device='cpu')
    with pytest.raises(ValueError, match='missing'):
        lm_opt_state_from_reference(
            cfg, dict(ref, v={k: x for k, x in ref['v'].items()
                              if k != 'embed'}), device='cpu')


# ---------------------------------------------------------------------------
# compressed reduction on two gloo ranks
# ---------------------------------------------------------------------------

N_RANKS = 2


def _linear_case():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((16, 4)).astype(np.float32),
            rng.standard_normal((32, 16)).astype(np.float32),
            rng.standard_normal((32, 4)).astype(np.float32))


def _psum_inputs():
    rng = np.random.default_rng(12)
    return rng.standard_normal((N_RANKS, 5, 33)).astype(np.float32)


def _compression_rank(rank):
    """One rank: ``quantized_psum`` of its slice, of a tree, and the
    compressed data-parallel gradient of a linear least-squares loss on
    its half of the batch."""
    x = torch.from_numpy(_psum_inputs()[rank])
    out = compression.quantized_psum(x)
    tree = compression.quantized_psum_tree({'a': {'b': x}, 'c': x * 2})
    w, xs, ys = _linear_case()
    n = xs.shape[0] // N_RANKS
    batch = {'x': torch.from_numpy(xs[rank * n:(rank + 1) * n]),
             'y': torch.from_numpy(ys[rank * n:(rank + 1) * n])}

    def loss_fn(params, b):
        return torch.mean((b['x'] @ params['w'] - b['y']) ** 2)
    loss, grads = compression.make_dp_compressed_grad(loss_fn)(
        {'w': torch.from_numpy(w)}, batch)
    return dict(psum=out.numpy(), tree_b=tree['a']['b'].numpy(),
                tree_c=tree['c'].numpy(), q_dtype=str(out.dtype),
                loss=float(loss), grad=grads['w'].numpy())


def test_compressed_reduction_on_two_ranks():
    results = spawn_ranks(_compression_rank, N_RANKS)
    xs = _psum_inputs()
    ref = np.asarray(jax.vmap(lambda x: rcomp.quantized_psum(x, 'i'),
                              axis_name='i')(jnp.asarray(xs)))
    ref2 = np.asarray(jax.vmap(lambda x: rcomp.quantized_psum(2 * x, 'i'),
                               axis_name='i')(jnp.asarray(xs)))
    w, bx, by = _linear_case()

    def loss_fn(p):
        return jnp.mean((jnp.asarray(bx) @ p - jnp.asarray(by)) ** 2)
    exact_loss, exact = jax.value_and_grad(loss_fn)(jnp.asarray(w))
    exact = np.asarray(exact)
    for r in results:
        assert rel(r['psum'], ref[0]) <= TOL
        assert np.array_equal(r['tree_b'], r['psum'])
        assert rel(r['tree_c'], ref2[0]) <= TOL
        err = np.abs(r['grad'] - exact).max() / np.abs(exact).max()
        assert err < 0.02, err
        assert abs(r['loss'] - float(exact_loss)) <= TOL * float(exact_loss)
    assert np.array_equal(results[0]['grad'], results[1]['grad'])


def test_compression_needs_a_process_group():
    with pytest.raises(RuntimeError, match='process group'):
        compression.quantized_psum(torch.ones(3))


# ---------------------------------------------------------------------------
# token streams and resilience policies: the reference's outcomes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('step,rank,world', [(0, 0, 1), (3, 1, 4), (7, 3, 4),
                                             (2, 1, 2)])
def test_synthetic_tokens_match_reference(step, rank, world):
    kw = dict(vocab=1000, seq=16, global_batch=8, rank=rank, world=world,
              step=step)
    ref, port = rpipe.SyntheticTokens(**kw), tpipe.SyntheticTokens(**kw)
    for _ in range(2):
        a, b = ref.next_batch(), port.next_batch()
        for k in ('tokens', 'labels'):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert ref.state() == port.state()
    # a restore onto another topology continues the same global stream
    ref.restore({'step': 1}, rank=0, world=2)
    port.restore({'step': 1}, rank=0, world=2)
    assert np.array_equal(ref.next_batch()['tokens'],
                          port.next_batch()['tokens'])
    with pytest.raises(ValueError, match='split'):
        tpipe.SyntheticTokens(vocab=10, seq=4, global_batch=6, world=4)


def test_memmap_tokens_match_reference(tmp_path):
    path = tmp_path / 'tokens.bin'
    np.random.default_rng(13).integers(0, 500, 1000).astype(np.int32) \
        .tofile(path)
    for rank, world in ((0, 1), (1, 2)):
        kw = dict(path=str(path), vocab=500, seq=16, global_batch=8,
                  rank=rank, world=world)
        ref, port = rpipe.MemmapTokens(**kw), tpipe.MemmapTokens(**kw)
        for _ in range(10):   # wraps around the file's 62 rows
            a, b = ref.next_batch(), port.next_batch()
            assert all(np.array_equal(a[k], b[k]) for k in a)
        ref.restore({'step': 3})
        port.restore({'step': 3})
        assert np.array_equal(ref.next_batch()['labels'],
                              port.next_batch()['labels'])


@pytest.mark.parametrize('mod', [rres, tres], ids=['reference', 'port'])
def test_resilience_outcomes(mod):
    """``tests/test_runtime.py``'s cases, on both packages."""
    mon = mod.HeartbeatMonitor(['w0', 'w1', 'w2'], timeout_s=10)
    for w in ('w0', 'w1', 'w2'):
        mon.beat(w, now=0.0)
    mon.beat('w0', 9.0)
    mon.beat('w1', 9.0)
    assert mon.dead(now=12.0) == {'w2'}
    assert mon.alive(now=12.0) == {'w0', 'w1'}
    late = mod.HeartbeatMonitor(['w0', 'w1'], timeout_s=10, now=100.0)
    assert late.alive(now=105.0) == {'w0', 'w1'}
    assert late.dead(now=109.9) == set()
    late.beat('w0', now=108.0)
    assert late.dead(now=111.0) == {'w1'}
    pol = mod.StragglerPolicy(threshold=1.5, window=10, patience=5)
    for step in range(10):
        durations = {f'w{i}': 1.0 for i in range(8)}
        durations['w3'] = 2.5
        if step % 3 == 0:
            durations['w5'] = 2.0
        pol.record_step(durations)
    assert pol.stragglers() == {'w3'}
    full = mod.plan_elastic_mesh(64, model_axis=16, chips_per_worker=4)
    shrunk = mod.plan_elastic_mesh(61, model_axis=16, prev_workers=64,
                                   chips_per_worker=4)
    assert full.mesh_shape == (16, 16) and not full.needs_reshard
    assert shrunk.mesh_shape == (8, 16) and shrunk.needs_reshard
    assert mod.plan_elastic_mesh(3, model_axis=16, chips_per_worker=4) is None
    log = mod.ResilienceLog()
    log.record(1, 'straggler', 'w3')
    log.record(2, 'worker_lost', 'w2')
    log.record(3, 'straggler', 'w3')
    assert log.summary() == {'straggler': 2, 'worker_lost': 1}
