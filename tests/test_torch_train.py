"""The port's language-model training path against the reference on the
CPU: the losses (``models.layers``), ``train_loss`` and its gradients
(``models.transformer``, remat on and off), the flash backward
(``models.flash_vjp`` and the ``REPRO_FLASH_VJP`` switch), the train step
(``launch.steps``) and the restartable CLI (``launch.train``).

The same numpy weights and inputs go through both packages.  The
reference's gradient of ``train_loss`` is jitted once an arch, on five
archs that cover every family: gemma2-2b (local and global attention,
both softcaps), granite-moe-1b-a400m (MoE), falcon-mamba-7b (Mamba-1),
zamba2-7b (hybrid with its shared block) and llama-3.2-vision-90b (cross
attention); the other archs run on the card (``chip_smoke.py``).

Bars: the losses and their gradients 1e-6 relative (float32);
``train_loss`` and every gradient leaf 1e-4 of that leaf's largest
|value| (the CPU bar of the forward tests); remat bitwise; the flash
backward 1e-5 relative; one train step's loss 1e-5 and its parameters
1e-4 of each leaf's largest |value|; microbatches 2 against the full
batch at the reference's bars (loss rtol 1e-5, parameters rtol 1e-4, atol
1e-6); the CLI's 4 + 2 steps bitwise equal to 6 straight.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as rsteps
from repro.models import flash_vjp as rflash
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models import transformer as rt
from repro_torch.configs import get_config
from repro_torch.convert import (lm_opt_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.launch import steps, train
from repro_torch.models import attention, flash_vjp, layers, moe
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import checkpoint as ckpt

GRAD_ARCHS = ('gemma2-2b', 'granite-moe-1b-a400m', 'falcon-mamba-7b',
              'zamba2-7b', 'llama-3.2-vision-90b')
B, S = 2, 16
TOL, LOSS_TOL, FLASH_TOL = 1e-4, 1e-6, 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref):
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)),
                                                   1e-30))


def numpy_weights(rcfg, seed):
    """Numpy weights in the reference's layout: matrices with std
    fan_in**-0.5, the embedding 0.3, vectors 0.1, the SSM's A_log,
    dt_bias and D 0.5."""
    shapes = jax.eval_shape(lambda: rt.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [k.key for k in path]
        layer = s.shape[1:] if 'groups' in keys else s.shape
        if keys[-1] in ('embed', 'unembed'):
            std = 0.3
        elif keys[-1] in ('A_log', 'dt_bias', 'D'):
            std = 0.5
        elif len(layer) == 1:
            std = 0.1
        else:
            std = int(np.prod(layer[:-1])) ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def numpy_batch(rcfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {'tokens': rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32),
             'labels': rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)}
    if rcfg.frontend == 'vision':
        batch['frontend'] = rng.standard_normal(
            (b, rcfg.n_frontend_tokens, rcfg.d_model)).astype(np.float32)
    elif rcfg.frontend == 'audio' or rcfg.enc_layers:
        batch['frontend'] = rng.standard_normal(
            (b, s, rcfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(v).long() if k != 'frontend'
            else torch.from_numpy(v) for k, v in batch.items()}


def port_grads(cfg, params, batch, remat=True):
    """(loss, {path: gradient}) of the port's ``train_loss``."""
    return tt.value_and_grad(
        lambda p: tt.train_loss(cfg, p, batch, remat=remat), params)


@lru_cache(maxsize=None)
def reference_grads(arch):
    """The reference's ``jax.value_and_grad(train_loss)`` (jitted, remat
    on) on one arch's reduced config, with its weights and batch."""
    rcfg = ref_config(arch).reduced()
    w = numpy_weights(rcfg, seed=len(arch))
    batch = numpy_batch(rcfg, seed=len(arch) + 1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: rt.train_loss(rcfg, p, b)))(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, batch))
    return w, batch, float(loss), dict(tt.tree_leaves(
        jax.tree.map(np.asarray, grads)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed, V=50, d=16):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((B, S, d)) * 0.5).astype(np.float32)
    table = (rng.standard_normal((V, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return hidden, table, labels, mask


@pytest.mark.parametrize('n_chunks,cap', [(4, 0.0), (8, 30.0), (5, 0.0),
                                          (32, 0.0)],
                         ids=['chunked', 'chunked-softcap',
                              'fallback-indivisible', 'fallback-short'])
def test_chunked_lm_loss_matches_reference(n_chunks, cap):
    """Value and gradients (hidden and table): chunked, and the unchunked
    fallback where n_chunks does not divide S or exceeds it."""
    hidden, table, labels, _ = _loss_inputs(n_chunks)
    ref, (gh, gt) = jax.jit(jax.value_and_grad(
        lambda h, t, l: rlayers.chunked_lm_loss(h, t, l, cap, n_chunks),
        argnums=(0, 1)))(hidden, table, labels)
    h = torch.from_numpy(hidden).requires_grad_(True)
    t = torch.from_numpy(table).requires_grad_(True)
    loss = layers.chunked_lm_loss(h, t, torch.from_numpy(labels), cap,
                                  n_chunks)
    loss.backward()
    assert rel(loss, ref) <= LOSS_TOL
    assert rel(h.grad, gh) <= LOSS_TOL
    assert rel(t.grad, gt) <= LOSS_TOL


@pytest.mark.parametrize('masked', [False, True])
def test_cross_entropy_matches_reference(masked):
    hidden, table, labels, mask = _loss_inputs(7)
    logits = hidden @ table.T
    m = mask if masked else None
    ref, g = jax.jit(jax.value_and_grad(
        lambda x, l, w: rlayers.cross_entropy(x, l, w)))(logits, labels, m)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = layers.cross_entropy(x, torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m))
    loss.backward()
    assert rel(loss, ref) <= LOSS_TOL and rel(x.grad, g) <= LOSS_TOL
    # an all-zero mask divides by max(0, 1): the loss is 0, not NaN
    zero = layers.cross_entropy(x.detach(), torch.from_numpy(labels),
                                torch.zeros(B, S))
    assert float(zero) == 0.0


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((24, 6)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_e = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    ref = rmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(top_e), 6)
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(top_e).long(), 6)
    assert rel(got, ref) <= LOSS_TOL


# ---------------------------------------------------------------------------
# train_loss, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('arch', GRAD_ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    w, batch, ref_loss, ref_grads = reference_grads(arch)
    cfg = get_config(arch).reduced()
    params = lm_params_from_reference(cfg, w, device='cpu')
    loss, grads = port_grads(cfg, params, port_batch(batch))
    assert rel(loss, ref_loss) <= TOL
    assert sorted(grads) == sorted(ref_grads)
    worst = {path: rel(g, ref_grads[path]) for path, g in grads.items()}
    assert max(worst.values()) <= TOL, worst
    # every leaf takes part
    assert all(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize('arch', GRAD_ARCHS)
def test_remat_changes_no_bit(arch):
    """``train_loss`` with every group recomputed in the backward and with
    its activations kept: the same loss and gradients, bitwise."""
    w, batch, _, _ = reference_grads(arch)
    cfg = get_config(arch).reduced()
    params = lm_params_from_reference(cfg, w, device='cpu')
    on = port_grads(cfg, params, port_batch(batch), remat=True)
    off = port_grads(cfg, params, port_batch(batch), remat=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][p], off[1][p]) for p in on[1])


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

FLASH_CASES = {   # Sq, Sk, causal, window, q_offset, block_q, block_k
    'causal': (16, 16, True, 0, 0, 4, 8),
    'windowed': (16, 16, True, 6, 0, 8, 4),
    'q_offset': (8, 16, True, 8, 8, 4, 8),
    'full': (8, 16, False, 0, 0, 8, 8),
}


@pytest.mark.parametrize('case', FLASH_CASES)
def test_flash_mha_matches_reference_vjp(case):
    Sq, Sk, causal, window, q_offset, bq, bk = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 8)).astype(np.float32)
    g = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    out, want = jax.jit(lambda a, b, c, d: (lambda o, f: (o, f(d)))(
        *jax.vjp(lambda a, b, c: rflash.flash_mha(
            a, b, c, causal, window, q_offset, bq, bk), a, b, c)))(
        q, k, v, g)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got = flash_vjp.flash_mha(tq, tk, tv, causal, window, q_offset, bq, bk)
    got.backward(torch.from_numpy(g))
    assert rel(got, out) <= FLASH_TOL
    for t, r in zip((tq, tk, tv), want):
        assert rel(t.grad, r) <= FLASH_TOL


def test_flash_vjp_switch(monkeypatch):
    """``REPRO_FLASH_VJP=1``, read at call time, routes
    ``flash_attention`` through ``flash_mha`` unless soft-capping is on;
    outputs and gradients match plain autograd through the blockwise
    forward."""
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (1, 16, 4, 8)).astype(np.float32)) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    calls = []
    real = attention.flash_mha
    monkeypatch.setattr(attention, 'flash_mha',
                        lambda *a: calls.append(a) or real(*a))

    def run(softcap_val=0.0):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = attention.flash_attention(*xs, causal=True, block_q=4,
                                        block_k=8, softcap_val=softcap_val)
        out.backward(g)
        return [out] + [x.grad for x in xs]

    plain = run()
    assert not calls
    monkeypatch.setenv('REPRO_FLASH_VJP', '1')
    fast = run()
    assert len(calls) == 1
    for a, b in zip(fast, plain):
        assert rel(a, b.detach().numpy()) <= FLASH_TOL
    run(softcap_val=30.0)
    assert len(calls) == 1


def test_flash_vjp_train_loss_matches_reference(monkeypatch):
    """zamba2-7b's shared attention block has no softcap: with the switch
    on, ``train_loss`` and its gradients still match the reference's (run
    without it)."""
    w, batch, ref_loss, ref_grads = reference_grads('zamba2-7b')
    cfg = get_config('zamba2-7b').reduced()
    params = lm_params_from_reference(cfg, w, device='cpu')
    calls = []
    real = attention.flash_mha
    monkeypatch.setattr(attention, 'flash_mha',
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setenv('REPRO_FLASH_VJP', '1')
    loss, grads = port_grads(cfg, params, port_batch(batch))
    assert calls
    assert rel(loss, ref_loss) <= TOL
    assert max(rel(g, ref_grads[p]) for p, g in grads.items()) <= TOL


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------

STEP_CFG = dict(n_layers=6, vocab=211)


def warm_state(w, seed):
    """An AdamW state 10 steps in (numpy): m ~ N(0, 1e-3), v = (1e-2 z)^2
    + 1e-6.  From a fresh state the first update is ~lr * sign(g), which
    turns a rounding-level difference in a near-zero gradient into a full
    step; a warm v keeps the update a smooth function of the gradient."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3)
                     .astype(np.float32), w)
    v = jax.tree.map(lambda a: (np.square(rng.standard_normal(a.shape) * 1e-2)
                                + 1e-6).astype(np.float32), w)
    return {'m': m, 'v': v, 'count': np.int32(10)}


@lru_cache(maxsize=None)
def reference_step():
    """The reference's train step (lr 1e-2, jitted) once on gemma3-1b
    reduced(n_layers=6, vocab=211), B=4, S=16, tokens as labels, from
    numpy weights and a warm AdamW state."""
    rcfg = ref_config('gemma3-1b').reduced(**STEP_CFG)
    w = numpy_weights(rcfg, seed=11)
    tokens = np.random.default_rng(12).integers(
        0, rcfg.vocab, (4, 16)).astype(np.int32)
    params = jax.tree.map(jnp.asarray, w)
    opt = warm_state(w, seed=13)
    step = jax.jit(rsteps.make_train_step(rcfg, lr=1e-2))
    batch = {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(tokens)}
    new_p, new_o, m = step(params, jax.tree.map(jnp.asarray, opt), batch)
    return (w, opt, tokens,
            jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_o),
            float(m['loss']))


def _port_state(w, opt, cfg=None):
    cfg = cfg or get_config('gemma3-1b').reduced(**STEP_CFG)
    return (lm_params_from_reference(cfg, w, device='cpu'),
            lm_opt_state_from_reference(cfg, opt, device='cpu'))


def test_train_step_matches_reference():
    w, opt, tokens, ref_p, ref_o, ref_loss = reference_step()
    cfg = get_config('gemma3-1b').reduced(**STEP_CFG)
    params, state = _port_state(w, opt)
    step = steps.make_train_step(cfg, lr=1e-2, device='cpu')
    batch = {'tokens': tokens, 'labels': tokens}
    params, state, m = step(params, state, batch)
    assert rel(m['loss'], ref_loss) <= 1e-5
    ref_p, ref_m = dict(tt.tree_leaves(ref_p)), dict(tt.tree_leaves(
        ref_o['m']))
    worst = {p: rel(t, ref_p[p]) for p, t in tt.tree_leaves(params)}
    assert max(worst.values()) <= TOL, worst
    assert max(rel(t, ref_m[p]) for p, t in tt.tree_leaves(state['m'])) \
        <= TOL
    assert int(state['count']) == int(ref_o['count']) == 11


def test_train_step_improves_loss():
    """The reference's system test on the port: four steps at lr 1e-2
    from a fresh AdamW state lower the loss."""
    w, opt, tokens, _, _, _ = reference_step()
    cfg = get_config('gemma3-1b').reduced(**STEP_CFG)
    params, _ = _port_state(w, opt)
    state = adamw_init(params)
    step = steps.make_train_step(cfg, lr=1e-2, device='cpu')
    batch = {'tokens': tokens, 'labels': tokens}
    losses = []
    for _ in range(4):
        params, state, m = step(params, state, batch)
        losses.append(float(m['loss']))
    assert losses[-1] < losses[0], losses


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation over 2 microbatches against the full batch
    (deepseek-7b reduced(n_layers=2, vocab=127), B=4, S=16), at the
    reference's bars, every leaf."""
    cfg = get_config('deepseek-7b').reduced(n_layers=2, vocab=127)
    gen = torch.Generator().manual_seed(0)
    params0, _ = steps.init_train_state(cfg, gen, device='cpu')
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    batch = {'tokens': tokens, 'labels': tokens}
    outs = {}
    for mb in (1, 2):
        params = tt.tree_map(torch.clone, params0)
        opt = adamw_init(params, 'float32')
        step = steps.make_train_step(cfg, microbatches=mb, device='cpu')
        new_p, _, m = step(params, opt, batch)
        outs[mb] = (float(m['loss']), new_p)
    np.testing.assert_allclose(outs[1][0], outs[2][0], rtol=1e-5)
    for (path, a), (_, b) in zip(tt.tree_leaves(outs[1][1]),
                                 tt.tree_leaves(outs[2][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match='microbatches'):
        steps.make_train_step(cfg, microbatches=3, device='cpu')(
            params0, adamw_init(params0), batch)


def test_prefill_and_decode_steps():
    cfg = get_config('gemma3-1b').reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(3))
    last, cache = steps.make_prefill_step(cfg)(params, {'tokens': tokens})
    want, _ = tt.prefill(cfg, params, tokens)
    assert torch.equal(last, want)
    from repro_torch.launch.serve import widen_cache
    cache = widen_cache(cfg, cache, 2, 10)
    logits, _ = steps.make_decode_step(cfg)(params, cache,
                                            torch.argmax(last, -1), 8)
    assert logits.shape == (2, 1, cfg.vocab)


def test_train_cli_restart(tmp_path, capsys):
    """The reference's restart test of its train CLI, on the port
    (``--device cpu``, in process): 4 steps with a checkpoint every 2,
    then the same command to 6 steps resumes from step 4 — ``latest_step``
    is 6, and the parameters and AdamW state equal 6 straight steps
    bitwise."""
    argv = ['--arch', 'gemma3-1b', '--reduced', '--steps', '4', '--batch',
            '8', '--seq', '32', '--ckpt', str(tmp_path / 'run'),
            '--ckpt-every', '2', '--device', 'cpu']
    first = train.main(argv)
    assert ckpt.latest_step(tmp_path / 'run') == 4
    argv[argv.index('--steps') + 1] = '6'
    resumed = train.main(argv)
    assert resumed['start_step'] == 4 and len(resumed['losses']) == 2
    assert ckpt.latest_step(tmp_path / 'run') == 6
    assert 'restoring step 4' in capsys.readouterr().out
    straight = train.main(argv[:argv.index('--ckpt')] + ['--device', 'cpu'])
    assert straight['start_step'] == 0 and len(straight['losses']) == 6
    assert straight['losses'][:4] == first['losses']
    assert straight['losses'][4:] == resumed['losses']
    for tree in ('params', 'opt'):
        a, b = (dict(ckpt._flatten(r[tree])) for r in (resumed, straight))
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), tree


def test_train_cli_policy_int8_state(tmp_path):
    """arctic-480b reduced runs under its policy (bfloat16 parameters,
    int8 moments, 4 microbatches) and resumes from its int8 checkpoint
    bitwise."""
    argv = ['--arch', 'arctic-480b', '--reduced', '--steps', '2', '--batch',
            '4', '--seq', '16', '--ckpt', str(tmp_path / 'run'),
            '--ckpt-every', '1', '--device', 'cpu']
    train.main(argv)
    argv[argv.index('--steps') + 1] = '3'
    resumed = train.main(argv)
    straight = train.main(argv[:argv.index('--ckpt')] + ['--device', 'cpu'])
    emb = resumed['params']['embed']
    assert emb.dtype == torch.bfloat16
    m = resumed['opt']['m']['embed']
    assert m.q.dtype == torch.int8 and m.scale.dtype == torch.float32
    for tree in ('params', 'opt'):
        a, b = (dict(ckpt._flatten(r[tree])) for r in (resumed, straight))
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    assert np.isfinite(resumed['losses']).all()
