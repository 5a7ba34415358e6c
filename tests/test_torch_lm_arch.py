"""The port's language-model stack (``repro_torch.models.transformer``)
against the reference's (``repro.models.transformer``) on the CPU, for
every one of the ten ``reduced()`` architectures and gemma3-1b
``reduced(n_layers=8)`` (one group and two tail layers): ``forward``
logits, ``prefill`` logits and cache, and two greedy decode steps started
from the reference's prefill cache converted to the port's
(``convert.lm_cache_from_reference``), with the weights converted by
``convert.lm_params_from_reference``.  Then checks on the port alone:
teacher forcing (decode steps against ``forward`` over the extended
sequence), the configs equal to the reference's, the serve CLI on the
CPU, and the ``ValueError`` where the reference's cache widening fails.

The same numpy weights and inputs go through both packages; the
reference's forward and decode step are jitted once per architecture and
shared by its cases.  Bars (max |port - ref| / max |ref|): 1e-4 in
float32 on logits and caches, 5e-2 for the one bfloat16 case."""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import serve as rserve
from repro.models import transformer as rt
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.models.layers import unembed

TOL = 1e-4       # float32 logits and caches
BF16_TOL = 5e-2  # the bfloat16 case
B, S, STEPS = 2, 16, 2
CASES = list(ARCHS) + ['gemma3-1b@8']


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(case, **over):
    """(reference cfg, port cfg) of a case: ``arch`` or ``arch@n_layers``."""
    arch, _, n = case.partition('@')
    if n:
        over['n_layers'] = int(n)
    return (ref_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def rel(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)),
                                                   1e-30))


def numpy_weights(rcfg, seed):
    """Numpy weights in the reference's pytree layout (its shapes from
    ``jax.eval_shape`` of its ``init_params``): matrices with std
    fan_in**-0.5, the embedding 0.3, norm scales and the SSM vectors
    0.1-0.5 (the reference's own init makes them 0)."""
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


def inputs(rcfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    front = None
    if rcfg.frontend == 'audio' or rcfg.enc_layers:
        front = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    elif rcfg.frontend == 'vision':
        front = rng.standard_normal(
            (B, rcfg.n_frontend_tokens, rcfg.d_model)).astype(np.float32)
    return tokens, front


def ref_decode_cache(rcfg, pcache):
    """The reference serve's widening (``jnp.pad`` into ``init_cache``'s
    buffers, P + STEPS long), except that cross-attention K/V keep their
    own length: the reference serve pads a VLM's patch K/V to the prompt
    length with zero keys that decode then attends to."""
    s_cross = pcache['cross_k'].shape[2] if 'cross_k' in pcache else None
    full = rt.init_cache(rcfg, B, S + STEPS, s_cross=s_cross)
    return jax.tree.map(
        lambda dst, src: jnp.pad(
            src, [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        ).astype(dst.dtype) if dst.shape != src.shape else src,
        full, pcache)


@lru_cache(maxsize=None)
def reference_run(case, dtype='float32'):
    """The reference on one case: weights, inputs, forward logits, the
    prefill cache, and STEPS greedy decode steps (their tokens, logits and
    final cache); the forward and the step jitted once."""
    rcfg, _ = configs(case, dtype=dtype)
    w = numpy_weights(rcfg, seed=len(case))
    tokens, front = inputs(rcfg, seed=len(case) + 1)
    params = jax.tree.map(jnp.asarray, w)
    fe = None if front is None else jnp.asarray(front)
    logits, pcache = jax.jit(
        lambda p, t, f: rt.forward(rcfg, p, t, frontend_embeds=f,
                                   remat=False, collect_cache=True)
    )(params, jnp.asarray(tokens), fe)
    out = dict(weights=w, tokens=tokens, front=front,
               logits=np.asarray(logits, np.float32),
               pcache=jax.tree.map(np.asarray, pcache))
    if dtype != 'float32':
        return out
    step = jax.jit(lambda p, c, t, pos: rt.decode_step(rcfg, p, c, t, pos))
    cache = ref_decode_cache(rcfg, pcache)
    tok = np.argmax(out['logits'][:, -1:], -1).astype(np.int32)
    toks, step_logits = [], []
    for i in range(STEPS):
        lg, cache = step(params, cache, jnp.asarray(tok),
                         jnp.asarray(S + i, jnp.int32))
        toks.append(tok)
        step_logits.append(np.asarray(lg))
        tok = np.argmax(step_logits[-1], -1).astype(np.int32)
    out.update(step_tokens=toks, step_logits=step_logits,
               cache=jax.tree.map(np.asarray, cache))
    return out


def port_inputs(case, dtype='float32'):
    rcfg, tcfg = configs(case, dtype=dtype)
    ref = reference_run(case, dtype)
    params = lm_params_from_reference(tcfg, ref['weights'], device='cpu')
    front = None if ref['front'] is None else torch.from_numpy(ref['front'])
    return tcfg, ref, params, torch.from_numpy(ref['tokens']).long(), front


def leaves(tree):
    return dict(tt.tree_leaves(tree))


@pytest.mark.parametrize('case', CASES)
def test_forward_matches_reference(case):
    cfg, ref, params, tokens, front = port_inputs(case)
    logits, caches = tt.forward(cfg, params, tokens, frontend_embeds=front)
    assert caches is None and logits.shape == ref['logits'].shape
    assert rel(logits, ref['logits']) <= TOL


@pytest.mark.parametrize('case', CASES)
def test_prefill_matches_reference(case):
    cfg, ref, params, tokens, front = port_inputs(case)
    last, cache = tt.prefill(cfg, params, tokens, frontend_embeds=front)
    assert rel(last, ref['logits'][:, -1:]) <= TOL
    got, want = leaves(cache), leaves(ref['pcache'])
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.shape == want[path].shape, path
        assert rel(a, want[path]) <= TOL, path


@pytest.mark.parametrize('case', CASES)
def test_decode_from_reference_prefill(case):
    """Two greedy steps from the reference's prefill cache, converted and
    widened by the port, against the reference's steps; then the caches
    both steps wrote."""
    cfg, ref, params, _, _ = port_inputs(case)
    pcache = lm_cache_from_reference(cfg, ref['pcache'], device='cpu')
    cache = tserve.widen_cache(cfg, pcache, B, S + STEPS)
    for i in range(STEPS):
        tok = torch.from_numpy(ref['step_tokens'][i]).long()
        logits, cache = tt.decode_step(cfg, params, cache, tok, S + i)
        assert rel(logits, ref['step_logits'][i]) <= TOL, i
    want = leaves(ref['cache'])
    for path, a in leaves(cache).items():
        assert rel(a, want[path]) <= TOL, path


@pytest.mark.parametrize('case', ['zamba2-7b', 'seamless-m4t-medium',
                                  'gemma3-1b@8'])
def test_transformer_module(case):
    """``TransformerLM``'s ``state_dict`` keys are the reference's pytree
    paths, dotted (the hybrid's shared block, the encoder's groups, the
    tail), and calling it gives ``forward``'s logits; so does unembedding
    ``forward(return_hidden=True)``'s hidden states."""
    cfg, ref, params, tokens, front = port_inputs(case)
    model = tt.TransformerLM(cfg, params)
    paths = {'.'.join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(ref['weights'])[0]}
    assert set(model.state_dict()) == paths
    logits, _ = tt.forward(cfg, params, tokens, frontend_embeds=front)
    assert torch.equal(model(tokens, front), logits)
    hidden, table = tt.forward(cfg, params, tokens, frontend_embeds=front,
                               return_hidden=True)
    assert torch.equal(unembed(hidden, table, cfg.softcap_final), logits)


def test_bfloat16_forward_matches_reference():
    """deepseek-7b reduced with bfloat16 compute (float32 master weights
    cast once): the logits within 5e-2."""
    cfg, ref, params, tokens, _ = port_inputs('deepseek-7b', 'bfloat16')
    cast = tt.cast_for_compute(params, torch.bfloat16)
    # >= 2-D weights are cast (a stacked norm scale too, as in the
    # reference); vectors stay float32
    assert cast['groups']['sub0']['wq'].dtype == torch.bfloat16
    assert cast['groups']['sub0']['ln1'].dtype == torch.bfloat16
    assert cast['final_ln'].dtype == torch.float32
    # a weight already cast is not copied again
    again = tt.cast_for_compute(cast, torch.bfloat16)
    assert again['embed'] is cast['embed']
    logits, _ = tt.forward(cfg, cast, tokens)
    assert logits.dtype == torch.bfloat16
    assert rel(logits, ref['logits']) <= BF16_TOL


def test_teacher_forcing():
    """gemma3-1b reduced to one group and two tail layers (ring buffers of
    window 8): a prefill of 8 tokens, then 8 decode steps fed the next
    tokens (the ring wraps), against ``forward`` over all 16 positions."""
    cfg = get_config('gemma3-1b').reduced(n_layers=8)
    params = tt.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(4))
    full, _ = tt.forward(cfg, params, tokens)
    last, pcache = tt.prefill(cfg, params, tokens[:, :8])
    cache = tserve.widen_cache(cfg, pcache, 1, 16)
    steps = [last[:, 0]]
    for t in range(8, 15):
        logits, cache = tt.decode_step(cfg, params, cache,
                                       tokens[:, t:t + 1], t)
        steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               full[:, 7:15].numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('arch', ARCHS)
def test_configs_equal_reference(arch):
    assert tuple(ARCHS) == tuple(REF_ARCHS)
    ref, port = ref_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert tt.param_shapes(port) == jax.tree.map(
        lambda s: s.shape,
        jax.eval_shape(lambda: rt.init_params(ref, jax.random.PRNGKey(0))))
    assert port.adtype == torch.bfloat16


def test_converters_reject_unknown_and_missing_leaves():
    cfg, ref, _, _, _ = port_inputs('deepseek-7b')
    w = dict(ref['weights'])
    with pytest.raises(ValueError, match='missing'):
        lm_params_from_reference(cfg, {k: v for k, v in w.items()
                                       if k != 'final_ln'}, device='cpu')
    with pytest.raises(ValueError, match='unknown'):
        lm_params_from_reference(cfg, {**w, 'extra': w['final_ln']},
                                 device='cpu')
    with pytest.raises(ValueError, match='shape'):
        lm_params_from_reference(cfg, {**w, 'final_ln': w['embed']},
                                 device='cpu')
    with pytest.raises(ValueError, match='missing'):
        lm_cache_from_reference(cfg, {}, device='cpu')


def test_serve_cli_on_cpu(capsys):
    out = tserve.main(['--arch', 'gemma3-1b', '--device', 'cpu',
                       '--batch', '2', '--prompt-len', '16', '--gen', '4'])
    assert out['tokens'].shape == (2, 4)
    assert torch.isfinite(out['logits'].float()).all()
    text = capsys.readouterr().out
    assert 'arch=gemma3-1b B=2 prompt=16 gen=4' in text
    assert 'prefill:' in text and 'decode :' in text
    # sampling at a temperature draws from the generator
    sampled = tserve.main(['--arch', 'gemma3-1b', '--device', 'cpu',
                           '--batch', '2', '--prompt-len', '16', '--gen',
                           '3', '--temperature', '0.8'])
    assert sampled['tokens'].shape == (2, 3)


def test_short_prompt_raises_where_the_reference_fails(monkeypatch):
    """gemma3-1b reduced has window 8: a 2-token prompt and 4 generated
    tokens give a local layer a prefill cache 8 wide and a decode buffer
    min(8, 6) = 6 wide.  The reference's serve fails in its pad (its
    weights taken from the forward case's run, to skip its eager init);
    the port raises a ValueError that names the window."""
    weights = reference_run('gemma3-1b')['weights']
    monkeypatch.setattr(rserve, 'init_params', lambda cfg, key: jax.tree.map(
        jnp.asarray, weights))
    argv = ['--arch', 'gemma3-1b', '--batch', '1', '--prompt-len', '2',
            '--gen', '4']
    with pytest.raises(ValueError):
        rserve.main(argv)
    with pytest.raises(ValueError, match='window 8'):
        tserve.main(argv + ['--device', 'cpu'])
