"""The port's language-model layers (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU: flash attention (causal,
non-causal, GQA, softcap, a window with ``q_offset``), local attention
(S < W, W not dividing S), decode attention against a ring buffer, MoE
(with and without capacity drops, gated and GeLU), the chunked diagonal
scan, the causal conv with state, and Mamba-1/Mamba-2 (a prefill, then one
decode step from the returned state).

The same numpy inputs go through both packages, the reference's functions
jitted, in float32.  Bars: 2e-5 relative to the largest reference value
(max |port - ref| / max |ref|) for attention and MoE, whose sums run in
the same order up to the einsum's blocking; 1e-4 for the scans, which
torch computes by a log-step scan where the reference uses
``associative_scan`` (another rounding order)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as ra
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

TOL = 2e-5       # attention, MoE
SCAN_TOL = 1e-4  # chunked scans (another rounding order)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(port, np.float64) - ref))
                 / max(np.max(np.abs(ref)), 1e-30))


def normal(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def both(fn_ref, fn_port, *arrays, **kw):
    """(reference result, port result) of the same numpy inputs."""
    ref = jax.jit(partial(fn_ref, **kw))(*(jnp.asarray(a) for a in arrays))
    port = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    return ref, port


# (B, Sq, Sk, H, G, kwargs); block sizes small enough for several blocks
FLASH = {
    'causal': (2, 32, 32, 4, 4, dict(causal=True, block_q=8, block_k=16)),
    'non_causal': (2, 24, 40, 4, 4, dict(causal=False, block_q=8,
                                         block_k=10)),
    'gqa': (2, 32, 32, 8, 2, dict(causal=True, block_q=16, block_k=8)),
    'softcap': (1, 32, 32, 4, 2, dict(causal=True, softcap_val=5.0,
                                      block_q=8, block_k=8)),
    'window_q_offset': (2, 16, 32, 4, 2, dict(causal=True, window=8,
                                              q_offset=16, block_q=8,
                                              block_k=16)),
}


@pytest.mark.parametrize('case', sorted(FLASH))
def test_flash_attention(case):
    B, Sq, Sk, H, G, kw = FLASH[case]
    rng = np.random.default_rng(1)
    q, k, v = (normal(rng, B, Sq, H, 16, std=2.0),
               normal(rng, B, Sk, G, 16, std=2.0), normal(rng, B, Sk, G, 16))
    ref, port = both(ra.flash_attention, ta.flash_attention, q, k, v, **kw)
    assert port.shape == ref.shape
    assert rel(port, ref) <= TOL


@pytest.mark.parametrize('S,W', [(12, 16), (40, 16)])
def test_local_attention(S, W):
    """S < W (one chunk, the window never binds) and W not dividing S
    (padded last chunk)."""
    rng = np.random.default_rng(2)
    q, k, v = (normal(rng, 2, S, 4, 8, std=2.0), normal(rng, 2, S, 2, 8,
                                                        std=2.0),
               normal(rng, 2, S, 2, 8))
    ref, port = both(ra.local_attention, ta.local_attention, q, k, v,
                     window=W, softcap_val=20.0)
    assert rel(port, ref) <= TOL


def test_decode_attention_ring():
    """A ring buffer of 16 slots: cache_len below and at the buffer's
    length, as a scalar and per row."""
    rng = np.random.default_rng(3)
    q, kc, vc = (normal(rng, 2, 1, 8, 16), normal(rng, 2, 16, 2, 16),
                 normal(rng, 2, 16, 2, 16))
    for cache_len in (5, 16):
        ref, port = both(ra.decode_attention, ta.decode_attention, q, kc, vc,
                         cache_len=cache_len, softcap_val=30.0)
        assert rel(port, ref) <= TOL
    lens = np.array([3, 16], np.int32)
    ref = jax.jit(ra.decode_attention)(*(jnp.asarray(a) for a in
                                         (q, kc, vc, lens)))
    port = ta.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                               torch.from_numpy(lens))
    assert rel(port, ref) <= TOL


@pytest.mark.parametrize('gated', [True, False], ids=['gated', 'gelu'])
@pytest.mark.parametrize('capacity_factor', [0.5, 4.0],
                         ids=['drops', 'no_drops'])
def test_moe_ffn(gated, capacity_factor):
    d, ff, E, k, B, S = 16, 32, 4, 2, 2, 24
    rng = np.random.default_rng(4)
    x = normal(rng, B, S, d)
    router = normal(rng, d, E)
    w_in, w_out = normal(rng, E, d, ff, std=0.25), normal(rng, E, ff, d,
                                                          std=0.2)
    w_gate = normal(rng, E, d, ff, std=0.25) if gated else None
    kw = dict(top_k=k, capacity_factor=capacity_factor)
    args = [a for a in (x, router, w_in, w_gate, w_out)]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    (y_r, p_r) = jax.jit(partial(rmoe.moe_ffn, **kw))(*jargs)
    y_t, p_t = tmoe.moe_ffn(*targs, **kw)
    # the case's capacity does (or does not) drop tokens
    T = B * S
    C = max(8, min(int(capacity_factor * T * k / E), T))
    top = np.argsort(-np.asarray(p_r), axis=1, kind='stable')[:, :k]
    load = np.bincount(top.ravel(), minlength=E)
    assert (load.max() > C) == (capacity_factor < 1), (load, C)
    assert rel(p_t, p_r) <= TOL
    assert rel(y_t, y_r) <= TOL


def test_chunked_diag_scan():
    rng = np.random.default_rng(5)
    log_a = -np.abs(normal(rng, 2, 32, 3, 4, std=0.5))
    b = normal(rng, 2, 32, 3, 4)
    h0 = normal(rng, 2, 3, 4)
    (h_r, last_r) = jax.jit(partial(rssm.chunked_diag_scan, chunk=8))(
        jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))
    h_t, last_t = tssm.chunked_diag_scan(torch.from_numpy(log_a),
                                         torch.from_numpy(b),
                                         torch.from_numpy(h0), chunk=8)
    assert rel(h_t, h_r) <= SCAN_TOL and rel(last_t, last_r) <= SCAN_TOL


def test_causal_conv1d_with_state():
    rng = np.random.default_rng(6)
    x, w, st = normal(rng, 2, 5, 6), normal(rng, 4, 6), normal(rng, 2, 3, 6)
    (y_r, s_r) = jax.jit(rssm.causal_conv1d)(*map(jnp.asarray, (x, w, st)))
    y_t, s_t = tssm.causal_conv1d(*map(torch.from_numpy, (x, w, st)))
    assert rel(y_t, y_r) <= TOL and rel(s_t, s_r) == 0.0
    (y_r, _) = jax.jit(rssm.causal_conv1d)(jnp.asarray(x), jnp.asarray(w))
    y_t, _ = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    assert rel(y_t, y_r) <= TOL


def _mamba_params(cfg, kind, rng):
    p = {}
    for name, shape in rssm.mamba_param_shapes(cfg, kind).items():
        if name == 'A_log':
            p[name] = normal(rng, *shape, std=0.5)
        elif name in ('dt_bias', 'D', 'norm_w'):
            p[name] = normal(rng, *shape, std=0.5)
        else:
            p[name] = normal(rng, *shape, std=shape[0] ** -0.5)
    return p


@pytest.mark.parametrize('arch,kind', [('falcon-mamba-7b', 'mamba1'),
                                       ('zamba2-7b', 'mamba2')])
def test_mamba_prefill_then_decode(arch, kind):
    """A 20-token prefill (chunk 8: two full chunks and a padded one), then
    one decode step from the returned state; outputs and states."""
    rcfg, tcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(7)
    p = _mamba_params(rcfg, kind, rng)
    x, x1 = normal(rng, 2, 20, rcfg.d_model), normal(rng, 2, 1, rcfg.d_model)
    rfwd = getattr(rssm, f'{kind}_forward')
    tfwd = getattr(tssm, f'{kind}_forward')
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    @jax.jit
    def ref(x, x1):
        y, st = rfwd(x, jp, rcfg, chunk=8)
        y1, st1 = rfwd(x1, jp, rcfg, st)
        return y, st, y1, st1

    y_r, st_r, y1_r, st1_r = ref(jnp.asarray(x), jnp.asarray(x1))
    y_t, st_t = tfwd(torch.from_numpy(x), tp, tcfg, chunk=8)
    y1_t, st1_t = tfwd(torch.from_numpy(x1), tp, tcfg, st_t)
    for port, r in ((y_t, y_r), (st_t.conv, st_r.conv), (st_t.h, st_r.h),
                    (y1_t, y1_r), (st1_t.conv, st1_r.conv),
                    (st1_t.h, st1_r.h)):
        assert port.shape == r.shape
        assert rel(port, r) <= SCAN_TOL
