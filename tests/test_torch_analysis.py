"""The port's static-analysis suite (``repro_torch.analysis``) on the CPU.

Three groups, as the reference's ``tests/test_analysis.py``:

- the registry against the reference's: the same example inputs bitwise,
  each port force entry's output against one jitted call of the
  reference's ``force.jnp.adjoint`` build (f64 1e-10, f32 1e-5, bf16
  1e-2), every reference entry present under the name mapping
  ``jnp`` -> ``torch``, the checked-in ``cpu`` budgets covering it, and
  the whole CPU registry clean against them;
- seeded violations, one per reference case (``host-callback-hot`` is
  ``host-sync-hot`` here) plus two of the port's own (a kernel launched
  twice a call, a cache miss on a second call), each through the pass
  and through the CLI's exit code;
- the allowlist, the budget ratchet and the CLI's JSON report.

The reference's ``weak-type-arg`` and ``unhashable-static`` have no
meaning in an eager PyTorch program (no weak types, no static arguments
of a jit cache) and are dropped; its broadcast pass is not used (it
fails under the installed jax).  torch runs on one thread; no process is
spawned and no reference Pallas kernel runs.
"""

import functools
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import registry as rreg
from repro_torch.analysis import launches
from repro_torch.analysis import registry as treg
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.budgets import (DEFAULT_PATH, check_budgets,
                                          load_budgets, make_budgets)
from repro_torch.analysis.registry import Built, DtypePolicy, EntryPoint
from repro_torch.analysis.retrace import (assert_trace_count, record_trace,
                                          trace_count)
from repro_torch.analysis.runner import analyze_entry, run_registry
from repro_torch.core.tables import device_table
from repro_torch.kernels.snap_u import snap_u_half


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# seeded-violation registry (loaded by the CLI via --registry file.py:attr)
# ---------------------------------------------------------------------------

def _host_sync_entry():
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x):
            c = x
            for _ in range(2):
                with launches.hot():
                    float(c[0])                    # the seeded violation
                    c = c * 1.5
            return c
        return Built(fn, (torch.ones(4),), counter)
    return EntryPoint(name='seed.host_sync', build=build)


def _drift_entry():
    def build(seed):
        counter, built = {}, {}

        def fn(x):
            # one build a signature, as a serving bucket's function is
            # built once a shape class
            if x.dtype not in built:
                record_trace(counter)
                built[x.dtype] = lambda t: t * 2
            return built[x.dtype](x)
        # dtype depends on the build seed: the unpinned-default drift that
        # makes production traffic miss every cache keyed on it
        dt = torch.float32 if seed == 0 else torch.float64
        return Built(fn, (torch.ones(8, dtype=dt),), counter)
    return EntryPoint(name='seed.drift', build=build)


_F64_TABLE = np.linspace(0.0, 1.0, 16)          # a float64 table


def _upcast_entry(allow=frozenset()):
    def build(seed):
        counter = {}
        record_trace(counter)
        table = torch.as_tensor(_F64_TABLE)      # uploaded once, float64

        def fn(x):
            return x * table                     # f32 * f64 -> upcast
        return Built(fn, (torch.ones(16),), counter)
    return EntryPoint(name='seed.upcast', build=build,
                      policy=DtypePolicy(allow_f64=False), allow=allow)


def _bf16_entry():
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x):
            return (x.to(torch.bfloat16) * 2).to(torch.float32)
        return Built(fn, (torch.ones(8),), counter)
    return EntryPoint(name='seed.bf16', build=build,
                      policy=DtypePolicy(mxu_dtype=None))


def _broadcast_entry():
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x):
            # 512 * 4096 * 4 = 8 MiB materialized from a [512, 1] column
            return x[:, None].expand(512, 4096).contiguous()
        return Built(fn, (torch.ones(512),), counter)
    return EntryPoint(name='seed.broadcast', build=build)


def _disp(lanes=128, live=16, nnbor=3):
    """[nnbor, 4, lanes] plane-layout displacements, ``live`` lanes with
    neighbors, the rest dead (r = 1.5, masked out)."""
    d = torch.zeros((nnbor, 4, lanes), dtype=torch.float64)
    d[:, 0, :] = 1.5
    g = torch.Generator().manual_seed(0)
    d[:, :3, :live] = torch.rand((nnbor, 3, live), generator=g,
                                 dtype=torch.float64) + 0.5
    d[:, 3, :live] = 1.0
    return d


def _u_entry(name, calls, **kw):
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(disp):
            return [snap_u_half(disp, twojmax=2, rcut=3.0)
                    for _ in range(calls)]
        return Built(fn, (_disp(),), counter)
    return EntryPoint(name=name, build=build,
                      policy=DtypePolicy(allow_f64=True), **kw)


def _padwaste_entry():
    # 16 live atoms on the 128-lane plane layout: 87.5 % of the U
    # kernel's operations on dead lanes
    return _u_entry('seed.padwaste', 1, pad_dims={128: 16},
                    pad_waste_limit=0.5)


def _launches_entry():
    # the U stage launched twice an evaluation (a split stage or a retry)
    return _u_entry('seed.launches', 2, launches={'snap_u_half': 1})


def _cache_miss_entry():
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x):
            # a table keyed on an object made anew every call: the cache
            # misses on every call, an upload on every call
            host = SimpleNamespace(w=np.arange(x.numel(), dtype=np.float32))
            return x * device_table(host, 'w', torch.float32, x.device)
        return Built(fn, (torch.ones(8),), counter)
    return EntryPoint(name='seed.cache_miss', build=build)


def _collective_entry(allow=frozenset()):
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x):
            y = x.clone()
            dist.all_reduce(y)
            return y
        return Built(fn, (torch.ones(4),), counter)
    return EntryPoint(name='seed.collective', build=build, allow=allow)


def _clean_entry(name='seed.clean'):
    def build(seed):
        counter = {}
        record_trace(counter)

        def fn(x, w):
            return torch.tanh(x @ w)
        return Built(fn, (torch.ones((8, 16)), torch.ones((16, 8))), counter)
    return EntryPoint(name=name, build=build)


def seeded_registry(device='cpu'):
    return [_host_sync_entry(), _drift_entry(), _upcast_entry(),
            _bf16_entry(), _broadcast_entry(), _padwaste_entry(),
            _launches_entry(), _cache_miss_entry(), _clean_entry()]


def _codes(report_entry):
    return {f.code for f in report_entry.findings}


# ---------------------------------------------------------------------------
# pass-level: each seeded violation yields its specific finding code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('entry, code', [
    (_host_sync_entry, 'host-sync-hot'),
    (_upcast_entry, 'f64-upcast'),
    (_bf16_entry, 'bf16-leak'),
    (_broadcast_entry, 'materialized-broadcast'),
    (_padwaste_entry, 'pad-waste'),
    (_launches_entry, 'launch-count'),
    (_cache_miss_entry, 'cache-fission'),
])
def test_seeded_violation_gives_its_code(entry, code):
    er = analyze_entry(entry())
    assert code in _codes(er), [str(f) for f in er.findings]


def test_retrace_detects_signature_drift_and_fission():
    er = analyze_entry(_drift_entry())
    codes = _codes(er)
    assert 'signature-drift' in codes
    assert 'cache-fission' in codes          # 2 builds counted
    assert er.metrics['compile_count'] == 2


def test_cache_miss_names_the_cache():
    er = analyze_entry(_cache_miss_entry())
    (f,) = [f for f in er.findings if f.code == 'cache-fission']
    assert 'repro_torch.core.tables._table' in f.detail['missed']


def test_memory_metrics_of_seeded_entries():
    er = analyze_entry(_broadcast_entry())
    assert er.metrics['broadcast_bytes_max'] >= 512 * 4096 * 4
    er = analyze_entry(_padwaste_entry())
    assert er.metrics['pad_waste_frac'] == pytest.approx(1 - 16 / 128)
    assert er.metrics['launches'] == 1


def test_dtype_allowlist_suppresses():
    er = analyze_entry(_upcast_entry(allow=frozenset({'f64-upcast'})))
    assert 'f64-upcast' not in _codes(er)
    assert any(f.code == 'f64-upcast' for f in er.suppressed)


def test_clean_entry_is_clean():
    er = analyze_entry(_clean_entry())
    assert er.findings == [], [str(f) for f in er.findings]
    assert er.metrics['compile_count'] == 1


def test_collective_flagged_and_allowlisted_by_name(tmp_path):
    """A gloo collective waits on the host: ``host-sync`` with the op's
    name, which the sharded entry's allowlist names."""
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            world_size=1, rank=0)
    try:
        er = analyze_entry(_collective_entry())
        assert [f.detail['op'] for f in er.findings
                if f.code == 'host-sync'] == ['c10d.allreduce_']
        er = analyze_entry(_collective_entry(
            allow=frozenset({'host-sync:c10d.allreduce_'})))
        assert er.findings == [] and len(er.suppressed) == 1
    finally:
        dist.destroy_process_group()


def test_recorder_off_costs_nothing_and_records_plain_launches():
    """Without a recorder the wrappers record nothing; with one, the
    plain version's ops are kept out of the op events (plain-body scope)
    and its call is one launch record."""
    assert launches.active() is None
    with launches.record_launches() as rec:
        snap_u_half(_disp(), twojmax=2, rcut=3.0)
    (r,) = rec.records
    assert (r.name, r.device, r.lanes, r.meta) == (
        'snap_u_half', 'cpu', 128, {'twojmax': 2})
    assert launches.active() is None


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

def test_budget_roundtrip_and_regression():
    report = run_registry([_clean_entry()])
    budgets = make_budgets(report)
    assert check_budgets(report, budgets) == []

    tight = json.loads(json.dumps(budgets))
    tight['entries']['seed.clean']['compile_count'] = 0
    findings = check_budgets(report, tight)
    assert any(f.code == 'over-budget' for f in findings)


def test_budget_unbudgeted_not_run_and_missing_metric():
    report = run_registry([_clean_entry()])
    findings = check_budgets(report, {'entries': {'seed.other': {}}})
    sev = {f.code: f.severity for f in findings}
    assert sev == {'unbudgeted-entry': 'error', 'entry-not-run': 'warn'}
    findings = check_budgets(report, {'entries': {'seed.clean': {
        'peak_bytes': 1}}})
    assert [(f.code, f.severity) for f in findings] == [
        ('metric-missing', 'warn')]


# ---------------------------------------------------------------------------
# CLI end-to-end: nonzero exit on each seeded violation class
# ---------------------------------------------------------------------------

_REG = f'{__file__}:seeded_registry'


@pytest.mark.parametrize('entry, code', [
    ('seed.host_sync', 'host-sync-hot'),   # host sync
    ('seed.drift', 'signature-drift'),     # retrace surface
    ('seed.upcast', 'f64-upcast'),         # dtype drift
    ('seed.bf16', 'bf16-leak'),
    ('seed.broadcast', 'materialized-broadcast'),
    ('seed.padwaste', 'pad-waste'),        # padding waste
    ('seed.launches', 'launch-count'),
    ('seed.cache_miss', 'cache-fission'),
])
def test_cli_exits_nonzero_on_seeded_violation(entry, code, capsys):
    rc = cli_main(['--registry', _REG, '--entry', entry, '--budgets', 'none',
                   '--device', 'cpu'])
    assert rc == 1
    out = capsys.readouterr().out
    assert entry in out and code in out


def test_cli_exits_nonzero_on_budget_violation(tmp_path, capsys):
    budgets = tmp_path / 'budgets.json'
    budgets.write_text(json.dumps(
        {'cpu': {'entries': {'seed.clean': {'compile_count': 0}}}}))
    rc = cli_main(['--registry', _REG, '--entry', 'seed.clean',
                   '--budgets', str(budgets), '--device', 'cpu'])
    assert rc == 1
    assert 'over-budget' in capsys.readouterr().out


def test_cli_clean_entry_exits_zero_and_keeps_other_section(tmp_path,
                                                            capsys):
    budgets = tmp_path / 'budgets.json'
    budgets.write_text(json.dumps({'cuda': {'entries': {'x': {}}},
                                   'cpu': {'entries': {'seed.other': {}}}}))
    rc = cli_main(['--registry', _REG, '--entry', 'seed.clean',
                   '--budgets', str(budgets), '--write-budgets',
                   '--device', 'cpu'])
    assert rc == 0
    doc = json.loads(budgets.read_text())
    assert doc['cuda'] == {'entries': {'x': {}}}
    # the budget of an entry this run did not reach stays
    assert doc['cpu']['entries']['seed.other'] == {}
    assert doc['cpu']['entries']['seed.clean']['launches'] == 0
    # the budgets it wrote immediately pass
    rc = cli_main(['--registry', _REG, '--entry', 'seed.clean',
                   '--budgets', str(budgets), '--device', 'cpu'])
    assert rc == 0


def test_cli_json_report(tmp_path, capsys):
    out = tmp_path / 'report.json'
    rc = cli_main(['--registry', _REG, '--entry', 'seed.upcast',
                   '--budgets', 'none', '--device', 'cpu',
                   '--json', str(out)])
    assert rc == 1
    doc = json.loads(out.read_text())
    assert doc['ok'] is False and doc['meta']['device'] == 'cpu'
    codes = {f['code'] for e in doc['entries'] for f in e['findings']}
    assert codes == {'f64-upcast'}


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='cuda'):
        cli_main(['--registry', _REG, '--entry', 'seed.clean'])


# ---------------------------------------------------------------------------
# the real registry, held against the reference's
# ---------------------------------------------------------------------------

def _ported(name):
    return name.replace('.jnp.', '.torch.')


def test_registry_covers_every_reference_entry(monkeypatch):
    ref = {ep.name for ep in rreg.default_registry()}
    assert {'force.kernel.half', 'force.jnp.adjoint', 'md.device_chunk',
            'serve.bucket_step'} <= ref
    # the sharded entry registers inside a process group of >= 2 ranks,
    # as the reference's does on >= 2 devices
    monkeypatch.setattr(treg, '_in_group', lambda: True)
    port = {ep.name for ep in treg.default_registry('cpu')}
    assert {_ported(n) for n in ref} | {'force.torch.sharded'} == port


def test_checked_in_cpu_budgets_cover_registry(monkeypatch):
    """Every entry has a budget in both sections, the sharded one (which
    registers only inside a process group) included."""
    monkeypatch.setattr(treg, '_in_group', lambda: True)
    names = {ep.name for ep in treg.default_registry('cpu')}
    assert 'force.torch.sharded' in names
    for device in ('cpu', 'cuda'):
        budgets = load_budgets(DEFAULT_PATH, device)
        assert budgets is not None, 'analysis/budgets.json must be checked in'
        missing = names - set(budgets['entries'])
        assert not missing, f'no {device} budget for {sorted(missing)}'


def test_cpu_registry_is_clean_against_its_budgets():
    """What ``python -m repro_torch.analysis --device cpu`` gates on: no
    finding, every budget met, one launch of each kernel of a path a
    call."""
    report = run_registry(treg.default_registry('cpu'),
                          budgets=load_budgets(DEFAULT_PATH, 'cpu'))
    assert report.ok, report.table()
    # outside a process group the sharded entry's budget goes unused
    assert [(f.code, f.entry) for f in report.all_findings()] == [
        ('entry-not-run', 'force.torch.sharded')]
    launched = {e.entry: e.metrics['launches'] for e in report.entries}
    assert launched['force.kernel.half'] == 5
    assert launched['md.device_chunk'] == 12


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_force_inputs_equal_the_reference(seed, dtype):
    ref = rreg._force_inputs(seed, getattr(jax.numpy, dtype))
    port = treg._force_inputs(seed, getattr(torch, dtype))
    for r, p in zip(ref, port):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype or p.dtype == torch.int64
        np.testing.assert_array_equal(p.numpy(), r)


@functools.lru_cache(maxsize=1)
def _reference_adjoint():
    built = rreg._jnp_entry('adjoint')(0)        # jitted, f64
    e, _, f = built.fn(*built.args)
    return float(e), np.asarray(f)


@pytest.mark.parametrize('name, bar', [
    ('force.torch.adjoint', 1e-10),
    ('force.torch.baseline', 1e-10),
    ('force.kernel.half', 1e-5),
    ('force.kernel.full', 1e-5),
    ('force.kernel.half.bf16', 1e-2),
])
def test_force_entry_matches_reference_adjoint(name, bar):
    e_ref, f_ref = _reference_adjoint()
    (ep,) = [ep for ep in treg.default_registry('cpu') if ep.name == name]
    built = ep.build(0)
    e, _, f = built.fn(*built.args)
    f_err = np.max(np.abs(f.double().numpy() - f_ref)) / np.max(np.abs(f_ref))
    assert f_err <= bar
    assert abs(float(e) - e_ref) / abs(e_ref) <= bar


# ---------------------------------------------------------------------------
# the build counter (retrace.py)
# ---------------------------------------------------------------------------

def test_record_trace_helper():
    c = {}
    assert trace_count(c) == 0
    assert record_trace(c) == 1
    assert record_trace(c) == 2
    assert trace_count(c) == 2
    assert record_trace(None) == 0      # no-op without a counter
    assert trace_count(None) == 0
    assert_trace_count(c, 2)
    with pytest.raises(AssertionError):
        assert_trace_count(c, 1, what='seed')
