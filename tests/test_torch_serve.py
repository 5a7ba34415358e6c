"""The port's force service (``repro_torch.launch.serve_forces``) on the
CPU: the twelve cases of the reference's tests/test_serve.py carried over
— bucket selection properties, build-count bounds, per-request fault
isolation with bitwise peer-vs-solo, admission control, deadlines,
retry/backoff and graceful degradation — on the reference's bucket table,
with the kernel path's plain versions (``device='cpu'``); and the wire
names and fault plans held equal to the reference's."""
import numpy as np
import pytest
import torch

from repro.launch import request_queue as rq
from repro.md import fault_inject as rfi
from repro_torch.core.snap import SnapConfig
from repro_torch.launch.request_queue import (BucketTable,
                                              DeadlineExceededError,
                                              ForceRequest,
                                              RequestFailedError,
                                              RequestRejectedError,
                                              ServiceOverloadError)
from repro_torch.kernels import ops
from repro_torch.launch.serve_forces import (ForceResult, ForceServer,
                                             pack_batch, run_open_loop)
from repro_torch.md.fault_inject import (RequestFaultPlan, ServeFault,
                                         ServeFaultInjector,
                                         poison_request_positions)
from repro_torch.md.lattice import paper_box, perturb


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def Server(table, **kw):
    """A ForceServer on the CPU (the kernel path runs the plain versions;
    the default device is the card)."""
    return ForceServer(table, device='cpu', **kw)


CFG2 = SnapConfig(twojmax=2, rcut=3.0)
RNG = np.random.default_rng(0)
BETA2 = RNG.normal(size=CFG2.ncoeff) * 5e-3

TABLE = BucketTable(model_classes=((2, 3.0),), n_pads=(16, 32, 64),
                    nbor_ladder=(12, 24), batch=4)

FROZEN = dict(timer=lambda: 0.0)      # deterministic step durations


def make_req(rid, seed=0, n=16, poison=False, dense=False, **kw):
    if dense:
        # 16 atoms in a 2.5A box: min-image distances are all < rcut, so
        # every atom sees all 15 others — overflowing the smallest
        # ladder rung (12) while staying inside the 16-atom shape bucket
        pos = np.random.default_rng(seed).uniform(0.0, 2.5, size=(16, 3))
        box = np.array([2.5, 2.5, 2.5])
    else:
        pos, box = paper_box(natoms=n)
        pos = perturb(pos, 0.03, seed=seed)
    if poison:
        pos = poison_request_positions(pos)
    return ForceRequest(rid, pos=pos, box=np.asarray(box, float),
                        beta=BETA2, twojmax=2, rcut=3.0, **kw)


# ---------------------------------------------------------------------------
# bucket selection properties
# ---------------------------------------------------------------------------

def test_bucketing_deterministic():
    """Same request -> same bucket, every time (property over sizes)."""
    for n in range(1, 65, 7):
        req = ForceRequest('r', pos=np.zeros((n, 3)), box=np.ones(3),
                           beta=BETA2, twojmax=2, rcut=3.0)
        picks = {TABLE.select(req) for _ in range(5)}
        assert len(picks) == 1, (n, picks)


def test_bucketing_padding_monotone():
    """A request never lands in a bucket smaller than its N, and growing
    N never shrinks the bucket."""
    last_pad = 0
    for n in range(1, 65):
        req = ForceRequest('r', pos=np.zeros((n, 3)), box=np.ones(3),
                           beta=BETA2, twojmax=2, rcut=3.0)
        b = TABLE.select(req)
        assert b.n_pad >= n, (n, b)
        assert b.n_pad >= last_pad, (n, b, last_pad)
        assert b.n_pad == min(p for p in TABLE.n_pads if p >= n)
        last_pad = b.n_pad


def test_bucketing_rejects_are_typed():
    too_big = ForceRequest('big', pos=np.zeros((65, 3)), box=np.ones(3),
                           beta=BETA2, twojmax=2, rcut=3.0)
    with pytest.raises(RequestRejectedError, match='larger than every'):
        TABLE.select(too_big)
    alien = ForceRequest('alien', pos=np.zeros((8, 3)), box=np.ones(3),
                         beta=BETA2, twojmax=8, rcut=4.7)
    with pytest.raises(RequestRejectedError, match='unserved model'):
        TABLE.select(alien)
    wide = ForceRequest('wide', pos=np.zeros((8, 3)), box=np.ones(3),
                        beta=BETA2, twojmax=2, rcut=3.0,
                        max_nbors_hint=100)
    with pytest.raises(RequestRejectedError, match='neighbor width'):
        TABLE.select(wide)
    assert TABLE.select(ForceRequest(
        'ok', pos=np.zeros((8, 3)), box=np.ones(3), beta=BETA2,
        twojmax=2, rcut=3.0, max_nbors_hint=20)).max_nbors == 24


def test_same_bucket_requests_compile_once():
    """Two same-bucket requests trigger exactly one trace of the batched
    entry (same trace-count idiom as tests/test_md.py), and the compile
    count is bounded by the buckets actually exercised."""
    srv = Server(TABLE, impl='jnp', queue_depth=8)
    for rid, seed in (('a', 1), ('b', 2)):
        srv.submit(make_req(rid, seed=seed), now=0.0)
    srv.step(0.0, **FROZEN)
    h = srv.health()
    assert h.compile_counts == {'2J2_rc3_n16_k12_b4/jnp': 1}, h
    # a third request in the same bucket: still one trace
    srv.submit(make_req('c', seed=3), now=1.0)
    srv.step(1.0, **FROZEN)
    assert srv.health().compile_counts == {'2J2_rc3_n16_k12_b4/jnp': 1}
    # a different bucket adds exactly one more
    srv.submit(make_req('d', seed=4, n=54), now=2.0)
    srv.step(2.0, **FROZEN)
    counts = srv.health().compile_counts
    assert counts == {'2J2_rc3_n16_k12_b4/jnp': 1,
                      '2J2_rc3_n64_k12_b4/jnp': 1}, counts
    assert all(isinstance(srv.result(r), ForceResult) for r in 'abcd')
    assert len(counts) <= len(TABLE.all_buckets())


# ---------------------------------------------------------------------------
# fault isolation (the acceptance batch): NaN + overflow + healthy peers
# ---------------------------------------------------------------------------

def test_batch_fault_isolation_bitwise():
    """One batch holding a NaN-poisoned and an overflowing request:
    those two come back as typed per-request errors, and both healthy
    peers' forces are bitwise identical to solo evaluation through the
    same serving path.  Compile count == distinct buckets exercised."""
    srv = Server(TABLE, impl='kernel', queue_depth=8)
    for r in (make_req('h1', seed=1), make_req('nan', seed=2, poison=True),
              make_req('ovf', seed=3, dense=True), make_req('h2', seed=4)):
        srv.submit(r, now=0.0)
    done, _ = srv.step(0.0, **FROZEN)
    assert len(done) == 4

    err_nan = srv.result('nan')
    assert isinstance(err_nan, RequestFailedError)
    assert 'nan_state' in err_nan.diagnostics['issues']
    err_ovf = srv.result('ovf')
    assert isinstance(err_ovf, RequestFailedError)
    assert err_ovf.diagnostics['observed'] > 12
    assert err_ovf.diagnostics['suggested_max_nbors'] > 12

    for rid, seed in (('h1', 1), ('h2', 4)):
        batched = srv.result(rid)
        assert isinstance(batched, ForceResult), (rid, batched)
        assert np.isfinite(batched.forces).all()
        solo = srv.evaluate(make_req(rid + '-solo', seed=seed), now=10.0)
        assert isinstance(solo, ForceResult)
        assert (batched.forces == solo.forces).all(), rid   # bitwise
        assert batched.energy == solo.energy, rid

    h = srv.health()
    assert h.compile_counts == {'2J2_rc3_n16_k12_b4/kernel': 1}, h
    assert h.served == 4 and h.failed == 2


# ---------------------------------------------------------------------------
# admission control, deadlines, retry/backoff, degradation
# ---------------------------------------------------------------------------

def test_overload_sheds_with_typed_error():
    srv = Server(TABLE, impl='jnp', queue_depth=2)
    srv.submit(make_req('a', 1), now=0.0)
    srv.submit(make_req('b', 2), now=0.0)
    with pytest.raises(ServiceOverloadError) as ei:
        srv.submit(make_req('c', 3), now=0.0)
    assert ei.value.diagnostics['max_depth'] == 2
    assert srv.queue.shed_count == 1
    assert isinstance(srv.result('c'), ServiceOverloadError)
    # shedding protects the admitted work: both still serve fine
    srv.step(0.0, **FROZEN)
    assert isinstance(srv.result('a'), ForceResult)
    assert isinstance(srv.result('b'), ForceResult)
    assert srv.health().shed_count == 1


def test_deadline_expires_before_dispatch():
    srv = Server(TABLE, impl='jnp', queue_depth=8)
    srv.submit(make_req('late', 1, deadline_s=0.5), now=0.0)
    srv.submit(make_req('fine', 2), now=0.0)
    done, _ = srv.step(1.0, **FROZEN)       # now > 0.5: 'late' expired
    errs = [d for d in done if isinstance(d, DeadlineExceededError)]
    assert len(errs) == 1
    assert errs[0].diagnostics['req_id'] == 'late'
    assert isinstance(srv.result('late'), DeadlineExceededError)
    assert isinstance(srv.result('fine'), ForceResult)
    assert srv.health().deadline_missed == 1


def test_transient_fault_retries_with_backoff():
    """A transient batch poisoning (clean input, flagged output) requeues
    the request with backoff; the retry sees the clean data and serves."""
    inj = ServeFaultInjector([ServeFault(step=1, kind='transient_nan')])
    srv = Server(TABLE, impl='jnp', queue_depth=8, max_retries=2,
                      backoff_s=0.1, fault_hook=inj)
    srv.submit(make_req('t', 1), now=0.0)
    done, _ = srv.step(0.0, **FROZEN)
    assert done == [] and srv.result('t') is None     # requeued, not failed
    assert srv.queue.depth == 1
    assert srv.queue.next_eligible_time() == pytest.approx(0.1)
    # before the backoff expires nothing is dispatched
    assert srv.step(0.05, **FROZEN) == ([], 0.0)
    done, _ = srv.step(0.2, **FROZEN)
    res = srv.result('t')
    assert isinstance(res, ForceResult) and res.retries == 1
    assert [f['kind'] for f in inj.fired] == ['transient_nan']
    assert srv.health().retries_scheduled == 1


def test_persistent_transient_fault_exhausts_to_typed_error():
    inj = ServeFaultInjector([ServeFault(step=1, kind='transient_nan',
                                         persistent=True)])
    srv = Server(TABLE, impl='jnp', queue_depth=8, max_retries=2,
                      backoff_s=0.01, fault_hook=inj)
    srv.submit(make_req('t', 1), now=0.0)
    now = 0.0
    for _ in range(6):
        srv.step(now, **FROZEN)
        now += 0.1
        if srv.result('t') is not None:
            break
    err = srv.result('t')
    assert isinstance(err, RequestFailedError)
    assert err.diagnostics['retries'] == 2
    assert srv.health().retries_scheduled == 2


def test_kernel_fault_quarantines_bucket_but_keeps_serving():
    """Repeated kernel-path faults degrade the bucket to the jnp
    reference path: every request still serves (slower, never down),
    and the quarantine is visible in the health report."""
    inj = ServeFaultInjector([ServeFault(step=1, kind='kernel_fault',
                                         persistent=True)])
    srv = Server(TABLE, impl='kernel', queue_depth=8,
                      quarantine_after=2, fault_hook=inj)
    for i, now in ((0, 0.0), (1, 1.0), (2, 2.0)):
        srv.submit(make_req(f'r{i}', seed=i), now=now)
        srv.step(now, **FROZEN)
        res = srv.result(f'r{i}')
        assert isinstance(res, ForceResult), (i, res)
        assert res.impl == 'jnp'          # every faulted step degraded
    h = srv.health()
    assert h.quarantined == ('2J2_rc3_n16_k12_b4',), h
    assert h.kernel_faults['2J2_rc3_n16_k12_b4'] == 2  # strikes stop once
    assert h.degraded_steps >= 2                       # quarantined
    # the kernel path was never successfully used; jnp compiled once
    assert h.compile_counts.get('2J2_rc3_n16_k12_b4/jnp') == 1
    # post-quarantine requests dispatch straight to jnp: no more faults
    assert [f['kind'] for f in inj.fired] == ['kernel_fault'] * 2


def test_kernel_path_failure_raises_not_degrades(monkeypatch):
    """Only an injected KernelPathFault degrades a step: a real failure
    of the kernel path (a kernel that does not build or launch) raises
    out of step(), is not re-run on the adjoint path and counts as no
    degradation."""
    def broken(*args, **kw):
        raise RuntimeError('kernel failed to launch')
    monkeypatch.setitem(ops._STAGES, 'half',
                        (broken,) + ops._STAGES['half'][1:])
    srv = Server(TABLE, impl='kernel', queue_depth=8)
    srv.submit(make_req('r0'), now=0.0)
    with pytest.raises(RuntimeError, match='failed to launch'):
        srv.step(0.0, **FROZEN)
    h = srv.health()
    assert (h.degraded_steps, h.kernel_faults, h.quarantined) == (0, {}, ())
    assert h.served == 0 and h.device_steps == 0
    assert h.compile_counts == {'2J2_rc3_n16_k12_b4/kernel': 1}


def test_pack_batch_lanes_and_inert_padding():
    """pack_batch puts each request in its lane and leaves the rest
    inert: n_valid 0, unit box, zero positions and betas."""
    reqs = [make_req('a', seed=1), make_req('b', seed=2, n=16)]
    bucket = TABLE.select(reqs[0])
    arrays = pack_batch(bucket, reqs, 'cpu')
    assert arrays['pos'].shape == (bucket.batch, bucket.n_pad, 3)
    assert arrays['n_valid'].dtype == torch.int32
    assert arrays['n_valid'].tolist() == [16, 16, 0, 0]
    for i, r in enumerate(reqs):
        assert np.array_equal(arrays['pos'][i, :r.natoms].numpy(), r.pos)
        assert np.array_equal(arrays['beta'][i].numpy(), r.beta)
    assert torch.equal(arrays['box'][2:], torch.ones(2, 3,
                                                     dtype=torch.float64))
    assert not arrays['pos'][2:].any() and not arrays['beta'][2:].any()


# ---------------------------------------------------------------------------
# open-loop runner + fault plan determinism
# ---------------------------------------------------------------------------

def test_request_fault_plan_deterministic():
    plan = RequestFaultPlan(fraction=0.25, seed=3)
    a, b = plan.assign(40), plan.assign(40)
    assert a == b and len(a) == 10
    assert set(a.values()) <= {'nan_pos', 'overflow'}


def test_open_loop_serves_schedule():
    reqs = [(0.1 * i, make_req(f'q{i}', seed=i)) for i in range(6)]
    reqs.append((0.25, make_req('bad', seed=99, poison=True)))
    srv = Server(TABLE, impl='jnp', queue_depth=8)
    health = run_open_loop(srv, reqs)
    assert health.served == 6 and health.failed == 1
    assert health.queue_depth == 0
    assert health.p99_ms >= health.p50_ms >= 0.0
    assert health.throughput_rps > 0.0
    assert 1 <= health.device_steps <= 7
    lat = [srv.result(f'q{i}').latency for i in range(6)]
    assert all(l >= 0.0 for l in lat)


# ---------------------------------------------------------------------------
# wire names and plans shared with the reference
# ---------------------------------------------------------------------------

def test_bucket_keys_and_errors_match_reference():
    """The journal of either package names buckets and failures the same
    way: every bucket of the table has the reference's key, and the error
    registry the reference's names."""
    ref = rq.BucketTable(model_classes=((2, 3.0), (8, 4.7)),
                         n_pads=(16, 128, 2048), nbor_ladder=(12, 32, 64),
                         batch=4)
    got = BucketTable(model_classes=((2, 3.0), (8, 4.7)),
                      n_pads=(16, 128, 2048), nbor_ladder=(12, 32, 64),
                      batch=4)
    assert [b.key for b in got.all_buckets()] == \
        [b.key for b in ref.all_buckets()]
    from repro_torch.launch.request_queue import ERROR_TYPES
    assert sorted(ERROR_TYPES) == sorted(rq.ERROR_TYPES)


@pytest.mark.parametrize('fraction,seed,n', [(0.25, 3, 40), (0.15, 0, 40),
                                             (0.2, 7, 16)])
def test_request_fault_plan_matches_reference(fraction, seed, n):
    assert RequestFaultPlan(fraction=fraction, seed=seed).assign(n) == \
        rfi.RequestFaultPlan(fraction=fraction, seed=seed).assign(n)
