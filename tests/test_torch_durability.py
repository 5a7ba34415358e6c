"""The port's durable service on the CPU (``device='cpu'``, the kernel
path's plain versions): the fifteen cases of the reference's
tests/test_durability.py carried over — write-ahead journal mechanics,
crash-recoverable restore, graceful drain, bounded result/latency stores,
FIFO-fair dequeue and the chaos-soak invariants — and journals and
snapshots written by either package restored by the other."""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from repro.launch import journal as rjournal
from repro.launch import serve_forces as rserve
from repro.launch.request_queue import BucketTable as RBucketTable
from repro.launch.request_queue import ForceRequest as RForceRequest
from repro_torch.core.snap import SnapConfig
from repro_torch.launch import journal as tjournal
from repro_torch.launch import serve_forces as tserve
from repro_torch.launch.chaos import run_chaos_soak
from repro_torch.launch.journal import (Journal, forces_digest, read_events,
                                        replay)
from repro_torch.launch.request_queue import (BucketTable,
                                              DeadlineExceededError,
                                              DuplicateRequestError,
                                              ForceRequest, QueueEntry,
                                              RequestQueue,
                                              RequestRejectedError,
                                              ServiceDrainingError)
from repro_torch.launch.serve_forces import (ForceResult, ForceServer,
                                             run_open_loop)
from repro_torch.md.fault_inject import (ChaosPlan, ServeFault,
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


CFG2 = SnapConfig(twojmax=2, rcut=3.0)
BETA2 = np.random.default_rng(0).normal(size=CFG2.ncoeff) * 5e-3

TABLE = BucketTable(model_classes=((2, 3.0),), n_pads=(16, 64),
                    nbor_ladder=(12,), batch=4)
RTABLE = RBucketTable(model_classes=((2, 3.0),), n_pads=(16, 64),
                      nbor_ladder=(12,), batch=4)

FROZEN = dict(timer=lambda: 0.0)      # deterministic step durations


def Server(table=TABLE, **kw):
    """A ForceServer on the CPU (the default device is the card)."""
    return ForceServer(table, device='cpu', **kw)


def restore(jp, **kw):
    return ForceServer.restore(TABLE, str(jp), device='cpu', **kw)


def payload(rid, seed=0, n=16, poison=False):
    pos, box = paper_box(natoms=n)
    pos = perturb(pos, 0.03, seed=seed)
    if poison:
        pos = poison_request_positions(pos)
    return dict(req_id=rid, pos=pos, box=np.asarray(box, float),
                beta=BETA2, twojmax=2, rcut=3.0)


def make_req(rid, seed=0, n=16, poison=False, **kw):
    return ForceRequest(**payload(rid, seed, n, poison), **kw)


def make_rreq(rid, seed=0, n=16, poison=False, **kw):
    """The same request for the reference's server."""
    return RForceRequest(**payload(rid, seed, n, poison), **kw)


# ---------------------------------------------------------------------------
# journal mechanics: append/read, torn tail, replay folding
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_seq_continuation(tmp_path):
    p = tmp_path / 'j.jsonl'
    with Journal(p, fsync_every=2) as j:
        j.append('accepted', 'a', t=0.0, payload=[1, 2])
        j.append('completed', 'a', energy=np.float32(1.5),
                 forces_sha=forces_digest(np.zeros((3, 3))))
        assert j.seq == 2
    evs = read_events(p)
    assert [(e['ev'], e['req_id']) for e in evs] == [
        ('accepted', 'a'), ('completed', 'a')]
    assert evs[1]['energy'] == 1.5          # numpy coerced to plain JSON
    # reopening continues the sequence numbering
    with Journal(p) as j2:
        assert j2.append('accepted', 'b') == 3
    assert read_events(p)[-1]['seq'] == 3
    with pytest.raises(ValueError, match='unknown journal event'):
        Journal(tmp_path / 'k.jsonl').append('exploded', 'a')
    # the digest of a tensor is the digest of its array
    f = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    assert forces_digest(torch.as_tensor(f)) == forces_digest(f)


def test_journal_torn_tail_is_dropped_and_healed(tmp_path):
    p = tmp_path / 'j.jsonl'
    with Journal(p) as j:
        j.append('accepted', 'a')
        j.append('accepted', 'b')
    with open(p, 'a') as fh:
        fh.write('{"seq": 3, "ev": "comp')       # crash mid-append
    # reader: complete prefix survives, torn tail costs only itself
    assert [e['req_id'] for e in read_events(p)] == ['a', 'b']
    # appender: heals the tail, so the next append cannot fuse with it
    with Journal(p) as j2:
        j2.append('completed', 'a')
    evs = read_events(p)
    assert [(e['ev'], e['req_id']) for e in evs] == [
        ('accepted', 'a'), ('accepted', 'b'), ('completed', 'a')]
    for line in p.read_text().splitlines():
        json.loads(line)                         # every line is whole


def test_replay_folds_idempotently():
    evs = [dict(seq=1, ev='accepted', req_id='a', t=0.0),
           dict(seq=2, ev='accepted', req_id='b', t=0.1),
           dict(seq=3, ev='requeued', req_id='a', retries=1),
           dict(seq=4, ev='accepted', req_id='a', t=0.2, replayed=True),
           dict(seq=5, ev='completed', req_id='a', energy=1.0),
           dict(seq=6, ev='completed', req_id='a', energy=1.0)]
    st = replay(evs)
    assert st.last_seq == 6
    a = st.records['a']
    assert a.n_accepted == 2 and a.requeues == 1
    assert a.terminal['seq'] == 5              # first terminal wins forever
    assert a.n_terminal == 2                   # the violation is visible
    assert st.acked == ['a', 'b']
    assert [r.req_id for r in st.pending] == ['b']


# ---------------------------------------------------------------------------
# durable acks -> crash -> restore replays exactly once
# ---------------------------------------------------------------------------

def test_crash_after_ack_replays_pending_exactly_once(tmp_path):
    jp = tmp_path / 'journal.jsonl'
    srv = Server(impl='jnp', queue_depth=8, journal=str(jp))
    srv.submit(make_req('done', 1), now=0.0)
    srv.step(0.0, **FROZEN)                     # 'done' terminal pre-crash
    srv.submit(make_req('lost1', 2), now=1.0)
    srv.submit(make_req('lost2', 3, poison=True), now=1.0)
    ref = srv.result('done')
    del srv                                      # crash: no snapshot at all

    srv2 = restore(jp, now=2.0, impl='jnp', queue_depth=8)
    # only the acked, non-terminal requests were re-admitted
    assert srv2._replayed == 2
    assert srv2.health().replayed == 2
    srv2.step(2.0, **FROZEN)
    assert isinstance(srv2.result('lost1'), ForceResult)
    assert type(srv2.result('lost2')).__name__ == 'RequestFailedError'
    # journal invariant: every acked id reached exactly one terminal event
    st = replay(read_events(jp))
    assert sorted(st.acked) == ['done', 'lost1', 'lost2']
    assert all(r.n_terminal == 1 for r in st.records.values()), st.records
    # a second restore replays nothing (idempotent by req_id)
    srv3 = restore(jp, now=3.0, impl='jnp', queue_depth=8)
    assert srv3._replayed == 0
    # ... and the pre-crash completion is bitwise re-derivable: the
    # journal's digest matches a fresh evaluation of the same request
    ev = st.records['done'].terminal
    solo = srv3.evaluate(make_req('done-ref', 1), now=9.0)
    assert forces_digest(solo.forces) == ev['forces_sha']
    assert float(solo.energy) == ev['energy']
    assert forces_digest(ref.forces) == ev['forces_sha']


def test_restore_with_snapshot_preserves_state(tmp_path):
    jp, sd = tmp_path / 'j.jsonl', tmp_path / 'snap'
    inj = ServeFaultInjector([ServeFault(step=1, kind='kernel_fault',
                                         persistent=True)])
    srv = Server(impl='kernel', queue_depth=8, quarantine_after=2,
                 fault_hook=inj, journal=str(jp))
    for i in range(3):
        srv.submit(make_req(f'r{i}', seed=i), now=float(i))
        srv.step(float(i), **FROZEN)
    h = srv.health()
    assert h.quarantined == ('2J2_rc3_n16_k12_b4',)
    srv.submit(make_req('tail', 7), now=5.0)    # acked, never served
    srv.snapshot(sd, now=5.0)
    del srv

    srv2 = restore(jp, snapshot=sd, now=6.0, impl='kernel', queue_depth=8,
                   quarantine_after=2)
    h2 = srv2.health()
    # quarantine + strike counts + counters survived the restart
    assert h2.quarantined == h.quarantined
    assert h2.kernel_faults == h.kernel_faults
    assert h2.served == h.served and h2.failed == h.failed
    # stored outcomes rehydrated with their typed classes and payloads
    r0 = srv2.result('r0')
    assert isinstance(r0, ForceResult)
    assert (r0.forces == srv2.evaluate(
        make_req('r0-ref', 0), now=9.0).forces).all()
    # the un-served acked request was re-admitted and serves to completion
    assert srv2._replayed == 1
    srv2.step(6.0, **FROZEN)
    assert isinstance(srv2.result('tail'), ForceResult)


def test_restore_rehydrates_typed_errors(tmp_path):
    jp, sd = tmp_path / 'j.jsonl', tmp_path / 'snap'
    srv = Server(impl='jnp', queue_depth=8, journal=str(jp))
    srv.submit(make_req('bad', 1, poison=True), now=0.0)
    srv.step(0.0, **FROZEN)
    err = srv.result('bad')
    srv.snapshot(sd)
    srv2 = restore(jp, snapshot=sd, impl='jnp', queue_depth=8)
    back = srv2.result('bad')
    assert type(back) is type(err)
    assert back.diagnostics['req_id'] == 'bad'
    assert str(back) == str(err)               # no message doubling


def test_outage_consumes_deadline_not_extends_it(tmp_path):
    jp = tmp_path / 'j.jsonl'
    srv = Server(impl='jnp', queue_depth=8, journal=str(jp))
    srv.submit(make_req('d', 1, deadline_s=0.5), now=0.0)
    del srv                                      # crash before dispatch
    # the outage lasted past the original absolute deadline (0.5)
    srv2 = restore(jp, now=2.0, impl='jnp', queue_depth=8)
    srv2.step(2.0, **FROZEN)
    out = srv2.result('d')
    assert isinstance(out, DeadlineExceededError), out
    assert out.diagnostics['deadline'] == 0.5


# ---------------------------------------------------------------------------
# duplicate req_ids — idempotent resubmission
# ---------------------------------------------------------------------------

def test_duplicate_req_id_is_idempotent_not_overwritten():
    srv = Server(impl='jnp', queue_depth=8)
    srv.submit(make_req('a', 1), now=0.0)
    # in flight: typed error, the original is untouched
    with pytest.raises(DuplicateRequestError) as ei:
        srv.submit(make_req('a', 99), now=0.0)
    assert ei.value.diagnostics['req_id'] == 'a'
    assert srv.queue.depth == 1
    srv.step(0.0, **FROZEN)
    first = srv.result('a')
    assert isinstance(first, ForceResult)
    # terminal: resubmission is a no-op returning the bucket, the stored
    # outcome is never recomputed or overwritten
    bucket = srv.submit(make_req('a', 99), now=1.0)
    assert bucket.key == first.bucket_key
    assert srv.result('a') is first
    assert srv.queue.depth == 0


def test_rejected_req_id_may_resubmit_fresh():
    srv = Server(impl='jnp', queue_depth=8)
    with pytest.raises(RequestRejectedError):
        srv.submit(make_req('r', 1, n=54, max_nbors_hint=99), now=0.0)
    assert isinstance(srv.result('r'), RequestRejectedError)
    # the reject was never acked, so the id is free to retry corrected
    srv.submit(make_req('r', 1), now=1.0)
    srv.step(1.0, **FROZEN)
    assert isinstance(srv.result('r'), ForceResult)


# ---------------------------------------------------------------------------
# bounded result store + latency reservoir
# ---------------------------------------------------------------------------

def test_result_store_and_latency_reservoir_are_bounded():
    srv = Server(impl='jnp', queue_depth=16, result_cap=4,
                 latency_reservoir=8)
    for i in range(10):
        srv.submit(make_req(f'r{i}', seed=i), now=float(i))
        srv.step(float(i), **FROZEN)
    h = srv.health()
    assert h.served == 10
    assert h.store_depth == 4 and h.store_evicted == 6
    assert len(srv._reservoir.values) <= 8
    assert srv._reservoir.count == 10
    # newest survive, oldest were evicted
    assert srv.result('r9') is not None and srv.result('r0') is None
    assert h.p99_ms >= h.p50_ms >= 0.0


# ---------------------------------------------------------------------------
# single-pass FIFO-fair dequeue
# ---------------------------------------------------------------------------

def _entry(rid, bucket, not_before=0.0):
    req = ForceRequest(rid, pos=np.zeros((4, 3)), box=np.ones(3),
                       beta=BETA2, twojmax=2, rcut=3.0)
    return QueueEntry(req=req, bucket=bucket, arrival=0.0,
                      deadline_abs=None, input_clean=True,
                      not_before=not_before)


def test_next_batch_is_single_pass_and_fifo_fair():
    bA = TABLE.select(make_req('x', n=16))
    bB = TABLE.select(make_req('y', n=54))
    q = RequestQueue(max_depth=32)
    for e in (_entry('a0', bA), _entry('b0', bB),
              _entry('a1', bA, not_before=5.0), _entry('a2', bA),
              _entry('b1', bB), _entry('a3', bA), _entry('a4', bA)):
        q.submit(e, now=0.0)
    # oldest eligible entry (a0) picks the bucket; eligible same-bucket
    # entries join in FIFO order up to the batch width (4)
    batch = q.next_batch(now=0.0)
    assert [e.req.req_id for e in batch] == ['a0', 'a2', 'a3', 'a4']
    # survivors keep their relative order (b0 before a1 before b1)
    assert [e.req.req_id for e in q.entries] == ['b0', 'a1', 'b1']
    # next head is b0: bucket B is not starved by backlogged A entries
    assert [e.req.req_id for e in q.next_batch(now=0.0)] == ['b0', 'b1']
    # only the backing-off entry remains; it is ineligible until 5.0
    assert q.next_batch(now=0.0) is None
    assert q.next_eligible_time() == 5.0
    assert [e.req.req_id for e in q.next_batch(now=5.0)] == ['a1']
    assert q.depth == 0


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_drain_serves_backlog_then_closes_admission(tmp_path):
    jp, sd = tmp_path / 'j.jsonl', tmp_path / 'snap'
    srv = Server(impl='jnp', queue_depth=8, journal=str(jp))
    for i in range(3):
        srv.submit(make_req(f'r{i}', seed=i), now=0.0)
    h = srv.drain(deadline=60.0, now=0.0, snapshot_dir=sd, **FROZEN)
    assert h.draining and h.queue_depth == 0
    assert all(isinstance(srv.result(f'r{i}'), ForceResult)
               for i in range(3))
    with pytest.raises(ServiceDrainingError):
        srv.submit(make_req('late', 9), now=61.0)
    assert isinstance(srv.result('late'), ServiceDrainingError)
    # the final snapshot is restorable and already fully terminal
    srv2 = restore(jp, snapshot=sd, impl='jnp', queue_depth=8)
    assert srv2._replayed == 0
    assert isinstance(srv2.result('r0'), ForceResult)


def test_drain_deadline_fails_remainder_with_typed_errors():
    srv = Server(impl='jnp', queue_depth=8)
    srv.submit(make_req('a', 1), now=0.0)
    srv.submit(make_req('b', 2), now=0.0)
    h = srv.drain(deadline=0.0, now=0.0, **FROZEN)   # no time at all
    assert h.queue_depth == 0 and h.deadline_missed == 2
    for rid in ('a', 'b'):
        out = srv.result(rid)
        assert isinstance(out, DeadlineExceededError), (rid, out)
        assert 'drain deadline' in str(out)


# ---------------------------------------------------------------------------
# open-loop idle-advance termination
# ---------------------------------------------------------------------------

def test_open_loop_idle_advances_across_long_gaps():
    """A huge arrival gap must be crossed by one clock jump, not busy
    steps — the open loop ends well inside a tiny step budget."""
    schedule = [(0.0, make_req('early', 1)), (500.0, make_req('late', 2))]
    srv = Server(impl='jnp', queue_depth=8)
    health = run_open_loop(srv, schedule, timer=lambda: 0.0, max_steps=16)
    assert health.served == 2 and health.queue_depth == 0
    late = srv.result('late')
    assert isinstance(late, ForceResult)
    assert late.latency < 1.0          # served at ~500.0, not queued since 0


# ---------------------------------------------------------------------------
# chaos soak: every fault class composed over >= 2 mid-step crashes
# ---------------------------------------------------------------------------

def step_cost_timer(seconds=0.25):
    """A clock that advances ``seconds`` a reading, so every soak step
    lasts ``seconds``.  The reference's case relies on its interpret-mode
    kernels taking about that long a step, so every arrival and the burst
    land before the first step ends and the bounded queue sheds; the
    plain versions take milliseconds."""
    ticks = itertools.count()
    return lambda: next(ticks) * seconds


def test_chaos_soak_invariants_hold(tmp_path):
    # kernel faults from the very first step: even with crashes landing
    # before any snapshot (strike counts lost), the surviving incarnation
    # accumulates its own strikes and must still quarantine
    plan = ChaosPlan(n_requests=8, seed=1, fraction_bad=0.25,
                     kernel_fault_step=1, crash_dispatches=(2, 4),
                     overload_burst_at=0.05, overload_burst_n=6,
                     torn_tail=True)
    rep = run_chaos_soak(plan, tmp_path, device='cpu',
                         timer=step_cost_timer())
    assert rep.ok, rep.violations
    assert rep.crashes_fired == [2, 4]
    assert rep.incarnations == 3               # two crashes -> two restores
    assert rep.replayed_total > 0              # restores re-admitted work
    assert rep.bitwise_checked > 0             # completed results verified
    assert rep.quarantined                     # kernel faults -> quarantine
    assert rep.shed_or_rejected > 0            # the burst visibly shed
    # every request has exactly one outcome on record
    assert len(rep.outcomes) == rep.n_requests
    assert 'LOST' not in rep.outcomes.values()


# ---------------------------------------------------------------------------
# across packages: journals and snapshots restore in either direction
# ---------------------------------------------------------------------------

def test_wire_names_match_reference():
    assert tjournal.EVENTS == rjournal.EVENTS
    assert tjournal.TERMINAL == rjournal.TERMINAL
    assert tserve.SNAPSHOT_KIND == rserve.SNAPSHOT_KIND
    # the port's health has one field more, device_steps (batched
    # evaluations of this incarnation); the rest are the reference's
    ours = [f.name for f in dataclasses.fields(tserve.ServiceHealth)]
    theirs = [f.name for f in dataclasses.fields(rserve.ServiceHealth)]
    assert [n for n in ours if n != 'device_steps'] == theirs
    # records and digests are byte-for-byte the reference's
    a = np.random.default_rng(3).normal(size=(7, 3))
    assert tjournal.pack_array(a) == rjournal.pack_array(a)
    assert tjournal.forces_digest(a) == rjournal.forces_digest(a)
    ev = dict(x=np.float32(1.5), y=(np.int64(2), np.arange(2)))
    assert tjournal._jsonable(ev) == rjournal._jsonable(ev)


def test_reference_journal_replays_in_port(tmp_path):
    """Acks journaled by the reference's server (submit only: no step, so
    nothing compiles) are replayed and served by the port."""
    jp = tmp_path / 'j.jsonl'
    ref = rserve.ForceServer(RTABLE, impl='jnp', queue_depth=8,
                             journal=str(jp))
    specs = dict(a=(1, 16), b=(2, 54))          # seed, atoms
    ref.submit(make_rreq('a', *specs['a']), now=0.0)
    ref.submit(make_rreq('b', *specs['b'], deadline_s=30.0), now=0.5)
    ref.submit(make_rreq('bad', 3, poison=True), now=1.0)
    ref._journal.close()
    del ref                                      # crash before any step

    srv = restore(jp, now=2.0, impl='jnp', queue_depth=8)
    assert srv.health().replayed == 3
    entries = {e.req.req_id: e for e in srv.queue.entries}
    assert entries['b'].deadline_abs == 30.5     # the original deadline
    srv.drain(deadline=60.0, now=2.0, **FROZEN)
    solo = Server(impl='jnp')
    for rid, spec in specs.items():
        out = srv.result(rid)
        assert isinstance(out, ForceResult) and out.impl == 'jnp'
        ref_out = solo.evaluate(make_req(rid + '-solo', *spec))
        assert forces_digest(out.forces) == forces_digest(ref_out.forces)
    assert type(srv.result('bad')).__name__ == 'RequestFailedError'
    st = rjournal.replay(rjournal.read_events(jp))
    assert not st.pending
    assert all(r.n_terminal == 1 for r in st.records.values())


def test_port_journal_replays_in_reference(tmp_path):
    """Acks journaled by the port replay in the reference: the same
    pending set, payloads bitwise equal, no step."""
    jp = tmp_path / 'j.jsonl'
    srv = Server(impl='jnp', queue_depth=8, journal=str(jp))
    reqs = [make_req('a', 1), make_req('b', 2, n=54, deadline_s=4.0),
            make_req('c', 3)]
    srv.submit(reqs[0], now=0.0)
    srv.step(0.0, **FROZEN)                      # 'a' terminal
    for r in reqs[1:]:
        srv.submit(r, now=1.0)
    srv._journal.close()
    del srv

    st = rjournal.replay(rjournal.read_events(jp))
    assert [r.req_id for r in st.pending] == ['b', 'c']
    assert st.records['a'].terminal['ev'] == 'completed'
    ref = rserve.ForceServer.restore(RTABLE, str(jp), now=2.0, impl='jnp',
                                     queue_depth=8)
    assert ref._replayed == 2
    got = {e.req.req_id: e for e in ref.queue.entries}
    assert sorted(got) == ['b', 'c']
    assert got['b'].deadline_abs == 5.0
    for r in reqs[1:]:
        q = got[r.req_id].req
        for k in ('pos', 'box', 'beta'):
            mine, theirs = np.asarray(getattr(r, k)), getattr(q, k)
            assert theirs.dtype == mine.dtype
            assert theirs.tobytes() == mine.tobytes()


def _store(srv):
    return [(rid, type(out).__name__, ack) for rid, out, ack in
            srv._store.items()]


def test_port_snapshot_loads_in_reference(tmp_path):
    """A port snapshot of 12 results and one typed error, read by the
    reference's ``_load_snapshot``: forces bitwise, counters equal."""
    jp, sd = tmp_path / 'j.jsonl', tmp_path / 'snap'
    srv = Server(impl='jnp', queue_depth=16, journal=str(jp))
    for i in range(12):
        srv.submit(make_req(f'r{i}', seed=i), now=0.0)
    srv.submit(make_req('bad', 1, poison=True), now=0.0)
    srv.drain(deadline=60.0, now=0.0, snapshot_dir=sd, **FROZEN)
    ref = rserve.ForceServer(RTABLE, impl='jnp')
    ref._load_snapshot(sd)
    assert _store(ref) == _store(srv)
    for rid, out, _ in srv._store.items():
        back = ref.result(rid)
        if isinstance(out, ForceResult):
            assert back.forces.dtype == out.forces.dtype
            assert back.forces.tobytes() == out.forces.tobytes()
            assert back.energy == out.energy and back.impl == out.impl
        else:
            assert str(back) == str(out)
            assert back.diagnostics == json.loads(json.dumps(
                tjournal._jsonable(out.diagnostics)))
    for k in ('served', 'failed', 'deadline_missed', 'retries_scheduled',
              'degraded_steps', 'shed_count', 'store_evicted', 'p50_ms',
              'p99_ms', 'quarantined', 'kernel_faults'):
        assert getattr(ref.health(), k) == getattr(srv.health(), k), k


@pytest.fixture(scope='module')
def reference_run(tmp_path_factory):
    """One reference run on its jnp path at 2J=2, 16 atoms (one compile):
    12 results and a typed failure, snapshotted, then a request acked
    after the snapshot (journal only) with r0's payload."""
    d = tmp_path_factory.mktemp('reference_run')
    jp, sd = d / 'j.jsonl', d / 'snap'
    ref = rserve.ForceServer(RTABLE, impl='jnp', queue_depth=16,
                             journal=str(jp))
    for i in range(12):
        ref.submit(make_rreq(f'r{i}', seed=i), now=0.0)
    ref.submit(make_rreq('bad', 1, poison=True), now=0.0)
    while ref.queue.depth:
        ref.step(0.0, **FROZEN)
    ref.snapshot(sd, now=1.0)
    ref.submit(make_rreq('tail', 0), now=1.0)
    ref._journal.close()
    return jp, sd, ref


def test_reference_snapshot_restores_in_port(reference_run):
    """The reference's snapshot (leaves forces.0 .. forces.11, files in
    jax's order) and journal tail, restored by the port: outcomes,
    counters and forces bitwise; the tail served by the port within the
    f32 bar of the reference's result for the same payload."""
    jp, sd, ref = reference_run
    names = [m['name'] for m in
             json.loads((sd / 'manifest.json').read_text())['leaves']]
    assert names == [f'forces.{i}' for i in range(12)] + ['reservoir']
    srv = restore(jp, snapshot=sd, now=2.0, impl='jnp', queue_depth=8)
    assert _store(srv) == _store(ref)
    for rid, out, _ in ref._store.items():
        back = srv.result(rid)
        if isinstance(out, rserve.ForceResult):
            assert back.forces.tobytes() == np.asarray(out.forces).tobytes()
            assert back.energy == out.energy
        else:
            assert type(back).__name__ == type(out).__name__
            assert str(back) == str(out)
    h, rh = srv.health(), ref.health()
    for k in ('served', 'failed', 'shed_count', 'store_evicted', 'p50_ms',
              'p99_ms'):
        assert getattr(h, k) == getattr(rh, k), k
    assert h.replayed == 1 and srv.queue.depth == 1
    srv.step(2.0, **FROZEN)
    tail = srv.result('tail')
    assert isinstance(tail, ForceResult)
    r_tail = ref.result('r0')
    rel = (np.abs(tail.forces - np.asarray(r_tail.forces)).max()
           / np.abs(np.asarray(r_tail.forces)).max())
    assert rel <= 1e-5 and abs(tail.energy - r_tail.energy) <= 1e-5 * abs(
        r_tail.energy)
