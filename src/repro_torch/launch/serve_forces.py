"""SNAP force evaluation as a service: a request queue in front of the
batched force entry.

Port of ``repro.launch.serve_forces``, with its durability half: the
write-ahead journal, ``drain``, ``snapshot`` and ``restore``.

Pipeline of one request:

    submit(req)  ->  BucketTable.select  (typed reject on unservable)
                 ->  RequestQueue        (typed shed when full)
    step(now)    ->  same-bucket batch, packed on the host to the bucket's
                     static [batch, n_pad, ...] shapes, one copy to the
                     device (:func:`pack_batch`)
                 ->  one call of the bucket's batched function
                     (repro_torch.kernels.ops.make_batched_force_fn: one
                     launch of each kernel a batch)
                 ->  energies, forces and flags back in one copy
                 ->  per-lane health flags decoded
                     (repro_torch.md.resilience.lane_health)

Robustness contract (the reference's):

- **Isolation**: flags are per batch lane, and a lane's arithmetic does
  not read its peers — a NaN-poisoned or overflowing request yields a
  typed :class:`~repro_torch.launch.request_queue.RequestFailedError`
  (with diagnostics and, for overflows, a suggested capacity) while its
  batch peers return forces bitwise identical to a solo evaluation
  through the same bucket.  The bucket's batch is static, so a solo
  request launches the kernels at the same width and with the same
  launch plans as a full batch.
- **Admission control**: the queue is bounded; excess load is shed with
  :class:`~repro_torch.launch.request_queue.ServiceOverloadError` at
  submit time instead of queueing unboundedly.
- **Deadlines + retry**: input-clean requests that come back numerically
  flagged (transient fault) are requeued with exponential backoff until
  their deadline or the retry budget runs out; expired requests fail with
  :class:`~repro_torch.launch.request_queue.DeadlineExceededError` before
  touching the device.
- **Graceful degradation**: a
  :class:`~repro_torch.md.fault_inject.KernelPathFault` raised by
  ``fault_hook`` re-runs the step on the adjoint path; after
  ``quarantine_after`` strikes the bucket is quarantined to it — slower,
  never down.  It never falls back to the kernels' plain versions, and
  every degradation shows in :meth:`ForceServer.health`
  (``degraded_steps``, ``kernel_faults``, ``quarantined``) and in
  ``ForceResult.impl``.  Unlike the reference, any other exception out
  of the kernel path (a kernel that fails to build or launch) is not
  caught: it raises out of :meth:`ForceServer.step`, so a broken kernel
  can never hide behind the adjoint path.
- **Durability**: with a :class:`~repro_torch.launch.journal.Journal`
  attached, every admitted request is journaled ``accepted`` (payload
  included) before ``submit`` returns its ack, and every terminal outcome
  is journaled before it is stored — so :meth:`ForceServer.restore` can
  rebuild a crashed server from (snapshot, journal tail) with every
  acked, non-terminal request re-admitted exactly once (idempotent by
  ``req_id``) and quarantine/strike knowledge intact.  An exception that
  leaves :meth:`ForceServer.step` (a crash) abandons the dequeued batch:
  its requests have no terminal event, so a restore replays them.
- **Bounded memory**: terminal outcomes live in a capacity-bounded
  :class:`ResultStore` and latencies in a fixed-size
  :class:`LatencyReservoir`.
- **Graceful lifecycle**: :meth:`ForceServer.drain` closes admission
  (typed :class:`~repro_torch.launch.request_queue.ServiceDrainingError`),
  serves the backlog until a deadline, fails the remainder with deadline
  errors, and writes a final snapshot.

While a profiler records, the server's phases are spans
(:mod:`repro_torch.runtime.trace`): ``serve.submit``; ``serve.step``
holding ``serve.next_batch``, ``serve.pack`` (holding ``serve.upload``,
the packed buffer's copy to the device), ``serve.call`` (the batched
function's enqueue), ``serve.readback`` and ``serve.triage``; and
``serve.build_fn`` (a bucket's function built).  The counters
``serve.dispatched`` and ``serve.queue_wait_ns`` add the requests
dispatched and their wait from entering the queue to dispatch (the
server's own ``time.perf_counter_ns``, whatever clock the caller's
``now`` is on); ``serve.atoms`` and ``serve.atom_slots`` the valid atoms
packed and the lanes x padded atoms launched for them.

Wire names are the reference's: bucket keys, and the impl names
``'kernel'`` and ``'jnp'`` in results, journal events and
``compile_counts`` — ``'jnp'`` names the adjoint path (``impl='adjoint'``
of the batched entry), the reference's jnp pipeline.  ``compile_counts``
counts builds of each bucket's batched function.  Journals and snapshots
have the reference's formats (:data:`SNAPSHOT_KIND`), so either package
restores the other's; ``device_steps`` and ``compile_counts`` count within
one incarnation and are not persisted.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..analysis.retrace import trace_count
from ..core.snap import SnapConfig, resolve_device
from ..kernels.ops import make_batched_force_fn
from ..md.fault_inject import KernelPathFault
from ..md.neighbor import suggest_capacity
from ..md.resilience import lane_health
from ..runtime import checkpoint as ckpt
from ..runtime.trace import count, span
from .journal import (Journal, forces_digest, pack_array, read_events,
                      unpack_array)
from .journal import _jsonable as _json_safe
from .journal import replay as replay_journal
from .request_queue import (ERROR_TYPES, Bucket, BucketTable,
                            DeadlineExceededError, DuplicateRequestError,
                            ForceRequest, QueueEntry, RequestFailedError,
                            RequestQueue, RequestRejectedError,
                            ServiceDrainingError, ServiceError)

# the reference's impl names -> make_batched_force_fn's
IMPLS = {'kernel': 'kernel', 'jnp': 'adjoint'}

SNAPSHOT_KIND = 'force_server_v1'


class ResultStore:
    """Capacity-bounded terminal-outcome store (oldest evicted first).

    Each entry also records whether the request was *accepted* (passed
    admission): the resubmission-dedup witness, so the idempotence window
    equals the store capacity.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._d: 'OrderedDict[str, Tuple[object, bool]]' = OrderedDict()
        self.evicted = 0

    def put(self, req_id: str, outcome, acked: bool) -> None:
        if req_id in self._d:
            del self._d[req_id]           # re-record moves to newest
        self._d[req_id] = (outcome, bool(acked))
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evicted += 1

    def get(self, req_id: str):
        v = self._d.get(req_id)
        return v[0] if v is not None else None

    def acked(self, req_id: str) -> bool:
        v = self._d.get(req_id)
        return bool(v is not None and v[1])

    def items(self):
        """(req_id, outcome, acked) in insertion (oldest-first) order."""
        return [(rid, out, ack) for rid, (out, ack) in self._d.items()]

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, req_id: str) -> bool:
        return req_id in self._d


class LatencyReservoir:
    """Fixed-size uniform sample of completion latencies (Algorithm R),
    deterministic for a given seed and completion order."""

    def __init__(self, k: int = 512, seed: int = 0):
        self.k = max(1, int(k))
        self.count = 0
        self.values: List[float] = []
        self._rng = np.random.default_rng(seed)

    def add(self, x: float) -> None:
        self.count += 1
        if len(self.values) < self.k:
            self.values.append(float(x))
            return
        j = int(self._rng.integers(0, self.count))
        if j < self.k:
            self.values[j] = float(x)

    def percentile(self, q: float) -> float:
        if not self.values:
            return 0.0
        return float(np.percentile(np.asarray(self.values), q))


@dataclass
class ForceResult:
    """A successful per-request evaluation."""
    req_id: str
    energy: float
    forces: np.ndarray            # [natoms, 3] (padding stripped)
    latency: float                # completion - arrival (caller's clock)
    bucket_key: str
    impl: str                     # 'kernel' | 'jnp' (path that produced it)
    retries: int = 0


@dataclass
class ServiceHealth:
    """One self-describing snapshot of the server."""
    queue_depth: int
    shed_count: int
    served: int
    failed: int
    deadline_missed: int
    retries_scheduled: int
    degraded_steps: int
    compile_counts: Dict[str, int]       # 'bucket.key/impl' -> builds
    kernel_faults: Dict[str, int]        # bucket.key -> strike count
    quarantined: Tuple[str, ...]
    p50_ms: float
    p99_ms: float
    throughput_rps: float
    store_depth: int = 0                 # bounded result-store occupancy
    store_evicted: int = 0               # outcomes evicted at capacity
    device_steps: int = 0                # batched evaluations run
    journal_seq: int = 0                 # last journaled event (0 = none)
    replayed: int = 0                    # requests re-admitted by restore
    draining: bool = False

    def summary(self) -> Dict:
        return dict(self.__dict__)


def pack_batch(bucket: Bucket, reqs: List[ForceRequest], device) -> Dict:
    """The batched function's inputs for ``reqs`` (at most
    ``bucket.batch``, all with one beta length): static [batch, n_pad,
    ...] tensors, packed in one float64 host buffer and copied to
    ``device`` once.  Empty lanes are inert (n_valid = 0, unit box) so
    padding can never flag or contaminate."""
    B, n_pad = bucket.batch, bucket.n_pad
    ncoeff = np.asarray(reqs[0].beta).shape[0]
    sizes = dict(pos=(B, n_pad, 3), box=(B, 3), beta=(B, ncoeff),
                 beta0=(B,), n_valid=(B,))
    ends = np.cumsum([int(np.prod(s)) for s in sizes.values()])
    buf = np.zeros(ends[-1])
    host = {k: v.reshape(sizes[k]) for k, v in
            zip(sizes, np.split(buf, ends[:-1]))}
    host['box'][:] = 1.0
    for i, r in enumerate(reqs):
        host['pos'][i, :r.natoms] = r.pos
        host['box'][i] = r.box
        host['beta'][i] = r.beta
        host['beta0'][i] = r.beta0
        host['n_valid'][i] = r.natoms
    with span('serve.upload'):
        dev = torch.as_tensor(buf).to(device)
    arrays = {k: t.view(sizes[k]) for k, t in
              zip(sizes, torch.split(dev, np.diff(ends, prepend=0)
                                     .tolist()))}
    arrays['n_valid'] = arrays['n_valid'].to(torch.int32)
    return arrays


class ForceServer:
    """Fault-isolated SNAP force-evaluation service on ``device``: one
    batched device step at a time, the batch being same-bucket requests.

    All methods take explicit ``now`` timestamps — the server holds no
    clock, so tests and the open-loop runner stay deterministic.
    ``dtype``: the kernel path's working type and the adjoint path's
    ``SnapConfig.dtype``.  ``force_kwargs`` go to the kernel path
    (``layout``, ``mxu_dtype``).  ``journal``: a
    :class:`~repro_torch.launch.journal.Journal` or its path (None: no
    durability).
    """

    def __init__(self, table: BucketTable, impl: str = 'kernel',
                 queue_depth: int = 64, quarantine_after: int = 2,
                 max_retries: int = 2, backoff_s: float = 1e-3,
                 dtype=torch.float32, device='cuda',
                 fault_hook: Optional[Callable] = None,
                 force_kwargs: Optional[Dict] = None,
                 journal: Optional[Union[Journal, str]] = None,
                 result_cap: int = 256, latency_reservoir: int = 512):
        if impl not in IMPLS:
            raise ValueError(f'unknown impl {impl!r}; choose from '
                             f'{tuple(IMPLS)}')
        self.device = resolve_device(device)
        self.table = table
        self.impl = impl
        self.quarantine_after = int(quarantine_after)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.dtype = dtype
        self.fault_hook = fault_hook
        self.force_kwargs = dict(force_kwargs or {})
        self.queue = RequestQueue(max_depth=queue_depth)
        self._journal: Optional[Journal] = (
            journal if isinstance(journal, Journal) or journal is None
            else Journal(journal))
        self._fns: Dict[Tuple[Bucket, str], Callable] = {}
        self._trace_counts: Dict[Tuple[str, str], Dict] = {}
        self._ncoeff: Dict[int, int] = {}
        self._store = ResultStore(capacity=result_cap)
        self._reservoir = LatencyReservoir(k=latency_reservoir)
        self._inflight: Dict[str, QueueEntry] = {}
        self._kernel_faults: Dict[str, int] = {}
        self._quarantined: set = set()
        self._draining = False
        self._replayed = 0
        self._step_idx = 0
        self._device_steps = 0
        self._served = 0
        self._failed = 0
        self._deadline_missed = 0
        self._retries_scheduled = 0
        self._degraded_steps = 0
        self._first_arrival: Optional[float] = None
        self._last_completion: Optional[float] = None

    # -- admission ---------------------------------------------------------

    def submit(self, req: ForceRequest, now: float = 0.0) -> Bucket:
        """Admit one request (typed raise on reject/shed; the error is
        also recorded as the request's result so callers that poll
        ``result()`` see the same typed object).

        Resubmission is idempotent by ``req_id``: while the original is
        in flight a typed :class:`DuplicateRequestError` is raised (and
        the in-flight request is untouched); after an *accepted* request
        reached its terminal outcome, resubmitting returns its bucket
        without re-enqueueing and ``result()`` keeps the stored outcome.
        Admission-time rejects/sheds were never acked, so those ids may
        be resubmitted fresh.  While draining, a typed
        :class:`ServiceDrainingError` is raised (and recorded, not acked).
        With a journal attached, the ``accepted`` event is appended before
        ``submit`` returns — the ack is durable.
        """
        with span('serve.submit'):
            return self._submit(req, now)

    def _submit(self, req: ForceRequest, now: float) -> Bucket:
        rid = req.req_id
        if rid in self._inflight:
            raise DuplicateRequestError(
                'req_id resubmitted while the original is in flight',
                dict(req_id=rid,
                     bucket=self._inflight[rid].bucket.key))
        if self._store.acked(rid):
            return self.table.select(req)  # idempotent: keep the outcome
        if self._draining:
            err = ServiceDrainingError(
                'server is draining; admission closed', dict(
                    req_id=rid, now=round(now, 6)))
            self._store.put(rid, err, acked=False)
            self._failed += 1
            raise err
        deadline = (None if req.deadline_s is None
                    else now + float(req.deadline_s))
        return self._admit(req, now, deadline)

    def _admit(self, req: ForceRequest, now: float,
               deadline_abs: Optional[float], retries: int = 0,
               replayed: bool = False) -> Bucket:
        """Admission core shared by :meth:`submit` and journal replay
        (replay keeps the original absolute deadline and retry count,
        clamped to ``max_retries``, instead of restarting them)."""
        try:
            bucket = self.table.select(req)
            ncoeff = self._ncoeff_for(bucket.twojmax)
            if np.asarray(req.beta).shape != (ncoeff,):
                raise RequestRejectedError(
                    'beta length does not match the model class', dict(
                        req_id=req.req_id, got=np.asarray(req.beta).shape,
                        expect=(ncoeff,), twojmax=bucket.twojmax))
            clean = bool(np.isfinite(req.pos).all()
                         and np.isfinite(req.box).all()
                         and np.isfinite(req.beta).all()
                         and np.isfinite(req.beta0))
            entry = QueueEntry(req=req, bucket=bucket, arrival=now,
                               deadline_abs=deadline_abs,
                               input_clean=clean,
                               retries=min(int(retries), self.max_retries),
                               not_before=now,
                               queued_ns=time.perf_counter_ns())
            self.queue.submit(entry, now)
        except ServiceError as err:
            # a *replayed* request was acked in a previous life, so an
            # admission failure now is its terminal outcome and must
            # reach the journal (else the ack would look lost)
            self._store.put(req.req_id, err, acked=replayed)
            self._failed += 1
            if replayed and self._journal is not None:
                self._journal.append('failed', req.req_id, t=now,
                                     error=type(err).__name__,
                                     message=str(err))
            raise
        self._inflight[req.req_id] = entry
        if self._journal is not None:
            self._journal.append(
                'accepted', req.req_id, t=now, bucket=bucket.key,
                deadline_abs=deadline_abs, replayed=replayed,
                req=dict(pos=pack_array(req.pos),
                         box=pack_array(req.box),
                         beta=pack_array(req.beta),
                         twojmax=req.twojmax, rcut=req.rcut,
                         beta0=req.beta0, deadline_s=req.deadline_s,
                         max_nbors_hint=req.max_nbors_hint))
        if self._first_arrival is None or now < self._first_arrival:
            self._first_arrival = now
        return bucket

    def _ncoeff_for(self, twojmax: int) -> int:
        if twojmax not in self._ncoeff:
            self._ncoeff[twojmax] = SnapConfig(twojmax=twojmax).ncoeff
        return self._ncoeff[twojmax]

    # -- dispatch ----------------------------------------------------------

    def _fn(self, bucket: Bucket, impl: str) -> Callable:
        key = (bucket, impl)
        if key not in self._fns:
            cfg = SnapConfig(twojmax=bucket.twojmax, rcut=bucket.rcut,
                             dtype=self.dtype)
            counter = self._trace_counts.setdefault(
                (bucket.key, impl), {})
            kw = self.force_kwargs if impl == 'kernel' else {}
            with span('serve.build_fn'):
                self._fns[key] = make_batched_force_fn(
                    cfg, bucket.n_pad, bucket.max_nbors, impl=IMPLS[impl],
                    dtype=self.dtype, device=self.device,
                    trace_counter=counter, **kw)
        return self._fns[key]

    def _run(self, bucket: Bucket, impl: str, arrays: Dict):
        """One batched call; energies, forces and flags come back to the
        host in one copy (float64 holds each exactly)."""
        with span('serve.call'):
            e, f, flags = self._fn(bucket, impl)(**arrays)
        with span('serve.readback'):
            host = torch.cat([e.double(), f.double().reshape(-1),
                              flags.double().reshape(-1)]).cpu().numpy()
            B = e.shape[0]
            ends = np.cumsum([B, f.numel()])
            f_np = torch.empty((), dtype=f.dtype).numpy().dtype
            return (host[:ends[0]],
                    host[ends[0]:ends[1]].reshape(f.shape).astype(f_np),
                    host[ends[1]:].reshape(flags.shape).astype(np.int32))

    def _strike(self, bucket: Bucket) -> None:
        n = self._kernel_faults.get(bucket.key, 0) + 1
        self._kernel_faults[bucket.key] = n
        if n >= self.quarantine_after:
            self._quarantined.add(bucket.key)

    def step(self, now: float = 0.0,
             timer: Callable[[], float] = time.perf_counter
             ) -> Tuple[List[Union[ForceResult, ServiceError]], float]:
        """Serve one batched device step.  Returns ``(finished, dt)``
        where ``dt`` is the measured step duration per ``timer`` (pass a
        constant timer for deterministic tests); completions are stamped
        at ``now + dt``."""
        with span('serve.step'):
            return self._step(now, timer)

    def _step(self, now, timer):
        t0 = timer()
        with span('serve.next_batch'):
            batch = self.queue.next_batch(now)
        if batch is None:
            return [], 0.0
        self._step_idx += 1
        bucket = batch[0].bucket
        finished: List[Union[ForceResult, ServiceError]] = []

        live: List[QueueEntry] = []
        for e in batch:
            if e.deadline_abs is not None and now > e.deadline_abs:
                err = DeadlineExceededError(
                    'deadline passed before dispatch', dict(
                        req_id=e.req.req_id, arrival=round(e.arrival, 6),
                        deadline=round(e.deadline_abs, 6),
                        now=round(now, 6), retries=e.retries))
                self._deadline_missed += 1
                finished.append(self._finish(e, err, now))
                continue
            live.append(e)
        if not live:
            return finished, timer() - t0

        t_ns = time.perf_counter_ns()
        count('serve.dispatched', len(live))
        count('serve.queue_wait_ns', sum(t_ns - e.queued_ns for e in live))
        with span('serve.pack'):
            arrays = pack_batch(bucket, [e.req for e in live], self.device)
        count('serve.atoms', sum(e.req.natoms for e in live))
        count('serve.atom_slots', bucket.batch * bucket.n_pad)
        impl = 'jnp' if bucket.key in self._quarantined else self.impl
        if self.fault_hook is not None:
            try:
                arrays = self.fault_hook(self._step_idx, bucket.key,
                                         arrays, impl)
            except KernelPathFault:
                # kernel path died for this bucket: degrade this step to
                # the adjoint path and count a quarantine strike
                self._strike(bucket)
                impl = 'jnp'
                self._degraded_steps += 1
        e_b, f_b, flags_b = self._run(bucket, impl, arrays)
        self._device_steps += 1

        dt = timer() - t0
        end = now + dt
        with span('serve.triage'):
            for lane, entry in enumerate(live):
                finished.extend(self._triage(entry, bucket, impl,
                                             e_b[lane], f_b[lane],
                                             flags_b[lane], now, end))
        return finished, dt

    def _triage(self, entry: QueueEntry, bucket: Bucket, impl: str,
                e, f, flags, now: float, end: float):
        """Decode one lane's flags into a result, a typed failure, or a
        backed-off retry."""
        rep = lane_health(flags, bucket.max_nbors, bucket.rcut)
        req = entry.req
        if rep.overflow:
            err = RequestFailedError(
                'neighbor capacity overflow', dict(
                    req_id=req.req_id, observed=rep.nbr_max,
                    max_nbors=bucket.max_nbors,
                    suggested_max_nbors=suggest_capacity(rep.nbr_max),
                    issues=tuple(rep.issues())))
            return [self._finish(entry, err, end)]
        if rep.numeric:
            if not entry.input_clean:
                err = RequestFailedError(
                    'non-finite input configuration', dict(
                        req_id=req.req_id, issues=tuple(rep.issues())))
                return [self._finish(entry, err, end)]
            deadline_ok = (entry.deadline_abs is None
                           or now <= entry.deadline_abs)
            if entry.retries < self.max_retries and deadline_ok:
                # transient fault on clean input: retry with backoff —
                # the requeued entry re-reads the clean request data
                entry.retries += 1
                entry.not_before = now + self.backoff_s \
                    * (2.0 ** (entry.retries - 1))
                entry.queued_ns = time.perf_counter_ns()
                self.queue.requeue(entry)
                self._retries_scheduled += 1
                if self._journal is not None:
                    self._journal.append('requeued', req.req_id,
                                         retries=entry.retries,
                                         not_before=entry.not_before)
                return []
            err = RequestFailedError(
                'numeric fault persisted through retries', dict(
                    req_id=req.req_id, retries=entry.retries,
                    issues=tuple(rep.issues())))
            return [self._finish(entry, err, end)]
        n = req.natoms
        res = ForceResult(req_id=req.req_id, energy=float(e),
                          forces=np.array(f[:n]), latency=end - entry.arrival,
                          bucket_key=bucket.key, impl=impl,
                          retries=entry.retries)
        return [self._finish(entry, res, end)]

    def _finish(self, entry: QueueEntry, outcome, end: float):
        rid = entry.req.req_id
        self._inflight.pop(rid, None)
        if self._journal is not None:
            # journal before store: a crash between the two re-derives
            # the store from the journal, never the other way round
            if isinstance(outcome, ForceResult):
                self._journal.append(
                    'completed', rid, t=end, impl=outcome.impl,
                    energy=outcome.energy,
                    forces_sha=forces_digest(outcome.forces),
                    latency=outcome.latency, retries=outcome.retries)
            else:
                self._journal.append(
                    'failed', rid, t=end,
                    error=type(outcome).__name__, message=str(outcome))
        self._store.put(rid, outcome, acked=True)
        if isinstance(outcome, ForceResult):
            self._served += 1
            self._reservoir.add(outcome.latency)
        else:
            self._failed += 1
        if self._last_completion is None or end > self._last_completion:
            self._last_completion = end
        return outcome

    # -- lifecycle: drain, snapshot, restore -------------------------------

    def drain(self, deadline: float, now: float = 0.0,
              timer: Callable[[], float] = time.perf_counter,
              snapshot_dir=None, max_steps: int = 100000) -> ServiceHealth:
        """Graceful shutdown: close admission (subsequent submits raise
        :class:`ServiceDrainingError`), serve the backlog until the
        absolute ``deadline`` (same clock as ``now``), fail whatever is
        left with :class:`DeadlineExceededError`, then write a final
        snapshot (if ``snapshot_dir``) and sync the journal.  Every
        backlog request reaches exactly one terminal outcome."""
        self._draining = True
        for _ in range(max_steps):
            if self.queue.depth == 0 or now >= deadline:
                break
            done, dt = self.step(now, timer=timer)
            if dt > 0 or done:
                now += max(dt, 1e-9)
                continue
            nxt = self.queue.next_eligible_time()
            if nxt is None or nxt >= deadline:
                break                     # backlog is all beyond deadline
            now = max(now + 1e-9, nxt)
        remainder, self.queue.entries = self.queue.entries, []
        for e in remainder:
            err = DeadlineExceededError(
                'drain deadline reached before service', dict(
                    req_id=e.req.req_id, deadline=round(deadline, 6),
                    now=round(now, 6), retries=e.retries))
            self._deadline_missed += 1
            self._finish(e, err, now)
        if snapshot_dir is not None:
            self.snapshot(snapshot_dir, now=now)
        if self._journal is not None:
            self._journal.sync()
        return self.health()

    def snapshot(self, ckpt_dir, now: float = 0.0) -> None:
        """Crash-safe server-state snapshot on the
        :mod:`repro_torch.runtime.checkpoint` leaf format (the reference's
        schema): quarantine set, strike counts, counters, the bounded
        result store (forces as leaves ``forces.0``, ``forces.1``, ...)
        and the latency reservoir.  The journal is fsynced first so a
        snapshot is never *ahead* of the journal."""
        if self._journal is not None:
            self._journal.sync()
        results_meta: List[Dict] = []
        forces_leaves: List[np.ndarray] = []
        for rid, outcome, acked in self._store.items():
            m: Dict = dict(req_id=rid, acked=bool(acked))
            if isinstance(outcome, ForceResult):
                m.update(kind='result', energy=float(outcome.energy),
                         latency=float(outcome.latency),
                         bucket_key=outcome.bucket_key,
                         impl=outcome.impl, retries=int(outcome.retries),
                         forces_leaf=len(forces_leaves))
                forces_leaves.append(np.asarray(outcome.forces))
            else:
                m.update(kind='error', error=type(outcome).__name__,
                         message=str(outcome),
                         diagnostics=_json_safe(
                             getattr(outcome, 'diagnostics', {})))
            results_meta.append(m)
        tree = dict(forces=forces_leaves,
                    reservoir=np.asarray(self._reservoir.values, float))
        extra = dict(
            kind=SNAPSHOT_KIND, now=float(now),
            journal_seq=self._journal.seq if self._journal else 0,
            quarantined=sorted(self._quarantined),
            kernel_faults={k: int(v)
                           for k, v in self._kernel_faults.items()},
            results=results_meta,
            counters=dict(served=self._served, failed=self._failed,
                          deadline_missed=self._deadline_missed,
                          retries_scheduled=self._retries_scheduled,
                          degraded_steps=self._degraded_steps,
                          step_idx=self._step_idx,
                          shed_count=self.queue.shed_count,
                          store_evicted=self._store.evicted,
                          reservoir_count=self._reservoir.count,
                          replayed=self._replayed))
        ckpt.save(ckpt_dir, tree, step=self._step_idx, extra=extra)

    def _load_snapshot(self, ckpt_dir) -> None:
        leaves, manifest = ckpt.restore_named(ckpt_dir)
        extra = manifest['extra']
        if extra.get('kind') != SNAPSHOT_KIND:
            raise ValueError(f'not a force-server snapshot: '
                             f'{extra.get("kind")!r}')
        self._quarantined = set(extra['quarantined'])
        self._kernel_faults = {k: int(v)
                               for k, v in extra['kernel_faults'].items()}
        c = extra['counters']
        self._served = int(c['served'])
        self._failed = int(c['failed'])
        self._deadline_missed = int(c['deadline_missed'])
        self._retries_scheduled = int(c['retries_scheduled'])
        self._degraded_steps = int(c['degraded_steps'])
        self._step_idx = int(c['step_idx'])
        self._replayed = int(c.get('replayed', 0))
        self.queue.shed_count = int(c['shed_count'])
        self._store.evicted = int(c['store_evicted'])
        self._reservoir.values = [float(x)
                                  for x in leaves.get('reservoir', [])]
        self._reservoir.count = int(c['reservoir_count'])
        for m in extra['results']:
            if m['kind'] == 'result':
                outcome: Union[ForceResult, ServiceError] = ForceResult(
                    req_id=m['req_id'], energy=float(m['energy']),
                    forces=np.asarray(leaves[f'forces.{m["forces_leaf"]}']),
                    latency=float(m['latency']),
                    bucket_key=m['bucket_key'], impl=m['impl'],
                    retries=int(m['retries']))
            else:
                errcls = ERROR_TYPES.get(m['error'], ServiceError)
                outcome = errcls(m['message'])
                outcome.diagnostics = dict(m.get('diagnostics', {}))
            self._store.put(m['req_id'], outcome, acked=m['acked'])

    @classmethod
    def restore(cls, table: BucketTable, journal, snapshot=None,
                now: float = 0.0, **kwargs) -> 'ForceServer':
        """Rebuild a crashed server from its journal (path or
        :class:`~repro_torch.launch.journal.Journal`) plus an optional
        state snapshot directory; ``kwargs`` go to the constructor
        (``device`` defaults to the card, as there).

        The snapshot restores quarantine/strike knowledge, counters and
        the bounded result store; the journal tail is then replayed so
        every journaled-``accepted`` request without a terminal event is
        re-admitted **exactly once** (idempotent by ``req_id`` — replay
        re-admissions are themselves journaled, and repeated restores
        collapse onto the first terminal outcome).  Original absolute
        deadlines and retry counts are kept, so an outage consumes a
        request's deadline rather than silently extending it."""
        srv = cls(table, journal=journal, **kwargs)
        if snapshot is not None:
            srv._load_snapshot(snapshot)
        state = replay_journal(read_events(srv._journal.path))
        replayed = 0
        for rec in state.pending:
            if srv._store.acked(rec.req_id) or rec.req_id in srv._inflight:
                continue                  # snapshot already terminal
            ev = rec.accepted
            p = ev['req']
            req = ForceRequest(
                req_id=rec.req_id, pos=unpack_array(p['pos']),
                box=unpack_array(p['box']),
                beta=unpack_array(p['beta']),
                twojmax=int(p['twojmax']), rcut=float(p['rcut']),
                beta0=float(p['beta0']), deadline_s=p.get('deadline_s'),
                max_nbors_hint=p.get('max_nbors_hint'))
            try:
                srv._admit(req, now, ev.get('deadline_abs'),
                           retries=rec.requeues, replayed=True)
            except ServiceError:
                pass                      # typed + recorded in the store
            else:
                replayed += 1
        srv._replayed = replayed
        return srv

    # -- convenience / introspection --------------------------------------

    def result(self, req_id: str):
        return self._store.get(req_id)

    def evaluate(self, req: ForceRequest, now: float = 0.0,
                 max_steps: int = 16):
        """Solo evaluation through the serving path: submit, step until
        done, return the typed outcome.  Uses the same bucket table and
        batched functions as batched serving — the bitwise reference that
        batched peers are compared against."""
        self.submit(req, now)
        for _ in range(max_steps):
            if req.req_id in self._store:
                break
            self.step(now, timer=lambda: 0.0)
            now += max(self.backoff_s * 2 ** self.max_retries, 1e-6)
        out = self._store.get(req.req_id)
        if out is None:
            raise RuntimeError(f'request {req.req_id} did not complete in '
                               f'{max_steps} steps')
        return out

    def health(self) -> ServiceHealth:
        span = None
        if self._first_arrival is not None \
                and self._last_completion is not None:
            span = max(self._last_completion - self._first_arrival, 1e-9)
        return ServiceHealth(
            queue_depth=self.queue.depth,
            shed_count=self.queue.shed_count,
            served=self._served,
            failed=self._failed,
            deadline_missed=self._deadline_missed,
            retries_scheduled=self._retries_scheduled,
            degraded_steps=self._degraded_steps,
            compile_counts={f'{bk}/{impl}': trace_count(c)
                            for (bk, impl), c in
                            self._trace_counts.items()},
            kernel_faults=dict(self._kernel_faults),
            quarantined=tuple(sorted(self._quarantined)),
            p50_ms=self._reservoir.percentile(50) * 1e3,
            p99_ms=self._reservoir.percentile(99) * 1e3,
            throughput_rps=(self._served / span) if span else 0.0,
            store_depth=len(self._store),
            store_evicted=self._store.evicted,
            device_steps=self._device_steps,
            journal_seq=self._journal.seq if self._journal else 0,
            replayed=self._replayed,
            draining=self._draining,
        )


def run_open_loop(server: ForceServer,
                  schedule: List[Tuple[float, ForceRequest]],
                  timer: Callable[[], float] = time.perf_counter,
                  max_steps: int = 100000) -> ServiceHealth:
    """Drive the server with a deterministic *open-loop* schedule.

    Arrivals fire at their scheduled times regardless of completions (the
    load does not back off when the server is slow — that is what makes
    shedding observable).  The virtual clock advances by each step's
    *measured* duration, so recorded latencies are real compute plus real
    queueing delay; when the server is idle the clock jumps to the next
    event instead of busy-waiting.
    """
    schedule = sorted(schedule, key=lambda it: it[0])
    clock = 0.0
    i = 0
    for _ in range(max_steps):
        while i < len(schedule) and schedule[i][0] <= clock:
            t, req = schedule[i]
            i += 1
            try:
                server.submit(req, now=t)
            except ServiceError:
                pass                      # typed + recorded in results
        done, dt = server.step(clock, timer=timer)
        if dt > 0 or done:
            clock += max(dt, 1e-9)
            continue
        # idle: advance to the next arrival or backoff expiry
        pending = [schedule[i][0]] if i < len(schedule) else []
        nxt = server.queue.next_eligible_time()
        if nxt is not None:
            pending.append(nxt)
        if not pending:
            break
        clock = max(clock + 1e-9, min(pending))
    return server.health()
