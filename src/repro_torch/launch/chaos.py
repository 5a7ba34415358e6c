"""Chaos-soak harness: composed fault load over crash/restart cycles.

Port of ``repro.launch.chaos``.  It composes every fault class at once
against a journaled :class:`~repro_torch.launch.serve_forces.ForceServer`
and checks the invariants the serving contract promises:

1. **No acked request is lost or double-served**: every journaled
   ``accepted`` request reaches *exactly one* terminal (``completed`` /
   ``failed``) event, across any number of crash/restart cycles.
2. **Every submitted request reaches exactly one outcome**: acked
   requests terminate via the journal; shed/rejected requests carry
   their typed admission error — nothing falls through, nothing is
   counted twice.
3. **Quarantine knowledge survives restart**: a bucket quarantined
   before a crash is still quarantined after restore.
4. **Healthy-lane results are bitwise-stable across crash/restart**:
   every journaled ``completed`` event's (energy, forces digest) equals
   a solo evaluation of the same payload on the same impl path through
   a fresh, fault-free server.
5. **The compile count stays structurally bounded** by the bucket table
   (each exercised (bucket, impl) entry is built exactly once per
   incarnation).

Everything is seeded and deterministic (:class:`ChaosPlan`); the crash
points are *cumulative dispatch counts* so restarts do not re-fire old
crashes.  A crash is a :class:`SimulatedCrash` raised by the server's
``fault_hook``: it leaves :meth:`ForceServer.step` with the dequeued batch
abandoned, as a host death would.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.snap import SnapConfig, resolve_device
from ..md.fault_inject import (ChaosPlan, ServeFaultInjector,
                               SimulatedCrash, poison_request_positions)
from ..md.lattice import paper_box, perturb

from .journal import forces_digest, read_events
from .journal import replay as replay_journal
from .request_queue import BucketTable, ForceRequest, ServiceError
from .serve_forces import ForceResult, ForceServer


def default_table(twojmax: int = 2, rcut: float = 3.0) -> BucketTable:
    return BucketTable(model_classes=((twojmax, rcut),), n_pads=(16, 64),
                       nbor_ladder=(12,), batch=4)


def build_chaos_load(plan: ChaosPlan, beta, twojmax: int = 2,
                     rcut: float = 3.0):
    """Deterministic schedule for a :class:`ChaosPlan`: seeded Poisson
    arrivals over heterogeneous sizes with the plan's poisoned fraction,
    plus a simultaneous overload burst.  Returns ``(schedule, assign)``
    with ``schedule`` sorted by arrival time."""
    assign = plan.request_faults().assign(plan.n_requests)
    rng = np.random.default_rng(plan.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / plan.rate,
                                         size=plan.n_requests))
    sizes = rng.choice([16, 54], size=plan.n_requests)
    schedule = []
    for i in range(plan.n_requests):
        n = int(sizes[i])
        pos, box = paper_box(natoms=n)
        pos = perturb(pos, 0.03, seed=plan.seed + i)
        box = np.asarray(box, float)
        kind = assign.get(i)
        if kind == 'nan_pos':
            pos = poison_request_positions(pos)
        elif kind == 'overflow':
            # denser than the neighbor ladder: every atom sees all others
            pos = rng.uniform(0.0, 2.5, size=(16, 3))
            box = np.array([2.5, 2.5, 2.5])
        schedule.append((float(arrivals[i]), ForceRequest(
            f'c{i}', pos=pos, box=box, beta=beta, twojmax=twojmax,
            rcut=rcut)))
    for k in range(plan.overload_burst_n):
        pos, box = paper_box(natoms=16)
        pos = perturb(pos, 0.03, seed=plan.seed + 10_000 + k)
        schedule.append((float(plan.overload_burst_at), ForceRequest(
            f'burst{k}', pos=pos, box=np.asarray(box, float), beta=beta,
            twojmax=twojmax, rcut=rcut)))
    return sorted(schedule, key=lambda it: it[0]), assign


class CrashHook:
    """Server ``fault_hook`` composing the plan's kernel faults with
    cumulative-dispatch :class:`SimulatedCrash` triggers.

    The hook outlives server incarnations (it models the *environment*,
    not the process), so the dispatch counter keeps counting across
    restarts and each crash point fires exactly once."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self.dispatches = 0
        self.crashes_fired: List[int] = []
        faults = plan.serve_faults()
        self.kernel_injector = (ServeFaultInjector(faults) if faults
                                else None)

    def __call__(self, step: int, bucket_key: str, arrays: Dict,
                 impl: str = 'kernel') -> Dict:
        self.dispatches += 1
        for c in self.plan.crash_dispatches:
            if self.dispatches >= c and c not in self.crashes_fired:
                self.crashes_fired.append(c)
                raise SimulatedCrash(self.dispatches)
        if self.kernel_injector is not None:
            return self.kernel_injector(step, bucket_key, arrays, impl)
        return arrays


@dataclass
class ChaosReport:
    """Outcome of one chaos soak: invariants + bookkeeping."""
    ok: bool
    violations: List[str]
    incarnations: int
    crashes_fired: List[int]
    n_requests: int
    served: int
    failed: int
    shed_or_rejected: int
    replayed_total: int
    journal_events: int
    recovery_s: float              # wall-clock total of restore() calls
    bitwise_checked: int
    quarantined: Tuple[str, ...]
    compile_counts: Dict[str, int]
    outcomes: Dict[str, str] = field(default_factory=dict)

    def summary(self) -> Dict:
        return dict(self.__dict__)


def run_chaos_soak(plan: ChaosPlan, workdir, table: Optional[BucketTable]
                   = None, impl: str = 'kernel', device='cuda',
                   queue_depth: int = 12, quarantine_after: int = 2,
                   snapshot_every: int = 2,
                   timer: Callable[[], float] = time.perf_counter,
                   verify_bitwise: bool = True,
                   max_steps: int = 100000,
                   schedule=None) -> ChaosReport:
    """Drive a journaled server on ``device`` through the plan's composed
    fault load with a restart loop, then check the durability invariants.

    The workdir holds ``journal.jsonl`` and the (re-saved, crash-safe)
    ``server_snap`` snapshot directory.  Each :class:`SimulatedCrash`
    abandons the live server mid-step — exactly what a host death does —
    optionally tears the journal tail, and rebuilds via
    :meth:`ForceServer.restore`.

    ``schedule``: None builds the load with :func:`build_chaos_load` from
    the plan and the table's first model class (the reference's soak);
    else ``(pairs, assign)`` as that function returns them, ``pairs``
    being ``(t, ForceRequest)``.  It lets a caller soak the service with
    its own requests (``chip_smoke.py`` sends snap-2j8 ones) and is the
    one keyword the reference's soak lacks; its ``interpret`` is
    ``device`` here.
    """
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    journal_path = workdir / 'journal.jsonl'
    snap_dir = workdir / 'server_snap'
    table = table or default_table()
    if schedule is None:
        (twojmax, rcut) = table.model_classes[0]
        cfg = SnapConfig(twojmax=twojmax, rcut=rcut)
        beta = np.random.default_rng(plan.seed).normal(
            size=cfg.ncoeff) * 5e-3
        schedule = build_chaos_load(plan, beta, twojmax, rcut)
    schedule, assign = schedule
    schedule = sorted(schedule, key=lambda it: it[0])

    hook = CrashHook(plan)
    server_kw = dict(impl=impl, device=device,
                     queue_depth=queue_depth,
                     quarantine_after=quarantine_after, fault_hook=hook)
    srv = ForceServer(table, journal=str(journal_path), **server_kw)

    shed_or_rejected: Dict[str, str] = {}
    quarantined_pre_crash: set = set()
    clock, i = 0.0, 0
    incarnations, replayed_total, recovery_s = 1, 0, 0.0
    steps_since_snap = 0

    def drive() -> None:
        nonlocal clock, i, steps_since_snap
        for _ in range(max_steps):
            while i < len(schedule) and schedule[i][0] <= clock:
                t, req = schedule[i]
                i += 1
                try:
                    srv.submit(req, now=t)
                except ServiceError as err:
                    shed_or_rejected[req.req_id] = type(err).__name__
            done, dt = srv.step(clock, timer=timer)
            if done:
                steps_since_snap += 1
                if steps_since_snap >= snapshot_every:
                    srv.snapshot(snap_dir, now=clock)
                    steps_since_snap = 0
            if dt > 0 or done:
                clock += max(dt, 1e-9)
                continue
            pending = [schedule[i][0]] if i < len(schedule) else []
            nxt = srv.queue.next_eligible_time()
            if nxt is not None:
                pending.append(nxt)
            if not pending:
                return
            clock = max(clock + 1e-9, min(pending))

    while True:
        try:
            drive()
            break
        except SimulatedCrash:
            quarantined_pre_crash |= set(srv.health().quarantined)
            # simulate process death: the journal fh just stops (per-
            # append flushes already landed); optionally tear the tail
            srv._journal._fh.close()
            if plan.torn_tail:
                with open(journal_path, 'a') as fh:
                    fh.write('{"seq": 0, "ev": "comp')   # torn mid-append
            t0 = time.perf_counter()
            # .old covers a crash inside the snapshot re-save swap
            # window (restore_named falls back to it)
            have_snap = ((snap_dir / 'manifest.json').exists()
                         or (snap_dir.parent / (snap_dir.name + '.old')
                             / 'manifest.json').exists())
            srv = ForceServer.restore(
                table, str(journal_path),
                snapshot=snap_dir if have_snap else None,
                now=clock, **server_kw)
            recovery_s += time.perf_counter() - t0
            incarnations += 1
            replayed_total += srv._replayed
    # graceful exit: serve any stragglers, final snapshot
    srv.drain(deadline=clock + 60.0, now=clock, timer=timer,
              snapshot_dir=snap_dir)

    # ---- invariant checking ---------------------------------------------
    events = read_events(journal_path)
    state = replay_journal(events)
    violations: List[str] = []

    for rec in state.records.values():
        if rec.accepted is not None and rec.n_terminal != 1:
            violations.append(
                f'{rec.req_id}: {rec.n_terminal} terminal events '
                f'(acked requests must reach exactly one)')

    outcomes: Dict[str, str] = {}
    for _, req in schedule:
        rid = req.req_id
        rec = state.records.get(rid)
        acked = rec is not None and rec.accepted is not None
        if acked and rid in shed_or_rejected:
            violations.append(f'{rid}: both acked and shed')
        elif acked:
            outcomes[rid] = (rec.terminal['ev'] if rec.terminal
                             else 'LOST')
            if rec.terminal is None:
                violations.append(f'{rid}: acked but never terminal')
        elif rid in shed_or_rejected:
            outcomes[rid] = shed_or_rejected[rid]
        else:
            violations.append(f'{rid}: no outcome at all')

    final_health = srv.health()
    for bk in quarantined_pre_crash:
        if bk not in final_health.quarantined:
            violations.append(
                f'quarantine of {bk} did not survive restart')

    bound = 2 * len(table.all_buckets())
    if len(final_health.compile_counts) > bound:
        violations.append(
            f'compile count {len(final_health.compile_counts)} exceeds '
            f'structural bound {bound}')
    for key, v in final_health.compile_counts.items():
        if v != 1:
            violations.append(f'{key}: traced {v}x in one incarnation')

    bitwise_checked = 0
    if verify_bitwise:
        refs: Dict[str, ForceServer] = {}
        payloads = {req.req_id: req for _, req in schedule}
        for rec in state.records.values():
            ev = rec.terminal
            if ev is None or ev['ev'] != 'completed':
                continue
            ref = refs.setdefault(ev['impl'], ForceServer(
                table, impl=ev['impl'], device=device,
                queue_depth=len(schedule) + 1))
            req = payloads[rec.req_id]
            solo = ref.evaluate(ForceRequest(
                req_id=rec.req_id + '-ref', pos=req.pos, box=req.box,
                beta=req.beta, twojmax=req.twojmax, rcut=req.rcut),
                now=0.0)
            if not isinstance(solo, ForceResult):
                violations.append(
                    f'{rec.req_id}: reference evaluation failed '
                    f'({type(solo).__name__}) for a completed request')
                continue
            if (float(solo.energy) != float(ev['energy'])
                    or forces_digest(solo.forces) != ev['forces_sha']):
                violations.append(
                    f'{rec.req_id}: result not bitwise-stable across '
                    f'crash/restart (impl={ev["impl"]})')
            bitwise_checked += 1

    return ChaosReport(
        ok=not violations, violations=violations,
        incarnations=incarnations, crashes_fired=hook.crashes_fired,
        n_requests=len(schedule), served=final_health.served,
        failed=final_health.failed,
        shed_or_rejected=len(shed_or_rejected),
        replayed_total=replayed_total, journal_events=len(events),
        recovery_s=recovery_s, bitwise_checked=bitwise_checked,
        quarantined=final_health.quarantined,
        compile_counts=dict(final_health.compile_counts),
        outcomes=outcomes)
