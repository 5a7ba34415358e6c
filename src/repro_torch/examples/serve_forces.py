"""Force-evaluation-as-a-service demo: SNAP behind a request queue.

Spins up a :class:`~repro_torch.launch.serve_forces.ForceServer` over a
small bucket table, fires a deterministic open-loop request stream at it
(a seeded fraction carry NaN coordinates or are too dense for the
neighbor budget), and prints the per-request outcomes plus the service
health report.  Bad requests come back as *typed errors with
diagnostics*; the healthy requests sharing their batch are unaffected and
bitwise-identical to a solo evaluation.

    PYTHONPATH=src python -m repro_torch.examples.serve_forces
        [--requests 12] [--impl adjoint|kernel] [--fraction-bad 0.25]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.snap import SnapConfig
from repro_torch.launch.request_queue import (BucketTable, ForceRequest,
                                              ServiceError)
from repro_torch.launch.serve_forces import ForceServer, run_open_loop
from repro_torch.md.fault_inject import (RequestFaultPlan,
                                         poison_request_positions)
from repro_torch.md.lattice import paper_box, perturb

# the reference's serving benchmark table (benchmarks/b_serve.py)
TWOJMAX, RCUT = 2, 3.0
TABLE = BucketTable(model_classes=((TWOJMAX, RCUT),), n_pads=(16, 64),
                    nbor_ladder=(12,), batch=4)
# --impl names: the adjoint path is the service's 'jnp' quarantine path
IMPLS = {'adjoint': 'jnp', 'kernel': 'kernel'}


def make_load(n_requests, beta, fraction_bad=0.0, seed=0, rate=50.0):
    """Deterministic open-loop schedule: seeded exponential inter-arrival
    gaps, heterogeneous sizes, and a seeded fault plan poisoning
    ``fraction_bad`` of the stream (NaN inputs / overflow-dense boxes)."""
    plan = RequestFaultPlan(fraction=fraction_bad, seed=seed).assign(
        n_requests)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    sizes = rng.choice([16, 54], size=n_requests)
    schedule = []
    for i in range(n_requests):
        n = int(sizes[i])
        pos, box = paper_box(natoms=n)
        pos = perturb(pos, 0.03, seed=seed + i)
        box = np.asarray(box, float)
        kind = plan.get(i)
        if kind == 'nan_pos':
            pos = poison_request_positions(pos)
        elif kind == 'overflow':
            # denser than any ladder rung: every atom sees all others
            pos = rng.uniform(0.0, 2.5, size=(16, 3))
            box = np.array([2.5, 2.5, 2.5])
        schedule.append((float(arrivals[i]), ForceRequest(
            f'r{i}', pos=pos, box=box, beta=beta, twojmax=TWOJMAX,
            rcut=RCUT)))
    return schedule, plan


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog='python -m repro_torch.examples.serve_forces')
    ap.add_argument('--requests', type=int, default=12)
    ap.add_argument('--impl', choices=tuple(IMPLS), default='adjoint')
    ap.add_argument('--fraction-bad', type=float, default=0.25)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)

    cfg = SnapConfig(twojmax=TWOJMAX, rcut=RCUT)
    beta = np.random.default_rng(args.seed).normal(size=cfg.ncoeff) * 5e-3
    schedule, plan = make_load(args.requests, beta,
                               fraction_bad=args.fraction_bad,
                               seed=args.seed)
    print(f'bucket table: {[b.key for b in TABLE.all_buckets()]}')
    print(f'poison plan: {plan or "(none)"}')

    srv = ForceServer(TABLE, impl=IMPLS[args.impl], device=args.device)
    health = run_open_loop(srv, schedule)

    print('\nper-request outcomes:')
    outcomes = {}
    for i in range(args.requests):
        rid = f'r{i}'
        res = outcomes[rid] = srv.result(rid)
        if isinstance(res, ServiceError):
            print(f'  {rid}: {type(res).__name__}: {res}')
        elif res is None:
            print(f'  {rid}: no outcome')
        else:
            fmax = float(np.abs(res.forces).max())
            print(f'  {rid}: E={res.energy:+.6f} eV  |F|max={fmax:.4f} '
                  f'bucket={res.bucket_key} impl={res.impl} '
                  f'latency={res.latency * 1e3:.1f}ms')

    print('\nservice health:')
    summary = health.summary()
    for k, v in summary.items():
        print(f'  {k}: {v}')
    return dict(plan=plan, outcomes=outcomes, health=summary)


if __name__ == '__main__':
    main()
