"""End-to-end MD driver: NVE dynamics of bcc tungsten under a SNAP
potential, with the thermodynamic check of the paper's Sec. VI (the
total energy stays constant; its relative drift is printed).

    PYTHONPATH=src python -m repro_torch.examples.md_nve [--steps 30]
        [--natoms 128] [--impl adjoint|baseline|kernel] [--loop device]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.snap import SnapConfig
from repro_torch.md.integrate import MDState, init_velocities, run_nve
from repro_torch.md.lattice import paper_box, perturb


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='python -m repro_torch.examples.md_nve')
    ap.add_argument('--steps', type=int, default=30)
    ap.add_argument('--natoms', type=int, default=128)
    ap.add_argument('--impl', default='adjoint',
                    choices=['baseline', 'adjoint', 'kernel'])
    ap.add_argument('--twojmax', type=int, default=8)
    ap.add_argument('--loop', default='scan',
                    choices=['device', 'scan', 'host'],
                    help="'device' folds neighbor rebuilds into the chunked "
                         'device loop (cell-list kernels + half-skin '
                         'trigger)')
    ap.add_argument('--skin', type=float, default=1.0,
                    help='Verlet skin radius for --loop device')
    ap.add_argument('--resilient', action='store_true',
                    help='arm the health-flag guards + recovery policy '
                         '(regrow on overflow, rollback on NaN/drift; '
                         '--loop device only)')
    ap.add_argument('--checkpoint', metavar='DIR', default=None,
                    help='directory for periodic atomic MD checkpoints '
                         '(--loop device only)')
    ap.add_argument('--checkpoint-every', type=int, default=10,
                    help='steps between checkpoints (multiple of '
                         'log_every keeps restarts bitwise-identical)')
    ap.add_argument('--restore', action='store_true',
                    help='resume from the latest checkpoint under '
                         '--checkpoint instead of a fresh lattice')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    if (args.resilient or args.checkpoint) and args.loop != 'device':
        ap.error('--resilient/--checkpoint require --loop device')
    if args.restore and not args.checkpoint:
        ap.error('--restore requires --checkpoint DIR')

    cfg = SnapConfig(twojmax=args.twojmax, rcut=4.7)
    rng = np.random.default_rng(1)
    # a stiff-ish random linear SNAP model (a fitted W potential would come
    # from the fit_snap example)
    beta = rng.normal(size=cfg.ncoeff) * 5e-3

    pos, box = paper_box(natoms=args.natoms)
    pos = perturb(pos, 0.02, seed=2)
    state = MDState(pos=pos, vel=init_velocities(len(pos), temp=300.0),
                    box=box)
    policy = None
    if args.resilient:
        from repro_torch.md.resilience import RecoveryPolicy
        policy = RecoveryPolicy()
    cache = {}
    state, thermo = run_nve(cfg, beta, 0.0, state, args.steps,
                            impl=args.impl, log_every=5, loop=args.loop,
                            skin=args.skin, policy=policy,
                            checkpoint_dir=args.checkpoint,
                            checkpoint_every=(args.checkpoint_every
                                              if args.checkpoint else 0),
                            restore=args.restore, fn_cache=cache,
                            device=args.device)
    print(f'{"step":>6} {"T[K]":>10} {"PE[eV]":>14} {"Etot[eV]":>14}')
    for t in thermo:
        print(f'{t["step"]:>6} {t["T"]:>10.2f} {t["pe"]:>14.6f} '
              f'{t["etot"]:>14.6f}')
    events = cache.get('recovery_events', [])
    for ev in events:
        print(f'recovery: step {ev.step} {ev.kind} {ev.detail}')
    drift = abs(thermo[-1]['etot'] - thermo[0]['etot'])
    scale = max(abs(thermo[0]['etot']), 1.0)
    print(f'NVE energy drift: {drift:.3e} eV ({drift / scale:.2e} relative)')
    return dict(thermo=thermo, drift=drift, rel_drift=drift / scale,
                recovery_events=events,
                rebuilds=cache.get('device_rebuilds'))


if __name__ == '__main__':
    main()
