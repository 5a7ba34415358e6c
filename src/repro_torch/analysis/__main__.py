"""``python -m repro_torch.analysis`` — run the static-analysis suite.

Prints the findings table, optionally writes the JSON report (the CI
artifact), checks the budget ratchet against the section of
``budgets.json`` for the device it ran on, and exits nonzero on any
unallowlisted error-severity finding.  Runs on the card unless
``--device cpu`` asks for the plain versions.

    python -m repro_torch.analysis                       # card, budgets
    python -m repro_torch.analysis --device cpu
    python -m repro_torch.analysis --entry force.kernel.half
    python -m repro_torch.analysis --json report.json    # CI artifact
    python -m repro_torch.analysis --write-budgets       # regenerate
    python -m repro_torch.analysis --registry tests/foo.py:my_registry
    python -m repro_torch.analysis --ranks 2 --entry force.torch.sharded

A registry is a callable taking ``device`` and returning entry points.
``--ranks N`` runs it in each of N processes of one gloo group on
localhost (the port's counterpart of the reference's device count: the
process-group-gated entry, ``force.torch.sharded``, registers only
there); rank 0's report is the one printed, checked and written.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m repro_torch.analysis',
        description='static-analysis lint suite over the registered entry '
                    'points of the port')
    ap.add_argument('--registry',
                    default='repro_torch.analysis.registry:default_registry',
                    help='MODULE:ATTR or file.py:ATTR returning the '
                         'entry-point list')
    ap.add_argument('--entry', action='append', default=None,
                    help='analyze only this entry (repeatable)')
    ap.add_argument('--budgets', default=None,
                    help="budgets JSON path (default: budgets.json of the "
                         "package; 'none' disables)")
    ap.add_argument('--write-budgets', action='store_true',
                    help="measure, then (re)write the device's section of "
                         'the budgets file instead of checking it')
    ap.add_argument('--json', default=None, metavar='PATH',
                    help='write the full JSON report here')
    ap.add_argument('--list', action='store_true',
                    help='list registered entry points and exit')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help="'cuda' (default): the kernels on the card; "
                         "'cpu': their plain versions")
    ap.add_argument('--ranks', type=int, default=1,
                    help='run the registry in each of N ranks of one gloo '
                         'group (the sharded entry registers only there); '
                         'rank 0 reports')
    args = ap.parse_args(argv)

    import torch

    from ..core.snap import resolve_device
    from .budgets import DEFAULT_PATH, load_budgets, write_budgets
    from .runner import entries_of, rank_report, run_registry

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f'python -m repro_torch.analysis: {e}')
    if args.list:
        for ep in entries_of(args.registry, device, args.entry):
            print(f'{ep.name:<28} {ep.description}')
        return 0

    budget_path = args.budgets or DEFAULT_PATH
    budgets = None
    if not args.write_budgets and budget_path != 'none':
        budgets = load_budgets(budget_path, device.type)
        if budgets is None and args.budgets is not None:
            raise SystemExit(f'budgets file not found: {budget_path}')

    if args.ranks > 1:
        from ..launch.sharding import spawn_ranks
        report = spawn_ranks(rank_report, args.ranks, args.registry,
                             str(device), args.entry, budgets)[0]
    else:
        report = run_registry(
            entries_of(args.registry, device, args.entry), budgets=budgets,
            progress=lambda name: print(f'analyzing {name} ...',
                                        file=sys.stderr))
    report.meta['device'] = (torch.cuda.get_device_name(device)
                             if device.type == 'cuda' else 'cpu')

    if args.write_budgets:
        write_budgets(report, budget_path, device.type)
        print(f'wrote the {device.type} section of {budget_path}',
              file=sys.stderr)

    print(report.table())
    if args.json:
        with open(args.json, 'w') as f:
            f.write(report.dumps())
        print(f'report written to {args.json}', file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == '__main__':
    sys.exit(main())
