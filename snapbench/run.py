"""Run one cell of the benchmark once and print its result line.

    python3 snapbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m snapbench.run ...``) from the root of a checkout.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
which also end standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits with 2; if JAX or the
JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, this folder leads the path: its modules are reached as
# ``snapbench.*`` only, so that none hides a module of the same name
sys.path[:] = [p for p in sys.path
               if Path(p or '.').resolve() != ROOT / 'snapbench']
for p in (str(ROOT / 'src'), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from snapbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'snapbench: the cell needs {cell.chips} CUDA card(s); '
              f'{n} found', file=sys.stderr)
        return 2
    result, checks, _ = harness.run_cell(cell, args.seed, args.seconds,
                                         bool(args.trace), 'cuda', T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f'snapbench: modules of JAX or the JAX package were loaded: '
              f'{bad}', file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f'check {name} {value!r} limit {limit!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
