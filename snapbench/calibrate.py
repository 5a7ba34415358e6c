"""Read a cell's compared numbers over many seeds, for the program and for
its control, in one process: the readings its limits are set from.

    python3 snapbench/calibrate.py --workload md-2j8-16k --seeds 12 \
        --control-seeds 3 --seconds 2 [--first 3000000000]

The control is the limits file's ``control``: the program in the nearest
lower precision (float32 for a float64 cell; bfloat16 Y operands for a
float32 one).  Every run is a whole run of the cell (set-up, a window of
``--seconds``, the check), on the card.  Prints one JSON line a run, then
for each number the largest program reading and the smallest control
reading.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path
               if Path(p or '.').resolve() != ROOT / 'snapbench']
for p in (str(ROOT / 'src'), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--control-seeds', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--first', type=int, default=3_000_000_000)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    from snapbench import harness
    cell = harness.load_cell(args.workload)
    readings = {'program': {}, 'control': {}}
    runs = [('program', None, k) for k in range(args.seeds)]
    runs += [('control', cell.limits['control'], k)
             for k in range(args.control_seeds)]
    for side, control, k in runs:
        seed = args.first + 7919 * k
        t = time.perf_counter()
        res, _, read = harness.run_cell(cell, seed, args.seconds, False,
                                        args.device, control=control)
        row = dict(side=side, seed=seed, correct=res['correct'],
                   seconds=round(time.perf_counter() - t, 3), **read)
        print(json.dumps(row), flush=True)
        for n, v in read.items():
            readings[side].setdefault(n, []).append(v)
    summary = {n: dict(program_max=max(v),
                       control_min=min(readings['control'].get(n, [None]),
                                       key=lambda x: float('inf')
                                       if x is None else x))
               for n, v in readings['program'].items()}
    print(json.dumps(dict(workload=args.workload, summary=summary)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
