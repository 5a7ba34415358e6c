"""The share of its roofline that the all-pairs neighbour build
(``brute_build``) reaches in the service's window: the least time for the
B x N^2 candidate pairs of each lane's valid atoms and the pairs found
(:mod:`snapbench.cost`, float64 positions) over its device time, %."""

from snapbench import cost
from snapbench.trace import KERNELS


def read(rec):
    c = rec.counters
    t = rec.time_s(KERNELS['brute'])
    if t <= 0 or 'pairs_served' not in c:
        return None
    flops = cost.brute_flops(c['lane_sq'])
    nbytes = c['atoms_served'] * 3 * 8 + c['pairs_served'] * (4 + 3 * 8)
    return 100 * cost.bound_s(flops, nbytes, 'float64') / t
