"""Device ms a thousand steps of the neighbour build: ``cell_bin`` and
``cell_build``, including the launches the trigger gates to no work."""

from snapbench.trace import KERNELS


def read(rec):
    steps = rec.counters.get('steps')
    if not steps or not rec.count(KERNELS['neighbor']):
        return None
    return rec.time_s(KERNELS['neighbor']) * 1e3 / steps * 1e3
