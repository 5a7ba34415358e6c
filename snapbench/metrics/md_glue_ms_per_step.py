"""Device ms a step of the operations that are not the port's hand-written
kernels: the device loop's torch operations, copies and memsets (MD driver
layer)."""

from snapbench.trace import HAND_WRITTEN


def read(rec):
    steps = rec.counters.get('steps')
    if not steps or not rec.count():
        return None
    return rec.time_s(exclude=HAND_WRITTEN) * 1e3 / steps
