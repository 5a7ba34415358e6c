"""Device operations a step: every operation the profiler saw on the
device in the window, over the steps of the window (MD driver layer)."""


def read(rec):
    steps = rec.counters.get('steps')
    n = rec.count()
    return n / steps if steps and n else None
