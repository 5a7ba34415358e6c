"""Device idle ms a thousand steps at the MD device loop's chunk
boundaries: the idle time inside the program's spans ``md.seed``,
``md.readback``, ``md.triage`` and ``md.finish`` (a run's set-up, each
chunk's one copy and what the host does with it, the final copy), over
the window's steps (MD driver layer)."""

from snapbench import program

BOUNDARY = ('md.seed', 'md.readback', 'md.triage', 'md.finish')


def read(rec):
    steps = rec.counters.get('steps')
    if not steps or not len(program.spans(rec, 'md.chunk')[0]):
        return None
    idle = sum(program.idle_ns(rec, n) for n in BOUNDARY)
    return idle * 1e-6 / steps * 1e3
