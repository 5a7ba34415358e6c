"""Neighbour rebuilds a thousand steps: the program's counter
``md.rebuilds`` (the rebuilds the trigger let run, read back once a
chunk) over the window's steps (neighbour builds layer)."""

from snapbench import program


def read(rec):
    steps = rec.counters.get('steps')
    c = program.counts(rec, 'md.chunk')
    if not steps or c is None:
        return None
    return c.get('md.rebuilds', 0) * 1e3 / steps
