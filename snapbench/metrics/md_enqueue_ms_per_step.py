"""Host ms a step of the MD device loop: the mean length of the program's
span ``md.step``, the host's enqueue of one step's operations (MD driver
layer)."""

from snapbench import program


def read(rec):
    s, e = program.spans(rec, 'md.step')
    return float((e - s).mean()) * 1e-6 if len(s) else None
