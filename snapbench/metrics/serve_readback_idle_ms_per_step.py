"""Device idle ms a service step while the host reads the batch's results
back: the idle time inside the program's span ``serve.readback`` over the
window's ``serve.step`` spans (force service layer)."""

from snapbench import program


def read(rec):
    n = len(program.spans(rec, 'serve.step')[0])
    if not n or not len(program.spans(rec, 'serve.readback')[0]):
        return None
    return program.idle_ns(rec, 'serve.readback') * 1e-6 / n
