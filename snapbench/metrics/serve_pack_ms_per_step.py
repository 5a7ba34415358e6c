"""Host ms a service step in packing a batch: the program's span
``serve.pack`` less the ``serve.upload`` inside it, over the window's
``serve.step`` spans (force service layer)."""

from snapbench import program


def read(rec):
    n = len(program.spans(rec, 'serve.step')[0])
    s, e = program.spans(rec, 'serve.pack')
    if not n or not len(s):
        return None
    u0, u1 = program.spans(rec, 'serve.upload')
    up = (u1 - u0)[program.inside(u0, u1, (s, e))].sum()
    return float((e - s).sum() - up) * 1e-6 / n
