"""Host ms a service step in decoding each lane's flags into its result:
the program's span ``serve.triage`` over the window's ``serve.step``
spans (force service layer)."""

from snapbench import program


def read(rec):
    n = len(program.spans(rec, 'serve.step')[0])
    s, e = program.spans(rec, 'serve.triage')
    if not n or not len(s):
        return None
    return float((e - s).sum()) * 1e-6 / n
