"""Host us a step in the launches of the hand-written kernels: the
program's ``kernel.<symbol>`` spans inside its ``md.step`` spans (each
the ctypes call that launches one kernel), summed over the window's
steps (MD driver layer)."""

from snapbench import program


def read(rec):
    steps = rec.counters.get('steps')
    outer = program.spans(rec, 'md.step')
    if not steps or not len(outer[0]):
        return None
    s, e = program.kernel_spans(rec)
    ok = program.inside(s, e, outer)
    return float((e[ok] - s[ok]).sum()) * 1e-3 / steps
