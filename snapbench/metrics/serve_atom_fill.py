"""The share of the batches' atom slots that hold a request's atom: the
program's counters ``serve.atoms`` over ``serve.atom_slots`` (lanes x
padded atoms) in the window, % (force service layer)."""

from snapbench import program


def read(rec):
    c = program.counts(rec, 'serve.step')
    if not c or not c.get('serve.atom_slots'):
        return None
    return 100 * c.get('serve.atoms', 0) / c['serve.atom_slots']
