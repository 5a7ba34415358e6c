"""The whole batched step's share of the card's peak: the SNAP operations
(U, Y, fused dE, assembly) of the requests served in the window, for their
valid atoms and pairs, over the window's length and the peak of the type,
%."""

from snapbench.roofline import mfu


def read(rec):
    return mfu(rec, 1, rec.counters.get('atoms_served'),
               rec.counters.get('pairs_served'))
