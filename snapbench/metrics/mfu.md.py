"""The whole MD step's share of the card's peak: the SNAP operations (U, Y,
fused dE, assembly) that the window's evaluations need for their valid
pairs and atoms, over the window's length and the peak of the type, %."""

from snapbench.roofline import mfu


def read(rec):
    return mfu(rec, rec.counters.get('evaluations'), rec.counters.get('atoms'),
               rec.counters.get('pairs'))
