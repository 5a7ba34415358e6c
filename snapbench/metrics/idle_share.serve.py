"""The share of the service's window in which no operation ran on the
device, %."""

from snapbench.roofline import idle_share


def read(rec):
    return idle_share(rec)
