"""The share of its roofline that Y (``snap_y``) reaches in the MD
window: the least time the window's evaluations need for the work the
inputs need (:mod:`snapbench.cost`) over the kernels' device time, %."""

from snapbench.roofline import stage_share


def read(rec):
    return stage_share(rec, 'y')
