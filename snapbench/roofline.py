"""Shares of the card's bounds, from a traced window's record and the
needed work of :mod:`snapbench.cost` (shared by the per-layer readers)."""

from __future__ import annotations

from . import cost
from .trace import KERNELS


def stage_share(rec, stage: str):
    """% of its bound that one SNAP stage's kernels reach in an MD window:
    the needed work of every evaluation the window ran, at the pairs the
    inputs hold, over the kernels' device time; None without either."""
    c = rec.counters
    t = rec.time_s(KERNELS[stage])
    if t <= 0 or not c.get('pairs'):
        return None
    flops, nbytes = cost.stage_work(c['twojmax'], c['atoms'], c['pairs'],
                                    c['dtype'])[stage]
    return 100 * c['evaluations'] * cost.bound_s(flops, nbytes,
                                                 c['dtype']) / t


def mfu(rec, evaluations, atoms, pairs):
    """% of the type's peak that the SNAP operations of ``evaluations``
    evaluations of ``atoms`` atoms and ``pairs`` pairs make over the
    window; None without device events or counts."""
    c = rec.counters
    if not evaluations or not atoms or not pairs or not rec.count():
        return None
    work = cost.stage_work(c['twojmax'], atoms, pairs, c['dtype'])
    flops = evaluations * sum(f for f, _ in work.values())
    return 100 * flops / rec.window_s / cost.PEAK_FLOPS[c['dtype']]


def idle_share(rec):
    """% of the window in which no operation ran on the device."""
    if not rec.count():
        return None
    return 100 * (1 - rec.busy_s / rec.window_s)
