"""Deterministic fault injection for the resilient MD device loop.

Port of the MD part of ``repro.md.fault_inject`` (the request and chaos
injectors of the force service wait for its port, ROADMAP Queue A item 5).
The device loop calls its ``fault_hook`` once per chunk boundary, after
keeping the last-good carry but *before* launching the chunk — so an
injected fault corrupts exactly one chunk attempt and the rollback target
stays clean:

- ``nan_force`` / ``nan_vel``: poison one element of the carried force /
  velocity tensor; the in-loop finite guards latch the sticky flag and
  the device loop rolls back + retries (the retry sees the clean carry).
- ``overflow_nbr`` / ``overflow_cell``: bump the corresponding health
  flag past capacity, simulating a density fluctuation the static lists
  cannot hold; the device loop regrows capacities, builds one new chunk
  function, and rolls back.
- ``crash``: raise :class:`SimulatedCrash` at the boundary, modelling a
  host death between chunks.

The poisoned tensor is a clone: the committed carry's tensors are never
written, so rollback returns to exactly the state before the fault.
Faults fire at the first chunk boundary whose absolute step is >= their
``step``, exactly once unless configured persistent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .cell_list import FLAG_CELL_MAX, FLAG_NBR_MAX, CellGrid


class SimulatedCrash(RuntimeError):
    """A deliberately induced host death at a chunk boundary."""

    def __init__(self, step: int):
        self.step = int(step)
        super().__init__(f'simulated host crash at step {self.step}')


KINDS = ('nan_force', 'nan_vel', 'overflow_nbr', 'overflow_cell', 'crash')


@dataclass
class Fault:
    step: int            # fire at the first chunk boundary >= this step
    kind: str            # one of KINDS
    persistent: bool = False   # re-fire at every boundary once armed

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f'unknown fault kind {self.kind!r}; '
                             f'choose from {KINDS}')


def _set(t, index, value):
    """A clone of tensor ``t`` with ``t[index] = value``."""
    t = t.clone()
    t[index] = value
    return t


@dataclass
class FaultInjector:
    """Deterministic chunk-boundary fault plan (a valid ``fault_hook``).

    Records every firing in ``fired`` (step, kind) so tests can assert
    the plan actually executed.
    """
    faults: List[Fault]
    fired: List[Dict] = field(default_factory=list)

    def __call__(self, step: int, carry: Dict, grid: CellGrid) -> Dict:
        carry = dict(carry)
        for fault in self.faults:
            if step < fault.step:
                continue
            if not fault.persistent and any(
                    f['kind'] == fault.kind and f['fault_step'] == fault.step
                    for f in self.fired):
                continue
            self.fired.append(dict(step=step, fault_step=fault.step,
                                   kind=fault.kind))
            if fault.kind == 'crash':
                raise SimulatedCrash(step)
            if fault.kind == 'nan_force':
                carry['f'] = _set(carry['f'], (0, 0), float('nan'))
            elif fault.kind == 'nan_vel':
                carry['vel'] = _set(carry['vel'], (0, 0), float('nan'))
            elif fault.kind == 'overflow_nbr':
                carry['flags'] = _set(carry['flags'], FLAG_NBR_MAX,
                                      grid.max_nbors + 3)
            elif fault.kind == 'overflow_cell':
                carry['flags'] = _set(carry['flags'], FLAG_CELL_MAX,
                                      grid.cell_cap + 2)
        return carry
