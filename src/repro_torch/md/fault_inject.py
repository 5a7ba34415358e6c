"""Deterministic fault injection for the resilient MD device loop and the
force service.

Port of ``repro.md.fault_inject``.  The request faults
(:class:`KernelPathFault`, :func:`poison_request_positions`,
:class:`RequestFaultPlan`, :class:`ServeFault`,
:class:`ServeFaultInjector`) drive
:class:`repro_torch.launch.serve_forces.ForceServer`, and
:class:`ChaosPlan` composes them with crashes for the chaos soak
(:mod:`repro_torch.launch.chaos`); the rest of this docstring is about
the MD faults.  The device loop calls its ``fault_hook`` once per chunk boundary, after
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
from typing import Dict, List, Optional

import numpy as np

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


# ---------------------------------------------------------------------------
# request-level faults for the force service (launch/serve_forces)
# ---------------------------------------------------------------------------

class KernelPathFault(RuntimeError):
    """A deliberately induced kernel-path failure during a serve step.

    Models the faults the graceful-degradation policy exists for: the
    kernel path dying on a bucket (a runtime bug, out of memory, a
    kernel that fails to launch) while the adjoint path stays healthy.  The
    server answers by re-running the step on the adjoint path and — after
    a bounded number of such faults — quarantining the bucket to it.
    """

    def __init__(self, bucket_key: str, step: int):
        self.bucket_key = bucket_key
        self.step = int(step)
        super().__init__(f'simulated kernel-path fault for bucket '
                         f'{bucket_key} at serve step {self.step}')


REQUEST_KINDS = ('nan_pos', 'overflow')


def poison_request_positions(pos):
    """NaN-poison one coordinate — the canonical bad-input request."""
    pos = np.array(pos, dtype=float, copy=True)
    pos[0, 0] = np.nan
    return pos


@dataclass
class RequestFaultPlan:
    """Deterministically poison a fraction of a synthetic request stream.

    ``assign(n)`` picks ``round(fraction * n)`` request indices with a
    seeded numpy RNG and cycles them through ``kinds`` — the reference's
    plan for the same seed.  'nan_pos' requests carry a non-finite
    coordinate; 'overflow' requests must be *constructed* overflowing
    (denser than the bucket's neighbor width) by the load generator — the
    plan only decides which indices get that treatment.
    """
    fraction: float = 0.1
    seed: int = 0
    kinds: tuple = REQUEST_KINDS

    def assign(self, n_requests: int) -> Dict[int, str]:
        for k in self.kinds:
            if k not in REQUEST_KINDS:
                raise ValueError(f'unknown request fault kind {k!r}; '
                                 f'choose from {REQUEST_KINDS}')
        n_bad = int(round(self.fraction * n_requests))
        rng = np.random.default_rng(self.seed)
        idx = rng.choice(n_requests, size=min(n_bad, n_requests),
                         replace=False)
        return {int(i): self.kinds[j % len(self.kinds)]
                for j, i in enumerate(sorted(idx))}


SERVE_KINDS = ('kernel_fault', 'transient_nan')


@dataclass
class ServeFault:
    """One serve-step fault: fires at the first step index >= ``step``."""
    step: int
    kind: str                  # one of SERVE_KINDS
    bucket_key: Optional[str] = None   # None = any bucket
    persistent: bool = False

    def __post_init__(self):
        if self.kind not in SERVE_KINDS:
            raise ValueError(f'unknown serve fault kind {self.kind!r}')


@dataclass(frozen=True)
class ChaosPlan:
    """Seeded, deterministic composition of *every* serving fault class
    over a crash/restart loop — the input to the chaos soak
    (:func:`repro_torch.launch.chaos.run_chaos_soak`).

    The plan is pure data: the same seed always produces the same
    request stream (sizes, arrival times, poison assignment via
    :class:`RequestFaultPlan`), the same overload burst, the same
    kernel-fault schedule, and the same crash points — the reference's
    plan for the same fields.

    - ``fraction_bad`` of the stream is poisoned (NaN inputs /
      overflow-dense boxes, cycled as in :class:`RequestFaultPlan`).
    - ``kernel_fault_step``: from this per-incarnation serve step on,
      every kernel-path dispatch raises :class:`KernelPathFault`
      (persistent — this is what drives the bucket into quarantine).
      ``None`` disables kernel faults.
    - ``crash_dispatches``: *cumulative* batch-dispatch counts (across
      restarts) at which a :class:`SimulatedCrash` fires mid-step —
      after admission and dequeue, before any result is produced, the
      window where durability is hardest.
    - ``overload_burst_n`` requests arrive simultaneously at
      ``overload_burst_at`` so a bounded queue must visibly shed.
    - ``torn_tail``: after each crash, append a partial JSON line to the
      journal (a crash mid-append) — the reader must drop it and the
      appender must heal it.
    """
    n_requests: int = 16
    seed: int = 0
    rate: float = 50.0
    fraction_bad: float = 0.2
    kernel_fault_step: Optional[int] = 2
    crash_dispatches: tuple = (3, 7)
    overload_burst_at: float = 0.05
    overload_burst_n: int = 12
    torn_tail: bool = True

    def request_faults(self) -> RequestFaultPlan:
        return RequestFaultPlan(fraction=self.fraction_bad,
                                seed=self.seed)

    def serve_faults(self) -> List[ServeFault]:
        if self.kernel_fault_step is None:
            return []
        return [ServeFault(step=self.kernel_fault_step,
                           kind='kernel_fault', persistent=True)]


@dataclass
class ServeFaultInjector:
    """Deterministic per-step fault plan for the force server.

    A valid ``fault_hook`` for
    :class:`repro_torch.launch.serve_forces.ForceServer`: called once per
    batch dispatch with ``(step, bucket_key, arrays, impl)`` *after*
    admission, so the queued request — the retry's source — stays clean.

    - 'kernel_fault' raises :class:`KernelPathFault`: the server re-runs
      the step on the adjoint path and counts a strike toward the
      bucket's quarantine.  It fires only when the dispatching path is the
      kernel one, so quarantine ends the fault storm.
    - 'transient_nan' poisons a clone of the packed position tensor
      (atom 0 of every lane) on any path: input-clean requests come back
      flagged, and the server requeues them with backoff.
    """
    faults: List[ServeFault]
    fired: List[Dict] = field(default_factory=list)

    def __call__(self, step: int, bucket_key: str, arrays: Dict,
                 impl: str = 'kernel') -> Dict:
        arrays = dict(arrays)
        for fault in self.faults:
            if step < fault.step:
                continue
            if fault.kind == 'kernel_fault' and impl != 'kernel':
                continue
            if fault.bucket_key is not None \
                    and fault.bucket_key != bucket_key:
                continue
            if not fault.persistent and any(
                    f['kind'] == fault.kind and f['fault_step'] == fault.step
                    for f in self.fired):
                continue
            self.fired.append(dict(step=step, fault_step=fault.step,
                                   kind=fault.kind, bucket=bucket_key))
            if fault.kind == 'kernel_fault':
                raise KernelPathFault(bucket_key, step)
            pos = arrays['pos'].clone()
            pos[:, 0, 0] = float('nan')
            arrays['pos'] = pos
        return arrays
