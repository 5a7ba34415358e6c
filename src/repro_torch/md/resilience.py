"""Recovery policy for the on-device MD loop: health-flag triage,
capacity regrowth, rollback bookkeeping, and MD checkpointing.

Port of ``repro.md.resilience``.  The device loop (`md/integrate.py`,
``loop='device'``) carries a sticky int32 health-flag vector
(:mod:`repro_torch.md.cell_list` ``FLAG_*`` slots) through each chunk and
hands it to the host once per logging chunk — the same readback that
returns the thermo rows, so triage costs no extra syncs.  This module is
the host half of that contract:

- :class:`HealthReport` decodes the flag vector against the current grid
  and classifies the chunk as clean / overflowed / numerically bad.
- :class:`RecoveryPolicy` bounds what the device loop may do about it:
  regrow ``cell_cap``/``max_nbors`` with headroom and build one new chunk
  function per regrow (never per chunk), roll back to the last good
  chunk, halve ``dt`` for numeric blow-ups — all a bounded number of
  times before a *typed* error (:class:`NumericalBlowupError` & friends)
  surfaces with full diagnostics.
- :func:`save_md_checkpoint` / :func:`load_md_checkpoint` snapshot the
  complete device carry (positions, velocities, forces, topology,
  flags) in the :mod:`repro_torch.runtime.checkpoint` per-leaf format,
  with the reference's leaf names and dtypes, so either package restores
  the other's snapshots.  Because the *whole* carry is saved, a restore
  resumes from bit-identical state: the continuation is bitwise equal to
  the uninterrupted run.  One rank of an atom-sharded run may load only
  its slice of the per-atom leaves (``rank_slice``).

Every recovery action is recorded as a :class:`RecoveryEvent`, surfaced
through the run's ``fn_cache['recovery_events']``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..runtime import checkpoint as ckpt
from .cell_list import (FLAG_CELL_MAX, FLAG_DRIFT, FLAG_ESCAPE,
                        FLAG_NAN_FORCE, FLAG_NAN_STATE, FLAG_NBR_MAX,
                        N_FLAGS, CellGrid, make_grid)
from .neighbor import suggest_capacity


class MDRuntimeError(RuntimeError):
    """Base for typed, diagnostic-carrying MD runtime failures.

    ``diagnostics`` holds everything the host knows at the failure
    boundary: absolute step, flag vector, grid capacities, retry
    counters — enough to reproduce or resume without re-running.
    """

    def __init__(self, msg: str, diagnostics: Optional[Dict] = None):
        self.diagnostics = dict(diagnostics or {})
        if self.diagnostics:
            pairs = ', '.join(f'{k}={v}' for k, v in
                              sorted(self.diagnostics.items()))
            msg = f'{msg} [{pairs}]'
        super().__init__(msg)


class NumericalBlowupError(MDRuntimeError):
    """Non-finite forces/positions/velocities survived bounded retries."""


class EnergyDriftError(MDRuntimeError):
    """The energy-drift watchdog bound was exceeded past retry budget."""


class AtomEscapeError(MDRuntimeError):
    """An atom left the box by more than escape_factor box lengths."""


class RecoveryExhaustedError(MDRuntimeError):
    """The bounded regrow budget ran out while overflows kept occurring."""


@dataclass(frozen=True)
class RecoveryPolicy:
    """Bounds on what the resilient device loop may do autonomously.

    With a policy in hand, ``run_nve(loop='device')`` turns capacity
    overflows into regrow+rollback (at most ``max_regrows`` new chunk
    functions) and numeric blow-ups into rollback+retry (``dt`` halved
    after ``retries_before_dt_halve`` plain retries,
    ``max_numeric_retries`` total) instead of raising at the first flag.
    ``drift_tol`` (eV, absolute on Etot) arms the in-loop energy watchdog;
    None disables it.
    ``escape_factor`` is in box lengths from the box center — raw
    (unwrapped) positions drift legitimately, so this only fires on the
    multi-box excursions characteristic of an integrator blow-up.
    """
    max_regrows: int = 3
    regrow_headroom: float = 1.3
    max_numeric_retries: int = 3
    retries_before_dt_halve: int = 1
    escape_factor: float = 10.0
    drift_tol: Optional[float] = None


@dataclass
class RecoveryEvent:
    """One host-visible recovery action, in occurrence order."""
    step: int             # absolute MD step of the chunk boundary
    kind: str             # 'regrow' | 'rollback' | 'dt_halve' | 'checkpoint'
    detail: Dict = field(default_factory=dict)


@dataclass
class HealthReport:
    """Decoded health-flag vector at a chunk boundary."""
    nbr_max: int
    cell_max: int
    nan_force: bool
    nan_state: bool
    escaped: bool
    drifted: bool
    grid: CellGrid

    @classmethod
    def from_flags(cls, flags, grid: CellGrid) -> 'HealthReport':
        f = ckpt.host_array(flags).astype(np.int64)
        if f.shape[0] < N_FLAGS:           # bare [2] build flags
            f = np.concatenate([f, np.zeros(N_FLAGS - f.shape[0],
                                            np.int64)])
        return cls(nbr_max=int(f[FLAG_NBR_MAX]),
                   cell_max=int(f[FLAG_CELL_MAX]),
                   nan_force=bool(f[FLAG_NAN_FORCE]),
                   nan_state=bool(f[FLAG_NAN_STATE]),
                   escaped=bool(f[FLAG_ESCAPE]),
                   drifted=bool(f[FLAG_DRIFT]),
                   grid=grid)

    @property
    def nbr_overflow(self) -> bool:
        return self.nbr_max > self.grid.max_nbors

    @property
    def cell_overflow(self) -> bool:
        return self.cell_max > self.grid.cell_cap

    @property
    def overflow(self) -> bool:
        return self.nbr_overflow or self.cell_overflow

    @property
    def numeric(self) -> bool:
        return self.nan_force or self.nan_state or self.escaped \
            or self.drifted

    @property
    def ok(self) -> bool:
        return not (self.overflow or self.numeric)

    def issues(self) -> List[str]:
        out = []
        if self.nbr_overflow:
            out.append(f'nbr_overflow({self.nbr_max}>'
                       f'{self.grid.max_nbors})')
        if self.cell_overflow:
            out.append(f'cell_overflow({self.cell_max}>'
                       f'{self.grid.cell_cap})')
        if self.nan_force:
            out.append('nan_force')
        if self.nan_state:
            out.append('nan_state')
        if self.escaped:
            out.append('atom_escape')
        if self.drifted:
            out.append('energy_drift')
        return out

    def numeric_error(self, diagnostics: Dict) -> MDRuntimeError:
        """The most specific typed error for the observed numeric issue."""
        if self.nan_force or self.nan_state:
            return NumericalBlowupError(
                'non-finite forces/state persisted through rollback '
                'retries', diagnostics)
        if self.escaped:
            return AtomEscapeError(
                'atom escaped the box beyond the escape bound',
                diagnostics)
        return EnergyDriftError(
            'energy drift watchdog bound exceeded past retry budget',
            diagnostics)


def lane_health(flags, max_nbors: int, rcut: float) -> HealthReport:
    """Decode one *batch lane's* flag vector from the serving path.

    The batched force entry
    (:func:`repro_torch.kernels.ops.make_batched_force_fn`, read by
    :class:`repro_torch.launch.serve_forces.ForceServer`) emits the same
    ``FLAG_*`` lattice as the MD device loop but per request lane, with no
    cell table behind it — so the capacity context is just
    the bucket's ``max_nbors``.  A synthetic single-cell grid carries that
    bound so every :class:`HealthReport` property (``overflow``,
    ``numeric``, ``ok``, ``issues``) works unchanged on serving lanes.
    """
    grid = CellGrid(nbins=(1, 1, 1), cell_cap=2 ** 30,
                    max_nbors=int(max_nbors), rcut=float(rcut), skin=0.0,
                    stencil=())
    return HealthReport.from_flags(flags, grid)


def regrow_grid(grid: CellGrid, report: HealthReport,
                policy: RecoveryPolicy) -> CellGrid:
    """New grid with overflowed capacities regrown (headroom applied).

    Only the capacities that actually overflowed grow; bin counts and
    cutoffs are untouched so the stencil and rebuild semantics are
    identical — the regrown grid differs from the old one purely in
    static tensor shapes (one new chunk function, never per chunk).
    """
    cell_cap = grid.cell_cap
    max_nbors = grid.max_nbors
    if report.cell_overflow:
        cell_cap = max(cell_cap + 1,
                       suggest_capacity(report.cell_max,
                                        policy.regrow_headroom))
    if report.nbr_overflow:
        max_nbors = max(max_nbors + 1,
                        suggest_capacity(report.nbr_max,
                                         policy.regrow_headroom))
    return CellGrid(nbins=grid.nbins, cell_cap=cell_cap,
                    max_nbors=max_nbors, rcut=grid.rcut, skin=grid.skin,
                    stencil=grid.stencil)


# ---------------------------------------------------------------------------
# MD checkpointing: full device-carry snapshots on the runtime leaf format

CARRY_KEYS = ('pos', 'vel', 'f', 'nbr_idx', 'shifts', 'mask', 'pos_ref',
              'flags')
# the carry leaves with a leading atom axis (flags and box are global)
ATOM_KEYS = CARRY_KEYS[:-1]


def save_md_checkpoint(root, step: int, carry: Dict, box, grid: CellGrid,
                       extra: Optional[Dict] = None):
    """Atomic snapshot of the complete device carry at ``step``.

    The tree holds every tensor the chunk function consumes (CARRY_KEYS +
    box; ``nbr_idx`` and ``flags`` int32, ``mask`` bool, the rest in the
    state's float dtype), so a restore re-enters the loop from
    bit-identical state; the
    manifest ``extra`` records the static grid geometry/capacities the
    restore needs to rebuild the same static shapes, plus any
    caller context (dt, e_ref, RNG state).
    """
    tree = {k: ckpt.host_array(carry[k]) for k in CARRY_KEYS}
    tree['box'] = ckpt.host_array(box)
    meta = dict(kind='md_carry', nbins=list(grid.nbins),
                cell_cap=grid.cell_cap, max_nbors=grid.max_nbors,
                rcut=grid.rcut, skin=grid.skin)
    meta.update(extra or {})
    path = ckpt.step_dir(root, step)
    ckpt.save(path, tree, step=step, extra=meta)
    return path


def load_md_checkpoint(root, step: Optional[int] = None,
                       rank_slice: Optional[ckpt.RankSlice] = None):
    """Load ``(carry, box, grid, manifest)`` from the latest (or given)
    step under ``root`` (numpy leaves).  The grid is reconstructed from
    the manifest so the restored run builds the exact same static shapes
    the saving run used — the precondition for bitwise continuation.

    ``rank_slice``: read only this rank's rows of the per-atom leaves
    (:data:`ATOM_KEYS`); ``flags`` and ``box`` stay whole."""
    if step is None:
        step = ckpt.latest_step(root)
        if step is None:
            raise FileNotFoundError(
                f'no MD checkpoint found under {root}')
    leaves, manifest = ckpt.restore_named(
        ckpt.step_dir(root, step),
        slices=None if rank_slice is None
        else dict.fromkeys(ATOM_KEYS, rank_slice))
    extra = manifest['extra']
    if extra.get('kind') != 'md_carry':
        raise ValueError(
            f'checkpoint at step {step} is not an MD carry snapshot '
            f'(kind={extra.get("kind")!r})')
    box = leaves.pop('box')
    carry = {k: leaves[k] for k in CARRY_KEYS}
    grid = make_grid(box, extra['rcut'], extra['skin'],
                     extra['cell_cap'], extra['max_nbors'])
    if tuple(grid.nbins) != tuple(extra['nbins']):
        raise ValueError(
            f'restored box implies nbins={grid.nbins} but checkpoint '
            f'was saved with nbins={tuple(extra["nbins"])}')
    return carry, box, grid, manifest
