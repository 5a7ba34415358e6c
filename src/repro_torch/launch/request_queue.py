"""Shape-bucketed admission control for the force-evaluation service.

A serving front end lives or dies by the number of shape classes it
serves: each is one batched force function with its own launch plans and
cached device tables (one jit trace in the reference), and an
adversarial (or merely diverse) request stream could otherwise build
them without bound.  This module makes the bound *structural*:

- :class:`BucketTable` is a small static table of padded shape classes —
  (model class, padded atom count, padded neighbor width) — fixed at
  server construction.  :meth:`BucketTable.select` maps a request to the
  unique smallest bucket that holds it, deterministically; requests that
  fit no bucket are rejected with a typed error at *admission*, before
  any device work.  The build count is therefore provably bounded by
  ``len(table.all_buckets())`` per implementation path (build-count
  tested in tests/test_torch_serve.py).
- :class:`RequestQueue` is the bounded FIFO between admission and the
  device: when ``max_depth`` is reached new work is *shed* with a typed
  :class:`ServiceOverloadError` instead of queueing unboundedly (the
  latency contract: bounded queue => bounded waiting time).  Dequeue
  groups same-bucket requests so each device step is one batched call.

Errors subclass :class:`repro_torch.md.resilience.MDRuntimeError`, so
every failure carries machine-readable ``diagnostics`` the same way the MD
recovery layer's errors do.

Copy of ``repro.launch.request_queue`` (numpy only): bucket keys, error
names and ``ERROR_TYPES`` are the reference's, so the two packages'
records name the same buckets and failures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..md.resilience import MDRuntimeError


class ServiceError(MDRuntimeError):
    """Base for typed, diagnostic-carrying serving failures."""


class RequestRejectedError(ServiceError):
    """The request fits no bucket in the table (unservable shape/model)."""


class ServiceOverloadError(ServiceError):
    """Admission refused: the bounded queue is full (load shedding)."""


class DeadlineExceededError(ServiceError):
    """The request's deadline passed before a result was produced."""


class RequestFailedError(ServiceError):
    """The request itself failed evaluation (peers are unaffected).

    ``diagnostics`` carries the decoded per-lane health flags and, for
    capacity overflows, the observed neighbor count plus a suggested
    ``max_nbors`` to resubmit with.
    """


class ServiceDrainingError(ServiceError):
    """Admission refused: the server is draining toward shutdown."""


class DuplicateRequestError(ServiceError):
    """A ``req_id`` was resubmitted while the original is still in
    flight.  (Resubmitting a *terminal* accepted request is idempotent —
    the stored outcome is returned, never recomputed — so only the
    in-flight case is an error.)"""


#: Error-class registry by name — how server snapshots rehydrate typed
#: failure outcomes (runtime/checkpoint manifests store only JSON).
ERROR_TYPES = {}


def _register_errors():
    for cls in (ServiceError, RequestRejectedError, ServiceOverloadError,
                DeadlineExceededError, RequestFailedError,
                ServiceDrainingError, DuplicateRequestError):
        ERROR_TYPES[cls.__name__] = cls


_register_errors()


@dataclass
class ForceRequest:
    """One force-evaluation request: a configuration plus its model class.

    ``twojmax``/``rcut`` name the served model class (they change the
    physics, so they are bucket keys, never padded); ``pos``/``box`` are
    the configuration; ``beta``/``beta0`` the potential coefficients.
    ``deadline_s`` is relative to arrival (None = no deadline);
    ``max_nbors_hint`` lets a caller pre-size the neighbor width for
    dense configurations.
    """
    req_id: str
    pos: np.ndarray                    # [N, 3]
    box: np.ndarray                    # [3]
    beta: np.ndarray                   # [ncoeff(twojmax)]
    twojmax: int = 2
    rcut: float = 3.0
    beta0: float = 0.0
    deadline_s: Optional[float] = None
    max_nbors_hint: Optional[int] = None

    @property
    def natoms(self) -> int:
        return int(np.asarray(self.pos).shape[0])


@dataclass(frozen=True)
class Bucket:
    """One padded shape class: everything a compiled entry specializes on."""
    twojmax: int
    rcut: float
    n_pad: int
    max_nbors: int
    batch: int

    @property
    def key(self) -> str:
        return (f'2J{self.twojmax}_rc{self.rcut:g}_n{self.n_pad}'
                f'_k{self.max_nbors}_b{self.batch}')


@dataclass(frozen=True)
class BucketTable:
    """Static set of served shape classes; the compile-count bound.

    ``model_classes`` are the served (twojmax, rcut) pairs — exact-match
    keys, since the cutoff is physics, not padding.  ``n_pads`` and
    ``nbor_ladder`` are ascending shape ladders: a request lands in the
    smallest rung that holds it (monotone padding, property-tested).
    ``batch`` is the static per-step batch width shared by every bucket,
    so batch occupancy never changes the compiled shape.
    """
    model_classes: Tuple[Tuple[int, float], ...] = ((2, 3.0),)
    n_pads: Tuple[int, ...] = (32, 64)
    nbor_ladder: Tuple[int, ...] = (24,)
    batch: int = 4

    def __post_init__(self):
        if list(self.n_pads) != sorted(set(self.n_pads)):
            raise ValueError(f'n_pads must be strictly ascending: '
                             f'{self.n_pads}')
        if list(self.nbor_ladder) != sorted(set(self.nbor_ladder)):
            raise ValueError(f'nbor_ladder must be strictly ascending: '
                             f'{self.nbor_ladder}')

    def select(self, req: ForceRequest) -> Bucket:
        """The unique smallest bucket holding ``req`` (deterministic).

        Raises :class:`RequestRejectedError` — with the table's limits in
        the diagnostics — when the model class is not served or the
        request exceeds every rung of a ladder.
        """
        model = (int(req.twojmax), float(req.rcut))
        if model not in self.model_classes:
            raise RequestRejectedError(
                'unserved model class', dict(
                    req_id=req.req_id, twojmax=req.twojmax, rcut=req.rcut,
                    served=tuple(self.model_classes)))
        n = req.natoms
        n_pad = next((p for p in self.n_pads if p >= n), None)
        if n_pad is None:
            raise RequestRejectedError(
                'request larger than every shape bucket', dict(
                    req_id=req.req_id, natoms=n, max_n=self.n_pads[-1]))
        want_k = req.max_nbors_hint or self.nbor_ladder[0]
        max_nbors = next((k for k in self.nbor_ladder if k >= want_k), None)
        if max_nbors is None:
            raise RequestRejectedError(
                'neighbor width beyond the served ladder', dict(
                    req_id=req.req_id, max_nbors_hint=want_k,
                    max_k=self.nbor_ladder[-1]))
        return Bucket(twojmax=model[0], rcut=model[1], n_pad=n_pad,
                      max_nbors=max_nbors, batch=self.batch)

    def all_buckets(self) -> List[Bucket]:
        """Every bucket the table can ever emit — the compile bound."""
        return [Bucket(tj, rc, n, k, self.batch)
                for (tj, rc) in self.model_classes
                for n in self.n_pads
                for k in self.nbor_ladder]


@dataclass
class QueueEntry:
    """One admitted request with its serving bookkeeping."""
    req: ForceRequest
    bucket: Bucket
    arrival: float
    deadline_abs: Optional[float]      # absolute; None = no deadline
    input_clean: bool                  # finite pos/box/beta at admission
    retries: int = 0
    not_before: float = 0.0            # backoff gate for retried entries
    queued_ns: int = 0                 # perf_counter_ns at (re)queueing


@dataclass
class RequestQueue:
    """Bounded FIFO with bucket-grouped dequeue and load shedding."""
    max_depth: int = 64
    entries: List[QueueEntry] = field(default_factory=list)
    shed_count: int = 0

    @property
    def depth(self) -> int:
        return len(self.entries)

    def submit(self, entry: QueueEntry, now: float) -> None:
        """Admit or shed.  Shedding raises :class:`ServiceOverloadError`
        immediately — the caller gets a typed signal at submit time, not
        an unbounded wait."""
        if len(self.entries) >= self.max_depth:
            self.shed_count += 1
            raise ServiceOverloadError(
                'queue full, request shed', dict(
                    req_id=entry.req.req_id, depth=len(self.entries),
                    max_depth=self.max_depth, now=round(now, 6)))
        self.entries.append(entry)

    def requeue(self, entry: QueueEntry) -> None:
        """Put a retrying entry back (not counted against admission: it
        already holds a slot's worth of latency budget)."""
        self.entries.append(entry)

    def next_batch(self, now: float) -> Optional[List[QueueEntry]]:
        """FIFO-fair batch: the oldest *eligible* entry picks the bucket,
        then up to ``bucket.batch`` eligible same-bucket entries join it.
        Returns None when nothing is eligible (empty, or all entries are
        backing off — see :meth:`next_eligible_time`).

        Single-pass partition: entries are split into the dispatched
        batch and the surviving queue in one traversal (the previous
        ``list.remove`` per batch member was quadratic in queue depth),
        preserving FIFO order in both (regression-tested)."""
        head = next((e for e in self.entries if e.not_before <= now), None)
        if head is None:
            return None
        batch: List[QueueEntry] = []
        rest: List[QueueEntry] = []
        for e in self.entries:
            if (e.bucket == head.bucket and e.not_before <= now
                    and len(batch) < head.bucket.batch):
                batch.append(e)
            else:
                rest.append(e)
        self.entries = rest
        return batch

    def next_eligible_time(self) -> Optional[float]:
        """Earliest ``not_before`` in the queue (None when empty) — lets
        the caller advance its clock instead of busy-waiting on backoff."""
        if not self.entries:
            return None
        return min(e.not_before for e in self.entries)
