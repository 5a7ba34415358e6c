"""Write-ahead request journal for the force-evaluation service.

Copy of ``repro.launch.journal``: the same events, record fields, base64
array packing and force digests, so a journal written by either package
reads and replays in the other.  Where the reference takes arrays, this
copy also takes tensors.

Durability layer of the serving contract: once
:meth:`repro_torch.launch.serve_forces.ForceServer.submit` returns, the
request is an *ack the service must honor across a crash*.  The journal
is what makes that true — an append-only JSON-lines file recording every
admitted request's lifecycle, so a restarted server can reconstruct
exactly which acks are still outstanding:

- ``accepted``  — the request passed admission; the event carries the
  *full request payload* (positions, box, beta, model class, absolute
  deadline), so replay needs nothing but the journal.
- ``requeued``  — a transient fault sent the request back with backoff
  (bookkeeping; the clean payload in the ``accepted`` event is still
  the replay source).
- ``completed`` — terminal success; carries the energy and a SHA-256
  digest of the force array so bitwise stability across restarts is
  checkable without storing forces in the journal.
- ``failed``    — terminal typed failure; carries the error type.

Crash model (mirrors ``runtime/checkpoint.py``):

- **Appends are atomic per line.**  Each event is one ``\\n``-terminated
  line, flushed per append and fsynced every ``fsync_every`` appends
  (batched fsync: the durability/throughput knob).  A crash can truncate
  at most the tail of the file, mid-line.
- **The reader tolerates a torn tail.**  :func:`read_events` stops at
  the first undecodable line — a torn tail costs the events after it
  (bounded by the fsync batch), never a parse crash.
- **The appender heals a torn tail.**  Re-opening for append truncates
  back to the last complete line first, so a post-crash append can never
  fuse with a partial record into one corrupt line.

Replay semantics live in :func:`replay`: fold events into per-request
state, idempotent by ``req_id`` — a request re-journaled as ``accepted``
by a previous replay is still one request, and any ``completed`` /
``failed`` event anywhere in the log makes it terminal forever.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

EVENTS = ('accepted', 'requeued', 'completed', 'failed')
TERMINAL = ('completed', 'failed')


def forces_digest(forces) -> str:
    """Stable digest of a force array — the bitwise-identity witness
    carried by ``completed`` events (and checked by the chaos soak).
    ``forces``: an array, or a tensor on any device (copied to the host)."""
    if isinstance(forces, torch.Tensor):
        forces = forces.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(forces))
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


def pack_array(arr) -> Dict:
    """Encode an array as base64 raw bytes + dtype/shape.  Exact
    bit-level round-trip (replayed requests must evaluate bitwise
    identically), and ~10x cheaper to serialize than decimal JSON —
    append cost is on the submit path, so it is part of ack latency."""
    a = np.ascontiguousarray(np.asarray(arr))
    return dict(b64=base64.b64encode(a.tobytes()).decode('ascii'),
                dtype=str(a.dtype), shape=list(a.shape))


def unpack_array(packed) -> np.ndarray:
    arr = np.frombuffer(base64.b64decode(packed['b64']),
                        dtype=np.dtype(packed['dtype']))
    return arr.reshape(packed['shape']).copy()


def _jsonable(obj):
    """Recursively coerce numpy scalars/arrays, tensors and tuples into
    plain JSON-serializable python (journal lines must always be writable)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


class Journal:
    """Append-only write-ahead journal (one JSON object per line).

    ``fsync_every`` batches fsyncs: every append is *flushed* (a clean
    process exit or same-host crash loses nothing), and every N-th
    append additionally fsyncs (bounding what an OS/power crash can
    lose).  ``sync()`` forces an fsync; ``close()`` syncs and closes.

    Opening an existing journal continues its ``seq`` numbering and
    heals a torn tail (see module docstring) before the first append.
    """

    def __init__(self, path, fsync_every: int = 16):
        self.path = Path(path)
        self.fsync_every = max(1, int(fsync_every))
        self._since_sync = 0
        self._seq = 0
        if self.path.exists():
            self._heal_torn_tail()
            events = read_events(self.path)
            if events:
                self._seq = max(e.get('seq', 0) for e in events)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, 'a', encoding='utf-8')

    def _heal_torn_tail(self) -> None:
        """Truncate back to the last complete ('\\n'-terminated) line so
        appending after a crash cannot fuse with a partial record."""
        raw = self.path.read_bytes()
        if not raw or raw.endswith(b'\n'):
            return
        cut = raw.rfind(b'\n')
        with open(self.path, 'r+b') as fh:
            fh.truncate(cut + 1 if cut >= 0 else 0)

    @property
    def seq(self) -> int:
        """Sequence number of the most recently appended event."""
        return self._seq

    def append(self, event: str, req_id: str, **fields) -> int:
        """Append one event; returns its ``seq``.  Flushes always,
        fsyncs every ``fsync_every`` appends."""
        if event not in EVENTS:
            raise ValueError(f'unknown journal event {event!r}; '
                             f'choose from {EVENTS}')
        self._seq += 1
        rec = dict(seq=self._seq, ev=event, req_id=str(req_id))
        rec.update(_jsonable(fields))
        self._fh.write(json.dumps(rec, separators=(',', ':')) + '\n')
        self._fh.flush()
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            self.sync()
        return self._seq

    def sync(self) -> None:
        if self._since_sync == 0:
            return                        # nothing new since last fsync
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._since_sync = 0

    def close(self) -> None:
        if not self._fh.closed:
            self.sync()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path) -> List[Dict]:
    """Read a journal, tolerant of crash truncation: parsing stops at
    the first undecodable line (a torn tail from a crash mid-append)
    and returns every complete event before it.  A missing file is an
    empty journal."""
    path = Path(path)
    if not path.exists():
        return []
    events: List[Dict] = []
    with open(path, 'r', encoding='utf-8') as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break                      # torn tail: drop it and stop
            if not isinstance(rec, dict) or 'ev' not in rec:
                break
            events.append(rec)
    return events


@dataclass
class RequestRecord:
    """Folded per-request journal state (see :func:`replay`)."""
    req_id: str
    accepted: Optional[Dict] = None        # first 'accepted' event
    terminal: Optional[Dict] = None        # first terminal event
    n_accepted: int = 0                    # incl. replay re-admissions
    n_terminal: int = 0                    # must be <= 1 (invariant)
    requeues: int = 0


@dataclass
class ReplayState:
    """The journal folded down to what a restarted server needs."""
    records: Dict[str, RequestRecord] = field(default_factory=dict)
    last_seq: int = 0

    @property
    def acked(self) -> List[str]:
        """req_ids with at least one 'accepted' event, in first-accepted
        order (dicts preserve insertion order)."""
        return [r.req_id for r in self.records.values()
                if r.accepted is not None]

    @property
    def pending(self) -> List[RequestRecord]:
        """Accepted, non-terminal records in first-accepted order — the
        set a restart must re-admit exactly once each."""
        return [r for r in self.records.values()
                if r.accepted is not None and r.terminal is None]


def replay(events: List[Dict]) -> ReplayState:
    """Fold a journal into per-request state, idempotent by ``req_id``:
    repeated ``accepted`` events (from replays re-journaling their
    re-admissions) collapse onto the first, and the first terminal event
    wins forever."""
    state = ReplayState()
    for ev in events:
        state.last_seq = max(state.last_seq, int(ev.get('seq', 0)))
        rid = ev['req_id']
        rec = state.records.setdefault(rid, RequestRecord(req_id=rid))
        kind = ev['ev']
        if kind == 'accepted':
            rec.n_accepted += 1
            if rec.accepted is None:
                rec.accepted = ev
        elif kind == 'requeued':
            rec.requeues += 1
        elif kind in TERMINAL:
            rec.n_terminal += 1
            if rec.terminal is None:
                rec.terminal = ev
    return state
