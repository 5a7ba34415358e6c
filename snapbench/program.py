"""The program's own spans and counts in a traced window (shared by the
per-layer readers that read them).

The port names stretches of its host work ``repro_torch.<name>`` in the
profile (``repro_torch/runtime/trace.py``); they are host events on the
profiler's clock, so they are among the record's host operations.  Its
counters of the profiled stretch come from ``profiled_counts()``.  On a
program without them every lookup finds nothing: the readers then
return None.
"""

from __future__ import annotations

import numpy as np

PREFIX = 'repro_torch.'


def _index(rec):
    """{span name: (starts, ends)} of the program's spans inside the
    window, each sorted by start; built once a record."""
    found = getattr(rec, '_program_spans', None)
    if found is None:
        lo, hi = rec.window
        acc = {}
        for i, n in enumerate(rec.host_names):
            if n.startswith(PREFIX):
                s, e = int(rec.host_start[i]), int(rec.host_end[i])
                if s >= lo and e <= hi:
                    acc.setdefault(n[len(PREFIX):], []).append((s, e))
        found = {n: (np.array([s for s, _ in v], np.int64),
                     np.array([e for _, e in v], np.int64))
                 for n, v in acc.items()}
        rec._program_spans = found
    return found


def spans(rec, name):
    """(starts, ends) ns of the span ``name`` in the window (empty arrays
    when there is none)."""
    empty = np.zeros(0, np.int64)
    return _index(rec).get(name, (empty, empty))


def kernel_spans(rec):
    """(starts, ends) of every ``kernel.<symbol>`` span, by start."""
    parts = [v for n, v in _index(rec).items() if n.startswith('kernel.')]
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    s = np.concatenate([p[0] for p in parts])
    e = np.concatenate([p[1] for p in parts])
    o = np.argsort(s, kind='stable')
    return s[o], e[o]


def inside(starts, ends, outer):
    """Mask of the spans (starts, ends) that lie inside one of the
    disjoint spans ``outer``."""
    o0, o1 = outer
    j = np.searchsorted(o0, starts, 'right') - 1
    ok = j >= 0
    ok[ok] &= ends[ok] <= o1[j[ok]]
    return ok


def idle_ns(rec, name) -> int:
    """Device idle ns inside the spans ``name``."""
    s, e = spans(rec, name)
    return int(sum((b - a) - rec.busy_within(a, b)
                   for a, b in zip(s.tolist(), e.tolist())))


def counts(rec, marker):
    """The program's counts of the profiled stretch, or None when the
    record holds no span ``marker`` of the program (a program without
    spans, or a record of other work)."""
    if not len(spans(rec, marker)[0]):
        return None
    try:
        from repro_torch.runtime.trace import profiled_counts
    except ImportError:
        return None
    return profiled_counts()
