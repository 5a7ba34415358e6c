"""Build accounting for the port's entry points.

Copy of ``record_trace`` / ``trace_count`` from ``repro.analysis.retrace``.
The reference counts jit traces; PyTorch runs eagerly, so the port counts
what takes a trace's place: each build of an entry's function (a serving
bucket's batched force function, the MD device loop's chunk function).
The counter is a plain ``dict`` with the reference's key, so
``counter['traces']`` reads the same in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

TRACE_KEY = 'traces'


def record_trace(counter: Optional[Dict]) -> int:
    """Bump ``counter['traces']`` (no-op on None); returns the new
    count."""
    if counter is None:
        return 0
    counter[TRACE_KEY] = counter.get(TRACE_KEY, 0) + 1
    return counter[TRACE_KEY]


def trace_count(counter: Optional[Dict]) -> int:
    """The number of builds recorded so far (0 for None / fresh dicts)."""
    if counter is None:
        return 0
    return int(counter.get(TRACE_KEY, 0))
