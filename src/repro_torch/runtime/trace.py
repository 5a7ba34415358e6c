"""The port's spans and counters, on the profiler's clock.

:func:`span` names a stretch of host work ``repro_torch.<name>`` in a
``torch.profiler`` trace; it records only while a profiler records, so a
profile is the switch and there is no flag.  The range is
``torch._C._profiler._RecordFunctionFast``: a host event on the
profiler's clock (so it lines up with the device's operations) that,
unlike ``record_function``, leaves no copy of itself among the device's
events.  With no profiler recording, :func:`span` returns :data:`NULL`,
one shared null context, and costs one check.

:func:`count` adds to :data:`COUNTS`, the port's one counter registry
(``kernels/_build.LAUNCHES`` is the same object: the kernel launch counts
are its entries named after the kernels).  While a profiler records it
also adds to the table that :func:`profiled_counts` returns, which holds
the counts of the stretch the profile covers: a span or count that finds a
profiler recording after one that found none empties it first.

The spans, outermost first (an operator reading a profile finds an idle
gap of the device named after the innermost span open when it began):

- MD device loop (``md/integrate``): ``md.seed`` (set-up of one run: the
  force function, uploads, the seed build, the seed force and the energy
  readback), ``md.build_chunk_fn`` (a chunk function built on a cache
  miss), ``md.chunk`` (one chunk function's call, holding ``md.step``
  once a step), ``md.readback`` (the one copy a chunk), ``md.triage``
  (flags, recovery, thermo rows and checkpoint after that copy),
  ``md.finish`` (the final positions and velocities copied back);
- force pipeline (``kernels/ops``): ``snap.layout``, ``snap.u``,
  ``snap.y``, ``snap.de``, ``snap.assemble``, ``snap.energy``;
- each hand-written kernel's launch: ``kernel.<C symbol>``;
- force service (``launch/serve_forces.ForceServer``): ``serve.submit``;
  ``serve.step`` holding ``serve.next_batch``, ``serve.pack`` (holding
  ``serve.upload``), ``serve.call`` (the batched function's enqueue),
  ``serve.readback`` and ``serve.triage``; ``serve.build_fn`` (a bucket's
  function built on a cache miss).

The counters besides the launch counts: ``md.rebuilds`` (neighbor
rebuilds of committed chunks), ``serve.dispatched`` and
``serve.queue_wait_ns`` (requests dispatched and their summed wait from
entering the queue to dispatch, on ``time.perf_counter_ns``),
``serve.atoms`` and ``serve.atom_slots`` (valid atoms packed, and lanes x
padded atoms of the batches that held them).
"""

from __future__ import annotations

import collections
import contextlib

import torch

PREFIX = 'repro_torch.'
NULL = contextlib.nullcontext()
# cumulative counts since the last reset (kernels/_build.LAUNCHES)
COUNTS = collections.Counter()
_PROFILED = collections.Counter()
_profiling = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_was_on = False


def _recording() -> bool:
    """Whether a profiler records now; the first check that finds one
    recording after a check that found none empties the profiled counts."""
    global _was_on
    on = _profiling()
    if on and not _was_on:
        _PROFILED.clear()
    _was_on = on
    return on


def span(name: str):
    """A context naming the enclosed host work ``repro_torch.<name>`` in
    the profile being recorded; :data:`NULL` when none is."""
    return _Range(PREFIX + name) if _recording() else NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to the profiled counts while a
    profiler records)."""
    COUNTS[name] += n
    if _recording():
        _PROFILED[name] += n


def profiled_counts() -> dict:
    """The counts of the last stretch in which a profiler recorded."""
    return dict(_PROFILED)
