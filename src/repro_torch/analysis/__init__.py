"""Static-analysis lint suite for the port's entry points.

Five passes over what an entry does when it runs — the glue ops it
dispatches (a ``TorchDispatchMode`` recorder) and the kernels it launches
(launch records from the wrappers) — see the reference's DESIGN.md
"Static analysis contract":

- ``host_sync`` — no op that makes the host wait on the card in a hot
  path (and, on the card, none under CUDA sync debug mode);
- ``retrace``  — input signatures stable across builds, one build of an
  entry's function, no cache miss on a second call, one launch of each
  kernel of the path a call;
- ``dtype``    — no accidental f64 upcasts or bf16 leaks outside each
  entry's declared precision policy;
- ``memory``   — padded-lane operation fraction and materialized
  broadcasts bounded;
- ``budget``   — measured metrics under the checked-in ``budgets.json``
  ratchet (a ``cpu`` and a ``cuda`` section).

Run ``python -m repro_torch.analysis [--device cpu]``.  This module stays
import-light: the kernel wrappers import :mod:`.launches` and the MD and
serving code :mod:`.retrace`, so pulling the registry (which imports them
back) at package-import time would cycle.
"""

from .findings import (ALL_PASSES, Finding, EntryReport, Report,  # noqa: F401
                       SEV_ERROR, SEV_WARN)
from .retrace import (TRACE_KEY, assert_trace_count, record_trace,  # noqa: F401
                      trace_count)
