"""Launch records and the op recorder's scopes.

The port's kernels are launched through ``ctypes``
(:func:`repro_torch.kernels._build.launch`), so neither a
``TorchDispatchMode`` nor the profiler's op list sees them.  Each kernel
wrapper reports to this module instead, at its device branch:

- on a CUDA tensor, :func:`record` after the launch (it also adds one to
  the kernel's entry of ``kernels._build.LAUNCHES``, the launch counts
  of the port's counter registry :mod:`repro_torch.runtime.trace`,
  so a wrapper counts and records in one call);
- on a CPU tensor, :func:`plain`, which runs the plain version inside the
  *plain-body* scope (its ops are the CPU stand-in for the kernel and are
  not linted as glue) and records it as the kernel's launch.

A record holds the kernel's name, device, the dtypes and shapes of its
tensor inputs and outputs, its lanes (the atom axis, padded to the plane
layout's 128) and the sizes its operation count needs (``twojmax``,
``nnbor``, ``nnz``).  Logical lanes come from an entry's ``pad_dims``
(padded extent -> logical extent, as in the reference's padding pass).

:func:`record_launches` collects records; :func:`hot` marks one MD step of
the device loop, the *hot* scope whose findings get the ``-hot`` codes.
With no recorder active each of these costs one ``None`` check.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..runtime import trace

PLAIN, HOT = 'plain', 'hot'


@dataclass
class LaunchRecord:
    """One kernel launch (or, on the CPU, one call of its plain version)."""
    name: str
    device: str
    in_dtypes: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_sizes: Tuple[int, ...]   # bytes of each output
    lanes: int
    operand_dtype: str           # 'bfloat16' for the rounded Y option
    meta: Dict = field(default_factory=dict)

    @property
    def out_bytes(self) -> int:
        return sum(self.out_sizes)

    def logical_lanes(self, pad_dims) -> int:
        return int(pad_dims.get(self.lanes, self.lanes))


class Recorder:
    """Collects :class:`LaunchRecord` s and holds the scope stack that the
    op recorder (:mod:`repro_torch.analysis.op_passes`) reads."""

    def __init__(self):
        self.records: List[LaunchRecord] = []
        self.scopes: List[str] = []

    def in_scope(self, kind: str) -> bool:
        return kind in self.scopes

    @contextlib.contextmanager
    def scope(self, kind: str):
        self.scopes.append(kind)
        try:
            yield
        finally:
            self.scopes.pop()

    def add(self, name, inputs, outputs, meta) -> None:
        ins = [t for t in inputs if isinstance(t, torch.Tensor)]
        outs = [t for t in outputs if isinstance(t, torch.Tensor)]
        first = ins[0]
        self.records.append(LaunchRecord(
            name=name, device=first.device.type,
            in_dtypes=tuple(str(t.dtype)[6:] for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_sizes=tuple(t.numel() * t.element_size() for t in outs),
            lanes=int(meta.get('lanes', first.shape[-1])),
            operand_dtype=('bfloat16' if meta.get('mxu_dtype') is not None
                           else str(first.dtype)[6:]),
            meta={k: v for k, v in meta.items()
                  if k not in ('lanes', 'mxu_dtype')}))


_ACTIVE: Optional[Recorder] = None


def active() -> Optional[Recorder]:
    return _ACTIVE


@contextlib.contextmanager
def record_launches():
    """Collect the launch records of the enclosed calls:
    ``with record_launches() as rec: ...; rec.records``.  Nests: the inner
    recorder collects alone until it exits."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, Recorder()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = outer


def _as_tuple(x):
    if x is None:
        return ()
    return x if isinstance(x, tuple) else (x,)


def record(name: str, inputs, outputs, **meta) -> None:
    """Report one CUDA launch of kernel ``name`` on the tensors ``inputs``
    and ``outputs``: one more in ``_build.LAUNCHES[name]`` (the counter
    ``name`` of :mod:`repro_torch.runtime.trace`) and, with a
    recorder active, its record.  ``meta``: ``lanes`` (the padded atom
    axis; default the first input's last extent), ``twojmax``,
    ``mxu_dtype`` and the sizes :mod:`repro_torch.analysis.cost` reads."""
    trace.count(name)
    if _ACTIVE is not None:
        _ACTIVE.add(name, inputs, _as_tuple(outputs), meta)


def plain(name: str, inputs, meta: Dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version of kernel ``name``, run
    in the plain-body scope and recorded as the kernel's launch, as
    :func:`record` records it.  Without a recorder it is the call
    alone."""
    rec = _ACTIVE
    if rec is None:
        return fn(*args, **kwargs)
    with rec.scope(PLAIN):
        out = fn(*args, **kwargs)
    rec.add(name, inputs, _as_tuple(out), meta)
    return out


def hot():
    """Scope of one MD step inside a device-loop chunk."""
    rec = _ACTIVE
    return contextlib.nullcontext() if rec is None else rec.scope(HOT)
