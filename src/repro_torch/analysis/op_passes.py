"""Op-level lint passes: host-sync detection, dtype drift, the retrace
surface and launch counts (counterpart of ``repro.analysis.jaxpr_passes``).

The reference walks closed jaxprs.  An eager PyTorch program has none, so
:class:`OpRecorder`, a ``TorchDispatchMode``, records every aten (and
c10d) op an entry dispatches while it runs, with two scopes read from the
active :class:`~repro_torch.analysis.launches.Recorder`:

- ops inside the *plain-body* scope (a kernel wrapper's plain version on
  the CPU) are the stand-in for a kernel and are not recorded; the
  kernel's dtypes come from its launch record instead;
- ops inside the *hot* scope (one MD step of the device loop) give the
  ``-hot`` codes.

The host-sync pass flags the glue ops that make the host wait on a CUDA
tensor, on whichever device the entry ran: the same code path syncs on
the card.  ``.numpy()`` and ``.tolist()`` of a CPU tensor dispatch no op,
so a CPU run cannot see them; on the card :func:`first_sync` (CUDA sync
debug mode) is the ground truth, and the runner uses both.
"""

from __future__ import annotations

import sys
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import launches
from .findings import (Finding, PASS_DTYPE, PASS_HOST_SYNC, PASS_RETRACE)
from .retrace import trace_count

# builds of an entry's function across its two same-signature calls
EXPECTED_COMPILES = 1

# ops that make the host wait for the device whatever their arguments
_SYNC_OPS = frozenset((
    '_local_scalar_dense',       # item(), float(), int(), bool() of a tensor
    'nonzero', 'masked_select', '_unique', '_unique2', 'unique_dim',
    'unique_consecutive', 'unique_dim_consecutive', 'equal', 'is_nonzero',
))
_ALLOC_OPS = frozenset(('empty', 'empty_like', 'empty_strided', 'new_empty',
                        'new_empty_strided'))
_COPY_OPS = frozenset(('clone', '_to_copy'))
_NARROW = (torch.float16, torch.bfloat16, torch.float32)


@dataclass
class OpEvent:
    """One dispatched op outside the plain-body scope."""
    op: str                      # e.g. 'aten.nonzero', 'c10d.allreduce_'
    hot: bool
    sync: Optional[str]          # why it syncs, or None
    upcast: Optional[str]        # narrow float dtype promoted to f64
    bf16: bool
    out_shapes: Tuple[Tuple[int, ...], ...]
    alloc_bytes: int             # bytes of fresh (non-aliasing) outputs
    written_bytes: Dict[Tuple[int, ...], int]   # by shape, not empty*
    broadcast_bytes: int         # bytes materialized from a broadcast


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _sync_reason(name, func, args, kwargs, ins, outs) -> Optional[str]:
    if func.namespace == 'c10d':
        return 'collective (gloo waits on the host)'
    if name in _SYNC_OPS:
        return 'reads a device value on the host'
    if name == 'index':
        idx = args[1] if len(args) > 1 else kwargs.get('indices', ())
        if any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                           torch.uint8)
               for t in idx):
            return 'boolean-mask index (data-dependent size)'
    if name == 'repeat_interleave' and func._overloadname != 'self_int' \
            and kwargs.get('output_size') is None:
        return 'repeat_interleave without output_size'
    if name in ('lift_fresh', 'lift_fresh_copy'):
        return ('host data made a tensor at call time (on the card an '
                'upload from pageable memory, which waits for the stream)')
    if name in ('_to_copy', 'copy_'):
        src = ins[-1] if name == 'copy_' else ins[0]
        dst = ins[0] if name == 'copy_' else (outs[0] if outs else None)
        if dst is None or src.device.type == dst.device.type:
            return None
        if dst.device.type == 'cpu':
            return 'device-to-host copy'
        if not kwargs.get('non_blocking', False) and \
                not (len(args) > 2 and args[2] is True):
            return 'host-to-device upload from pageable memory'
    return None


def _broadcast_bytes(name, ins, outs) -> int:
    """Bytes of an output materialized from an input broadcast to a larger
    shape: a copy of an expanded (stride-0) view, ``repeat``, or an op
    whose every input broadcasts up to a larger output."""
    if not outs or not ins:
        return 0
    out = outs[0]
    nbytes = out.numel() * out.element_size()
    if name in _COPY_OPS:
        src = ins[0]
        if any(st == 0 and sz > 1 for st, sz in zip(src.stride(),
                                                    src.shape)):
            return nbytes
        return 0
    if name == 'repeat':
        return nbytes if out.numel() > ins[0].numel() else 0
    if len(ins) < 2 or any(t.ndim == 0 for t in ins):
        return 0
    try:
        if any(torch.broadcast_shapes(t.shape, out.shape) != out.shape
               for t in ins):
            return 0
    except RuntimeError:
        return 0
    return nbytes if out.numel() > max(t.numel() for t in ins) else 0


class OpRecorder(TorchDispatchMode):
    """Records the :class:`OpEvent` of each op dispatched while it is
    entered, reading the plain-body and hot scopes of ``recorder``."""

    def __init__(self, recorder: launches.Recorder):
        super().__init__()
        self.recorder = recorder
        self.events: List[OpEvent] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.recorder.in_scope(launches.PLAIN):
            return out
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        aliases = any(r.alias_info is not None
                      for r in func._schema.returns)
        fresh = [] if aliases else outs
        narrow = {t.dtype for t in ins if t.dtype in _NARROW and t.ndim}
        upcast = (str(min(narrow, key=str))[6:]
                  if narrow and any(t.dtype == torch.float64 for t in outs)
                  else None)
        written = {}
        if name not in _ALLOC_OPS:
            for t in fresh:
                key = tuple(t.shape)
                written[key] = written.get(key, 0) + \
                    t.numel() * t.element_size()
        self.events.append(OpEvent(
            op=f'{func.namespace}.{name}',
            hot=self.recorder.in_scope(launches.HOT),
            sync=_sync_reason(name, func, args, kwargs, ins, outs),
            upcast=upcast,
            bf16=any(t.dtype == torch.bfloat16 for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            alloc_bytes=sum(t.numel() * t.element_size() for t in fresh),
            written_bytes=written,
            broadcast_bytes=(_broadcast_bytes(name, ins, outs)
                             if fresh else 0)))
        return out


def first_sync(fn) -> Optional[str]:
    """The error of the first host synchronization ``fn()`` makes on the
    card, else None (CUDA sync debug mode, 'error')."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
        return None
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def host_sync_pass(entry: str, events: List[OpEvent],
                   sync_error: Optional[str] = None) -> List[Finding]:
    """Flag every glue op that makes the host wait (folded per op with a
    count).  Inside the hot scope (``host-sync-hot``) it stalls every MD
    step; elsewhere (``host-sync``) once an evaluation.  Both are errors.
    ``sync_error``: the first sync CUDA sync debug mode raised on the
    card."""
    found: Counter = Counter()
    reason = {}
    for ev in events:
        if ev.sync is None:
            continue
        key = ('host-sync-hot' if ev.hot else 'host-sync', ev.op)
        found[key] += 1
        reason[key] = ev.sync
    findings = [Finding(
        pass_name=PASS_HOST_SYNC, code=code, entry=entry,
        message=(f'{op} (x{n}): {reason[(code, op)]} — '
                 + ('inside an MD step (stalls every step)' if code.endswith(
                     '-hot') else 'in the entry (syncs once a call)')),
        detail=dict(op=op, count=n, reason=reason[(code, op)]))
        for (code, op), n in sorted(found.items())]
    if sync_error is not None:
        findings.append(Finding(
            pass_name=PASS_HOST_SYNC, code='host-sync', entry=entry,
            message=f'CUDA sync debug mode: {sync_error}',
            detail=dict(op='cuda-sync-debug', error=sync_error)))
    return findings


def dtype_pass(entry: str, events: List[OpEvent], records,
               allow_f64: bool = False,
               mxu_dtype: Optional[str] = None) -> List[Finding]:
    """Precision-policy violations, folded per (code, op, shape):

    - ``f64-upcast``: a float64 output of an op with narrower float
      inputs, or a kernel launched on float64 tensors, in an entry whose
      policy forbids f64 (the reference's pass found one in ``y_coef``);
    - ``bf16-leak``: a bfloat16 output, or a kernel launched with
      bfloat16 operands, in an entry whose policy declares no
      ``mxu_dtype``.
    """
    up: Counter = Counter()
    bf: Counter = Counter()
    for ev in events:
        shape = list(ev.out_shapes[0]) if ev.out_shapes else []
        if not allow_f64 and ev.upcast:
            up[(ev.op, ev.upcast, str(shape))] += 1
        if mxu_dtype is None and ev.bf16:
            bf[(ev.op, 'bfloat16', str(shape))] += 1
    for r in records:
        shape = str(list(r.in_shapes[0]))
        if not allow_f64 and 'float64' in r.in_dtypes:
            up[(f'kernel.{r.name}', 'float64', shape)] += 1
        if mxu_dtype is None and r.operand_dtype == 'bfloat16':
            bf[(f'kernel.{r.name}', 'bfloat16', shape)] += 1
    findings = []
    for (op, src, shape), n in sorted(up.items()):
        findings.append(Finding(
            pass_name=PASS_DTYPE, code='f64-upcast', entry=entry,
            message=(f'{op}: {src} -> float64 on shape {shape} (x{n}) — a '
                     'float64 table or constant leaking into a '
                     'narrow-precision pipeline'),
            detail=dict(op=op, src=src, shape=shape, count=n)))
    for (op, _, shape), n in sorted(bf.items()):
        findings.append(Finding(
            pass_name=PASS_DTYPE, code='bf16-leak', entry=entry,
            message=(f'{op}: bfloat16 on shape {shape} (x{n}) outside a '
                     'declared mxu_dtype policy'),
            detail=dict(op=op, shape=shape, count=n)))
    return findings


def signature(args) -> Tuple:
    """Per input leaf: (shape, dtype, device) of a tensor, the type of
    anything else — what decides whether a build's caches and launch
    plans fit the call."""
    return tuple((tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
                 if isinstance(leaf, torch.Tensor)
                 else (type(leaf).__name__,)
                 for leaf in tree_flatten(args)[0])


def port_caches() -> Dict[str, object]:
    """Every ``lru_cache`` of the port's loaded modules, by qualified
    name: the constant tables and launch plans an evaluation must find
    cached."""
    out = {}
    for modname, mod in list(sys.modules.items()):
        if not modname.startswith('repro_torch.') or mod is None:
            continue
        for attr, obj in vars(mod).items():
            if hasattr(obj, 'cache_info') and \
                    getattr(obj, '__module__', None) == modname:
                out[f'{modname}.{attr}'] = obj
    return out


def cache_misses(caches: Dict[str, object]) -> Dict[str, int]:
    return {k: f.cache_info().misses for k, f in caches.items()}


def retrace_pass(entry: str, sig_a: Tuple, sig_b: Tuple, counter,
                 missed: Optional[Dict[str, int]] = None) -> List[Finding]:
    """The cache-fission lint.

    ``sig_a``/``sig_b`` are :func:`signature` results of two independent
    builds of the entry's inputs: any drift means production traffic
    would miss the caches keyed on them.  ``counter`` holds the entry's
    builds of its function after two calls and must not exceed
    :data:`EXPECTED_COMPILES`; ``missed`` maps each port cache that missed on
    the second call to its misses (a table upload or a plan rebuild on
    every call: on the card a pageable upload waits for the stream).
    """
    findings = []
    if sig_a != sig_b:
        drift = [dict(index=i, a=list(a), b=list(b))
                 for i, (a, b) in enumerate(zip(sig_a, sig_b)) if a != b]
        if len(sig_a) != len(sig_b):
            drift.append(dict(index='arity', a=len(sig_a), b=len(sig_b)))
        findings.append(Finding(
            pass_name=PASS_RETRACE, code='signature-drift', entry=entry,
            message=('shape, dtype or device of an input differs between '
                     'two builds of the example inputs — every call would '
                     'miss the caches keyed on them'),
            detail=dict(drift=drift[:8])))
    got = trace_count(counter)
    if got > EXPECTED_COMPILES:
        findings.append(Finding(
            pass_name=PASS_RETRACE, code='cache-fission', entry=entry,
            message=(f'{got} build(s) of the entry\'s function across two '
                     f'same-signature calls (expected {EXPECTED_COMPILES})'),
            detail=dict(traces=got, expected=EXPECTED_COMPILES)))
    if missed:
        findings.append(Finding(
            pass_name=PASS_RETRACE, code='cache-fission', entry=entry,
            message=(f'the second call missed {sorted(missed)} — a table '
                     'upload or plan rebuild on every call'),
            detail=dict(missed=missed)))
    return findings


def launch_count_pass(entry: str, records, expected: Dict[str, int]
                      ) -> List[Finding]:
    """``launch-count``: the launches of one call by kernel must equal the
    entry's ``launches`` (one of each stage an evaluation: a second launch
    is a stage split or a retry)."""
    got = Counter(r.name for r in records)
    if dict(got) == dict(expected):
        return []
    return [Finding(
        pass_name=PASS_RETRACE, code='launch-count', entry=entry,
        message=f'launches of one call {dict(sorted(got.items()))}, '
                f'expected {dict(sorted(expected.items()))}',
        detail=dict(got=dict(got), expected=dict(expected)))]
