"""Structural memory passes: padding waste, materialized broadcasts, and
the traffic metrics the budget ratchet consumes (counterpart of
``repro.analysis.hlo_passes``).

The reference reads these from optimized HLO text through
``repro/launch/hlo_cost.py``; the port reads them from what its two
recorders saw while the entry ran: the kernel launch records
(:mod:`repro_torch.analysis.launches`, weighted by the operation counts of
:mod:`repro_torch.analysis.cost`) and the glue ops' events
(:mod:`repro_torch.analysis.op_passes`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from .cost import launch_flops
from .findings import Finding, PASS_MEMORY

# an op output from an input broadcast to a larger shape, from this size on,
# is a materialized broadcast
BROADCAST_BYTES_LIMIT = 1 << 21       # 2 MiB


def pad_waste(records, pad_dims: Mapping[int, int]) -> Dict:
    """Fraction of the kernels' operations that land on padded lanes.

    ``pad_dims`` maps a *padded* lane count to its *logical* one (e.g.
    ``{128: 120}`` for 120 atoms on the 128-atom plane layout); a launch
    over ``lanes`` padded lanes spends ``1 - logical / lanes`` of its
    operations on dead lanes.  Summed, weighted by each launch's operation
    count, this is the padding tax of the entry."""
    pads = {int(p): int(l) for p, l in pad_dims.items()}
    total = wasted = 0.0
    for r in records:
        ops = float(launch_flops(r))
        total += ops
        wasted += ops * (1.0 - r.logical_lanes(pads) / float(r.lanes))
    frac = (wasted / total) if total > 0 else 0.0
    return dict(flops_kernels=total, flops_padded=wasted,
                pad_waste_frac=frac)


def memory_pass(entry: str, events, records,
                pad_dims: Mapping[int, int] | None = None,
                pad_waste_limit: float = 0.5,
                plane_rows: Tuple[int, ...] = (),
                lane_cols: Tuple[int, ...] = (128,),
                ) -> Tuple[List[Finding], Dict]:
    """Padding-waste and broadcast-materialization analysis of one call.

    Returns ``(findings, metrics)``: ``launches`` (kernel launches),
    ``total_bytes`` (bytes of the tensors the call allocates: the glue
    ops' fresh outputs, and on the CPU each plain version's outputs, so
    the count matches the card's), ``flops_kernels``, ``pad_waste_frac``,
    ``broadcast_bytes_max`` and, when the entry declares plane rows,
    ``plane_bytes``: the bytes of the ``[plane_rows, lane_cols]`` planes
    the call writes (glue outputs and kernel outputs).
    """
    findings: List[Finding] = []
    metrics: Dict[str, float] = dict(
        launches=len(records),
        total_bytes=(sum(ev.alloc_bytes for ev in events)
                     + sum(r.out_bytes for r in records
                           if r.device == 'cpu')))

    worst = max(events, key=lambda ev: ev.broadcast_bytes, default=None)
    metrics['broadcast_bytes_max'] = worst.broadcast_bytes if worst else 0
    for ev in events:
        if ev.broadcast_bytes < BROADCAST_BYTES_LIMIT:
            continue
        findings.append(Finding(
            pass_name=PASS_MEMORY, code='materialized-broadcast',
            entry=entry,
            message=(f'{ev.op} materializes {list(ev.out_shapes[0])} = '
                     f'{ev.broadcast_bytes / 2**20:.1f} MiB from an input '
                     f'broadcast to a larger shape — keep it a broadcast in '
                     f'its consumer'),
            detail=dict(op=ev.op, shape=list(ev.out_shapes[0]),
                        bytes=ev.broadcast_bytes,
                        limit_bytes=BROADCAST_BYTES_LIMIT)))

    pw = pad_waste(records, pad_dims or {})
    metrics['flops_kernels'] = pw['flops_kernels']
    metrics['pad_waste_frac'] = pw['pad_waste_frac']
    if pad_dims and pw['pad_waste_frac'] > pad_waste_limit:
        findings.append(Finding(
            pass_name=PASS_MEMORY, code='pad-waste', entry=entry,
            message=(f"{100 * pw['pad_waste_frac']:.1f}% of the kernels' "
                     f"operations land on padded lanes (limit "
                     f"{100 * pad_waste_limit:.0f}%) — shrink the padding "
                     f"or pack the lanes"),
            detail=dict(pad_waste_frac=pw['pad_waste_frac'],
                        limit=pad_waste_limit,
                        flops_kernels=pw['flops_kernels'],
                        flops_padded=pw['flops_padded'],
                        pad_dims={str(k): v
                                  for k, v in (pad_dims or {}).items()})))

    if plane_rows:
        planes = {(r, c) for r in plane_rows for c in lane_cols}
        nbytes = sum(b for ev in events
                     for shape, b in ev.written_bytes.items()
                     if shape in planes)
        nbytes += sum(size for r in records
                      for shape, size in zip(r.out_shapes, r.out_sizes)
                      if shape in planes)
        metrics['plane_bytes'] = nbytes
    return findings, metrics
