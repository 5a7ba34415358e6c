"""The traced run's record: the profiler's device events, the harness's own
spans and the host's operations, reduced to what the per-layer metrics
read.

The profiler is ``torch.profiler`` (CUPTI on the card).  Its raw events
are read once, with their start and end on one clock; the harness's spans
are ``record_function`` ranges named ``snapbench.<span>``, so they share
that clock.  A copy of the reduction in ``chip_smoke.profile_summary``
(device time by name, busy time as the union of device intervals), applied
to the measured window only.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict

import numpy as np
import torch

SPAN = 'snapbench.'

# The port's hand-written kernels, by a part of their CUDA names, and the
# layer of each (PERF.md's list of layers).
KERNELS = {
    'u': ('snap_u_kernel', 'snap_u_sum_kernel'),
    'y': ('snap_y_kernel',),
    'de': ('snap_fused_de',),
    'asm': ('csr_count', 'csr_place', 'csr_sort', 'assemble_forces'),
    'neighbor': ('cell_bin', 'cell_build'),
    'brute': ('brute_build',),
}
HAND_WRITTEN = tuple(k for ks in KERNELS.values() for k in ks)


def merge(starts, ends):
    """The union of intervals as sorted disjoint (starts, ends) arrays."""
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if not len(starts):
        return starts, ends
    o = np.argsort(starts, kind='stable')
    s, e = starts[o], np.maximum.accumulate(ends[o])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    return s[first], e[np.r_[first[1:] - 1, len(s) - 1]]


class Record:
    """What one traced window left: the device's operations (``names``,
    one name index, start and end in ns a operation, clipped to the
    window), ``spans`` {name: [(start, end)]}, the host's operations
    (``host``: names, starts, ends), ``window`` (start, end) and the
    driver's ``counters``."""

    def __init__(self, device, spans, host, window, counters):
        self.spans, self.window, self.counters = spans, window, counters
        names = sorted({n for n, _, _ in device})
        index = {n: i for i, n in enumerate(names)}
        self.names = names
        self.op = np.array([index[n] for n, _, _ in device], np.int64)
        self.start = np.array([s for _, s, _ in device], np.int64)
        self.end = np.array([e for _, _, e in device], np.int64)
        self.total = np.bincount(self.op, weights=self.end - self.start,
                                 minlength=len(names))
        self.ops = np.bincount(self.op, minlength=len(names))
        self.busy_start, self.busy_end = merge(self.start, self.end)
        self.busy_cum = np.r_[0, np.cumsum(self.busy_end - self.busy_start)]
        host = sorted(host, key=lambda h: h[1])
        self.host_names = [h[0] for h in host]
        self.host_start = np.array([h[1] for h in host], np.int64)
        self.host_end = np.array([h[2] for h in host], np.int64)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return float(self.busy_cum[-1]) * 1e-9

    def _match(self, parts=None, exclude=None):
        return [i for i, n in enumerate(self.names)
                if (parts is None or any(p in n for p in parts))
                and not (exclude and any(p in n for p in exclude))]

    def time_s(self, parts=None, exclude=None) -> float:
        """Summed device time of the operations whose name holds one of
        ``parts`` (all when None), less those holding one of ``exclude``."""
        return float(np.sum(self.total[self._match(parts, exclude)])) * 1e-9

    def count(self, parts=None) -> int:
        return int(np.sum(self.ops[self._match(parts)]))

    def spans_in_window(self, name):
        lo, hi = self.window
        return [(s, e) for s, e in self.spans.get(name, ())
                if s >= lo and e <= hi]

    def busy_within(self, lo, hi) -> int:
        """Device busy ns inside [lo, hi]."""
        bs, be = self.busy_start, self.busy_end
        i0 = int(np.searchsorted(be, lo, 'right'))
        i1 = int(np.searchsorted(bs, hi, 'left'))
        if i1 <= i0:
            return 0
        t = int(self.busy_cum[i1] - self.busy_cum[i0])
        return t - max(0, lo - int(bs[i0])) - max(0, int(be[i1 - 1]) - hi)

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the idle gaps
        summed by the host operation running when each began (the latest
        to start of those that span it), in seconds."""
        order = np.argsort(-self.total)[:top]
        ops = [[self.names[i], float(self.total[i]) * 1e-9] for i in order
               if self.total[i] > 0]
        w0, w1 = self.window
        g0 = np.r_[w0, self.busy_end]
        g1 = np.r_[self.busy_start, w1]
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        label = np.full(len(g0), -1, np.int64)
        hs, he = self.host_start, self.host_end
        last = np.searchsorted(hs, g0, 'right') - 1
        for back in range(256):      # the innermost op that spans the start
            cand = last - back
            ok = (label < 0) & (cand >= 0)
            ok[ok] &= he[cand[ok]] >= g0[ok]
            label[ok] = cand[ok]
        gaps = defaultdict(int)
        for lab, t in zip(label.tolist(), (g1 - g0).tolist()):
            gaps[self.host_names[lab] if lab >= 0
                 else '(no host operation)'] += t
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=ops,
                    idle_gaps=[[n, t * 1e-9] for n, t in idle])


class Tracer:
    """The profiler around a cell's window, or nothing when ``on`` is
    false; ``span(name)`` marks a harness call in the trace."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == 'cuda'
        self.prof = None

    def start(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.prof.__enter__()

    def finish(self) -> 'Record':
        """Stop the profiler, read its events once and let it go."""
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            self.prof.__exit__(None, None, None)
        rec = self.record({})
        self.prof = None
        return rec

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN + name)

    def record(self, counters) -> Record:
        """Read the raw events once and keep the window's."""
        from torch.autograd import DeviceType
        cpu = DeviceType.CPU
        spans, device, host = defaultdict(list), [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == cpu:
                name = ev.name()
                if name.startswith(SPAN):
                    spans[name[len(SPAN):]].append((s, e))
                else:
                    host.append((name, s, e))
            else:
                name = ev.name()
                if not name.startswith(SPAN):
                    device.append((name, s, e))
        window = spans['window'][0]
        lo, hi = window
        device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                  if e > lo and s < hi]
        host = [h for h in host if h[2] > lo and h[1] < hi]
        return Record(device, dict(spans), host, window, counters)
