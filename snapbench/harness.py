"""The harness: finds a cell's files by name, runs its driver, reduces the
trace with the per-layer readers, and assembles the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix; its ``driver`` names the
  generator ``drivers/<driver>.py`` that reads it;
- ``limits/<workload>.json``: the cell's correctness limits, the control
  they were set against, and the readings they were set from;
- ``metrics/<metric>.py``: one per-layer metric, ``read(record)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'repro')
DTYPES = {'float64': torch.float64, 'float32': torch.float32,
          'bfloat16': torch.bfloat16}


def read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int = 1


def load_cell(name: str, bench: dict | None = None,
              files: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` at the root by
    default) with its configuration, traffic and limits read from
    ``files``."""
    if bench is None:
        bench = read_json(ROOT / 'BENCHMARK.json')
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in the benchmark')

    def here(m):
        return 'workloads' not in m or name in m['workloads']
    return Cell(name=name, entry=entry,
                config=read_json(files / 'configs'
                                 / f"{entry['config']}.json"),
                traffic=read_json(files / 'traffic'
                                  / f"{entry['traffic']}.json"),
                limits=read_json(files / 'limits' / f'{name}.json'),
                end_to_end=[m for m in bench['end_to_end'] if here(m)],
                per_layer=[m for m in bench['per_layer'] if here(m)],
                chips=int(entry.get('chips', 1)))


def load_driver(name: str):
    return importlib.import_module(f'snapbench.drivers.{name}')


def load_reader(metric: str, files: Path = HERE):
    """The reader module ``metrics/<metric>.py`` (the metric's name may hold
    dots, so it is loaded by path)."""
    path = files / 'metrics' / f'{metric}.py'
    mod_name = 'snapbench_metric_' + re.sub(r'\W', '_', metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, and the window's
    clock.  ``control`` (the limits file's lower-precision settings) is
    for the checks' own runs."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    control: dict | None = None
    tracer: Tracer = None
    setup_s: float = 0.0
    t0: float = 0.0
    window_s: float = 0.0
    t1: float = 0.0
    memory_peak: int = 0
    record: object = None
    _window_span: object = None

    def __post_init__(self):
        self.tracer = Tracer(self.trace, self.device)

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == 'cuda'

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def span(self, name):
        return self.tracer.span(name)

    def precision(self):
        """(the state's type name, the force options) of this run: the
        traffic's, or the control's in their place."""
        dtype, kw = self.cell.traffic['dtype'], {}
        if self.control:
            dtype = self.control.get('dtype', dtype)
            if 'mxu_dtype' in self.control:
                kw['mxu_dtype'] = DTYPES[self.control['mxu_dtype']]
        return dtype, kw

    def begin_window(self):
        """End of set-up: everything is built and warm."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.tracer.start()
        self._window_span = self.span('window')
        self._window_span.__enter__()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start
        return self.t0

    def end_window(self):
        """The window closes once the device has finished its work."""
        self.sync()
        t1 = self.t1 = time.perf_counter()
        self.window_s = t1 - self.t0
        self._window_span.__exit__(None, None, None)
        if self.cuda:
            self.memory_peak = int(torch.cuda.max_memory_allocated())
        if self.trace:
            # read the trace and drop the profiler before the check runs
            self.record = self.tracer.finish()
        return t1


@dataclass
class Outcome:
    """A driver's answer: counts, end-to-end metrics, the per-layer
    readers' counters, and every number its check read (``readings``), of
    which those the cell's limits file names are compared."""
    attempted: int
    failed: int
    metrics: dict
    readings: dict
    counters: dict = field(default_factory=dict)

    def checks(self, limits: dict):
        """(name, value, limit) of each reading the limits name; a limit
        whose reading is missing compares NaN, which fails."""
        return [(n, float(self.readings.get(n, float('nan'))), float(lim))
                for n, lim in limits.items()]


def checks_pass(checks) -> bool:
    return all(v is not None and v == v and v <= lim
               for _, v, lim in checks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', t_start: float | None = None,
             control=None, files: Path = HERE):
    """Run ``cell`` once: its driver's set-up, window and check, then the
    per-layer readers on the trace.  Returns (result dict, the compared
    (name, value, limit), every reading)."""
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, control=control,
                  t_start=time.perf_counter() if t_start is None
                  else t_start)
    out = load_driver(cell.traffic['driver']).run(ctx)
    t_done = time.perf_counter()
    checks = out.checks(cell.limits['limits'])
    units = {m['name']: m['unit'] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    result = dict(correct=checks_pass(checks),
                  attempted=out.attempted, failed=out.failed)
    cuda = ctx.cuda
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(0) if cuda else 'cpu',
               count=cell.chips, memory_peak_bytes=ctx.memory_peak)
    if not trace:
        for m in cell.end_to_end:
            v = (ctx.setup_s if m['name'] == 'setup_s'
                 else out.metrics.get(m['name']))
            if v is not None:
                metrics[m['name']] = dict(value=v, unit=units[m['name']])
    else:
        rec = ctx.record
        rec.counters.update(out.counters)
        for m in cell.per_layer:
            v = load_reader(m['name'], files).read(rec)
            if v is not None:
                metrics[m['name']] = dict(value=v, unit=units[m['name']])
        dev.update(busy_s=rec.busy_s, window_s=rec.window_s)
        result['breakdown'] = rec.breakdown()
    print(f'snapbench: {cell.name} seed {seed}: set-up {ctx.setup_s:.3f} s, '
          f'window {ctx.window_s:.3f} s, check {t_done - ctx.t1:.3f} s, '
          f'readers {time.perf_counter() - t_done:.3f} s',
          file=sys.stderr)
    result['metrics'] = metrics
    result['device'] = dev
    result['checks'] = {n: dict(value=v, limit=lim) for n, v, lim in checks}
    return result, checks, out.readings


def forbidden_modules(modules=None):
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is JAX's or the JAX package's, compared as whole names."""
    tops = {m.split('.')[0] for m in list(modules or sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
