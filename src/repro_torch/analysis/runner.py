"""Drive every static-analysis pass over every registered entry point.

Per entry the runner, in the reference's order:

1. builds the entry twice with independent seeds (two :class:`Built`
   instances: function, example inputs, build counter);
2. calls build A's function on build A's inputs (the first call fills
   the port's caches), then on build B's inputs under the op and launch
   recorders and, on the card, under CUDA sync debug mode; it reads the
   build counter and the caches' misses before anything calls the
   function again;
3. runs the retrace lint on the two builds' signatures, the counter and
   the second call's cache misses, and checks the second call's kernel
   launches;
4. runs the host-sync and dtype passes over the second call's ops and
   launches;
5. runs the memory pass over them (and, on the card, reads the call's
   peak of ``torch.cuda.max_memory_allocated``);
6. splits findings into active vs allowlisted.

Budget checking is a whole-report concern and happens in
:func:`run_registry` after all entries complete.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import traceback
from typing import Callable, Dict, Iterable, List, Optional

import torch

from .budgets import check_budgets
from .findings import EntryReport, Finding, Report, SEV_ERROR
from .launches import record_launches
from .memory_passes import memory_pass
from .op_passes import (OpRecorder, cache_misses, dtype_pass, first_sync,
                        host_sync_pass, launch_count_pass, port_caches,
                        retrace_pass, signature)
from .registry import EntryPoint
from .retrace import trace_count


def analyze_entry(ep: EntryPoint) -> EntryReport:
    """Run all per-entry passes; never raises — an analysis crash becomes
    an ``analysis-error`` finding so one broken entry cannot hide the
    rest of the report."""
    try:
        return _analyze(ep)
    except Exception as exc:
        return EntryReport(entry=ep.name, findings=[Finding(
            pass_name='runner', code='analysis-error', entry=ep.name,
            message=f'analysis crashed: {type(exc).__name__}: {exc}',
            detail=dict(traceback=traceback.format_exc(limit=8)))])


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device('cpu')


def _analyze(ep: EntryPoint) -> EntryReport:
    built_a = ep.build(0)
    built_b = ep.build(1)
    cuda = _device_of(built_a.args).type == 'cuda'
    metrics: Dict[str, float] = {}

    built_a.fn(*built_a.args)
    caches = port_caches()
    before = cache_misses(caches)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    sync_error = None
    with record_launches() as rec, OpRecorder(rec) as ops:
        if cuda and ep.sync_check:
            sync_error = first_sync(lambda: built_a.fn(*built_b.args))
        else:
            built_a.fn(*built_b.args)
    if cuda:
        torch.cuda.synchronize()
        metrics['peak_bytes'] = torch.cuda.max_memory_allocated() - base
    after = cache_misses(caches)
    missed = {k: after[k] - before[k] for k in caches if after[k] > before[k]}
    metrics['compile_count'] = trace_count(built_a.counter)

    findings: List[Finding] = []
    findings += retrace_pass(
        ep.name, signature(built_a.args), signature(built_b.args),
        built_a.counter, missed=missed)
    if ep.launches is not None:
        findings += launch_count_pass(ep.name, rec.records, ep.launches)
    findings += host_sync_pass(ep.name, ops.events, sync_error)
    findings += dtype_pass(ep.name, ops.events, rec.records,
                           allow_f64=ep.policy.allow_f64,
                           mxu_dtype=ep.policy.mxu_dtype)
    mem_findings, mem_metrics = memory_pass(
        ep.name, ops.events, rec.records,
        pad_dims=ep.pad_dims,
        pad_waste_limit=ep.pad_waste_limit,
        plane_rows=ep.plane_rows, lane_cols=ep.lane_cols)
    findings += mem_findings
    metrics.update(mem_metrics)

    active, suppressed = [], []
    for f in findings:
        if any(k in ep.allow for k in f.allow_keys()):
            suppressed.append(f)
        else:
            active.append(f)
    return EntryReport(entry=ep.name, findings=active,
                       suppressed=suppressed, metrics=metrics)


def run_registry(entries: Iterable[EntryPoint],
                 budgets: Optional[Dict] = None,
                 progress=None) -> Report:
    """Analyze every entry, then (optionally) apply the budget ratchet."""
    import torch.distributed as dist
    entries = list(entries)
    report = Report(meta=dict(
        torch_version=torch.__version__,
        n_ranks=(dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else 1),
    ))
    for ep in entries:
        if progress:
            progress(ep.name)
        report.entries.append(analyze_entry(ep))
    if budgets is not None:
        report.budget_findings = check_budgets(report, budgets)
    report.meta['n_findings'] = sum(
        1 for f in report.all_findings() if f.severity == SEV_ERROR)
    return report


def _load_registry(spec: str) -> Callable[..., List]:
    """Resolve ``module.path:attr`` or ``/path/to/file.py:attr`` to the
    registry factory (a callable of ``device`` returning EntryPoints)."""
    mod_part, _, attr = spec.rpartition(':')
    if not mod_part:
        raise SystemExit(f'--registry must be MODULE:ATTR, got {spec!r}')
    if mod_part.endswith('.py') or os.path.sep in mod_part:
        loader_spec = importlib.util.spec_from_file_location(
            '_analysis_registry', mod_part)
        if loader_spec is None or loader_spec.loader is None:
            raise SystemExit(f'cannot load registry file {mod_part!r}')
        mod = importlib.util.module_from_spec(loader_spec)
        loader_spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_part)
    return getattr(mod, attr)


def entries_of(registry: str, device, names) -> List[EntryPoint]:
    """The entries of registry ``registry`` on ``device``, only those named
    in ``names`` if it is given."""
    entries = _load_registry(registry)(device=device)
    if names:
        want = set(names)
        unknown = want - {ep.name for ep in entries}
        if unknown:
            raise SystemExit(f'unknown entries: {sorted(unknown)}; have '
                             f'{sorted(ep.name for ep in entries)}')
        entries = [ep for ep in entries if ep.name in want]
    return entries


def rank_report(rank, registry, device, names, budgets):
    """One rank's report of the registry run in step on every rank
    (``--ranks``; a module-level function, so a spawned rank imports
    it)."""
    try:
        entries = entries_of(registry, device, names)
    except SystemExit as e:     # a rank reports an Exception to the parent
        raise ValueError(str(e)) from None
    return run_registry(entries, budgets=budgets)
