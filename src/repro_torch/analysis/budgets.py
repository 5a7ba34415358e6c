"""The budget ratchet: checked-in per-entry ceilings on the metrics the
static analysis measures (plane bytes, bytes allocated, launches, builds,
finding counts).

``budgets.json`` beside this module is the contract (the reference's
``ANALYSIS_BUDGETS.json`` at the repository root is the JAX package's).
The CPU runs the plain versions of the kernels and the card runs the
kernels, so the file has a ``cpu`` and a ``cuda`` section, each
``{"entries": {name: {metric: ceiling}}}``; a run is checked against the
section of its device.  A gate fails if any entry's measured value exceeds
its budget, so traffic and launch regressions cannot land silently;
improving a metric is free until someone tightens the budget.  Byte
budgets carry headroom (allocator and library versions differ); counts
are exact.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional

from .findings import Finding, PASS_BUDGET, SEV_WARN, Report

DEFAULT_PATH = str(Path(__file__).resolve().parent / 'budgets.json')
SECTIONS = ('cpu', 'cuda')

# metrics the ratchet tracks, with the headroom rule applied when
# (re)generating budgets from a measured report:
#   'exact'  — integer counts, no headroom
#   'bytes'  — x1.5 headroom, ceil to int
#   'frac'   — +0.05 absolute, capped at 1.0
_METRIC_RULES = {
    'findings': 'exact',
    'compile_count': 'exact',
    'launches': 'exact',
    'plane_bytes': 'bytes',
    'total_bytes': 'bytes',
    'peak_bytes': 'bytes',
    'broadcast_bytes_max': 'bytes',
    'pad_waste_frac': 'frac',
}

BYTES_HEADROOM = 1.5
FRAC_HEADROOM = 0.05


def _section(device: str) -> str:
    if device not in SECTIONS:
        raise ValueError(f'no budget section for device {device!r}; '
                         f'choose from {SECTIONS}')
    return device


def load_budgets(path: str = DEFAULT_PATH,
                 device: str = 'cpu') -> Optional[Dict]:
    """The ``device`` section of the budgets file, or None if the file
    does not exist (an empty section if it lacks one)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get(_section(device), {'entries': {}})


def _measured(entry_report) -> Dict[str, float]:
    vals = dict(entry_report.metrics)
    vals['findings'] = len(entry_report.findings)
    return vals


def check_budgets(report: Report, budgets: Dict) -> List[Finding]:
    """Compare a measured report against one section of the budgets.

    Errors: a metric over budget, or an entry that ran with no budget
    entry at all (new entry points must be budgeted when registered).
    Warnings: a budgeted entry that did not run (the sharded path outside
    a process group) or a budgeted metric the run did not measure.
    """
    findings: List[Finding] = []
    per_entry = budgets.get('entries', {})
    seen = set()
    for er in report.entries:
        seen.add(er.entry)
        bud = per_entry.get(er.entry)
        if bud is None:
            findings.append(Finding(
                pass_name=PASS_BUDGET, code='unbudgeted-entry',
                entry=er.entry,
                message=(f'entry {er.entry!r} has no budget — run with '
                         f'--write-budgets and check in the result'),
                detail=dict(available=sorted(per_entry))))
            continue
        vals = _measured(er)
        for key, limit in sorted(bud.items()):
            if key not in vals:
                findings.append(Finding(
                    pass_name=PASS_BUDGET, code='metric-missing',
                    entry=er.entry, severity=SEV_WARN,
                    message=(f'budgeted metric {key!r} was not measured '
                             f'for {er.entry!r}'),
                    detail=dict(metric=key, budget=limit)))
                continue
            got = vals[key]
            if got > limit:
                findings.append(Finding(
                    pass_name=PASS_BUDGET, code='over-budget',
                    entry=er.entry,
                    message=(f'{key} = {_fmt(got)} exceeds budget '
                             f'{_fmt(limit)} — a regression landed, or '
                             f'ratchet the budget deliberately'),
                    detail=dict(metric=key, measured=got, budget=limit)))
    for name in sorted(set(per_entry) - seen):
        findings.append(Finding(
            pass_name=PASS_BUDGET, code='entry-not-run', entry=name,
            severity=SEV_WARN,
            message=(f'budgeted entry {name!r} did not run (process-group '
                     f'gated, or filtered with --entry)'),
            detail=dict()))
    return findings


def make_budgets(report: Report) -> Dict:
    """One budgets section from a measured report, with the per-metric
    headroom rules applied."""
    entries: Dict[str, Dict] = {}
    for er in report.entries:
        vals = _measured(er)
        bud: Dict[str, float] = {}
        for key, rule in _METRIC_RULES.items():
            if key not in vals:
                continue
            v = vals[key]
            if rule == 'exact':
                bud[key] = int(v)
            elif rule == 'bytes':
                bud[key] = int(math.ceil(v * BYTES_HEADROOM))
            else:
                bud[key] = round(min(1.0, float(v) + FRAC_HEADROOM), 3)
        entries[er.entry] = bud
    return dict(entries=entries)


def write_budgets(report: Report, path: str = DEFAULT_PATH,
                  device: str = 'cpu') -> Dict:
    """Rewrite the budgets of the entries in ``report`` in the ``device``
    section of the budgets file, keeping the other section and the budgets
    of entries this run did not reach (the process-group-gated sharded
    entry outside a group, entries left out with ``--entry``); returns the
    whole document."""
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc['_comment'] = (
        'Per-entry ceilings for repro_torch.analysis metrics, one section '
        'a device (cpu: the plain versions; cuda: the kernels). Byte '
        'budgets carry 1.5x headroom; counts are exact. Regenerate a '
        'section with `python -m repro_torch.analysis --device DEV '
        '--write-budgets` (the sharded entry: add `--ranks 2 --entry '
        'force.torch.sharded`) and review the diff: loosening a budget is a '
        'deliberate act.')
    section = doc.setdefault(_section(device), {}).setdefault('entries', {})
    section.update(make_budgets(report)['entries'])
    with open(path, 'w') as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write('\n')
    return doc


def _fmt(v) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f'{v:.4g}'
    return str(int(v)) if isinstance(v, float) else str(v)
