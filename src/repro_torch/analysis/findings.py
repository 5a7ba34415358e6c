"""Typed findings and reports of the static-analysis suite.

Copy of ``repro.analysis.findings``.  A *finding* is one violated
performance invariant, attributed to a pass and an entry point.  Findings
carry machine-readable detail so a CI gate can act on them; an entry
point's ``allow`` set suppresses codes it accepts: ``'{code}'``,
``'{pass}:{code}'``, or, for a finding about one op, ``'{code}:{op}'``
(the sharded entry allowlists its gloo collectives by name).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SEV_ERROR = 'error'
SEV_WARN = 'warn'

# pass names (stable identifiers used in allowlists and budgets)
PASS_HOST_SYNC = 'host_sync'
PASS_RETRACE = 'retrace'
PASS_DTYPE = 'dtype'
PASS_MEMORY = 'memory'
PASS_BUDGET = 'budget'

ALL_PASSES = (PASS_HOST_SYNC, PASS_RETRACE, PASS_DTYPE, PASS_MEMORY,
              PASS_BUDGET)

# the metrics the findings table prints
TABLE_METRICS = ('compile_count', 'launches', 'plane_bytes', 'peak_bytes',
                 'pad_waste_frac', 'broadcast_bytes_max')


@dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``code`` is the allowlist key (see the module docstring for the other
    forms); ``detail`` is JSON-safe context.
    """
    pass_name: str
    code: str
    entry: str
    message: str
    severity: str = SEV_ERROR
    detail: Dict = field(default_factory=dict)

    def allow_keys(self) -> Tuple[str, ...]:
        keys = (self.code, f'{self.pass_name}:{self.code}')
        if 'op' in self.detail:
            keys += (f'{self.code}:{self.detail["op"]}',)
        return keys

    def to_json(self) -> Dict:
        return dict(pass_name=self.pass_name, code=self.code,
                    entry=self.entry, severity=self.severity,
                    message=self.message, detail=_jsonable(self.detail))

    def __str__(self) -> str:
        return (f'[{self.severity}] {self.entry} {self.pass_name}:'
                f'{self.code} — {self.message}')


@dataclass
class EntryReport:
    """Per-entry-point outcome: active findings, suppressed findings,
    and the measured metrics the budget ratchet consumes."""
    entry: str
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    metrics: Dict[str, float] = field(default_factory=dict)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def to_json(self) -> Dict:
        return dict(entry=self.entry,
                    findings=[f.to_json() for f in self.findings],
                    suppressed=[f.to_json() for f in self.suppressed],
                    metrics=_jsonable(self.metrics))


@dataclass
class Report:
    """Whole-registry report: what ``python -m repro_torch.analysis``
    prints and serializes, and what the CI gate consumes."""
    entries: List[EntryReport] = field(default_factory=list)
    budget_findings: List[Finding] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def all_findings(self) -> List[Finding]:
        out = [f for e in self.entries for f in e.findings]
        out.extend(self.budget_findings)
        return out

    @property
    def ok(self) -> bool:
        return not any(f.severity == SEV_ERROR for f in self.all_findings())

    def to_json(self) -> Dict:
        return dict(ok=self.ok, meta=_jsonable(self.meta),
                    entries=[e.to_json() for e in self.entries],
                    budget_findings=[f.to_json()
                                     for f in self.budget_findings])

    def dumps(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent, sort_keys=True)

    def table(self) -> str:
        """Fixed-width per-entry findings table for terminal output."""
        rows = [('entry point', 'findings', 'suppressed', 'key metrics')]
        for e in self.entries:
            mets = ', '.join(f'{k}={_fmt(e.metrics[k])}'
                             for k in TABLE_METRICS if k in e.metrics)
            rows.append((e.entry, str(len(e.findings)),
                         str(len(e.suppressed)), mets))
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        w2 = max(len(r[2]) for r in rows)
        lines = [f'{r[0]:<{w0}}  {r[1]:>{w1}}  {r[2]:>{w2}}  {r[3]}'
                 for r in rows]
        lines.insert(1, '-' * len(lines[0]))
        for f in self.all_findings():
            lines.append(str(f))
        return '\n'.join(lines)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f'{v:.3g}'
    return str(v)


def _jsonable(obj):
    """Best-effort conversion to JSON-safe values (numpy scalars etc.)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, 'item') and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except (TypeError, ValueError, RuntimeError):
            pass
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
