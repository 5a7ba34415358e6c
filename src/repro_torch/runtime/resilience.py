"""Fault-tolerance runtime: heartbeats, straggler mitigation, elastic
rescale decisions (the port's copy of ``repro.runtime.resilience``: plain
Python, the same decisions).

On a real multi-pod deployment these hooks bind to the cluster scheduler
(GKE/Borg preemption notices, ICI link health, per-host heartbeats).  Here
the *policy logic* is implemented and unit-tested against a simulated
cluster — the part that must be correct before hardware ever sees it.

Components:
- ``HeartbeatMonitor``: declares a worker dead after ``timeout_s`` without
  a heartbeat; exposes the surviving worker set.
- ``StragglerPolicy``: tracks per-step per-worker durations; flags workers
  persistently slower than ``threshold`` x median over a sliding window
  (the paper-world analogue: drop/replace slow hosts rather than letting
  the all-reduce critical path inherit their latency).
- ``ElasticPlan``: given survivors, picks the largest runnable mesh
  (power-of-two data axis, fixed model axis) and whether a restore+reshard
  is required — for a restart loop (``launch/train.py`` uses the
  straggler policy and the log).
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set


class HeartbeatMonitor:
    def __init__(self, workers: Sequence[str], timeout_s: float = 60.0,
                 now: float = 0.0):
        """``now`` is the construction time on the caller's clock and
        counts as every worker's first beat — a freshly constructed
        monitor must never declare workers dead before they have had a
        full ``timeout_s`` to report (initializing to 0.0 made all
        workers look dead the moment the clock passed ``timeout_s``)."""
        self.timeout_s = timeout_s
        self.last_seen: Dict[str, float] = {w: float(now) for w in workers}

    def beat(self, worker: str, now: float):
        self.last_seen[worker] = now

    def alive(self, now: float) -> Set[str]:
        return {w for w, t in self.last_seen.items()
                if now - t <= self.timeout_s}

    def dead(self, now: float) -> Set[str]:
        return set(self.last_seen) - self.alive(now)


class StragglerPolicy:
    """Flag workers whose step time exceeds threshold x median for at
    least ``patience`` of the last ``window`` steps."""

    def __init__(self, threshold: float = 1.5, window: int = 10,
                 patience: int = 5):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self._hist: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record_step(self, durations: Dict[str, float]):
        med = sorted(durations.values())[len(durations) // 2]
        for w, d in durations.items():
            self._hist[w].append(d > self.threshold * med)

    def stragglers(self) -> Set[str]:
        return {w for w, h in self._hist.items()
                if sum(h) >= self.patience}


@dataclass
class ElasticPlan:
    n_workers: int
    mesh_shape: tuple
    needs_reshard: bool
    dropped: tuple = ()


def plan_elastic_mesh(survivors: int, *, model_axis: int = 16,
                      prev_workers: Optional[int] = None,
                      chips_per_worker: int = 4) -> Optional[ElasticPlan]:
    """Largest (data, model) mesh runnable on the surviving chips.

    The model axis is pinned (TP degree is a property of the checkpointed
    layout only insofar as shapes divide — restore reshards anyway); the
    data axis shrinks to the largest power of two that fits.  Returns None
    when fewer than one model group survives (unrecoverable without
    replacement hardware).
    """
    chips = survivors * chips_per_worker
    if chips < model_axis:
        return None
    data = 2 ** int(math.log2(chips // model_axis))
    shape = (data, model_axis)
    needs_reshard = prev_workers is not None and survivors != prev_workers
    return ElasticPlan(n_workers=survivors, mesh_shape=shape,
                       needs_reshard=needs_reshard)


@dataclass
class FailureEvent:
    step: int
    kind: str            # 'worker_lost' | 'straggler' | 'preemption'
    worker: str


class ResilienceLog:
    """Structured record of failures/responses (surfaced in run reports)."""

    def __init__(self):
        self.events: List[FailureEvent] = []

    def record(self, step: int, kind: str, worker: str):
        self.events.append(FailureEvent(step, kind, worker))

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for e in self.events:
            out[e.kind] += 1
        return dict(out)
