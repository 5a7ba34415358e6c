"""Deterministic, checkpointable, sharded token pipeline (the port's copy
of ``repro.data.pipeline``: numpy only, the same tokens bit for bit).

- ``SyntheticTokens``: collision-free counter-based stream (splitmix64 per
  (stream_id, step, position)) — every DP rank derives its slice of the
  global batch from (step, rank) alone, so restarts and *elastic rescales*
  reproduce the exact global token sequence with no coordination.
- ``MemmapTokens``: the same contract over a flat binary token file
  (np.memmap), for real corpora.

Iterator state is a single integer (the step counter) — it rides in the
checkpoint's ``extra`` dict and restores on any worker topology.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _check_split(global_batch: int, world: int):
    if global_batch % world:
        raise ValueError(f'global batch {global_batch} does not split into '
                         f'{world} equal rank batches')


@dataclass
class SyntheticTokens:
    vocab: int
    seq: int
    global_batch: int
    rank: int = 0
    world: int = 1
    step: int = 0

    def __post_init__(self):
        _check_split(self.global_batch, self.world)
        self.local_batch = self.global_batch // self.world

    def next_batch(self) -> Dict[str, np.ndarray]:
        b0 = self.rank * self.local_batch
        rows = (np.uint64(self.step) * np.uint64(self.global_batch)
                + np.arange(b0, b0 + self.local_batch, dtype=np.uint64))
        cols = np.arange(self.seq + 1, dtype=np.uint64)
        key = rows[:, None] * np.uint64(1_000_003) + cols[None, :]
        toks = (_splitmix64(key) % np.uint64(self.vocab)).astype(np.int32)
        self.step += 1
        return {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}

    def state(self) -> Dict:
        return dict(step=self.step)

    def restore(self, state: Dict, rank: Optional[int] = None,
                world: Optional[int] = None):
        """Restores the global stream position; rank/world may CHANGE
        (elastic rescale) — determinism is per (step, global row)."""
        self.step = int(state['step'])
        if rank is not None:
            self.rank = rank
        if world is not None:
            self.world = world
            _check_split(self.global_batch, self.world)
            self.local_batch = self.global_batch // self.world


@dataclass
class MemmapTokens:
    """Flat int32 token file; batch rows stride deterministically."""
    path: str
    vocab: int
    seq: int
    global_batch: int
    rank: int = 0
    world: int = 1
    step: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode='r')
        self.local_batch = self.global_batch // self.world
        self._n_rows = (len(self._data) - 1) // self.seq

    def next_batch(self) -> Dict[str, np.ndarray]:
        b0 = self.rank * self.local_batch
        rows = (self.step * self.global_batch
                + np.arange(b0, b0 + self.local_batch)) % self._n_rows
        out_t = np.empty((self.local_batch, self.seq), np.int32)
        out_l = np.empty((self.local_batch, self.seq), np.int32)
        for i, r in enumerate(rows):
            seg = self._data[r * self.seq: r * self.seq + self.seq + 1]
            out_t[i] = seg[:-1]
            out_l[i] = seg[1:]
        self.step += 1
        return {'tokens': out_t, 'labels': out_l}

    state = SyntheticTokens.state
    restore = SyntheticTokens.restore
