"""The static index tables on a device, uploaded once.

``torch.as_tensor`` of a numpy table at call time is an upload from
pageable memory, and on the card such an upload waits for the stream: a
host synchronization in every evaluation (the static analysis flags it,
``host-sync``).  The torch pipelines read their tables through
:func:`device_table` instead, which uploads each (table, dtype, device)
once and hands back the same read-only tensor afterwards.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


class _Identity:
    """Hash and equality by identity, for the index objects (frozen
    dataclasses of numpy arrays, which do not hash); holding the object
    keeps its id from being reused while the cache entry lives."""
    __slots__ = ('obj',)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Identity) and other.obj is self.obj


@lru_cache(maxsize=1024)
def _table(key: _Identity, attr, dtype, device):
    a = getattr(key.obj, attr) if isinstance(attr, str) else attr(key.obj)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def device_table(obj, attr, dtype, device) -> torch.Tensor:
    """``obj.<attr>`` — a table of a ``SnapIndex`` or one of its
    ``ULevelMaps`` — as a tensor of ``dtype`` on ``device``, uploaded on
    the first call only.  ``attr`` may also be a module-level function of
    ``obj`` for a table derived from others.  Treat the result as
    read-only: every caller gets the same tensor."""
    return _table(_Identity(obj), attr, dtype, torch.device(device))
