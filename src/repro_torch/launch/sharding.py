"""Local ranks for atom sharding: :func:`spawn_ranks` runs a function on
N ranks, each its own process (``spawn`` start method) in one gloo group
on localhost, and returns what each returned.

The sharding itself (a rank's rows, the all-gather of rows, checkpoint
slices) is :mod:`repro_torch.runtime.shard`; it works in any process
group, this launcher's or the caller's.
"""

from __future__ import annotations

import datetime
import socket
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist

# spawn_ranks: gloo runs on one card for every rank (NCCL takes one card a
# rank) and on the CPU; a bound on each collective and on each result
_BACKEND, _TIMEOUT_S = 'gloo', 600.0


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, port, fn, args, queue):
    dist.init_process_group(
        _BACKEND, init_method=f'tcp://localhost:{port}', world_size=n_ranks,
        rank=rank, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    try:
        queue.put((rank, fn(rank, *args), None))
    except Exception:   # reported to the parent, which raises it
        queue.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_ranks: int, *args) -> List:
    """``[fn(rank, *args) for rank in range(n_ranks)]``, each call in its
    own process of one gloo group (``tcp://localhost``, a free port).
    ``fn`` and ``args`` must pickle (``fn`` a module-level function), and
    so must what ``fn`` returns.  A rank that raises makes the call raise
    with its traceback; the other ranks are stopped.  Each collective and
    the wait for each result are bounded (10 minutes)."""
    ctx = torch.multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, port, fn, args, queue))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    results, errors, done = [None] * n_ranks, [], False
    try:
        for _ in range(n_ranks):
            rank, out, err = queue.get(timeout=_TIMEOUT_S)
            if err is not None:
                errors.append(f'rank {rank}:\n{err}')
                break
            results[rank] = out
        done = not errors
    finally:
        for p in procs:
            if not done:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError('a rank failed\n' + '\n'.join(errors))
    return results
