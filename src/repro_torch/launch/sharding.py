"""Partition specs and placements for the language models, and local
ranks (the port of ``repro.launch.sharding``).

**Specs are plain data.**  A :class:`P` holds one entry a tensor dim:
None, an axis name, or a tuple of axis names, as the reference's
``PartitionSpec``.  The rules below (copied from the reference) produce
them from shapes and a mesh's axis sizes alone, so they can be held
against the reference's on the production geometry with no devices.

Baseline policy (per tensor *role*, with divisibility-checked fallbacks):

- FSDP ("data" axis): d_model dims of weight matrices (ZeRO-3).
- TP   ("model" axis): head / ff / expert / vocab dims.
- the "pod" axis is never used for parameters (pure DP across pods).
- batch dims shard over ("pod","data"); decode caches shard batch if
  divisible, else sequence; head_dim is the model-axis fallback when head
  counts aren't divisible.

**Placements.**  :class:`NamedSharding` ``(mesh, spec)`` turns a spec into
DTensor placements on a ``DeviceMesh``: a mesh dim gets ``Shard(d)`` when
the spec names it at tensor dim ``d``, else ``Replicate()``.
:func:`place` is the counterpart of ``jax.device_put`` with shardings: it
makes DTensors (a fake or meta leaf becomes a DTensor over a local shard
of the same kind, so no global tensor is built).

:func:`spawn_ranks` runs a function on N ranks, each its own process
(``spawn`` start method) in one gloo group on localhost, and returns what
each returned.  The atom sharding itself (a rank's rows, the all-gather
of rows, checkpoint slices) is :mod:`repro_torch.runtime.shard`; it works
in any process group, this launcher's or the caller's.
"""

from __future__ import annotations

import datetime
import faulthandler
import math
import socket
import time
import traceback
from dataclasses import dataclass
from queue import Empty
from typing import Callable, List

import torch
import torch.distributed as dist

from .compat import axis_sizes


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of axis names), as the reference's ``PartitionSpec`` (which
    also reads a one-name tuple as the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f'P{tuple.__repr__(self)}'


def _axis_size(mesh, name):
    return axis_sizes(mesh).get(name)


def auto_spec(shape, mesh, *, skip_leading=0):
    """Greedy fallback: 'model' then 'data' on the largest divisible dims."""
    spec = [None] * len(shape)
    taken = set()
    for ax in ('model', 'data'):
        size = _axis_size(mesh, ax)
        if size is None:
            continue
        cands = sorted(
            (d for d in range(skip_leading, len(shape))
             if d not in taken and shape[d] % size == 0 and shape[d] >= size),
            key=lambda d: -shape[d])
        if cands:
            spec[cands[0]] = ax
            taken.add(cands[0])
    return P(*spec)


# role -> preference list of (dim, axis); dims relative to the UNSTACKED
# tensor (a leading stack dim is handled by the caller).  First divisible
# wins, one dim per axis.
_PARAM_RULES = {
    'wq':   [(1, 'model'), (2, 'model'), (0, 'data')],
    'wk':   [(1, 'model'), (2, 'model'), (0, 'data')],
    'wv':   [(1, 'model'), (2, 'model'), (0, 'data')],
    'wo':   [(0, 'model'), (1, 'model'), (2, 'data')],
    'xwq':  [(1, 'model'), (2, 'model'), (0, 'data')],
    'xwk':  [(1, 'model'), (2, 'model'), (0, 'data')],
    'xwv':  [(1, 'model'), (2, 'model'), (0, 'data')],
    'xwo':  [(0, 'model'), (1, 'model'), (2, 'data')],
    'w_in':   [(1, 'model'), (0, 'data')],
    'w_gate': [(1, 'model'), (0, 'data')],
    'w_out':  [(0, 'model'), (1, 'data')],
    'r_w_in':   [(1, 'model'), (0, 'data')],
    'r_w_gate': [(1, 'model'), (0, 'data')],
    'r_w_out':  [(0, 'model'), (1, 'data')],
    'e_in':   [(0, 'model'), (1, 'data')],
    'e_gate': [(0, 'model'), (1, 'data')],
    'e_out':  [(0, 'model'), (2, 'data')],
    'router': [(0, 'data')],
    'in_proj':  [(1, 'model'), (0, 'data')],
    'out_proj': [(0, 'model'), (1, 'data')],
    'x_proj':   [(0, 'model')],
    'dt_proj':  [(1, 'model')],
    'conv_w':   [(1, 'model')],
    'A_log':    [(0, 'model')],
    'D':        [(0, 'model')],
    'dt_bias':  [(0, 'model')],
    'norm_w':   [(0, 'model')],
    'embed':   [(0, 'model'), (1, 'model'), (1, 'data')],
    'unembed': [(0, 'model'), (1, 'model'), (1, 'data')],
}

_NDIMS = {k: max(d for d, _ in v) + 1 for k, v in _PARAM_RULES.items()}


def _spec_for_param(path_names, shape, mesh):
    name = path_names[-1]
    rules = _PARAM_RULES.get(name)
    if rules is None:
        if len(shape) <= 1:
            return P()
        return auto_spec(shape, mesh, skip_leading=0)
    lead = len(shape) - _NDIMS[name]        # stacked group dims (0 or 1)
    if lead < 0:
        return auto_spec(shape, mesh)
    spec = [None] * len(shape)
    used_axes = set()
    for dim, axis in rules:
        d = dim + lead
        size = _axis_size(mesh, axis)
        if size is None or axis in used_axes or spec[d] is not None:
            continue
        if shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axis
            used_axes.add(axis)
    return P(*spec)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(d)`` where the spec
        names the mesh dim at tensor dim ``d``, else ``Replicate()`` (also
        on a mesh dim of size 1: one shard is the whole tensor)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name, size in axis_sizes(self.mesh).items():
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
        return tuple(out)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and NamedTuples (None leaves
    are kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return None if tree is None else fn(tree, *rest)


def _walk_params(tree, path, mesh):
    if isinstance(tree, dict):
        return {k: _walk_params(v, path + (k,), mesh)
                for k, v in tree.items()}
    return NamedSharding(mesh, _spec_for_param(path, tuple(tree.shape),
                                               mesh))


def param_shardings(params, mesh):
    """NamedSharding tree matching the parameter tree (leaves: anything
    with a ``shape``)."""
    return _walk_params(params, (), mesh)


def _is_qtensor(x) -> bool:
    return hasattr(x, 'q') and hasattr(x, 'scale')


def opt_shardings(opt_state, pshard, mesh):
    """Moments inherit parameter shardings; int8 QTensors fall back to the
    greedy auto rule (their block dims differ from the parameter's)."""
    def leaf(m, s):
        if _is_qtensor(m):
            return type(m)(
                q=NamedSharding(mesh, auto_spec(tuple(m.q.shape), mesh)),
                scale=NamedSharding(mesh,
                                    auto_spec(tuple(m.scale.shape), mesh)))
        return s

    def walk(m, s):
        if isinstance(m, dict):
            return {k: walk(v, s[k]) for k, v in m.items()}
        return leaf(m, s)
    return {'m': walk(opt_state['m'], pshard),
            'v': walk(opt_state['v'], pshard),
            'count': NamedSharding(mesh, P())}


def batch_shardings(batch, mesh):
    """Shard every input's leading (batch) dim over the data axes when
    divisible (batch=1 long-context decode stays replicated)."""
    from .mesh import batch_axes
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in axes)

    def spec(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % n == 0 and shape[0] >= n:
            return NamedSharding(mesh, P(axes))
        if len(shape) >= 2:
            return NamedSharding(mesh, auto_spec(shape, mesh))
        return NamedSharding(mesh, P())
    return tree_map(spec, batch)


def cache_shardings(cache, mesh):
    """Decode caches: greedy auto over trailing dims (batch or sequence on
    'data', channels/head_dim on 'model'); the group stack dim is never
    sharded."""
    return tree_map(lambda leaf: NamedSharding(
        mesh, auto_spec(tuple(leaf.shape), mesh, skip_leading=1)), cache)


def replicated(mesh):
    return NamedSharding(mesh, P())


def local_shape(shape, sharding: NamedSharding) -> tuple:
    """This rank's shard shape of a global ``shape`` (the specs shard only
    dims that divide evenly)."""
    out = list(shape)
    for size, pl in zip(axis_sizes(sharding.mesh).values(),
                        sharding.placements):
        if pl.is_shard():
            if out[pl.dim] % size:
                raise ValueError(f'dim {pl.dim} of {tuple(shape)} does not '
                                 f'split {size} ways')
            out[pl.dim] //= size
    return tuple(out)


def _is_abstract(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def place(tree, shardings):
    """``jax.device_put(tree, shardings)``: each leaf a DTensor with its
    sharding's placements.  A plain tensor is split locally (every rank
    holds the same global value, so nothing is sent); a DTensor is
    redistributed; a fake or meta tensor becomes a DTensor over a fake or
    meta local shard, with no global tensor built."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, ns):
        if isinstance(x, DTensor):
            return x.redistribute(ns.mesh, ns.placements)
        if _is_abstract(x):
            return DTensor.from_local(
                x.new_empty(local_shape(x.shape, ns)), ns.mesh,
                ns.placements, run_check=False, shape=x.shape,
                stride=x.stride())
        return distribute_tensor(x, ns.mesh, ns.placements,
                                 src_data_rank=None)
    return tree_map(one, tree, shardings)


def make_atom_mesh(n_shards=None, device_type='cuda'):
    """1-D mesh over the 'data' axis for atom-sharded SNAP pipelines: its
    ``get_group('data')`` is a group :mod:`repro_torch.runtime.shard`
    takes.  ``n_shards`` defaults to the world size."""
    import torch.distributed as dist
    from .compat import make_auto_mesh
    n = int(n_shards) if n_shards else dist.get_world_size()
    return make_auto_mesh((n,), ('data',), device_type)


def atom_shardings(mesh, axis='data'):
    """NamedShardings for atom-leading arrays: (sharded, replicated)."""
    return NamedSharding(mesh, P(axis)), NamedSharding(mesh, P())


# spawn_ranks: gloo runs on one card for every rank (NCCL takes one card a
# rank) and on the CPU; a bound on each collective and on each result
_BACKEND, _TIMEOUT_S = 'gloo', 600.0


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, port, fn, args, queue):
    faulthandler.enable()   # a rank that crashes says where
    dist.init_process_group(
        _BACKEND, init_method=f'tcp://localhost:{port}', world_size=n_ranks,
        rank=rank, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    try:
        out = fn(rank, *args)
        # no rank leaves the group while another is still in a collective
        dist.barrier()
        queue.put((rank, out, None))
    except Exception:   # reported to the parent, which raises it
        queue.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _collect(procs, queue, results) -> List[str]:
    """Fill ``results`` from the ranks' reports; the errors: the first
    rank that raised, a rank that died without reporting (its exit code),
    or the wait running out."""
    pending = set(range(len(procs)))
    deadline = time.monotonic() + _TIMEOUT_S
    while pending:
        try:
            rank, out, err = queue.get(timeout=1.0)
        except Empty:
            dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
            if dead:
                return [f'rank {r} died with exit code {procs[r].exitcode} '
                        'without reporting' for r in dead]
            if time.monotonic() > deadline:
                return [f'ranks {sorted(pending)} reported nothing in '
                        f'{_TIMEOUT_S:.0f} s']
            continue
        if err is not None:
            return [f'rank {rank}:\n{err}']
        results[rank] = out
        pending.discard(rank)
    return []


def spawn_ranks(fn: Callable, n_ranks: int, *args) -> List:
    """``[fn(rank, *args) for rank in range(n_ranks)]``, each call in its
    own process of one gloo group (``tcp://localhost``, a free port).
    ``fn`` and ``args`` must pickle (``fn`` a module-level function), and
    so must what ``fn`` returns.  A rank that raises makes the call raise
    with its traceback, and so does one that dies without reporting (with
    its exit code); the other ranks are stopped.  Each collective and the
    wait for the results are bounded (10 minutes)."""
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
        errors = _collect(procs, queue, results)
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
