"""Mesh-aware optional sharding constraints for model internals (the port
of ``repro.models.shard_utils``).

``constrain(x, *axes)`` redistributes a DTensor to the named axes of the
current mesh (:func:`repro_torch.launch.compat.current_mesh`) where the
dims divide; on a plain tensor, or without a mesh, it returns ``x``.  This
pins intermediate tensors whose natural axis cannot cover the model axis
to one consistent layout, as the reference's ``with_sharding_constraint``
does.

Some ops have no DTensor sharding rule, and torch 2.11's DTensor refuses
some reshapes of sharded dims.  The model code runs such ops on plain
tensors: the whole value on every rank (:func:`whole`, and back with
:func:`replicated_on`), or each rank's own rows and shards
(:func:`gather_rows`, :func:`pick_last`, :func:`on_batch_rows`, and the
attention's ``_on_shards``), each call with a comment naming the
missing rule; :func:`matmul`, :func:`batch_layout`, :func:`pin` and
:func:`whole_dims` keep DTensor's own propagation to layouts it can
reshape.
"""

from __future__ import annotations

import contextlib
import math

import torch


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False without ``torch.distributed``)."""
    import torch.distributed as dist
    return dist.is_available() and isinstance(x, _dtensor_type())


def constrain(x, *axes):
    """``x`` redistributed so that tensor dim i is sharded over mesh axis
    ``axes[i]``: an axis of the current mesh, not used by an earlier dim,
    whose size divides the dim and is at most the dim.  Other dims and
    mesh axes are replicated.  A plain tensor, no mesh, or no dim that
    qualifies: ``x`` unchanged."""
    from ..launch.compat import axis_sizes, current_mesh
    from ..launch.sharding import NamedSharding, P
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    sizes = axis_sizes(mesh)
    spec, used = [], set()
    for dim, ax in enumerate(axes):
        ok = (ax is not None and ax in sizes and ax not in used
              and dim < x.ndim and x.shape[dim] % sizes[ax] == 0
              and x.shape[dim] >= sizes[ax])
        spec.append(ax if ok else None)
        if ok:
            used.add(ax)
    spec += [None] * (x.ndim - len(spec))
    if all(s is None for s in spec):
        return x
    return x.redistribute(mesh, NamedSharding(mesh, P(*spec)).placements)


class _Pin(torch.autograd.Function):
    """The identity, whose backward hands on the gradient in the forward
    value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):   # a partial value's gradient is whole
        from torch.distributed.tensor import Replicate
        return g.redistribute(ctx.mesh, [Replicate() if p.is_partial()
                                         else p for p in ctx.placements])


def pin(x):
    """``x``, with its gradient redistributed to ``x``'s placements before
    it flows further back (a DTensor; anything else unchanged).  Ahead of
    a reshape that merges a sharded dim, this keeps the backward's reshape
    from splitting a gradient sharded more ways than the merged dim's
    first part divides, which DTensor gets wrong."""
    return _Pin.apply(x) if is_dtensor(x) else x


def whole_dims(x, *dims):
    """A DTensor with no mesh dim sharding tensor dim ``dims`` (those made
    whole, the rest kept); anything else unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    return x if tuple(pl) == x.placements else x.redistribute(
        x.device_mesh, pl)


def unflatten_last(x, sizes):
    """``x``'s last dim split into ``sizes``; a DTensor's last dim is made
    whole first where the mesh shards it more ways than ``sizes[0]``
    divides (DTensor cannot split such a dim)."""
    if is_dtensor(x):
        mesh, last = x.device_mesh, x.ndim - 1
        ways = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if p.is_shard(last))
        if sizes[0] % ways:
            x = whole_dims(x, last)
    return x.reshape(*x.shape[:-1], *sizes)


def batch_layout(x):
    """A DTensor activation [B, ...] redistributed to the data-parallel
    layout: B over the mesh's batch axes ('pod', 'data') where they divide
    it, everything else whole; anything else unchanged.  Pinned at each
    block's entry, it keeps DTensor's cost-driven choices from handing a
    block an activation sharded in a way its reshapes cannot split (rows
    over 'model', d_model over 'data')."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    data = [i for i, n in enumerate(names)
            if n in ('pod', 'data') and mesh.size(i) > 1]
    split = x.shape[0] % math.prod(mesh.size(i) for i in data) == 0
    pl = tuple(Shard(0) if i in data and split else Replicate()
               for i in range(mesh.ndim))
    return x if pl == x.placements else x.redistribute(mesh, pl)


def _rows_on_data(x):
    """A DTensor whose dim 0 is split over the data axes only (a split of
    it over another mesh dim made whole)."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names or ()
    pl = tuple(Replicate() if p.is_shard(0) and names[i] not in
               ('pod', 'data') else p for i, p in enumerate(x.placements))
    return x if pl == x.placements else x.redistribute(x.device_mesh, pl)


def matmul(x, w):
    """``x @ w``.  For a DTensor ``x`` [B, S, K] (or [rows, K]), the
    product of its rows, split over the data axes only on the way in and
    out: torch 2.11's DTensor folds B and S into one dim only when S is
    whole, and splits it back only when B divides the ways the rows are
    split (``pin`` keeps the gradients in those layouts too).  ``w`` is
    made whole on the mesh dims that split the rows (FSDP's all-gather of
    the weights): left to itself, DTensor gathers whichever operand moves
    fewer bytes, and for a large ``w`` (a 262k-word unembedding) that is
    every rank's rows, each rank then computing the whole batch."""
    if not (is_dtensor(x) and x.ndim in (2, 3)):
        return x @ w
    lead = x.shape[:-1]
    rows = pin(batch_layout(x).reshape(-1, x.shape[-1]))
    if is_dtensor(w):
        from torch.distributed.tensor import Replicate
        w = w.redistribute(w.device_mesh, [
            Replicate() if r.is_shard(0) else p
            for r, p in zip(rows.placements, w.placements)])
    return pin(_rows_on_data(rows @ w).reshape(*lead, -1))


def reshard(x, sharding):
    """A DTensor redistributed to a ``launch.sharding.NamedSharding``'s
    placements (``with_sharding_constraint``); anything else unchanged."""
    if not is_dtensor(x):
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


_DEPTH = [0]   # mesh_context blocks open (implicit_replication does not nest)


@contextlib.contextmanager
def mesh_context(tree):
    """``implicit_replication()`` when a leaf of the nested dict ``tree``
    is a DTensor (the model's plain constants, such as positions, rotary
    tables and masks, then count as replicated); nothing otherwise.
    Blocks nest: only the outermost enters it, since leaving it turns
    implicit replication off whatever it was before."""
    from .transformer import tree_leaves
    if _DEPTH[0] or not any(is_dtensor(t) for _, t in tree_leaves(tree)):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _DEPTH[0] -= 1


def replicated(x):
    """A DTensor made whole on every rank (``Replicate()`` on each mesh
    dim); anything else unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def gather_rows(table, ids):
    """``table[ids]`` for a DTensor table: each rank gathers its own ids'
    rows from the whole table, and the rows take the ids' placements (the
    table's gradient is partial over the mesh dims that shard the ids)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    full = replicated(table)
    if not is_dtensor(ids):
        rep = [Replicate()] * full.device_mesh.ndim
        ids = DTensor.from_local(ids, full.device_mesh, rep, run_check=False)
    grad_pl = [Partial() if pl.is_shard() else Replicate()
               for pl in ids.placements]
    rows = full.to_local(grad_placements=grad_pl)[ids.to_local()]
    return DTensor.from_local(rows, ids.device_mesh, ids.placements,
                              run_check=False)


def pick_last(x, idx):
    """``x[..., idx]`` along the last dim of a DTensor ``x`` (``idx`` one
    integer an element of ``x.shape[:-1]``): each rank picks from its own
    slice of the last dim, and the result is partial over the mesh dims
    that shard it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, last = x.device_mesh, x.ndim - 1
    if any(pl.is_partial() for pl in x.placements):
        x = x.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                  for pl in x.placements])
    idx_pl, out_pl = [], []
    n, off = x.shape[-1], 0
    for i, pl in enumerate(x.placements):
        if pl.is_shard(last):
            n //= mesh.size(i)
            off += mesh.get_local_rank(i) * n
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            idx_pl.append(pl)
            out_pl.append(pl)
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    il = idx.redistribute(mesh, idx_pl).to_local() - off
    xl = x.to_local(grad_placements=x.placements)
    inside = (il >= 0) & (il < n)
    got = torch.gather(xl, -1, il.clamp(0, n - 1)[..., None])[..., 0]
    return DTensor.from_local(torch.where(inside, got, 0), mesh, out_pl,
                              run_check=False)


def on_batch_rows(fn, x, params, *rest):
    """``fn(x, params, *rest)`` on each rank's own batch rows of the
    DTensor ``x`` (``batch_layout``), with ``params`` (a dict) whole and
    the DTensors in ``rest`` (tensors or NamedTuples of them, leading dim
    the batch) in the same rows, all as plain tensors; its outputs
    (likewise) become DTensors of those rows.  For a mixer that
    is independent across batch rows and whose reshapes DTensor refuses
    (the SSM scans); the mixer then repeats on the ranks of the other
    mesh dims, and its parameters' gradients are partial over the data
    axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    x = batch_layout(x)
    mesh, pl = x.device_mesh, x.placements
    grad_pl = [Partial() if p.is_shard(0) else Replicate() for p in pl]

    def local(t):
        if not is_dtensor(t):
            return t
        return t.redistribute(mesh, pl).to_local()

    def tree(fn_, t):
        if isinstance(t, tuple) and hasattr(t, '_fields'):
            return type(t)(*(tree(fn_, u) for u in t))
        if isinstance(t, tuple):
            return tuple(tree(fn_, u) for u in t)
        return None if t is None else fn_(t)
    p = {k: replicated(v).to_local(grad_placements=grad_pl)
         if is_dtensor(v) else v for k, v in params.items()}
    out = fn(x.to_local(), p, *(tree(local, r) for r in rest))
    return tree(lambda t: DTensor.from_local(t, mesh, pl, run_check=False),
                out)


def whole(x):
    """A DTensor's whole value on every rank, as a plain tensor; its
    gradient, the same on every rank, flows back as a replicated one."""
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * x.device_mesh.ndim
    return replicated(x).to_local(grad_placements=rep)


def replicated_on(mesh, t):
    """A plain tensor that every rank holds whole, as a replicated DTensor
    of ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
