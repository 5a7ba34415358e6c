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
tensors: each rank's own rows and shards (:func:`pick_last`,
:func:`on_channel_shards`, :func:`on_batch_rows`, the attention's
``_on_shards``, and the embedding, the loss and the expert-parallel MoE
of ``layers`` and ``moe``), or, where the shards do not split evenly, the
whole value on every rank (:func:`whole`, and back with
:func:`replicated_on`), each call with a comment naming the missing
rule.  Code on local shards says where its values are partial sums
(``to_local``'s and ``from_local``'s placements, :func:`local_part`) and
runs the collectives its math needs itself (:func:`sum_over`,
:func:`vocab_logsumexp`, :func:`exchange`: ``_c10d_functional`` ops,
which the dry run counts).  :func:`matmul`, :func:`batch_layout`,
:func:`pin` and :func:`whole_dims` keep DTensor's own propagation to
layouts it can reshape.
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


def batch_layout(x, keep_last=()):
    """A DTensor activation [B, ...] redistributed to the data-parallel
    layout: B over the mesh's batch axes ('pod', 'data') where they divide
    it, everything else whole but the last dim's split over the mesh dims
    ``keep_last`` (where it is split so); anything else unchanged.  Pinned
    at each block's entry, it keeps DTensor's cost-driven choices from
    handing a block an activation sharded in a way its reshapes cannot
    split (rows over 'model', d_model over 'data')."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    data = [i for i, n in enumerate(names)
            if n in ('pod', 'data') and mesh.size(i) > 1]
    split = x.shape[0] % math.prod(mesh.size(i) for i in data) == 0
    last = x.ndim - 1
    pl = tuple(Shard(0) if i in data and split
               else p if i in keep_last and p.is_shard(last) and last
               else Replicate() for i, p in enumerate(x.placements))
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
    split (``pin`` keeps the gradients in those layouts too).  K stays
    split over the mesh dims that split ``w``'s first dim too (a
    contraction over shards: the product is partial there), and is whole
    otherwise.  ``w`` is made whole on the mesh dims that split the rows
    (FSDP's all-gather of the weights): left to itself, DTensor gathers
    whichever operand moves fewer bytes, and for a large ``w`` (a
    262k-word unembedding) that is every rank's rows, each rank then
    computing the whole batch.  A ``w`` split on its output dim alone
    keeps that split, and the product its rows."""
    if not (is_dtensor(x) and x.ndim in (2, 3)):
        return x @ w
    lead = x.shape[:-1]
    keep = () if not is_dtensor(w) else [
        i for i, p in enumerate(w.placements) if p.is_shard(0)]
    rows = pin(batch_layout(x, keep).reshape(-1, x.shape[-1]))
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


# ---------------------------------------------------------------------------
# explicit collectives for code that runs on each rank's local shards
# ---------------------------------------------------------------------------


def _wait(t):
    return torch.ops._c10d_functional.wait_tensor(t)


def _groups(mesh, dims):
    return [mesh.get_group(i) for i in dims if mesh.size(i) > 1]


def all_reduce(x, mesh, dims, op='sum'):
    """``x`` reduced over the mesh dims ``dims`` (no autograd: see
    :func:`sum_over`)."""
    for g in _groups(mesh, dims):
        x = _wait(torch.ops._c10d_functional.all_reduce(x, op, g.group_name))
    return x


def all_gather(x, mesh, dims):
    """``x`` gathered along a new leading dim for each mesh dim in
    ``dims`` (the first of ``dims`` outermost), no autograd."""
    for i in reversed(dims):
        n = mesh.size(i)
        if n > 1:
            x = _wait(torch.ops._c10d_functional.all_gather_into_tensor(
                x.contiguous(), n, mesh.get_group(i).group_name)
                ).reshape(n, *x.shape)
        else:
            x = x[None]
    return x


def _all_to_all(x, mesh, dims):
    """Block ``c`` of the leading dims of ``x`` ([n_0, n_1, ..., rest],
    one leading dim a mesh dim of ``dims``) sent to the rank at mesh
    coordinates ``c`` on those dims; what comes back is indexed by the
    sending rank's coordinates.  One equal-split ``all_to_all_single`` a
    mesh dim (a mesh dim's exchange moves its own leading dim)."""
    for k, i in enumerate(dims):
        n = mesh.size(i)
        if n == 1:
            continue
        y = x.movedim(k, 0).contiguous()
        split = [y.shape[0] // n] * n
        y = _wait(torch.ops._c10d_functional.all_to_all_single(
            y, split, split, mesh.get_group(i).group_name))
        x = y.movedim(0, k)
    return x


class _SumOver(torch.autograd.Function):
    """Sum over mesh dims; the backward hands the gradient on as it is
    (``both=False``: every rank's downstream is the same, as after a
    loss) or sums it over the same dims (``both=True``: each rank's
    downstream uses its own share of the channels, so each holds a part
    of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, both):
        ctx.mesh, ctx.dims, ctx.both = mesh, dims, both
        return all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        if ctx.both:
            g = all_reduce(g.contiguous(), ctx.mesh, ctx.dims)
        return g, None, None, None


def sum_over(x, mesh, dims, both=False):
    """``x`` summed over the mesh dims ``dims``, differentiable
    (:class:`_SumOver`)."""
    return _SumOver.apply(x, mesh, tuple(dims), both)


class _LogSumExp(torch.autograd.Function):
    """logsumexp along the last dim of ``x`` when each rank of the mesh
    dims ``dims`` holds a slice of that dim: a local max and an all-reduce
    max, a local sum and an all-reduce sum.  The backward is local: the
    gradient of a rank's slice is its own part of the softmax."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        m = all_reduce(x.amax(-1), mesh, dims, op='max')
        m = torch.where(torch.isfinite(m), m, 0)
        s = all_reduce(torch.exp(x - m[..., None]).sum(-1), mesh, dims)
        out = torch.log(s) + m
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * torch.exp(x - out[..., None]), None, None


def vocab_logsumexp(x, mesh, dims):
    """logsumexp along the last dim of ``x``, which the ranks of the mesh
    dims ``dims`` hold a slice each of (:class:`_LogSumExp`)."""
    return _LogSumExp.apply(x, mesh, tuple(dims))


class _Exchange(torch.autograd.Function):
    """:func:`exchange`.  An all-to-all is its own transpose (block j of
    rank i goes to block i of rank j), so the backward is the same
    exchange; the mesh dims' exchanges commute."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _exchange(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.dims), None, None


def _exchange(x, mesh, dims):
    sizes = [mesh.size(i) for i in dims]
    return _all_to_all(x.reshape(*sizes, *x.shape[1:]), mesh,
                       dims).reshape(x.shape)


def exchange(x, mesh, dims):
    """Block ``j`` of the leading dim of ``x`` sent to rank ``j`` of the
    ranks of the mesh dims ``dims`` (numbered as :func:`flat_rank` does),
    block ``j`` of the result received from rank ``j``: an all-to-all,
    differentiable (one ``all_to_all_single`` a mesh dim)."""
    return _Exchange.apply(x, mesh, tuple(dims))


class _GradOnFirst(torch.autograd.Function):
    """The identity, whose gradient reaches only the first rank of the
    mesh dims ``dims`` (zero elsewhere): for a value that every rank of
    those dims computes alike, from inputs whose gradients the mesh sums
    over them."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.first = all(mesh.get_local_rank(i) == 0 for i in dims)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None


def grad_on_first(x, mesh, dims):
    """:class:`_GradOnFirst`."""
    return _GradOnFirst.apply(x, mesh, tuple(dims))


def row_dims(x):
    """The mesh dims that split dim 0 (the batch rows) of a DTensor."""
    return [i for i, p in enumerate(x.placements) if p.is_shard(0)]


def model_dim(mesh):
    """The index of the mesh's 'model' dim, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index('model') if 'model' in names else None


def flat_rank(mesh, dims):
    """This rank's index among the ranks of the mesh dims ``dims``, the
    first dim outermost (the order of a dim split over them)."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


def on_rows(x, mi):
    """The local rows of the batch-layout DTensor ``x``, its gradient
    partial over the mesh dim ``mi`` (each of its ranks uses the rows
    for its own share of the work; None: no such dim)."""
    from torch.distributed.tensor import Partial
    return x.to_local(grad_placements=[
        Partial() if i == mi else p for i, p in enumerate(x.placements)])


def rows_out(t, mesh, row_pl, mi, partial=False):
    """A plain tensor of each rank's own rows as a DTensor with the row
    placements ``row_pl``; on the mesh dim ``mi`` partial (each rank's
    share of a sum) or replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [(Partial() if partial else Replicate()) if i == mi else p
          for i, p in enumerate(row_pl)]
    return DTensor.from_local(t, mesh, pl, run_check=False)


def take(t, dim, ranges):
    """The slices ``ranges`` ((start, stop) pairs) of ``t`` along ``dim``,
    in order (one range: a view)."""
    parts = [t.narrow(dim, a, b - a) for a, b in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def local_part(w, rows, mi=None, dim=None, ranges=None):
    """A DTensor parameter ``w`` as the plain tensor that a rank uses on
    its own rows (``rows``: the mesh dims that split them): whole on every
    mesh dim (the FSDP gather), except that where ``ranges`` (along
    ``dim``) is one range, this rank's even share of ``dim`` over 'model'
    (mesh dim ``mi``), it is that 'model' shard (redistributed to it where
    the parameter is split otherwise); any other ``ranges`` are taken
    (:func:`take`) from the whole.  Its gradient is partial over the mesh
    dims whose ranks each use it on their own rows or channels, replicated
    over the others (a plain ``w``: ``w``, taken)."""
    if not is_dtensor(w):
        return w if ranges is None else take(w, dim, ranges)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    keep = False
    if mi is not None and dim is not None:
        n, r = w.shape[dim] // mesh.size(mi), mesh.get_local_rank(mi)
        keep = (w.shape[dim] % mesh.size(mi) == 0
                and list(ranges) == [(r * n, (r + 1) * n)])
    pl = [Shard(dim) if keep and i == mi else Replicate()
          for i in range(mesh.ndim)]
    grad = [Shard(dim) if keep and i == mi
            else Partial() if i in rows or i == mi else Replicate()
            for i in range(mesh.ndim)]
    local = w.redistribute(mesh, pl).to_local(grad_placements=grad)
    return local if ranges is None or keep else take(local, dim, ranges)


def on_channel_shards(fn, x, params, state, layout):
    """``fn(x, params, state, reduce)`` on each rank's own batch rows of
    the DTensor ``x`` (``batch_layout``) and its own share of a mixer's
    channels over 'model', as plain tensors.  ``layout(r, m)`` gives rank
    ``r`` of ``m``'s share: ``({param: (dim, ranges)}, {state leaf: (dim,
    ranges)})`` (``ssm.channel_layout``); each parameter comes as
    :func:`local_part` gives it (its own 'model' shard where that is the
    share), the state (a NamedTuple of DTensors, or None) likewise.
    ``reduce`` is the sum over 'model' that a contraction over the
    channels needs (:func:`sum_over`, both ways).  ``fn`` returns (y,
    state): y, this rank's part of a sum over the channels, comes back
    partial over 'model' (DTensor sums it where it is used); a state leaf
    whose share is the rank's own 'model' shard comes back as that shard,
    any other (a share that also holds channels every rank has) whole,
    from an all-gather over 'model'."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = batch_layout(x)
    mesh = x.device_mesh
    mi, rows = model_dim(mesh), row_dims(x)
    r, m = mesh.get_local_rank(mi), mesh.size(mi)
    pmap, smap = layout(r, m)

    def placements(name, size):
        """The state leaf's placements, and whether they hold the share."""
        dim, ranges = smap[name]
        n = size // m
        pl = [p if i in rows else Replicate()
              for i, p in enumerate(x.placements)]
        keep = size % m == 0 and list(ranges) == [(r * n, (r + 1) * n)]
        if keep:
            pl[mi] = Shard(dim)
        return pl, keep

    def state_in(name, t):
        dim, ranges = smap[name]
        pl, keep = placements(name, t.shape[dim])
        local = t.redistribute(mesh, pl).to_local()
        return local if keep else take(local, dim, ranges)

    def state_out(name, t):
        dim = smap[name][0]
        shares = [layout(k, m)[1][name][1] for k in range(m)]
        size = max(b for share in shares for _, b in share)
        pl, keep = placements(name, size)
        if not keep:    # every rank's share, placed in the whole
            parts = all_gather(t.detach(), mesh, [mi])
            t = t.new_zeros(*t.shape[:dim], size, *t.shape[dim + 1:])
            for part, share in zip(parts, shares):
                off = 0
                for a, b in share:
                    t.narrow(dim, a, b - a).copy_(
                        part.narrow(dim, off, b - a))
                    off += b - a
        return DTensor.from_local(t, mesh, pl, run_check=False)

    p = {k: local_part(params[k], rows, mi, *pmap[k]) for k in pmap}
    st = None if state is None else type(state)(
        *(state_in(k, t) for k, t in zip(state._fields, state)))
    y, new = fn(on_rows(x, mi), p, st,
                lambda t: sum_over(t, mesh, [mi], both=True))
    return (rows_out(y, mesh, x.placements, mi, partial=True),
            type(new)(*(state_out(k, t) for k, t in zip(new._fields, new))))


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
