"""Int8-compressed gradient sum over a data-parallel process group (the
port of ``repro.optim.compression``).

``quantized_psum`` replaces an all-reduce of float32 values with an
all-gather of int8 values and one float32 scale a rank, then sums the
gathered ranks locally, each weighted by its scale: 4x fewer bytes on the
wire, and an error of at most max|x| / 254 a rank and element.

The group is the caller's (``torch.distributed``; see
``launch/sharding.spawn_ranks``), or one axis of the caller's mesh.  A gloo group takes the card's tensors
in its collectives and moves them through the host itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.transformer import tree_from_paths, tree_map, value_and_grad
from ..runtime.shard import group_of


def _all_gather(t, group):
    """[world, *t.shape]: every rank's ``t``, in rank order (gathered
    along a leading axis of 1, which gloo needs)."""
    out = t.new_empty((dist.get_world_size(group),) + tuple(t.shape))
    dist.all_gather_into_tensor(out, t.reshape((1,) + tuple(t.shape))
                                .contiguous(), group=group)
    return out


def quantized_psum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (default: the world),
    sent as int8 with one float32 scale a rank (max|x| / 127, at least
    1e-20; values round half to even)."""
    group = group_of(group)
    scale = (x.abs().amax().float() / 127.0).clamp_min(1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    qs = _all_gather(q, group)                  # int8 on the wire
    ss = _all_gather(scale, group)
    return torch.tensordot(ss, qs.float(), dims=([0], [0]))


def quantized_psum_tree(tree, group=None):
    return tree_map(lambda g: quantized_psum(g, group), tree)


def make_dp_compressed_grad(loss_fn, mesh=None, axis: str = 'pod'):
    """Data-parallel gradient with an int8-compressed reduction.

    ``loss_fn(params, batch) -> scalar``, ``params`` a nested dict of
    tensors (the same on every rank).  Returns ``fn(params, batch) ->
    (loss_mean, grads_mean)``: the loss is averaged over the ranks with an
    all-reduce, the gradients with ``quantized_psum`` / n.

    With a ``mesh`` (a ``DeviceMesh``), as the reference: ``batch`` is the
    global batch, each rank takes the share of its coordinate along
    ``axis`` (dim 0 cut into ``mesh`` size-of-``axis`` equal parts), and
    the reduction runs over ``mesh.get_group(axis)``.  Without one, every
    rank of the default group passes its own equal share of the global
    batch, and the reduction runs over that group."""
    def fn(params, batch):
        if mesh is None:
            g, part = group_of(None), batch
        else:
            g = mesh.get_group(axis)
            c, k = mesh.get_local_rank(axis), mesh.size(
                mesh.mesh_dim_names.index(axis))
            part = tree_map(lambda x: x[c * (x.shape[0] // k):
                                        (c + 1) * (x.shape[0] // k)], batch)
        n = dist.get_world_size(g)
        loss, grads = value_and_grad(lambda p: loss_fn(p, part), params)
        loss = loss.clone()
        dist.all_reduce(loss, group=g)
        return loss / n, tree_from_paths(
            {path: quantized_psum(gr, g) / n for path, gr in grads.items()})
    return fn
