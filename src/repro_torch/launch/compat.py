"""The ambient device mesh (the port of ``repro.launch.compat``).

The reference's mesh is a ``jax.sharding.Mesh`` that ``set_mesh``
installs for ``with_sharding_constraint``.  The port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, and :func:`set_mesh` installs it for
:func:`repro_torch.models.shard_utils.constrain` and the steps, which read
it with :func:`current_mesh`.

Nothing here creates a process group: the caller's (``spawn_ranks``, the
train driver's, or the dry run's fake group) must exist.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch.distributed as dist

_MESHES = []   # the stack of meshes set_mesh installed


def make_auto_mesh(shape, axes, device_type: str = 'cuda'):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose size must be ``prod(shape)``.  ``device_type`` is
    where the mesh's tensors live (the card unless the CPU is asked for).
    A card's mesh over a gloo group gets :func:`stage_gloo_collectives`."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError('a mesh needs an initialized process group '
                           '(torch.distributed.init_process_group)')
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if len(shape) != len(axes) or world != math.prod(shape):
        raise ValueError(f'a mesh {shape} named {axes} needs '
                         f'{math.prod(shape)} ranks; the group has {world}')
    if device_type == 'cuda' and dist.get_backend() == 'gloo':
        import torch
        torch.cuda.set_device(0 if torch.cuda.device_count() == 1
                              else dist.get_rank() % torch.cuda.device_count())
        stage_gloo_collectives('CUDA')
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


_STAGED = {}   # dispatch key -> the torch.library.Library holding the kernels


def stage_gloo_collectives(key: str = 'CUDA'):
    """DTensor's functional collectives (``_c10d_functional``, and
    ``_dtensor.shard_dim_alltoall``) on ``key`` tensors run as the
    blocking ``torch.distributed`` collectives of the group they name.

    On the card over gloo (the one backend that runs several ranks on one
    card), torch 2.11's functional collectives crash the process (a
    segmentation fault in ``all_gather_tensor``), while the blocking
    collectives take the card's tensors and move them through host memory
    inside gloo (all but the all-to-all, which gloo takes on the host
    only: it is staged through host memory here).  So these kernels
    replace the functional ones for ``key``: each collective completes
    before it returns, and ``wait_tensor`` is the identity.  The compute
    stays on the card."""
    if key in _STAGED:
        return
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {'sum': dist.ReduceOp.SUM, 'avg': dist.ReduceOp.SUM,
           'max': dist.ReduceOp.MAX, 'min': dist.ReduceOp.MIN,
           'product': dist.ReduceOp.PRODUCT}

    def reduce(out, op, g):     # gloo has no average: sum, then divide
        if op.lower() == 'avg':
            out.div_(dist.get_world_size(g))
        return out

    def all_reduce_(x, op, name):
        g = _resolve_process_group(name)
        dist.all_reduce(x, op=ops[op.lower()], group=g)
        return reduce(x, op, g)

    def all_reduce(x, op, name):
        return all_reduce_(x.clone(), op, name)

    def all_gather_into_tensor_out(x, size, name, *, out):
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(name))
        return out

    def all_gather_into_tensor(x, size, name):
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        return all_gather_into_tensor_out(x, size, name, out=out)

    def reduce_scatter_tensor(x, op, size, name):
        g = _resolve_process_group(name)
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=ops[op.lower()],
                                   group=g)
        return reduce(out, op, g)

    def all_to_all_single(x, out_splits, in_splits, name):
        # through host memory: gloo's all-to-all takes CPU tensors only
        n = sum(out_splits) if out_splits else x.shape[0]
        out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype)
        dist.all_to_all_single(out, x.cpu().contiguous(),
                               list(out_splits) or None,
                               list(in_splits) or None,
                               group=_resolve_process_group(name))
        return out.to(x.device)

    def shard_dim_alltoall(x, gather_dim, shard_dim, name):
        g = _resolve_process_group(name)
        parts = [torch.empty_like(x) for _ in range(g.size())]
        dist.all_gather(parts, x.contiguous(), group=g)
        whole = torch.cat(parts, dim=gather_dim)
        return whole.chunk(g.size(), dim=shard_dim)[g.rank()].contiguous()

    lib = torch.library.Library('_c10d_functional', 'IMPL')
    for name, fn in (('all_reduce', all_reduce), ('all_reduce_', all_reduce_),
                     ('all_gather_into_tensor', all_gather_into_tensor),
                     ('all_gather_into_tensor_out',
                      all_gather_into_tensor_out),
                     ('reduce_scatter_tensor', reduce_scatter_tensor),
                     ('all_to_all_single', all_to_all_single),
                     ('wait_tensor', lambda t: t)):
        lib.impl(name, fn, key)
    dtensor = torch.library.Library('_dtensor', 'IMPL')
    dtensor.impl('shard_dim_alltoall', shard_dim_alltoall, key)
    _STAGED[key] = (lib, dtensor)


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the ``with`` block."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object with the
    reference's mesh interface (``axis_names`` and a ``shape`` dict)."""
    if hasattr(mesh, 'mesh_dim_names'):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def current_mesh() -> Optional[object]:
    """The mesh :func:`set_mesh` installed, or None outside it."""
    return _MESHES[-1] if _MESHES else None
