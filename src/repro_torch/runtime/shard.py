"""Atom sharding over a ``torch.distributed`` process group.

The port's counterpart of the reference's atom mesh
(``repro.launch.sharding.make_atom_mesh`` and ``atom_shardings``): where
the reference maps atoms over a 1-D device mesh, the port splits them over
the ranks of a process group, in rank order, ``natoms / world_size`` rows
each.

- :func:`group_of` — the given group or the default one, which must be
  initialized.
- :func:`rank_rows` — this rank's ``(offset, n_local)``.
- :func:`gather_atoms` — every rank's rows, all-gathered in rank order
  (what the reference returns as one global array).
- :func:`atom_slices` — ``(RankSlice, None)``, the placements of
  :func:`repro_torch.runtime.checkpoint.restore` for atom-axis and
  replicated leaves (the reference's ``(P('data'), P())``).

Nothing here creates a group: the group is the caller's (or
:func:`repro_torch.launch.sharding.spawn_ranks`').  The collectives take
tensors on the group's device; a gloo group on one card takes CUDA tensors
and moves them through the host itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .checkpoint import RankSlice


def group_of(group=None):
    """``group``, or the default group; raises when no group is
    initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError('sharding needs an initialized process group '
                           '(torch.distributed.init_process_group)')
    return group if group is not None else dist.group.WORLD


def rank_rows(natoms: int, group=None):
    """``(offset, n_local)`` of this rank's atoms; ``natoms`` must divide by
    the group's size."""
    group = group_of(group)
    world = dist.get_world_size(group)
    if natoms % world:
        raise ValueError(f'natoms={natoms} must divide by the group size '
                         f'{world}')
    n_local = natoms // world
    return dist.get_rank(group) * n_local, n_local


def gather_atoms(t, group=None):
    """[n_local, ...] rows of every rank -> [world * n_local, ...], in rank
    order.  Bool tensors travel as uint8."""
    group = group_of(group)
    world = dist.get_world_size(group)
    src = t.contiguous()
    if t.dtype == torch.bool:
        src = src.to(torch.uint8)
    out = src.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def atom_slices(group=None):
    """(sharded, replicated) placements for ``checkpoint.restore``: this
    rank's slice along the atom axis, and the whole leaf."""
    group = group_of(group)
    return RankSlice(dist.get_rank(group), dist.get_world_size(group)), None
