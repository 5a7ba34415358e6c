"""U stage: per atom, sum over masked neighbors of sfac * u_j.

Replaces two TPU kernels of ``repro/kernels/snap_u.py``:

- :func:`snap_u_half` — ``snap_u_half_pallas``: the left rows 2mb <= j,
  planes ``[idxu_half_max, natoms_pad]`` (the pipeline's default layout);
- :func:`snap_u_full` — ``snap_u_pallas``: every row, planes
  ``[idxu_max, natoms_pad]`` (``layout='full'``).

Each wrapper runs its plain PyTorch version (``*_plain``, the recursion
vectorized over all (neighbor, atom) pairs) on a CPU tensor, launches its
hand-written kernel (``csrc/snap_u.cu``: atom tiles x neighbor groups,
the elements of each level shared by a block's threads, the sums in shared
memory; see the source for its bound on the H100) on a CUDA tensor with
the plan of :func:`launch_plan.u_plan`, and raises otherwise.
"""

from __future__ import annotations

import torch

from . import _build
from ..analysis import launches
from .common import (MAX_TWOJMAX, geom_ck, rootpq, u_half_level_step,
                     u_level_step)
from .launch_plan import u_plan
from ..core.indices import build_index

_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
         _build.I, _build.D, _build.D, _build.D, _build.I,
         # launch plan: lanes, threads, groups, shared bytes, partial planes
         _build.I, _build.I, _build.I, _build.I, _build.P)


def check_disp(disp, twojmax):
    if not isinstance(disp, torch.Tensor):
        raise TypeError(f'disp must be a tensor, got {type(disp).__name__}')
    if disp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'disp dtype must be float32/float64, got '
                        f'{disp.dtype}')
    if disp.ndim != 3 or disp.shape[1] != 4:
        raise ValueError(f'disp must be [nnbor, 4, natoms_pad], got '
                         f'{tuple(disp.shape)}')
    if not disp.is_contiguous():
        raise ValueError('disp must be contiguous')
    if not 0 <= twojmax <= MAX_TWOJMAX:
        raise ValueError(f'twojmax={twojmax} outside 0..{MAX_TWOJMAX}')


def _u_plain(disp, level_step, rows_of, nrows, *, twojmax, rcut, rmin0,
             rfac0, switch_flag):
    """Recursion vectorized over all pairs, each level's rows weighted by
    sfac, summed over neighbors: [nrows, N] re/im planes."""
    nnbor, _, n = disp.shape
    x, y, z, m = (disp[:, c, :].reshape(-1) for c in range(4))
    a_r, a_i, b_r, b_i, sfac = geom_ck(x, y, z, rcut, rmin0, rfac0,
                                       switch_flag)
    sfac = sfac * m
    lvl_r = torch.ones((1, 1, x.numel()), dtype=disp.dtype,
                       device=disp.device)
    lvl_i = torch.zeros_like(lvl_r)
    outs_r, outs_i = [sfac[None, :]], [torch.zeros_like(sfac)[None, :]]
    for j in range(1, twojmax + 1):
        lvl_r, lvl_i = level_step(lvl_r, lvl_i, a_r, a_i, b_r, b_i, j)
        outs_r.append(sfac * lvl_r.reshape(rows_of(j), -1))
        outs_i.append(sfac * lvl_i.reshape(rows_of(j), -1))
    return (torch.cat(outs_r).reshape(nrows, nnbor, n).sum(dim=1),
            torch.cat(outs_i).reshape(nrows, nnbor, n).sum(dim=1))


def snap_u_half_plain(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                      switch_flag=True):
    """Plain version: disp [nnbor, 4, N] -> (ut_r, ut_i) [idxu_half_max, N],
    the neighbor-accumulated raw U sums on the half rows (no self term)."""
    return _u_plain(disp, u_half_level_step, lambda j: (j // 2 + 1) * (j + 1),
                    build_index(twojmax).idxu_half_max, twojmax=twojmax,
                    rcut=rcut, rmin0=rmin0, rfac0=rfac0,
                    switch_flag=switch_flag)


def snap_u_full_plain(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                      switch_flag=True):
    """Plain version: disp [nnbor, 4, N] -> (ut_r, ut_i) [idxu_max, N],
    every row, each level mirror-filled as it is built
    (``common.u_level_step``), no self term."""
    return _u_plain(disp, u_level_step, lambda j: (j + 1) ** 2,
                    build_index(twojmax).idxu_max, twojmax=twojmax,
                    rcut=rcut, rmin0=rmin0, rfac0=rfac0,
                    switch_flag=switch_flag)


def _u(name, plain, nrows, disp, geo):
    """The wrapper of both U stages."""
    check_disp(disp, geo['twojmax'])
    meta = dict(twojmax=geo['twojmax'])
    if disp.device.type == 'cpu':
        return launches.plain(name, (disp,), meta, plain, disp, **geo)
    if disp.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {disp.device}')
    nnbor, _, n = disp.shape
    tj = geo['twojmax']
    plan = u_plan(tj, disp.dtype, n, nnbor)
    out_r = torch.empty((nrows, n), dtype=disp.dtype, device=disp.device)
    out_i = torch.empty_like(out_r)
    # the neighbor groups' partial sums [re, im][groups][idxu_half_max, n]
    part = torch.empty((2, plan.groups, build_index(tj).idxu_half_max, n),
                       dtype=disp.dtype, device=disp.device)
    sym = name + ('_f32' if disp.dtype == torch.float32 else '_f64')
    _build.launch('snap_u', sym, _ARGS, disp, out_r, out_i,
                  rootpq(disp.dtype, disp.device), nnbor, n, tj,
                  float(geo['rcut']), float(geo['rmin0']),
                  float(geo['rfac0']), int(geo['switch_flag']), plan.lanes,
                  plan.threads, plan.groups, plan.smem, part)
    launches.record(name, (disp,), (out_r, out_i), **meta)
    return out_r, out_i


def snap_u_half(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                switch_flag=True):
    """Half-plane U: disp [nnbor, 4, natoms_pad] (x, y, z, mask) ->
    (ut_r, ut_i) [idxu_half_max, natoms_pad], self term NOT included."""
    return _u('snap_u_half', snap_u_half_plain,
              build_index(twojmax).idxu_half_max, disp,
              dict(twojmax=twojmax, rcut=rcut, rmin0=rmin0, rfac0=rfac0,
                   switch_flag=switch_flag))


def snap_u_full(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                switch_flag=True):
    """Full-plane U: disp [nnbor, 4, natoms_pad] (x, y, z, mask) ->
    (ut_r, ut_i) [idxu_max, natoms_pad], self term NOT included."""
    return _u('snap_u_full', snap_u_full_plain,
              build_index(twojmax).idxu_max, disp,
              dict(twojmax=twojmax, rcut=rcut, rmin0=rmin0, rfac0=rfac0,
                   switch_flag=switch_flag))
