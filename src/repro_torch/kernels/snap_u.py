"""Half-plane U stage: per atom, sum over masked neighbors of sfac * u_j.

Replaces the TPU kernel ``repro/kernels/snap_u.py:snap_u_half_pallas``.

- :func:`snap_u_half` — the wrapper: a CPU tensor runs the plain version,
  a CUDA tensor launches the hand-written kernel
  (``csrc/snap_u_half.cu``), anything else raises.
- :func:`snap_u_half_plain` — the same function in plain PyTorch, the
  recursion vectorized over all (neighbor, atom) pairs.

The CUDA kernel runs one thread per atom over its neighbors (see the
source for its bound on the H100 and what the design does about it).
"""

from __future__ import annotations

import torch

from . import _build
from .common import MAX_TWOJMAX, geom_ck, rootpq, u_half_level_step
from ..core.indices import build_index

_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
         _build.I, _build.D, _build.D, _build.D, _build.I)


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


def snap_u_half_plain(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                      switch_flag=True):
    """Plain version: disp [nnbor, 4, N] -> (ut_r, ut_i) [idxu_half_max, N],
    the neighbor-accumulated raw U sums on the half rows (no self term)."""
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
        lvl_r, lvl_i = u_half_level_step(lvl_r, lvl_i, a_r, a_i, b_r, b_i, j)
        rows = (j // 2 + 1) * (j + 1)
        outs_r.append(sfac * lvl_r.reshape(rows, -1))
        outs_i.append(sfac * lvl_i.reshape(rows, -1))
    nh = build_index(twojmax).idxu_half_max
    return (torch.cat(outs_r).reshape(nh, nnbor, n).sum(dim=1),
            torch.cat(outs_i).reshape(nh, nnbor, n).sum(dim=1))


def snap_u_half(disp, *, twojmax, rcut, rmin0=0.0, rfac0=0.99363,
                switch_flag=True):
    """Half-plane U: disp [nnbor, 4, natoms_pad] (x, y, z, mask) ->
    (ut_r, ut_i) [idxu_half_max, natoms_pad], self term NOT included."""
    check_disp(disp, twojmax)
    geo = dict(twojmax=twojmax, rcut=rcut, rmin0=rmin0, rfac0=rfac0,
               switch_flag=switch_flag)
    if disp.device.type == 'cpu':
        return snap_u_half_plain(disp, **geo)
    if disp.device.type != 'cuda':
        raise RuntimeError(f'snap_u_half: no kernel for device {disp.device}')
    nnbor, _, n = disp.shape
    nh = build_index(twojmax).idxu_half_max
    out_r = torch.empty((nh, n), dtype=disp.dtype, device=disp.device)
    out_i = torch.empty_like(out_r)
    sym = 'snap_u_half_f32' if disp.dtype == torch.float32 else \
        'snap_u_half_f64'
    _build.launch('snap_u_half', sym, _ARGS, disp, out_r, out_i,
                  rootpq(disp.dtype, disp.device), nnbor, n, twojmax,
                  float(rcut), float(rmin0), float(rfac0), int(switch_flag))
    snap_u_half.launches += 1
    return out_r, out_i


snap_u_half.launches = 0
