"""Central registry of the port's entry points (counterpart of
``repro.analysis.registry``).

Every hot path the reference has a structural invariant for is registered
here under the reference's sizes (2J=2, rcut 3.0, 120 of 128 bcc sites,
16-wide lists, the same beta seeds), with:

- a ``build(seed)`` factory returning the entry's function, example inputs
  on the registry's device and its build counter (two independent builds
  must agree in shape, dtype and device: the retrace lint's input);
- a :class:`DtypePolicy` declaring what precision is deliberate;
- padded vs logical lanes for the padding pass, and the plane rows for
  the plane-bytes metric;
- the kernel launches one call must make;
- an explicit allowlist for findings that are understood and accepted.

The names follow the reference's with ``jnp`` -> ``torch``:
``force.torch.adjoint``, ``force.torch.baseline``, ``force.kernel.half``,
``force.kernel.full``, ``force.kernel.half.bf16``, ``md.device_chunk``,
``serve.bucket_step`` and, inside a process group of at least 2 ranks,
``force.torch.sharded``.  ``python -m repro_torch.analysis`` runs every
pass over every entry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from .retrace import record_trace

TWOJMAX = 2
RCUT = 3.0
HALF = ('snap_u_half', 'snap_y_half', 'snap_fused_de_half',
        'destination_csr', 'assemble_forces')
FULL = ('snap_u_full', 'snap_y_full', 'snap_fused_de_full',
        'destination_csr', 'assemble_forces')
BF16 = ('snap_u_half', 'snap_y_half_bf16', 'snap_fused_de_half',
        'destination_csr', 'assemble_forces')
# the force assembly of the adjoint, baseline and sharded paths
ASSEMBLY = ('destination_csr', 'assemble_forces')
# the sharded adjoint's gloo collectives, allowlisted by name
COLLECTIVES = ('c10d._reduce_scatter_base_', 'c10d.allreduce_')


@dataclass(frozen=True)
class DtypePolicy:
    """What precision an entry point is *allowed* to touch.

    ``allow_f64``: the adjoint and baseline pipelines compute in f64 on
    purpose; the kernel pipelines must never upcast to it.  ``mxu_dtype``:
    set (``'bfloat16'``) when bfloat16 Y operands are a declared choice;
    otherwise any bf16 value is a leak.
    """
    allow_f64: bool = False
    mxu_dtype: Optional[str] = None


@dataclass
class Built:
    """One concrete build of an entry point: its function, example inputs,
    and the counter its build bumps."""
    fn: Callable
    args: Tuple
    counter: Dict


@dataclass
class EntryPoint:
    name: str
    build: Callable[[int], Built]
    policy: DtypePolicy = field(default_factory=DtypePolicy)
    pad_dims: Dict[int, int] = field(default_factory=dict)
    plane_rows: Tuple[int, ...] = ()
    lane_cols: Tuple[int, ...] = (128,)
    allow: FrozenSet[str] = frozenset()
    # kernel -> launches one call makes (None: not checked)
    launches: Optional[Dict[str, int]] = None
    # on the card, run the second call under CUDA sync debug mode
    sync_check: bool = True
    pad_waste_limit: float = 0.5
    description: str = ''


# ---------------------------------------------------------------------------
# shared example-input builders
# ---------------------------------------------------------------------------

def _force_inputs(seed: int, dtype, natoms: int = 120, max_nbors: int = 16,
                  device='cpu'):
    """Deterministic periodic W cluster + padded host neighbor lists:
    (dx, dy, dz, nbr_idx, mask) on ``device``, the displacements in
    ``dtype``.  120 of 128 bcc sites (8 vacancies) so the 128-lane pad
    carries real, representative padding waste."""
    from ..md.lattice import paper_box, perturb
    from ..md.neighbor import brute_neighbors

    pos, box = paper_box(natoms=128)
    pos = perturb(pos, 0.02, seed=seed)[:natoms]
    nbr_idx, mask, disp, _ = brute_neighbors(pos, box, RCUT, max_nbors)
    return (*(torch.as_tensor(disp[..., c], dtype=dtype, device=device)
              for c in range(3)),
            torch.as_tensor(nbr_idx, device=device),
            torch.as_tensor(mask, device=device))


def _beta(seed: int, dtype, cfg, device='cpu'):
    b = np.random.default_rng(100 + seed).normal(size=cfg.ncoeff) * 5e-3
    return torch.as_tensor(b, dtype=dtype, device=device)


def _cfg(dtype=torch.float64):
    from ..core.snap import SnapConfig
    return SnapConfig(twojmax=TWOJMAX, rcut=RCUT, dtype=dtype)


def _kernel_entry(layout: str, device, mxu_dtype=None):
    from ..kernels.ops import snap_force_pipeline

    def build(seed: int) -> Built:
        cfg = _cfg()
        counter: Dict = {}
        mxu = torch.bfloat16 if mxu_dtype == 'bfloat16' else None
        record_trace(counter)

        def fn(beta, dx, dy, dz, nbr_idx, mask):
            return snap_force_pipeline(
                cfg, beta, 0.0, dx, dy, dz, nbr_idx, mask,
                dtype=torch.float32, device=device, layout=layout,
                mxu_dtype=mxu)

        args = (_beta(seed, torch.float32, cfg, device),
                *_force_inputs(seed, torch.float32, device=device))
        return Built(fn, args, counter)
    return build


def _torch_entry(impl: str, device):
    from ..core.snap import energy_forces

    def build(seed: int) -> Built:
        cfg = _cfg()
        counter: Dict = {}
        record_trace(counter)

        def fn(beta, dx, dy, dz, nbr_idx, mask):
            return energy_forces(cfg, beta, 0.0, dx, dy, dz, nbr_idx, mask,
                                 impl=impl, device=device)

        args = (_beta(seed, torch.float64, cfg, device),
                *_force_inputs(seed, torch.float64, device=device))
        return Built(fn, args, counter)
    return build


def _md_chunk_entry(device):
    from ..md.cell_list import (N_FLAGS, auto_cell_cap, device_neighbors,
                                make_grid)
    from ..md.integrate import (W_MASS, init_velocities,
                                make_device_chunk_fn, make_force_fn)
    from ..md.lattice import paper_box, perturb

    def build(seed: int) -> Built:
        cfg = _cfg()
        pos, box = paper_box(natoms=54)
        pos = perturb(pos, 0.02, seed=seed)
        skin = 0.4
        rb = cfg.rcut + skin
        k_build = int(np.ceil(16 * (rb / cfg.rcut) ** 3 / 4.0)) * 4
        grid = make_grid(box, cfg.rcut, skin,
                         auto_cell_cap(pos, box, rb), k_build)
        counter: Dict = {}
        force_fn = make_force_fn(cfg, _beta(seed, torch.float64, cfg, device),
                                 0.0, impl='adjoint', device=device)
        chunk = make_device_chunk_fn(cfg, 5e-4, W_MASS, grid, force_fn,
                                     n_sub=3, trace_counter=counter)
        t = dict(dtype=torch.float64, device=device)
        pos_t = torch.as_tensor(pos, **t)
        box_t = torch.as_tensor(np.asarray(box, np.float64), **t)
        nbr_idx, mask, shifts, fl = device_neighbors(pos_t, box_t, grid)
        flags = torch.zeros(N_FLAGS, dtype=torch.int32, device=device)
        flags[:2] = fl
        vel = torch.as_tensor(init_velocities(54, 300.0, seed=seed), **t)
        args = (pos_t, vel, torch.zeros_like(pos_t), box_t, nbr_idx, shifts,
                mask, pos_t.clone(), flags, 0.0)
        return Built(chunk, args, counter)
    return build


SERVE_N_PAD, SERVE_MAX_NBORS, SERVE_BATCH = 16, 14, 2


def _serve_entry(device):
    from ..kernels.ops import make_batched_force_fn

    def build(seed: int) -> Built:
        cfg = _cfg()
        counter: Dict = {}
        fn = make_batched_force_fn(cfg, SERVE_N_PAD, SERVE_MAX_NBORS,
                                   impl='kernel', dtype=torch.float32,
                                   device=device, trace_counter=counter)
        rng = np.random.default_rng(200 + seed)
        n_valid = np.array([12, 14], np.int32)
        pos = np.zeros((SERVE_BATCH, SERVE_N_PAD, 3), np.float32)
        for i, n in enumerate(n_valid):
            pos[i, :n] = rng.uniform(0.0, 7.0, (n, 3))
        box = np.full((SERVE_BATCH, 3), 7.0, np.float32)
        beta = torch.stack([_beta(seed + i, torch.float32, cfg, device)
                            for i in range(SERVE_BATCH)])
        args = (torch.as_tensor(pos, device=device),
                torch.as_tensor(box, device=device), beta,
                torch.zeros(SERVE_BATCH, dtype=torch.float32, device=device),
                torch.as_tensor(n_valid, device=device))
        return Built(fn, args, counter)
    return build


def _sharded_entry(device):
    from ..kernels.ops import make_sharded_force_fn

    def build(seed: int) -> Built:
        cfg = _cfg()
        counter: Dict = {}
        record_trace(counter)
        fn = make_sharded_force_fn(cfg, _beta(seed, torch.float64, cfg,
                                              device),
                                   0.0, impl='adjoint', device=device)
        args = _force_inputs(seed, torch.float64, natoms=128, device=device)
        return Built(fn, args, counter)
    return build


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() >= 2


def default_registry(device='cuda') -> List[EntryPoint]:
    """Every registered entry point on ``device``, cheapest first.

    The atom-sharded path registers only inside an initialized default
    process group of at least 2 ranks (the reference's ">= 2 devices"
    rule); each rank then runs the registry in step."""
    from ..core.snap import resolve_device
    device = resolve_device(device)
    idx = _cfg().index
    plane_rows = (idx.idxu_max, idx.idxu_half_max)
    kernel_pads = {128: 120}        # natoms=120 on the 128-lane axis

    def once(names):
        return {k: 1 for k in names}

    entries = [
        EntryPoint(
            name='force.torch.adjoint', build=_torch_entry('adjoint', device),
            policy=DtypePolicy(allow_f64=True),
            launches=once(ASSEMBLY),
            description='paper Sec. IV adjoint pipeline (f64 oracle)'),
        EntryPoint(
            name='force.torch.baseline',
            build=_torch_entry('baseline', device),
            policy=DtypePolicy(allow_f64=True),
            launches=once(ASSEMBLY),
            description='pre-paper baseline (Z + dB materialized)'),
        EntryPoint(
            name='force.kernel.half', build=_kernel_entry('half', device),
            pad_dims=kernel_pads, plane_rows=plane_rows,
            pad_waste_limit=0.25, launches=once(HALF),
            description='CUDA U->Y->dE, half-plane layout (default)'),
        EntryPoint(
            name='force.kernel.full', build=_kernel_entry('full', device),
            pad_dims=kernel_pads, plane_rows=plane_rows,
            pad_waste_limit=0.25, launches=once(FULL),
            description='CUDA pipeline, full-plane A/B layout'),
        EntryPoint(
            name='force.kernel.half.bf16',
            build=_kernel_entry('half', device, mxu_dtype='bfloat16'),
            policy=DtypePolicy(mxu_dtype='bfloat16'),
            pad_dims=kernel_pads, plane_rows=plane_rows,
            pad_waste_limit=0.25, launches=once(BF16),
            description='half-plane pipeline with bfloat16 Y operands'),
        EntryPoint(
            name='md.device_chunk', build=_md_chunk_entry(device),
            policy=DtypePolicy(allow_f64=True),
            launches={'cell_bin': 3, 'cell_build': 3, 'destination_csr': 3,
                      'assemble_forces': 3},
            description='device-loop MD chunk (in-chunk rebuilds, n_sub=3)'),
        EntryPoint(
            name='serve.bucket_step', build=_serve_entry(device),
            # two 16-atom lanes, each padded to 128 atoms on one lane axis:
            # the lane-granularity padding tax is real and visible (7/8);
            # the budget ratchet holds it, the limit documents it
            pad_dims={2 * 128: 2 * SERVE_N_PAD}, plane_rows=plane_rows,
            lane_cols=(2 * 128,), pad_waste_limit=0.95,
            launches=once(HALF + ('brute_build',)),
            description='batched serving bucket step (B=2, n_pad=16)'),
    ]
    if _in_group():
        entries.append(EntryPoint(
            name='force.torch.sharded', build=_sharded_entry(device),
            policy=DtypePolicy(allow_f64=True),
            launches=once(ASSEMBLY),
            allow=frozenset(f'host-sync:{op}' for op in COLLECTIVES),
            sync_check=False,
            description='atom-sharded adjoint pipeline (reduce-scatter '
                        'force assembly over the process group)'))
    return entries
