#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SNAP on one NVIDIA card.

    python3 chip_smoke.py

Builds every hand-written CUDA kernel of the port from
``src/repro_torch/kernels/csrc`` (U, Y and fused dE on half and on full
planes, the bfloat16 Y operand option, and the deterministic force
assembly), holds each one against its plain PyTorch version at the paper's
snap-2j8 size (2000 bcc W atoms x 26 neighbors, 2J = 8) in float32 and
float64, holds the half, full and bfloat16 pipelines against their plain
pipelines and the float64 adjoint, checks that two evaluations give equal
bits and that an evaluation neither uploads nor synchronizes, and drives
each path through ``repro_torch.md.integrate.run_nve(impl='kernel')`` with
the launch counters set to 0 before and read after: 10 NVE steps on half
planes (the main path), 10 on full planes, 4 with bfloat16 Y operands.  At
2J = 14 (float32) it holds the half and full kernels against their plain
versions and runs one pipeline evaluation.

Bars: kernel vs plain, max |difference| / max |plain| <= 1e-10 in float64
and <= 1e-5 in float32, <= 1e-3 for the bfloat16 option; pipelines vs the
float64 adjoint (assembled with ``index_add_``, not the assembly kernel)
at the same bars, <= 1e-2 for bfloat16; the bfloat16 kernel at least twice
its bar away from the unrounded plain Y; relative NVE drift <= 1e-5; the
full-plane run's potential energy at step 10 within 1e-10 of the
half-plane run's.  Times are medians of CUDA-event timings after
warm-up.  The last two lines are one JSON object per kernel
(``{"kernels": [...]}``) and the result line; any failed check exits
nonzero without the result line.  Without a card it exits nonzero and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / 'src'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NATOMS, NNBOR, RCUT = 2000, 26, 4.7
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
BF16_TOL, BF16_ADJ_TOL = 1e-3, 1e-2
MD_STEPS, MD_REBUILD, MD_DRIFT_TOL, MD_PE_TOL = 10, 10, 1e-5, 1e-10
BF16_MD_STEPS = 4
# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): HBM3 3.35 TB/s,
# 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
CSRC = 'src/repro_torch/kernels/csrc/'
KERNELS = {   # name: (source, pl.pallas_call site it replaces)
    'snap_u_half': (CSRC + 'snap_u.cu', 'src/repro/kernels/snap_u.py:144'),
    'snap_y_half': (CSRC + 'snap_y.cu', 'src/repro/kernels/snap_y.py:273'),
    'snap_y_half_bf16': (CSRC + 'snap_y.cu',
                         'src/repro/kernels/snap_y.py:273'),
    'snap_fused_de_half': (CSRC + 'snap_fused_de.cu',
                           'src/repro/kernels/snap_fused_de_half.py:143'),
    'snap_u_full': (CSRC + 'snap_u.cu', 'src/repro/kernels/snap_u.py:84'),
    'snap_y_full': (CSRC + 'snap_y.cu', 'src/repro/kernels/snap_y.py:148'),
    'snap_fused_de_full': (CSRC + 'snap_fused_de.cu',
                           'src/repro/kernels/snap_fused_de.py:148'),
    # jnp scatter in the reference, no Pallas kernel
    'assemble_forces': (CSRC + 'assemble_forces.cu',
                        'src/repro/core/snap.py:95'),
}
HALF = ('snap_u_half', 'snap_y_half', 'snap_fused_de_half')
FULL = ('snap_u_full', 'snap_y_full', 'snap_fused_de_full')
# the kernels each path launches once per force evaluation
PATHS = {
    'half': HALF + ('assemble_forces',),
    'full': FULL + ('assemble_forces',),
    'bf16': ('snap_u_half', 'snap_y_half_bf16', 'snap_fused_de_half',
             'assemble_forces'),
}
FAILURES = []


def check(ok, what):
    print(('ok   ' if ok else 'FAIL ') + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times (ms) after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(a, b):
    """(max |a - b|, max |a - b| / max |b|) over tuples of tensors."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    num = max(float((x - y).abs().max()) for x, y in zip(a, b))
    den = max(float(y.abs().max()) for y in b)
    return num, num / den


# -- work counts for the bound: each input read once, each output written
# once; operations counted from each kernel's arithmetic per element ------

def _levels(twojmax):
    for j in range(1, twojmax + 1):
        rows = j // 2 + 1
        weighted = sum(1 for mb in range(rows) for ma in range(j + 1)
                       if 2 * mb < j or 2 * ma <= j)
        yield j, rows, weighted


def u_flops(twojmax, pairs, atoms=0, n_mirror=0):
    # geometry ~40; per recursion term 10 (conj mult, coefficient, add);
    # per half element 4 to accumulate sfac * u; the full layout adds the
    # mirror fill, 2 per mirror element per atom
    per = 40 + 1 + sum(10 * 2 * j * rows + 4 * rows * (j + 1)
                       for j, rows, _ in _levels(twojmax))
    return per * pairs + 2 * n_mirror * atoms


def y_flops(nnz, atoms, sigma=True):
    # 6 complex product, 2 coef, 2 add, and 2 sign multiplies with sigma
    return (12 if sigma else 10) * nnz * atoms


def de_flops(twojmax, pairs):
    # geometry + gradient ~80; per term 10 for u and 3 x 18 for the
    # tangents; per weighted element 2 + 3 x 10 for the contraction (the
    # same in both layouts: the full kernel carries the left rows, the
    # weight is 0 on the others)
    per = 80 + 4 + sum((10 + 54) * 2 * j * rows + 32 * w
                       for j, rows, w in _levels(twojmax))
    return per * pairs


def bound(nbytes, flops, dtype):
    t_mem, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            'bytes' if t_mem >= t_ops else 'operations')


def card_identity():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        'nvidia-smi: ' + out.stderr.strip()


def setup(twojmax, dev):
    from repro_torch.core.snap import SnapConfig
    from repro_torch.md.lattice import paper_box, perturb
    from repro_torch.md.neighbor import cell_neighbors
    cfg = SnapConfig(twojmax=twojmax, rcut=RCUT)
    pos, box = paper_box(NATOMS)
    pos = perturb(pos, 0.02, seed=2)
    nbr_idx, mask, disp, _ = cell_neighbors(pos, box, RCUT,
                                            max_nbors=NNBOR)
    rng = np.random.default_rng(1)
    beta = torch.as_tensor(rng.normal(size=cfg.ncoeff) * 5e-3, device=dev)
    return cfg, beta, pos, box, nbr_idx, mask, disp


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_phase(cfg, beta, nbr_idx, mask, disp, dtype, dev, names):
    """Each kernel of ``names`` and its plain version on the same card
    inputs, the ones the main path hands it (made by the plain stages)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.assemble import (assemble_forces_csr,
                                              assemble_forces_csr_plain,
                                              destination_csr)
    from repro_torch.kernels.snap_fused_de import (snap_fused_de_full,
                                                   snap_fused_de_full_plain)
    from repro_torch.kernels.snap_fused_de_half import (
        snap_fused_de_half, snap_fused_de_half_plain)
    from repro_torch.kernels.snap_u import (snap_u_full, snap_u_full_plain,
                                            snap_u_half, snap_u_half_plain)
    from repro_torch.kernels.snap_y import (snap_y_full, snap_y_full_plain,
                                            snap_y_half, snap_y_half_plain,
                                            y_coef, y_coef_half, y_tables)
    d = [torch.as_tensor(disp[..., c], device=dev, dtype=dtype)
         for c in range(3)]
    layout, ok, _ = ops._kernel_layout(
        cfg, *d, torch.as_tensor(mask, device=dev), dtype)
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    tj, idx, pairs = cfg.twojmax, cfg.index, NNBOR * NATOMS
    stages = {}   # layout: (U planes, coef, Y planes, Y tables)
    for lay, u_plain, y_plain, coef_of in (
            ('half', snap_u_half_plain, snap_y_half_plain, y_coef_half),
            ('full', snap_u_full_plain, snap_y_full_plain, y_coef)):
        u_r, u_i = u_plain(layout, **geo)
        ut = ((u_r + ops._self_planes(cfg, dtype, dev, lay)).contiguous(),
              u_i.contiguous())
        coef = coef_of(beta, tj).to(dtype)
        stages[lay] = (ut, coef, y_plain(*ut, coef, twojmax=tj),
                       y_tables(tj, dtype, dev, lay))
    dedr = snap_fused_de_half_plain(layout, *stages['half'][2], **geo)
    dmask = (dedr[:, :3, :NATOMS].permute(2, 0, 1) *
             ok[..., None].to(dtype)).contiguous()
    csr = destination_csr(torch.as_tensor(nbr_idx, device=dev), NATOMS)
    dest = torch.as_tensor(nbr_idx, device=dev).reshape(-1).long()
    bf16 = dict(mxu_dtype=torch.bfloat16)
    (uh, ch, yh, th), (uf, cf, yf, tf) = stages['half'], stages['full']
    cases = {   # name: (kernel, plain, bytes, operations, bar, library)
        'snap_u_half': (
            lambda: snap_u_half(layout, **geo),
            lambda: snap_u_half_plain(layout, **geo),
            nbytes(layout, *uh), u_flops(tj, pairs), TOL[dtype], None),
        'snap_u_full': (
            lambda: snap_u_full(layout, **geo),
            lambda: snap_u_full_plain(layout, **geo),
            nbytes(layout, *uf),
            u_flops(tj, pairs, NATOMS, idx.idxu_max - idx.idxu_half_max),
            TOL[dtype], None),
        'snap_y_half': (
            lambda: snap_y_half(*uh, ch, twojmax=tj),
            lambda: snap_y_half_plain(*uh, ch, twojmax=tj),
            2 * nbytes(*uh) + nbytes(ch, *th),
            y_flops(ch.numel(), NATOMS), TOL[dtype], None),
        'snap_y_half_bf16': (
            lambda: snap_y_half(*uh, ch, twojmax=tj, **bf16),
            lambda: snap_y_half_plain(*uh, ch, twojmax=tj, **bf16),
            2 * nbytes(*uh) + nbytes(ch, *th),
            y_flops(ch.numel(), NATOMS), BF16_TOL, None),
        'snap_y_full': (
            lambda: snap_y_full(*uf, cf, twojmax=tj),
            lambda: snap_y_full_plain(*uf, cf, twojmax=tj),
            2 * nbytes(*uf) + nbytes(cf, *tf),
            y_flops(cf.numel(), NATOMS, sigma=False), TOL[dtype], None),
        'snap_fused_de_half': (
            lambda: snap_fused_de_half(layout, *yh, **geo),
            lambda: snap_fused_de_half_plain(layout, *yh, **geo),
            2 * nbytes(layout) + nbytes(*yh), de_flops(tj, pairs),
            TOL[dtype], None),
        'snap_fused_de_full': (
            lambda: snap_fused_de_full(layout, *yf, **geo),
            lambda: snap_fused_de_full_plain(layout, *yf, **geo),
            2 * nbytes(layout) + nbytes(*yf), de_flops(tj, pairs),
            TOL[dtype], None),
        'assemble_forces': (
            lambda: assemble_forces_csr(dmask, *csr),
            lambda: assemble_forces_csr_plain(dmask, *csr),
            nbytes(dmask, *csr) + NATOMS * 3 * dmask.element_size(),
            6 * pairs, TOL[dtype],
            # the one-call library form of the same sum: the own rows,
            # then index_add_ of the reactions (float atomics)
            lambda: dmask.sum(dim=1).index_add_(0, dest,
                                                -dmask.reshape(-1, 3))),
    }
    out = {}
    for name in names:
        kern, plain, nb, flops, bar, library = cases[name]
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, ref)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (got if isinstance(got, tuple) else (got,)))
        check(finite and err <= bar,
              f'{name} {str(dtype)[6:]} 2J={tj}: max rel err {err:.3e} '
              f'(bar {bar:.0e}), max abs err {abs_err:.3e}')
        gap = None
        if name == 'snap_y_half_bf16':
            # the bar must tell a kernel that rounds from one that does not
            _, gap = rel_err(got, snap_y_half_plain(*uh, ch, twojmax=tj))
            check(gap >= 2 * bar, f'{name} {str(dtype)[6:]}: max rel '
                  f'distance from the unrounded plain Y {gap:.3e} (at least '
                  f'2 x the bar {bar:.0e}: a kernel that skipped the '
                  'roundings would fail it)')
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(nb, flops, dtype)
        lib = f', index_add_ form {lib_ms:.4f} ms' if lib_ms else ''
        print(f'     {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms{lib}, '
              f'bound {b_ms:.4f} ms by {b_by}; {flops / 1e9:.3f} GFLOP, '
              f'{nb / 1e6:.2f} MB; natoms_pad {layout.shape[2]})',
              flush=True)
        out[name] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms)
        if gap is not None:
            out[name]['rel_gap_unrounded'] = gap
    return out


def device_inputs(disp, nbr_idx, mask, dev):
    """(dx, dy, dz, nbr_idx, mask) on the card, as the MD loop holds them:
    a force evaluation then uploads nothing."""
    return (*(torch.as_tensor(disp[..., c], device=dev, dtype=torch.float64)
              for c in range(3)),
            torch.as_tensor(nbr_idx, device=dev),
            torch.as_tensor(mask, device=dev))


def syncs(fn):
    """The error of the first host synchronization ``fn`` makes, else
    None (CUDA sync debug mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
        return None
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


# tag: (dtype, layout, mxu_dtype, bar vs plain pipeline, bar vs adjoint).
# bf16 vs its plain pipeline takes the bf16 bar: the kernel and the plain
# U planes differ in their last float32 bits, which moves a bfloat16
# rounding of the Y stage by one step (2^-8 relative) here and there; the
# kernel phase holds the Y kernel to 1e-3 on identical inputs.
VARIANTS = {
    'half f64': (torch.float64, 'half', None, 1e-10, 1e-10),
    'half f32': (torch.float32, 'half', None, 1e-5, 1e-5),
    'full f64': (torch.float64, 'full', None, 1e-10, 1e-10),
    'full f32': (torch.float32, 'full', None, 1e-5, 1e-5),
    'bf16 f32': (torch.float32, 'half', torch.bfloat16, BF16_ADJ_TOL,
                 BF16_ADJ_TOL),
}


def assemble_index_add(dedr, nbr_idx, mask, natoms):
    """The reference's force scatter in its one-call library form
    (``index_add_``, float atomics on the card)."""
    d = dedr * mask[..., None].to(dedr.dtype)
    return d.sum(dim=1).index_add_(0, nbr_idx.reshape(-1).long(),
                                   -d.reshape(-1, 3))


def pipeline_phase(cfg, beta, nbr_idx, mask, disp, dev):
    """Each pipeline vs its plain pipeline and the float64 adjoint; full vs
    half at equal dtype; two evaluations bitwise equal, with no upload or
    host synchronization (half f64, full f64, bf16)."""
    from dataclasses import replace

    from repro_torch.core import snap as core_snap
    from repro_torch.kernels import ops
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    # the reference assembles with index_add_, not the kernel under test
    with mock.patch.object(core_snap, 'assemble_forces',
                           assemble_index_add):
        e_ref, _, f_ref = core_snap.energy_forces_adjoint(
            replace(cfg, dtype=torch.float64), *args[1:], device=dev)
    print(f'     adjoint f64: E = {float(e_ref):.10f} eV, max |F| = '
          f'{float(f_ref.abs().max()):.6f} eV/A', flush=True)
    forces = {}
    for tag, (dtype, layout, mxu, bar, adj_bar) in VARIANTS.items():
        kw = dict(dtype=dtype, device=dev, layout=layout, mxu_dtype=mxu)
        e_k, _, f_k = ops.snap_force_pipeline(*args, **kw)
        e_p, _, f_p = ops.plain_force_pipeline(*args, **kw)
        forces[tag] = f_k
        _, vs_plain = rel_err(f_k, f_p)
        _, vs_adj = rel_err(f_k.double(), f_ref)
        check(vs_plain <= bar and vs_adj <= adj_bar,
              f'pipeline {tag}: max |F| rel err vs plain {vs_plain:.3e} '
              f'(bar {bar:.0e}), vs f64 adjoint {vs_adj:.3e} (bar '
              f'{adj_bar:.0e})')
        de = abs(float(e_k) - float(e_ref)) / abs(float(e_ref))
        check(de <= adj_bar, f'pipeline {tag}: E = {float(e_k):.10f} eV '
              f'(rel diff vs adjoint {de:.3e}, bar {adj_bar:.0e})')
        if tag in ('half f64', 'full f64', 'bf16 f32'):
            e_2, _, f_2 = ops.snap_force_pipeline(*args, **kw)
            check(torch.equal(f_2, f_k) and torch.equal(e_2, e_k),
                  f'pipeline {tag}: two evaluations give equal forces and '
                  'energies (bitwise)')
            err = syncs(lambda: ops.snap_force_pipeline(*args, **kw))
            check(err is None, f'pipeline {tag}: no host synchronization '
                  f'in an evaluation ({err or "none raised"})')
        ms = time_ms(lambda: ops.snap_force_pipeline(*args, **kw), reps=10)
        plain_ms = time_ms(lambda: ops.plain_force_pipeline(*args, **kw),
                           reps=5)
        print(f'     pipeline {tag}: {ms:.3f} ms per force evaluation '
              f'(plain pipeline {plain_ms:.3f} ms)', flush=True)
    for dt in ('f64', 'f32'):
        dtype = VARIANTS[f'half {dt}'][0]
        _, err = rel_err(forces[f'full {dt}'], forces[f'half {dt}'])
        check(err <= TOL[dtype], f'pipeline full vs half {dt}: max |F| rel '
              f'err {err:.3e} (bar {TOL[dtype]:.0e})')


def profile_phase(cfg, beta, nbr_idx, mask, disp, dev, layout, reps=5):
    """Where the device time of one float64 force evaluation on ``layout``
    planes goes (torch.profiler over ``reps`` evaluations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    kw = dict(dtype=torch.float64, device=dev, layout=layout)
    ops.snap_force_pipeline(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            ops.snap_force_pipeline(*args, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print('     profile: no device events recorded (device time not '
              'measured)', flush=True)
        return
    per = {}
    for e in events:
        n, us = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy, end = 0.0, float('-inf')
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    total = sum(us for _, us in per.values())
    print(f'     profile {layout} f64 (per evaluation): '
          f'{len(events) / reps:.0f} device operations, '
          f'{total / reps / 1e3:.3f} ms device time, device busy '
          f'{busy / wall_us:.3f} of the profiled wall clock', flush=True)
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f'       {us / reps / 1e3:8.4f} ms  x{n / reps:4.0f}  '
              f'{name[:90]}', flush=True)
    # an upload from pageable memory makes the host wait for the stream
    h2d = sum(n for name, (n, _) in per.items() if 'HtoD' in name) / reps
    check(h2d == 0, f'profile {layout}: {h2d:.0f} host-to-device copies per '
          'force evaluation with inputs on the card (constant tables '
          'cached)')


def md_phase(cfg, beta, pos, box, dev, path, steps, dtype):
    """One path through run_nve(impl='kernel'), the launch counters set to
    0 just before and read just after; returns (counts, thermo)."""
    from repro_torch.kernels import ops
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    from repro_torch.md.neighbor import brute_neighbors
    force_kwargs = ({'mxu_dtype': torch.bfloat16} if path == 'bf16'
                    else {'layout': path})
    state = MDState(pos=pos.copy(), vel=init_velocities(len(pos), 300.0),
                    box=box)
    rebuild = []
    for _ in range(3):
        t0 = time.perf_counter()
        brute_neighbors(pos, box, RCUT, NNBOR)
        rebuild.append((time.perf_counter() - t0) * 1e3)
    rebuild_ms = statistics.median(rebuild)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, thermo = run_nve(cfg, beta, 0.0, state, steps, impl='kernel',
                        loop='scan', rebuild_every=MD_REBUILD,
                        max_nbors=NNBOR, log_every=5, device=dev,
                        dtype=dtype, force_kwargs=force_kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_eval = steps + 1          # one force per step plus the seed
    for row in thermo:
        print(f'     {path} step {row["step"]:>3}  T {row["T"]:9.3f} K  PE '
              f'{row["pe"]:.10f}  Etot {row["etot"]:.10f} eV', flush=True)
    e0, e1 = thermo[0]['etot'], thermo[-1]['etot']
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    if path == 'bf16':   # forces are not the gradient of the energy here
        check(np.isfinite(drift), f'md {path}: finite, relative NVE drift '
              f'{drift:.3e} over {steps} steps (no bar)')
    else:
        check(np.isfinite(drift) and drift <= MD_DRIFT_TOL,
              f'md {path}: relative NVE drift {drift:.3e} over {steps} '
              f'steps (bar {MD_DRIFT_TOL:.0e})')
    want = {k: (n_eval if k in PATHS[path] else 0) for k in counts}
    check(counts == want, f'md {path}: launches {counts} == {n_eval} force '
          f'evaluations for each kernel of the path, 0 for the others')
    ms_step = wall * 1e3 / steps
    n_rebuild = -(-steps // MD_REBUILD)
    ms_dev = (wall * 1e3 - n_rebuild * rebuild_ms) / steps
    print(f'     md {path}: {ms_step:.3f} ms per step, '
          f'{ms_step * 1e3 / NATOMS:.4f} us per atom-step (wall clock, '
          f'incl. {n_rebuild} host neighbor rebuild(s) of ~{rebuild_ms:.1f} '
          f'ms each, median of 3 alone); without them (derived) '
          f'{ms_dev:.3f} ms per step, '
          f'{ms_dev * 1e3 / NATOMS:.4f} us per atom-step', flush=True)
    return counts, thermo


def big_phase(dev):
    """2J = 14 in float32: each half and full kernel vs plain, then one
    half-plane pipeline evaluation, kernel pipeline vs plain."""
    from repro_torch.kernels import ops
    cfg, beta, _, _, nbr_idx, mask, disp = setup(14, dev)
    beta = beta * 1e-2
    stats = kernel_phase(cfg, beta, nbr_idx, mask, disp, torch.float32, dev,
                         HALF + FULL)
    args = (cfg, beta, 0.0, disp[..., 0], disp[..., 1], disp[..., 2],
            nbr_idx, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_k, _, f_k = ops.snap_force_pipeline(*args, dtype=torch.float32,
                                          device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    e_p, _, f_p = ops.plain_force_pipeline(*args, dtype=torch.float32,
                                           device=dev)
    _, err = rel_err(f_k, f_p)
    finite = bool(torch.isfinite(f_k).all()) and np.isfinite(float(e_k))
    check(finite and err <= TOL[torch.float32],
          f'2J=14 pipeline f32: max |F| rel err vs plain {err:.3e} (bar '
          f'1e-05), E {float(e_k):.6f} vs {float(e_p):.6f} eV, '
          f'{ms:.2f} ms (first call)')
    return stats


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'run needs an NVIDIA card', file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # no kernel here uses a
    torch.backends.cudnn.allow_tf32 = False         # matmul; stated anyway
    dev = torch.device('cuda', 0)
    ident = card_identity()
    print(f'card: {ident}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; allow_tf32 False', flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f'build: {time.perf_counter() - t0:.1f} s for '
          f'{len(built)} libraries (parallel nvcc, sm_90a)', flush=True)
    for name, info in built.items():
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'     {name}: {line.strip()}')

    cfg, beta, pos, box, nbr_idx, mask, disp = setup(8, dev)
    print(f'snap-2j8: {NATOMS} atoms, neighbors per atom '
          f'{int(mask.sum(1).min())}..{int(mask.sum(1).max())}, '
          f'idxu_half_max {cfg.index.idxu_half_max}, idxu_max '
          f'{cfg.index.idxu_max}', flush=True)
    stats = {torch.float64: kernel_phase(
                 cfg, beta, nbr_idx, mask, disp, torch.float64, dev,
                 list(KERNELS)),
             torch.float32: kernel_phase(
                 cfg, beta, nbr_idx, mask, disp, torch.float32, dev,
                 list(KERNELS))}
    pipeline_phase(cfg, beta, nbr_idx, mask, disp, dev)
    for layout in ('half', 'full'):
        profile_phase(cfg, beta, nbr_idx, mask, disp, dev, layout)
    runs = {path: md_phase(cfg, beta, pos, box, dev, path, steps, dtype)
            for path, steps, dtype in (
                ('half', MD_STEPS, torch.float64),
                ('full', MD_STEPS, torch.float64),
                ('bf16', BF16_MD_STEPS, torch.float32))}
    pe = {p: runs[p][1][-1]['pe'] for p in ('half', 'full')}
    d_pe = abs(pe['full'] - pe['half']) / abs(pe['half'])
    check(d_pe <= MD_PE_TOL, f'md: full-plane PE at step {MD_STEPS} '
          f'{pe["full"]:.12f} vs half-plane {pe["half"]:.12f} eV (rel diff '
          f'{d_pe:.3e}, bar {MD_PE_TOL:.0e})')
    big = big_phase(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = next(p for p in PATHS if name in PATHS[p])
        top, dt = ((stats[torch.float32][name], 'float32')
                   if name == 'snap_y_half_bf16'
                   else (stats[torch.float64][name], 'float64'))
        # top: max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms,
        # max_rel_err (and the bf16 kernel's rel_gap_unrounded)
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=runs[path][0][name], **top,
                     dtype=dt, path=path)
        other, sfx = ((torch.float32, 'f32') if dt == 'float64'
                      else (torch.float64, 'f64'))
        entry.update({f'{k}_{sfx}': v
                      for k, v in stats[other][name].items()})
        if name in big:
            entry.update({f'{k}_2j14_f32': v for k, v in big[name].items()})
        kernels.append(entry)
    print(ident)
    print(json.dumps({'kernels': kernels}))
    if FAILURES:
        print(f'chip_smoke: {len(FAILURES)} check(s) failed', file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
