#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SNAP on one NVIDIA card.

    python3 chip_smoke.py

Builds the three hand-written CUDA kernels of the half-plane force pipeline
(U -> Y -> fused dE) from ``src/repro_torch/kernels/csrc``, holds each one
against its plain PyTorch version at the paper's snap-2j8 size (2000 bcc W
atoms x 26 neighbors, 2J = 8) in float32 and float64, holds the kernel
pipeline against the plain pipeline and the float64 adjoint, runs 20 NVE
steps through ``repro_torch.md.integrate.run_nve(impl='kernel')`` with the
launch counters checked, and at 2J = 14 (float32) holds each kernel against
its plain version and runs one pipeline evaluation.

Bars: kernel vs plain, max |difference| / max |plain| <= 1e-10 in float64
and <= 1e-5 in float32; relative NVE drift <= 1e-5.  Times are medians of
CUDA-event timings after warm-up.  The last two lines are one JSON object
per kernel (``{"kernels": [...]}``) and the result line; any failed check
exits nonzero without the result line.  Without a card it exits nonzero
and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / 'src'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NATOMS, NNBOR, RCUT = 2000, 26, 4.7
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
MD_STEPS, MD_REBUILD, MD_DRIFT_TOL = 20, 10, 1e-5
# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): HBM3 3.35 TB/s,
# 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
KERNELS = {
    'snap_u_half': ('src/repro_torch/kernels/csrc/snap_u_half.cu',
                    'src/repro/kernels/snap_u.py:144'),
    'snap_y_half': ('src/repro_torch/kernels/csrc/snap_y_half.cu',
                    'src/repro/kernels/snap_y.py:273'),
    'snap_fused_de_half': (
        'src/repro_torch/kernels/csrc/snap_fused_de_half.cu',
        'src/repro/kernels/snap_fused_de_half.py:143'),
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


def u_flops(twojmax, pairs):
    # geometry ~40; per recursion term 10 (conj mult, coefficient, add);
    # per half element 4 to accumulate sfac * u
    per = 40 + 1 + sum(10 * 2 * j * rows + 4 * rows * (j + 1)
                       for j, rows, _ in _levels(twojmax))
    return per * pairs


def y_flops(nnz, atoms):
    return 12 * nnz * atoms   # 2 sign, 6 complex product, 2 coef, 2 add


def de_flops(twojmax, pairs):
    # geometry + gradient ~80; per term 10 for u and 3 x 18 for the
    # tangents; per weighted element 2 + 3 x 10 for the contraction
    per = 80 + 4 + sum((10 + 54) * 2 * j * rows + 32 * w
                       for j, rows, w in _levels(twojmax))
    return per * pairs


def bound(nbytes, flops, dtype):
    t_mem, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            'bytes' if t_mem >= t_ops else 'operations')


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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


def kernel_phase(cfg, beta, mask, disp, dtype, dev):
    """Each kernel and its plain version on the same card inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.snap_fused_de_half import (
        snap_fused_de_half, snap_fused_de_half_plain)
    from repro_torch.kernels.snap_u import snap_u_half, snap_u_half_plain
    from repro_torch.kernels.snap_y import (snap_y_half, snap_y_half_plain,
                                            y_coef_half)
    d = [torch.as_tensor(disp[..., c], device=dev, dtype=dtype)
         for c in range(3)]
    layout, _, _ = ops._kernel_layout(
        cfg, *d, torch.as_tensor(mask, device=dev), dtype)
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    u_plain = snap_u_half_plain(layout, **geo)
    ut_r = (u_plain[0] + ops._self_planes(cfg, dtype, dev)).contiguous()
    ut_i = u_plain[1].contiguous()
    coef = y_coef_half(beta, cfg.twojmax).to(dtype)
    y_plain = snap_y_half_plain(ut_r, ut_i, coef, twojmax=cfg.twojmax)
    natoms_pad = layout.shape[2]
    pairs = NNBOR * NATOMS
    cases = {
        'snap_u_half': (
            lambda: snap_u_half(layout, **geo),
            lambda: snap_u_half_plain(layout, **geo),
            nbytes(layout) + 2 * nbytes(ut_r),
            u_flops(cfg.twojmax, pairs)),
        'snap_y_half': (
            lambda: snap_y_half(ut_r, ut_i, coef, twojmax=cfg.twojmax),
            lambda: snap_y_half_plain(ut_r, ut_i, coef,
                                      twojmax=cfg.twojmax),
            4 * nbytes(ut_r) + nbytes(coef),
            y_flops(coef.numel(), NATOMS)),
        'snap_fused_de_half': (
            lambda: snap_fused_de_half(layout, *y_plain, **geo),
            lambda: snap_fused_de_half_plain(layout, *y_plain, **geo),
            2 * nbytes(layout) + 2 * nbytes(y_plain[0]),
            de_flops(cfg.twojmax, pairs)),
    }
    out = {}
    for name, (kern, plain, nb, flops) in cases.items():
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, ref)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (got if isinstance(got, tuple) else (got,)))
        check(finite and err <= TOL[dtype],
              f'{name} {str(dtype)[6:]} 2J={cfg.twojmax}: max rel err '
              f'{err:.3e} (bar {TOL[dtype]:.0e}), max abs err {abs_err:.3e}')
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
        b_ms, b_by = bound(nb, flops, dtype)
        print(f'     {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound '
              f'{b_ms:.4f} ms by {b_by}; {flops / 1e9:.3f} GFLOP, '
              f'{nb / 1e6:.2f} MB; natoms_pad {natoms_pad})', flush=True)
        out[name] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return out


def device_inputs(disp, nbr_idx, mask, dev):
    """(dx, dy, dz, nbr_idx, mask) on the card, as the MD loop holds them:
    a force evaluation then uploads nothing."""
    return (*(torch.as_tensor(disp[..., c], device=dev, dtype=torch.float64)
              for c in range(3)),
            torch.as_tensor(nbr_idx, device=dev),
            torch.as_tensor(mask, device=dev))


def pipeline_phase(cfg, beta, nbr_idx, mask, disp, dev):
    """Kernel pipeline vs plain pipeline vs the float64 adjoint."""
    from dataclasses import replace

    from repro_torch.core.snap import energy_forces_adjoint
    from repro_torch.kernels import ops
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    e_ref, _, f_ref = energy_forces_adjoint(
        replace(cfg, dtype=torch.float64), *args[1:], device=dev)
    fscale = float(f_ref.abs().max())
    print(f'     adjoint f64: E = {float(e_ref):.10f} eV, max |F| = '
          f'{fscale:.6f} eV/A', flush=True)
    for dtype in (torch.float64, torch.float32):
        kw = dict(dtype=dtype, device=dev)
        e_k, _, f_k = ops.snap_force_pipeline(*args, **kw)
        e_p, _, f_p = ops.plain_force_pipeline(*args, **kw)
        tag = str(dtype)[6:]
        _, vs_plain = rel_err(f_k, f_p)
        _, vs_adj = rel_err(f_k.double(), f_ref)
        check(vs_plain <= TOL[dtype] and vs_adj <= TOL[dtype],
              f'pipeline {tag}: max |F| rel err vs plain {vs_plain:.3e}, '
              f'vs f64 adjoint {vs_adj:.3e} (bar {TOL[dtype]:.0e})')
        de = abs(float(e_k) - float(e_ref)) / abs(float(e_ref))
        check(de <= TOL[dtype], f'pipeline {tag}: E = {float(e_k):.10f} eV '
              f'(rel diff vs adjoint {de:.3e})')
        ms = time_ms(lambda: ops.snap_force_pipeline(*args, **kw), reps=10)
        plain_ms = time_ms(lambda: ops.plain_force_pipeline(*args, **kw),
                           reps=5)
        print(f'     pipeline {tag}: {ms:.3f} ms per force evaluation '
              f'(plain pipeline {plain_ms:.3f} ms)', flush=True)


def profile_phase(cfg, beta, nbr_idx, mask, disp, dev, reps=5):
    """Where the device time of one float64 force evaluation goes
    (torch.profiler over ``reps`` evaluations); informational."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    kw = dict(dtype=torch.float64, device=dev)
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
    print(f'     profile f64 (per evaluation): {len(events) / reps:.0f} '
          f'device operations, {total / reps / 1e3:.3f} ms device time, '
          f'device busy {busy / wall_us:.3f} of the profiled wall clock',
          flush=True)
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f'       {us / reps / 1e3:8.4f} ms  x{n / reps:4.0f}  '
              f'{name[:90]}', flush=True)
    # an upload from pageable memory makes the host wait for the stream
    h2d = sum(n for name, (n, _) in per.items() if 'HtoD' in name) / reps
    check(h2d == 0, f'profile: {h2d:.0f} host-to-device copies per force '
          'evaluation with inputs on the card (constant tables cached)')


def md_phase(cfg, beta, pos, box, dev):
    """The main path: NVE MD through run_nve(impl='kernel')."""
    from repro_torch.kernels import ops
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    from repro_torch.md.neighbor import brute_neighbors
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
    _, thermo = run_nve(cfg, beta, 0.0, state, MD_STEPS, impl='kernel',
                        loop='scan', rebuild_every=MD_REBUILD,
                        max_nbors=NNBOR, log_every=5, device=dev,
                        dtype=torch.float64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_eval = MD_STEPS + 1          # one force per step plus the seed
    for row in thermo:
        print(f'     step {row["step"]:>3}  T {row["T"]:9.3f} K  PE '
              f'{row["pe"]:.10f}  Etot {row["etot"]:.10f} eV', flush=True)
    e0, e1 = thermo[0]['etot'], thermo[-1]['etot']
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    check(np.isfinite(drift) and drift <= MD_DRIFT_TOL,
          f'md: relative NVE drift {drift:.3e} over {MD_STEPS} steps '
          f'(bar {MD_DRIFT_TOL:.0e})')
    check(all(c == n_eval for c in counts.values()),
          f'md: launches {counts} == {n_eval} force evaluations each')
    ms_step = wall * 1e3 / MD_STEPS
    n_rebuild = -(-MD_STEPS // MD_REBUILD)
    ms_dev = (wall * 1e3 - n_rebuild * rebuild_ms) / MD_STEPS
    print(f'     md: {ms_step:.3f} ms per step, '
          f'{ms_step * 1e3 / NATOMS:.4f} us per atom-step (wall clock, '
          f'incl. {n_rebuild} host neighbor rebuilds of ~{rebuild_ms:.1f} '
          f'ms each, median of 3 alone); without them (derived) '
          f'{ms_dev:.3f} ms per step, '
          f'{ms_dev * 1e3 / NATOMS:.4f} us per atom-step', flush=True)
    return counts


def big_phase(dev):
    """2J = 14 in float32: each kernel vs plain, then one pipeline
    evaluation, kernel pipeline vs plain."""
    from repro_torch.kernels import ops
    cfg, beta, _, _, nbr_idx, mask, disp = setup(14, dev)
    beta = beta * 1e-2
    kernel_phase(cfg, beta, mask, disp, torch.float32, dev)
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
            if 'registers' in line or 'spill' in line:
                print(f'     {name}: {line.strip()}')

    cfg, beta, pos, box, nbr_idx, mask, disp = setup(8, dev)
    print(f'snap-2j8: {NATOMS} atoms, neighbors per atom '
          f'{int(mask.sum(1).min())}..{int(mask.sum(1).max())}, '
          f'idxu_half_max {cfg.index.idxu_half_max}', flush=True)
    stats = {dt: kernel_phase(cfg, beta, mask, disp, dt, dev)
             for dt in (torch.float64, torch.float32)}
    pipeline_phase(cfg, beta, nbr_idx, mask, disp, dev)
    profile_phase(cfg, beta, nbr_idx, mask, disp, dev)
    counts = md_phase(cfg, beta, pos, box, dev)
    big_phase(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        f64, f32 = stats[torch.float64][name], stats[torch.float32][name]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=counts[name],
                     max_abs_err=f64['max_abs_err'], ms=f64['ms'],
                     plain_ms=f64['plain_ms'], bound_ms=f64['bound_ms'],
                     bound_by=f64['bound_by'], library_ms=None,
                     dtype='float64', max_rel_err=f64['max_rel_err'])
        entry.update({f'{k}_f32': v for k, v in f32.items()})
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
