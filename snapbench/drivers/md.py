"""NVE molecular dynamics in segments on the port's device loop.

Traffic parameters (``traffic/<name>.json``): ``natoms`` (a cube of bcc
cells of the configuration's lattice), ``perturb_A``, ``temperature_K``,
``dt_ps``, ``skin_A``, ``max_nbors``, ``log_every``, ``segment_steps``,
``warmup_steps``, ``dtype``.

Set-up makes the coefficients and warms the device loop with one run of
``warmup_steps`` from its own start.  The window is a run of segments:
each starts from the lattice, perturbed and given Maxwell-Boltzmann
velocities from (seed, segment), and runs ``segment_steps`` steps of
``run_nve(loop='device', impl='kernel')`` with one ``fn_cache`` kept
across segments.  The window ends after the first segment that finishes
past ``--seconds``; ``md_grind_us`` is its wall time over atoms x steps.

The check follows one segment drawn from the seed with the float64
reference from the same start: the end positions and velocities and every
thermo row against the reference's, and the energy of the returned state
against the segment's last row.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from .. import inputs
from ..harness import DTYPES, Outcome
from ..reference.md import count_pairs, follow_nve, forces_of
from ..reference.snap import Snap


def thermo_steps(steps: int, log_every: int):
    """The 1-based steps after which the port logs a thermo row."""
    return {it + 1 for it in range(steps)
            if it % log_every == 0 or it == steps - 1}


def run(ctx) -> Outcome:
    from repro_torch.core.snap import SnapConfig
    from repro_torch.md.integrate import MDState, run_nve

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    sc = cfg['snap']
    scfg = SnapConfig(twojmax=sc['twojmax'], rcut=sc['rcut'],
                      rfac0=sc['rfac0'], rmin0=sc['rmin0'],
                      switch_flag=sc['switch_flag'],
                      bzero_flag=sc['bzero_flag'], wself=sc['wself'])
    dtype_name, fk = ctx.precision()
    dtype = DTYPES[dtype_name]
    n = int(tr['natoms'])
    base, box = inputs.bcc(inputs.cells_for(n), float(cfg['lattice_a']))
    beta = inputs.beta(inputs.ncoeff(sc['twojmax']), float(cfg['beta_scale']),
                       ctx.seed, ctx.device)
    steps, mass = int(tr['segment_steps']), inputs.W_MASS
    dt, temp = float(tr['dt_ps']), float(tr['temperature_K'])

    def start(s):
        g = inputs.rng(ctx.seed, 1, s)
        pos = base + g.normal(scale=float(tr['perturb_A']), size=base.shape)
        return pos, inputs.velocities(n, temp, g, mass)

    cache = {}

    def segment(s, n_steps):
        pos, vel = start(s)
        st = MDState(pos.copy(), vel.copy(), box.copy())
        return run_nve(
            scfg, beta, 0.0, st, n_steps, dt=dt, mass=mass, impl='kernel',
            max_nbors=int(tr['max_nbors']), log_every=int(tr['log_every']),
            loop='device', force_kwargs=fk, fn_cache=cache,
            skin=float(tr['skin_A']), device=ctx.device, dtype=dtype)

    # set-up: the chunk functions, the cell grid and every kernel's plan
    segment(1 << 30, int(tr['warmup_steps']))

    t0 = ctx.begin_window()
    done, failed, s = [], 0, 0
    while True:
        with ctx.span('segment'):
            try:
                st, thermo = segment(s, steps)
                ok = all(np.isfinite([r['pe'], r['ke']]).all()
                         for r in thermo)
            except Exception:     # noqa: BLE001 (a failed segment counts)
                print(f'segment {s} failed:', file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                ok = False
        if ok:
            done.append((s, st.pos, st.vel, thermo))
        else:
            failed += 1
        s += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.end_window()
    metrics = {}
    if done:
        metrics['md_grind_us'] = ctx.window_s * 1e6 / (n * steps * len(done))

    del cache
    if ctx.cuda:
        torch.cuda.empty_cache()
    counters = dict(steps=steps * s, segments=s, atoms=n,
                    evaluations=(steps + 1) * s, twojmax=sc['twojmax'],
                    dtype=dtype_name)
    if ctx.trace and done:
        # the pairs the inputs need, at each segment's start and end
        dev = torch.device(ctx.device)
        counts = []
        for k, pos, _, _ in done:
            p0 = torch.as_tensor(start(k)[0], device=dev)
            p1 = torch.as_tensor(pos, device=dev, dtype=torch.float64)
            counts += [count_pairs(p0, box, sc['rcut']),
                       count_pairs(p1, box, sc['rcut'])]
        counters['pairs'] = float(np.mean(counts))

    readings = dict(failed_segments=float(failed))
    if done:
        k, pos, vel, thermo = done[int(inputs.rng(ctx.seed, 2).integers(
            len(done)))]
        ref = Snap(sc, beta, 0.0, ctx.device)
        p0, v0 = start(k)
        rows = {r['step']: r for r in thermo}
        pos_r, vel_r, ref_rows = follow_nve(
            ref, p0, v0, box, steps, dt, mass,
            thermo_steps(steps, tr['log_every']))
        pos_r, vel_r = pos_r.cpu().numpy(), vel_r.cpu().numpy()
        pos, vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
        # the energy of the state the segment returned, against its own
        # last row
        e_end, _ = forces_of(ref, torch.as_tensor(pos, device=ref.dev), box,
                             forces=False)
        last = rows.get(steps, dict(pe=np.inf))['pe']
        readings.update(
            pos_err_A=float(np.max(np.abs(pos - pos_r))),
            vel_err_rel=float(np.max(np.abs(vel - vel_r))
                              / np.max(np.abs(vel_r))),
            pe_err_eV_atom=max(abs(rows[j]['pe'] - e) / n if j in rows
                               else np.inf for j, (e, _) in ref_rows.items()),
            ke_err_rel=max(abs(rows[j]['ke'] - kr) / kr if j in rows
                           else np.inf for j, (_, kr) in ref_rows.items()),
            end_pe_err_eV_atom=abs(last - float(e_end)) / n)
    return Outcome(attempted=s, failed=failed, metrics=metrics,
                   readings=readings, counters=counters)
