"""Velocity-Verlet NVE integration driving the SNAP force pipelines.

Port of ``repro.md.integrate`` with three step loops, fastest first:

- ``loop='device'``: the on-device engine.  Each logging chunk is a Python
  loop of velocity-Verlet steps whose state — positions, velocities,
  forces, the neighbor topology and the health-flag lattice — stays on the
  device.  A half-skin displacement trigger decides rebuilds *on the
  device* (a 0-d int32 tensor the cell-list kernels read themselves, see
  :func:`repro_torch.md.cell_list.rebuild_if`), and the lists, built at
  ``rcut + skin``, are hard-cut at ``rcut`` every step.  The host reads
  the stacked (PE, KE) rows, the flags and the rebuild count once per
  chunk, with one copy; nothing inside a chunk synchronizes.  A
  :class:`~repro_torch.md.resilience.RecoveryPolicy`, MD checkpoints and a
  fault hook apply to this loop only.  While a profiler records, its
  phases are spans (:mod:`repro_torch.runtime.trace`): ``md.seed``,
  ``md.build_chunk_fn``, ``md.chunk`` (``md.step`` a step),
  ``md.readback``, ``md.triage`` and ``md.finish``; the counter
  ``md.rebuilds`` adds the rebuilds of each committed chunk.
- ``loop='scan'``: neighbor lists rebuild on the host every
  ``rebuild_every`` steps (fixed-shape padded lists); between rebuilds a
  plain Python loop runs the velocity-Verlet steps with positions,
  velocities and forces kept on the device, and the host reads the stacked
  (PE, KE) rows once per segment.
- ``loop='host'``: the per-step loop (state on the host, one force call
  per step), kept as the A/B reference.

All evaluate the force exactly once per step, plus once at step 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..analysis import launches
from ..analysis.retrace import record_trace
from ..core.snap import SnapConfig, energy_forces, resolve_device
from ..runtime.checkpoint import host_array
from ..runtime.shard import atom_slices, gather_atoms, group_of
from ..runtime.trace import count, span
from .cell_list import (FLAG_DRIFT, FLAG_ESCAPE, FLAG_NAN_FORCE,
                        FLAG_NAN_STATE, N_FLAGS, auto_cell_cap, check_flags,
                        device_neighbors, make_grid, rebuild_if)
from .neighbor import brute_neighbors

KB = 8.617333262e-5      # eV/K
# mass in LAMMPS 'metal' units: grams/mole; time ps; conversion for
# a = F/m: 1 eV/(A*g/mol) = 9648.53 A/ps^2
ACC_CONV = 9648.533212331
W_MASS = 183.84


@dataclass
class MDState:
    pos: np.ndarray
    vel: np.ndarray
    box: np.ndarray
    step: int = 0


def init_velocities(n, temp, mass=W_MASS, seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(KB * temp / (mass / ACC_CONV))
    v = rng.normal(scale=sigma, size=(n, 3))
    return v - v.mean(0)


def temperature(vel, mass=W_MASS):
    ke = 0.5 * (mass / ACC_CONV) * float(np.sum(vel * vel))
    return 2.0 * ke / (3.0 * len(vel) * KB), ke


def make_force_fn(cfg: SnapConfig, beta, beta0, impl='adjoint', shards=1,
                  **kw):
    """fn(dx, dy, dz, nbr_idx, mask) -> (E, forces) with the physics
    parameters bound; ``kw`` goes to :func:`energy_forces`.

    shards > 1: the atom-sharded force over the default process group,
    whose size must equal ``shards``
    (:func:`repro_torch.kernels.ops.make_sharded_force_fn`); each rank
    passes the whole replicated inputs and gets the total energy and every
    atom's force, all-gathered in rank order."""
    if shards > 1:
        from ..kernels.ops import make_sharded_force_fn
        world = dist.get_world_size(group_of())
        if world != shards:
            raise ValueError(f'shards={shards} but the process group has '
                             f'{world} ranks')
        sharded = make_sharded_force_fn(cfg, beta, beta0, impl=impl, **kw)

        def force_fn(dx, dy, dz, nbr_idx, mask):
            e, _, f = sharded(dx, dy, dz, nbr_idx, mask)
            return e, gather_atoms(f)
        return force_fn

    def force_fn(dx, dy, dz, nbr_idx, mask):
        e, _, f = energy_forces(cfg, beta, beta0, dx, dy, dz, nbr_idx, mask,
                                impl=impl, **kw)
        return e, f
    return force_fn


def run_nve(cfg: SnapConfig, beta, beta0, state: MDState, n_steps: int,
            dt: float = 0.0005, mass: float = W_MASS,
            impl: str = 'adjoint', rebuild_every: int = 10,
            max_nbors: int = 40, log_every: int = 10, loop: str = 'scan',
            force_kwargs: Dict | None = None, fn_cache: Dict | None = None,
            skin: float = 1.0, cell_cap: int | None = None, shards: int = 1,
            policy=None, checkpoint_dir=None, checkpoint_every: int = 0,
            restore: bool = False, fault_hook=None, device='cuda',
            dtype=torch.float64):
    """NVE loop; returns (state, list of thermo dicts).

    ``device`` holds the MD state and runs the forces; ``dtype`` is the
    state's precision and, for impl='kernel', the pipeline's (unless
    ``force_kwargs`` names another).  impl='adjoint' runs in ``cfg.dtype``.
    ``force_kwargs`` go to the force implementation (for impl='kernel':
    ``layout``, ``mxu_dtype``).

    skin / cell_cap / shards apply to loop='device' only: Verlet skin
    radius (Å), static cell capacity (auto-sized from the initial
    configuration when None), and atom shards for the force pipeline.
    shards > 1 needs an initialized default process group of ``shards``
    ranks (``run_nve`` never creates one) and natoms divisible by
    ``shards``; every rank holds the whole replicated state, the force
    all-gathers every atom's rows, so each rank integrates the same
    positions and logs the same thermo; only rank 0 writes MD checkpoints
    (the others wait at a barrier), and a restore reads each rank's slice
    of the per-atom leaves and all-gathers them.  max_nbors keeps its
    host-path meaning (capacity of the rcut sphere); the device build
    scales it to the rcut+skin shell.

    Resilience (loop='device' only): a
    :class:`repro_torch.md.resilience.RecoveryPolicy` arms the in-loop
    health guards and turns capacity overflows into regrow + rollback and
    numeric blow-ups into rollback + dt-halving retries (bounded, typed
    errors past the budget); without a policy the first overflow raises
    at the chunk boundary.  checkpoint_dir + checkpoint_every snapshot the
    full device carry atomically every >= checkpoint_every committed
    steps; restore=True resumes from the latest snapshot under
    checkpoint_dir (bitwise-identical continuation when chunk boundaries
    align).  fault_hook (see :mod:`repro_torch.md.fault_inject`) is called
    at every chunk boundary to inject deterministic faults for testing.

    fn_cache: optional dict reused across calls to keep the device loop's
    grid and chunk functions; reuse is only valid for identical (cfg,
    beta, beta0, dt, mass, impl, skin, shards, force_kwargs, device,
    dtype) — enforced via a fingerprint.
    """
    device = resolve_device(device)
    if fn_cache is not None:
        fp = (cfg, host_array(beta).tobytes(), float(beta0), float(dt),
              float(mass), impl, float(skin), int(shards),
              tuple(sorted((force_kwargs or {}).items())), str(device),
              dtype)
        if fn_cache.setdefault('fingerprint', fp) != fp:
            raise ValueError(
                'fn_cache was built for different physics parameters '
                '(cfg/beta/dt/mass/impl/...); pass a fresh dict')
    if loop != 'device' and (policy is not None or checkpoint_dir
                             or restore or fault_hook or shards > 1):
        raise ValueError(
            'policy/checkpoint/restore/fault_hook/shards > 1 are '
            "device-loop features; use loop='device'")
    if len(state.pos) % shards:
        raise ValueError(f'natoms={len(state.pos)} must divide by '
                         f'shards={shards}')
    kw = dict(force_kwargs or {}, device=device)
    if impl == 'kernel':
        kw.setdefault('dtype', dtype)
    force_fn = make_force_fn(cfg, torch.as_tensor(beta, device=device),
                             beta0, impl, shards, **kw)
    if loop == 'device':
        return _run_nve_device(cfg, force_fn, state, n_steps, dt, mass,
                               max_nbors, log_every, fn_cache, skin,
                               cell_cap, shards, policy, checkpoint_dir,
                               checkpoint_every, restore, fault_hook, device,
                               dtype)
    if loop == 'scan':
        return _run_nve_scan(cfg, force_fn, state, n_steps, dt, mass,
                             rebuild_every, max_nbors, log_every, device,
                             dtype)
    if loop == 'host':
        return _run_nve_host(cfg, force_fn, state, n_steps, dt, mass,
                             rebuild_every, max_nbors, log_every, device,
                             dtype)
    raise ValueError(
        f"unknown loop {loop!r}; choose 'device', 'scan' or 'host'")


def _log_rows(thermo, seg_pe, seg_ke, first_step, base_step, n_atoms,
              n_steps, log_every):
    """Append thermo dicts for the logged steps of one segment."""
    for k, (pe, ke) in enumerate(zip(seg_pe, seg_ke)):
        it = first_step + k
        if it % log_every == 0 or it == n_steps - 1:
            ke = float(ke)
            T = 2.0 * ke / (3.0 * n_atoms * KB)
            thermo.append(dict(step=base_step + it + 1, T=T, ke=ke,
                               pe=float(pe), etot=float(pe) + ke))


def _run_nve_scan(cfg, force_fn, state, n_steps, dt, mass, rebuild_every,
                  max_nbors, log_every, device, dtype):
    acc_scale = ACC_CONV / mass
    n_atoms = len(state.pos)
    thermo = []
    pos = vel = f = None
    it = 0
    while it < n_steps:
        n_sub = min(rebuild_every, n_steps - it)
        # host boundary: rebuild topology at current positions
        pos_h = pos.cpu().numpy() if pos is not None else state.pos
        nbr_idx, mask, disp, shifts = brute_neighbors(
            pos_h, state.box, cfg.rcut, max_nbors)
        nbr_idx = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
        mask = torch.as_tensor(mask, device=device)
        shifts = torch.as_tensor(shifts, device=device, dtype=dtype)
        if f is None:   # first segment: seed the force carry once
            disp = torch.as_tensor(disp, device=device, dtype=dtype)
            _, f = force_fn(disp[..., 0], disp[..., 1], disp[..., 2],
                            nbr_idx, mask)
            pos = torch.as_tensor(pos_h, device=device, dtype=dtype)
            vel = torch.as_tensor(state.vel, device=device, dtype=dtype)
        rows = []
        for _ in range(n_sub):
            vel = vel + (0.5 * dt * acc_scale) * f
            pos = pos + dt * vel
            d = pos[nbr_idx] + shifts - pos[:, None, :]
            e, f = force_fn(d[..., 0], d[..., 1], d[..., 2], nbr_idx, mask)
            vel = vel + (0.5 * dt * acc_scale) * f
            ke = (0.5 * mass / ACC_CONV) * torch.sum(vel * vel)
            rows.append(torch.stack([e.to(ke.dtype), ke]))
        seg = torch.stack(rows).cpu().numpy()     # one read per segment
        _log_rows(thermo, seg[:, 0], seg[:, 1], it, state.step, n_atoms,
                  n_steps, log_every)
        it += n_sub
    if pos is not None:
        state.pos = pos.cpu().numpy()
        state.vel = vel.cpu().numpy()
    state.step += n_steps
    return state, thermo


def make_device_chunk_fn(cfg: SnapConfig, dt, mass, grid, force_fn,
                         n_sub: int = 10, trace_counter=None, policy=None):
    """One chunk of ``n_sub`` velocity-Verlet steps with the rebuild folded
    in (the counterpart of the reference's jitted chunk scan).

    Carry = (pos, vel, f, nbr_idx, shifts, mask, pos_ref, flags), all on one
    device.  Each step: half-kick, drift, then :func:`rebuild_if` with the
    trigger "some atom moved more than skin/2 since ``pos_ref``" (the
    positions of the last build) as a 0-d device tensor — a rebuild is
    decided and done on the device, otherwise the carried topology is
    still a superset of the exact rcut pair set.  The force pipeline then
    sees a per-step hard cut ``mask & (r^2 < rcut^2)``, so forces equal a
    rebuild-every-step reference.

    ``flags`` is the ``[N_FLAGS]`` int32 health lattice: slots 0-1 carry
    the running maxima of neighbor/cell occupancy from the rebuilds; with
    a :class:`~repro_torch.md.resilience.RecoveryPolicy` the step also
    latches sticky non-finite-force/state, atom-escape and energy-drift
    indicators (slots 2-5), device reductions merged into the carried
    vector.  ``e_ref`` is the watchdog's reference total energy (unused
    when the policy has no ``drift_tol``).  The chunk contains no branch on
    a device value and reads nothing back.

    Each call starts from copies of the carried topology and flags (the
    rebuild writes them in place), so the caller's carry — the rollback
    target — is never written.  Building the function adds one to
    ``trace_counter['traces']``, the counterpart of the reference's trace
    count.  force_fn: ``(dx, dy, dz, nbr_idx, mask) -> (e, forces)``.
    """
    acc_scale = ACC_CONV / mass
    half_skin2 = (0.5 * grid.skin) ** 2
    rc2 = cfg.rcut * cfg.rcut
    record_trace(trace_counter)
    guards = policy is not None
    escape_factor = getattr(policy, 'escape_factor', None)
    drift_tol = getattr(policy, 'drift_tol', None)

    def chunk(pos, vel, f, box, nbr_idx, shifts, mask, pos_ref, flags,
              e_ref):
        nbr_idx, shifts, mask, pos_ref, flags = (
            t.clone() for t in (nbr_idx, shifts, mask, pos_ref, flags))
        rebuilt = torch.zeros((), dtype=torch.int32, device=pos.device)
        rows = []
        for _ in range(n_sub):
            # one step: the analysis' hot scope and the span md.step
            with launches.hot(), span('md.step'):
                vel = vel + (0.5 * dt * acc_scale) * f
                pos = pos + dt * vel
                dp = pos - pos_ref
                moved2 = torch.max(torch.sum(dp * dp, dim=-1))
                # skin=0 degenerates to rebuild-every-step (moved2 >= 0 always)
                trigger = ((moved2 > half_skin2) if grid.skin > 0
                           else (moved2 >= 0.0)).to(torch.int32)
                rebuild_if(trigger, pos, box, grid, nbr_idx, shifts, mask,
                           pos_ref, flags)
                rebuilt = rebuilt + trigger
                disp = pos[nbr_idx] + shifts - pos[:, None, :]
                r2 = torch.sum(disp * disp, dim=-1)
                mask_t = mask & (r2 < rc2)              # exact per-step cutoff
                e, f = force_fn(disp[..., 0], disp[..., 1], disp[..., 2],
                                nbr_idx, mask_t)
                f = f.to(pos.dtype)
                vel = vel + (0.5 * dt * acc_scale) * f
                ke = (0.5 * mass / ACC_CONV) * torch.sum(vel * vel)
                if guards:
                    # sticky health lattice: O(N) reductions merged into the
                    # carried running-max vector (read with the thermo rows)
                    health = [torch.zeros((), dtype=torch.int32,
                                          device=pos.device)] * N_FLAGS
                    health[FLAG_NAN_FORCE] = ~torch.isfinite(f).all()
                    health[FLAG_NAN_STATE] = ~(torch.isfinite(pos).all()
                                               & torch.isfinite(vel).all())
                    health[FLAG_ESCAPE] = (
                        torch.max(torch.abs(pos / box - 0.5)) > escape_factor)
                    if drift_tol is not None:
                        health[FLAG_DRIFT] = torch.abs((e + ke) - e_ref) > \
                            drift_tol
                    flags = torch.maximum(flags, torch.stack(
                        [h.to(torch.int32) for h in health]))
                rows.append(torch.stack([e.to(ke.dtype), ke]))
        return (pos, vel, f, nbr_idx, shifts, mask, pos_ref, flags,
                torch.stack(rows), rebuilt)
    return chunk


def _seed_force(force_fn, cfg, pos, nbr_idx, shifts, mask):
    """(energy, forces) at the carried positions (exact rcut cut) — used at
    step 0 and after capacity regrows (same positions, wider topology)."""
    disp = pos[nbr_idx] + shifts - pos[:, None, :]
    mask0 = mask & (torch.sum(disp * disp, -1) < cfg.rcut * cfg.rcut)
    e, f = force_fn(disp[..., 0], disp[..., 1], disp[..., 2], nbr_idx,
                    mask0)
    return e, f.to(pos.dtype)


def _full_flags(build_flags):
    """Lift the [2] build flags into the [N_FLAGS] health lattice."""
    flags = torch.zeros(N_FLAGS, dtype=torch.int32,
                        device=build_flags.device)
    flags[:2] = build_flags
    return flags


def _carry_tensor(x, device, dtype):
    """A restored carry leaf on ``device``: float leaves in ``dtype``, the
    int32 and bool leaves as saved."""
    t = torch.tensor(np.asarray(x), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _run_nve_device(cfg, force_fn, state, n_steps, dt, mass, max_nbors,
                    log_every, fn_cache, skin, cell_cap, shards, policy=None,
                    checkpoint_dir=None, checkpoint_every=0, restore=False,
                    fault_hook=None, device='cuda', dtype=torch.float64):
    """The on-device loop: rebuilds inside each chunk, decided on the device.

    The host's role shrinks to (a) reading stacked (PE, KE) logging rows
    and (b) triaging the health-flag lattice — both once per chunk
    (= logging boundary), in one copy.  Positions, velocities, forces,
    topology and the rebuild decision never leave the device.

    With a RecoveryPolicy the flag triage becomes recovery instead of a
    raise: capacity overflows regrow the grid (one new chunk function per
    regrow) and roll back to the last good chunk; non-finite/escape/drift
    flags roll back and retry, halving dt after
    ``retries_before_dt_halve`` plain retries — all bounded, with typed
    errors past the budget.  A chunk's outputs are only *committed* to the
    carry after a clean health check, and a chunk never writes the carry
    it was given, so rollback is simply "keep the previous carry".
    """
    from .resilience import (ATOM_KEYS, HealthReport, RecoveryEvent,
                             RecoveryExhaustedError, load_md_checkpoint,
                             regrow_grid, save_md_checkpoint)
    writer = shards == 1 or dist.get_rank() == 0
    cache = fn_cache if fn_cache is not None else {}
    n_atoms = len(state.pos)
    events = cache.setdefault('recovery_events', [])
    rb = cfg.rcut + skin
    # max_nbors sizes the rcut sphere (host-path contract); scale the
    # padded width to the rcut+skin shell by the volume ratio
    k_build = int(np.ceil(max_nbors * (rb / cfg.rcut) ** 3 / 4.0)) * 4

    with span('md.seed'):
        carry = None
        e_ref = 0.0
        dt_cur = float(dt)
        if restore:
            if not checkpoint_dir:
                raise ValueError('restore=True requires checkpoint_dir')
            carry_np, box, grid, manifest = load_md_checkpoint(
                checkpoint_dir,
                rank_slice=atom_slices()[0] if shards > 1 else None)
            box = np.asarray(box, np.float64)
            carry = {k: _carry_tensor(v, device, dtype)
                     for k, v in carry_np.items()}
            if shards > 1:   # each rank read its rows; the group
                # replicates them
                carry.update({k: gather_atoms(carry[k])
                              for k in ATOM_KEYS})
            if carry['pos'].shape[0] != n_atoms:
                raise ValueError(
                    f"checkpoint holds {carry['pos'].shape[0]} atoms but "
                    f'state has {n_atoms}')
            state.step = int(manifest['step'])
            state.box = box
            e_ref = float(manifest['extra'].get('e_ref', 0.0))
            # dt is part of the continuation contract: a dt-halving before the
            # snapshot must survive the restart
            dt_cur = float(manifest['extra'].get('dt', dt))
            cache['device_grid'] = grid
        else:
            box = np.asarray(state.box, np.float64)
            nbins = tuple(int(max(1, np.floor(b / rb))) for b in box)
            grid = cache.get('device_grid')
            if grid is None:
                cap = cell_cap or auto_cell_cap(state.pos, box, rb)
                grid = cache['device_grid'] = make_grid(box, cfg.rcut, skin,
                                                        cap, k_build)
            elif (grid.nbins != nbins or grid.max_nbors < k_build
                  or grid.rcut != cfg.rcut or grid.skin != skin
                  or (cell_cap is not None and grid.cell_cap < cell_cap)):
                # the grid fingerprint covers what the run_nve fingerprint
                # cannot: box geometry and list capacities.  Capacities may
                # legitimately *exceed* the request — a previous run under
                # this cache may have regrown them — but never undershoot.
                raise ValueError(
                    'fn_cache device grid was built for a different '
                    'box/max_nbors/cell_cap; pass a fresh dict')
        box_t = torch.tensor(box, dtype=dtype, device=device)
        max_regrows = policy.max_regrows if policy is not None else 0
        regrows = 0

        if carry is None:
            pos = torch.tensor(np.asarray(state.pos), dtype=dtype,
                               device=device)
            vel = torch.tensor(np.asarray(state.vel), dtype=dtype,
                               device=device)
            while True:   # seed build, with bounded regrow under a policy
                nbr_idx, mask, shifts, fl = device_neighbors(pos, box_t, grid)
                report = HealthReport.from_flags(fl, grid)
                if not report.overflow:
                    break
                if policy is None:
                    check_flags(fl, grid)   # raises the legacy typed error
                if regrows >= max_regrows:
                    raise RecoveryExhaustedError(
                        'initial neighbor build still overflows after '
                        'regrowing', dict(step=state.step,
                                          issues=report.issues(),
                                          regrows=regrows))
                new_grid = regrow_grid(grid, report, policy)
                events.append(RecoveryEvent(
                    state.step, 'regrow',
                    dict(where='seed_build', issues=report.issues(),
                         cell_cap=(grid.cell_cap, new_grid.cell_cap),
                         max_nbors=(grid.max_nbors, new_grid.max_nbors))))
                grid = cache['device_grid'] = new_grid
                regrows += 1
            # seed the force carry once at step 0 (exact rcut cut, like every
            # step)
            e0, f = _seed_force(force_fn, cfg, pos, nbr_idx, shifts, mask)
            ke0 = 0.5 * (mass / ACC_CONV) * float(torch.sum(vel * vel))
            e_ref = float(e0) + ke0
            carry = dict(pos=pos, vel=vel, f=f, nbr_idx=nbr_idx,
                         shifts=shifts, mask=mask, pos_ref=pos,
                         flags=_full_flags(fl))

    chunks = cache.setdefault('device_chunks', {})
    counter = cache.setdefault('device_trace_count', {})
    thermo = []
    rebuilds = 0
    it = 0
    numeric_retries = 0
    steps_since_ckpt = 0
    chunk_len = max(1, min(log_every, n_steps))
    while it < n_steps:
        n_sub = min(chunk_len, n_steps - it)
        abs_step = state.step + it
        # chunk functions are keyed by every static they bake in: length,
        # grid capacities (regrows change tensor shapes), and dt
        # (resilience may halve it) — one function per key
        key = (n_sub, grid.cell_cap, grid.max_nbors, dt_cur)
        if key not in chunks:
            with span('md.build_chunk_fn'):
                chunks[key] = make_device_chunk_fn(
                    cfg, dt_cur, mass, grid, force_fn, n_sub,
                    trace_counter=counter, policy=policy)
        attempt = carry
        if fault_hook is not None:
            attempt = fault_hook(abs_step, carry, grid)
        with span('md.chunk'):
            (pos, vel, f, nbr_idx, shifts, mask, pos_ref, flags, rows,
             nreb) = chunks[key](attempt['pos'], attempt['vel'],
                                 attempt['f'], box_t, attempt['nbr_idx'],
                                 attempt['shifts'], attempt['mask'],
                                 attempt['pos_ref'], attempt['flags'], e_ref)
        with span('md.readback'):
            # host boundary, one copy: the (PE, KE) rows, the flag lattice
            # and the rebuild count (small integers, exact in float64)
            host = torch.cat([rows.reshape(-1).double(), flags.double(),
                              nreb.double().reshape(1)]).cpu().numpy()
        with span('md.triage'):
            pe, ke = host[0:2 * n_sub:2], host[1:2 * n_sub:2]
            flags_h = host[2 * n_sub:2 * n_sub + N_FLAGS].astype(np.int64)
            if policy is None:
                check_flags(flags_h, grid)
            else:
                report = HealthReport.from_flags(flags_h, grid)
                if report.overflow:
                    if regrows >= max_regrows:
                        raise RecoveryExhaustedError(
                            'capacity overflows persisted past the regrow '
                            'budget', dict(step=abs_step,
                                           issues=report.issues(),
                                           regrows=regrows))
                    new_grid = regrow_grid(grid, report, policy)
                    events.append(RecoveryEvent(
                        abs_step, 'regrow',
                        dict(issues=report.issues(),
                             cell_cap=(grid.cell_cap, new_grid.cell_cap),
                             max_nbors=(grid.max_nbors,
                                        new_grid.max_nbors))))
                    grid = cache['device_grid'] = new_grid
                    regrows += 1
                    # roll back to the last good chunk: rebuild the
                    # topology at the regrown capacities from the committed
                    # positions (the force carry is still valid — same
                    # positions)
                    ni, ms, sh, fl = device_neighbors(carry['pos'], box_t,
                                                      grid)
                    carry = dict(carry, nbr_idx=ni, mask=ms, shifts=sh,
                                 pos_ref=carry['pos'],
                                 flags=_full_flags(fl))
                    continue
                if report.numeric:
                    if numeric_retries >= policy.max_numeric_retries:
                        raise report.numeric_error(
                            dict(step=abs_step, issues=report.issues(),
                                 retries=numeric_retries, dt=dt_cur))
                    events.append(RecoveryEvent(
                        abs_step, 'rollback',
                        dict(issues=report.issues(),
                             retries=numeric_retries)))
                    if numeric_retries >= policy.retries_before_dt_halve:
                        dt_cur *= 0.5
                        events.append(RecoveryEvent(abs_step, 'dt_halve',
                                                    dict(dt=dt_cur)))
                    numeric_retries += 1
                    continue   # carry is still the last good chunk
            # clean chunk: commit to the carry and the thermo log
            carry = dict(pos=pos, vel=vel, f=f, nbr_idx=nbr_idx,
                         shifts=shifts, mask=mask, pos_ref=pos_ref,
                         flags=flags)
            numeric_retries = 0
            rebuilds += int(host[-1])
            count('md.rebuilds', int(host[-1]))
            _log_rows(thermo, pe, ke, it, state.step, n_atoms, n_steps,
                      log_every)
            it += n_sub
            steps_since_ckpt += n_sub
            if (checkpoint_dir and checkpoint_every
                    and steps_since_ckpt >= checkpoint_every):
                # the carry is replicated: rank 0 writes it for the group
                if writer:
                    path = save_md_checkpoint(
                        checkpoint_dir, state.step + it, carry, box, grid,
                        extra=dict(dt=dt_cur, e_ref=e_ref,
                                   n_atoms=n_atoms))
                    events.append(RecoveryEvent(state.step + it,
                                                'checkpoint',
                                                dict(path=str(path))))
                if shards > 1:
                    dist.barrier()
                steps_since_ckpt = 0
    cache['device_rebuilds'] = rebuilds
    with span('md.finish'):
        state.pos = carry['pos'].cpu().numpy()
        state.vel = carry['vel'].cpu().numpy()
    state.step += n_steps
    return state, thermo


def _run_nve_host(cfg, force_fn, state, n_steps, dt, mass, rebuild_every,
                  max_nbors, log_every, device, dtype):
    def force(disp, nbr_idx, mask):
        d = torch.as_tensor(disp, device=device, dtype=dtype)
        nbr = torch.as_tensor(nbr_idx, device=device, dtype=torch.long)
        e, fj = force_fn(d[..., 0], d[..., 1], d[..., 2], nbr,
                         torch.as_tensor(mask, device=device))
        return float(e), fj.cpu().numpy().astype(np.float64)

    thermo = []
    nbr = None
    f = None
    e = None
    for it in range(n_steps):
        if it % rebuild_every == 0 or nbr is None:
            nbr_idx, mask, disp, _ = brute_neighbors(
                state.pos, state.box, cfg.rcut, max_nbors)
            nbr = (nbr_idx, mask)
            if f is None:   # only step 0 lacks a force; rebuilds keep the
                # carried force (same positions, refreshed topology)
                e, f = force(disp, nbr_idx, mask)
        acc = f / mass * ACC_CONV
        state.vel = state.vel + 0.5 * dt * acc
        state.pos = state.pos + dt * state.vel
        nbr_idx, mask = nbr
        e, f = force(_recompute_disp(state.pos, state.box, nbr_idx),
                     nbr_idx, mask)
        acc = f / mass * ACC_CONV
        state.vel = state.vel + 0.5 * dt * acc
        state.step += 1
        if it % log_every == 0 or it == n_steps - 1:
            T, ke = temperature(state.vel, mass)
            thermo.append(dict(step=state.step, T=T, ke=ke, pe=e,
                               etot=e + ke))
    return state, thermo


def _recompute_disp(pos, box, nbr_idx):
    d = pos[nbr_idx] - pos[:, None, :]
    return d - box * np.round(d / box)
