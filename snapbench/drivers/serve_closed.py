"""The force service under a closed loop of clients on the wall clock.

Traffic parameters (``traffic/<name>.json``): ``clients``,
``cells_per_side`` (the clients' structures are cubes of these many bcc
cells, in turn; the seed deals them to the clients), ``perturb_A``, ``structures_per_client``,
``n_pads``, ``nbor_ladder``, ``batch``, ``queue_depth``, ``warmup_steps``,
``check_requests``, ``dtype``.

Each client holds one structure and sends it again, perturbed anew, as
soon as its previous result is back: zero think time.  Its perturbed
copies are drawn at set-up from (seed, client, copy), and request k sends
copy k mod ``structures_per_client``, so that making a request costs the
clients, which share this process with the server, nothing in the window.
Set-up builds the ``ForceServer`` and serves ``warmup_steps`` full
batches.  In the window the server steps as fast as
it can; a request's latency is its submit-to-result time on the host
clock.  Once the window closes the clients stop sending and the requests
in flight are served, and counted in the latency tail.

The check compares a sample of the served results, drawn from the seed by
a reservoir over the whole window, with the float64 reference, and counts
every request that failed or never came back.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import inputs
from ..harness import DTYPES, Outcome
from ..reference.md import count_pairs, forces_of
from ..reference.snap import Snap

DRAIN_S = 60.0


def run(ctx) -> Outcome:
    from repro_torch.launch.request_queue import (BucketTable, ForceRequest,
                                                  ServiceError)
    from repro_torch.launch.serve_forces import ForceServer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    sc = cfg['snap']
    tj, rcut = int(sc['twojmax']), float(sc['rcut'])
    dtype_name, fk = ctx.precision()
    beta = inputs.beta(inputs.ncoeff(tj), float(cfg['beta_scale']),
                       ctx.seed, ctx.device)
    a = float(cfg['lattice_a'])
    table = BucketTable(((tj, rcut),), tuple(tr['n_pads']),
                        tuple(tr['nbor_ladder']), int(tr['batch']))
    srv = ForceServer(table, impl='kernel', queue_depth=int(tr['queue_depth']),
                      dtype=DTYPES[dtype_name], device=ctx.device,
                      force_kwargs=fk)
    lattices = {c: inputs.bcc(c, a) for c in tr['cells_per_side']}
    nc, ring = int(tr['clients']), int(tr['structures_per_client'])
    # every seed serves the same mix of sizes, to other clients
    sizes = inputs.rng(ctx.seed, 3).permutation(
        np.resize(tr['cells_per_side'], nc))
    scale = float(tr['perturb_A'])
    copies = []
    for c in range(nc):
        base = lattices[int(sizes[c])][0]
        copies.append(base + inputs.rng(ctx.seed, 4, c).normal(
            scale=scale, size=(ring,) + base.shape))
    sent_count = [0] * nc

    def request(rid, c, pos):
        return ForceRequest(req_id=rid, pos=pos,
                            box=lattices[int(sizes[c])][1], beta=beta,
                            twojmax=tj, rcut=rcut, beta0=0.0)

    # set-up: the bucket's batched function, its lists and launch plans
    for w in range(int(tr['warmup_steps'])):
        for i in range(table.batch):
            c = (w * table.batch + i) % nc
            srv.submit(request(f'w{w}.{i}', c, copies[c][-1]))
        while srv.queue.depth:
            srv.step(now=time.perf_counter())

    keep = int(tr['check_requests'])
    pick = inputs.rng(ctx.seed, 6)
    sample, n_ok = [], 0
    flight = {}                      # req_id -> (client, request, t_submit)
    lat, failed, served_in_window = [], 0, 0
    steps_in_window, lane_sq, lane_atoms = 0, 0.0, 0.0
    served = np.zeros((nc, ring), np.int64)   # window's results a copy

    def submit(c):
        k = sent_count[c]
        sent_count[c] += 1
        req = request(f'c{c}.{k}', c, copies[c][k % ring])
        t = time.perf_counter()
        with ctx.span('submit'):
            srv.submit(req, now=t)
        flight[req.req_id] = (c, k, req, t)

    t0 = ctx.begin_window()
    for c in range(nc):
        submit(c)
    open_ = True
    t_close = None
    while flight:
        with ctx.span('step'):
            finished, _ = srv.step(now=time.perf_counter())
        t = time.perf_counter()
        if open_:
            steps_in_window += 1
        if not finished and srv.queue.depth == 0:
            print(f'{len(flight)} requests lost by the server',
                  file=sys.stderr)
            failed += len(flight)
            break
        for out in finished:
            rid = (out.req_id if not isinstance(out, ServiceError)
                   else out.diagnostics.get('req_id'))
            c, k, req, ts = flight.pop(rid)
            lat.append(t - ts)
            if isinstance(out, ServiceError):
                failed += 1
            else:
                n_ok += 1
                if len(sample) < keep:
                    sample.append((req, out))
                else:
                    j = int(pick.integers(n_ok))
                    if j < keep:
                        sample[j] = (req, out)
                if open_:
                    served_in_window += 1
                    lane_sq += req.natoms ** 2
                    lane_atoms += req.natoms
                    served[c, k % ring] += 1
            if open_:
                submit(c)
        if open_ and t - t0 >= ctx.seconds:
            open_ = False
            t_close = ctx.end_window()
        if t_close is not None and t - t_close > DRAIN_S:
            failed += len(flight)
            break
    attempted = sum(sent_count)
    metrics = dict(serve_rps=served_in_window / ctx.window_s,
                   serve_p95_ms=float(np.percentile(lat, 95)) * 1e3)
    counters = dict(device_steps=steps_in_window, served=served_in_window,
                    atoms_served=lane_atoms, lane_sq=lane_sq, twojmax=tj,
                    dtype=dtype_name)
    del srv
    if ctx.cuda:
        torch.cuda.empty_cache()
    dev = torch.device(ctx.device)
    if ctx.trace:
        counters['pairs_served'] = float(sum(
            int(served[c, r]) * count_pairs(torch.as_tensor(
                copies[c][r], device=dev), lattices[int(sizes[c])][1], rcut)
            for c in range(nc) for r in range(ring) if served[c, r]))

    ref = Snap(sc, beta, 0.0, dev)
    f_err = e_err = np.inf if not sample else 0.0
    for req, out in sample:
        pos = torch.as_tensor(req.pos, device=dev, dtype=torch.float64)
        e, f = forces_of(ref, pos, req.box)
        f = f.cpu().numpy()
        f_err = max(f_err, float(np.max(np.abs(out.forces - f))
                                 / np.max(np.abs(f))))
        e_err = max(e_err, abs(out.energy - float(e)) / req.natoms)
    readings = dict(failed_requests=float(failed),
                    force_err_rel=f_err, energy_err_eV_atom=e_err)
    return Outcome(attempted=attempted, failed=failed, metrics=metrics,
                   readings=readings, counters=counters)
