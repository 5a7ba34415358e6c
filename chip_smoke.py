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
planes, 10 on full planes, 4 with bfloat16 Y operands.  The cell-list
kernels (``csrc/cell_list.cu``: the neighbor build of the MD device loop)
are held against their plain version bitwise in float64 and float32 at
snap-2j8 (skin 0.4 A, 52-wide lists), against the host build's pair sets,
in an overflow case and in a gated call with trigger 0.  Then this slice's
main path, ``run_nve(loop='device', impl='kernel')`` (half planes, float64,
skin 0.4 A, max_nbors 40, 300 K), runs 20 steps in chunks of 10 with the
counters set to 0 before and read after, is timed again and profiled; one
chunk runs under CUDA sync debug mode; a run with a 0.01 A skin (rebuilds
firing) is held against ``loop='scan', rebuild_every=1``; 10 steps +
``save_md_checkpoint`` + restore + 10 steps against 20 straight; and a
``nan_force`` fault is rolled back.  The serving phase drives
``repro_torch.launch.serve_forces.ForceServer`` (snap-2j8's model class,
buckets n_pad 128 and 2048, lists 32 and 64 wide, batch 4, each lane its
own beta): the batched brute build against the host build's pair sets and
its CPU run's flags; the batched kernel entry (``make_batched_force_fn``)
against the same function on the plain stages and the plain assembly in
float64 and float32, and the assembly kernel against its plain version on
the batched path's own inputs (8192 atoms, lane-offset lists); the
Y kernel with a coefficient row a lane at 4 x 2048 against its plain
version (equal rows give the one-row bits); a solo 2000-atom request
against ``snap_force_pipeline`` and the float64 adjoint, and the float32
adjoint against the float64 one; a batch of a healthy, a NaN-poisoned, an
overflowing and a healthy request (typed failures, the peers bitwise equal
to solo evaluations), one launch of each of U, Y, fused dE and the
assembly a batched step, one build a bucket, no host synchronization in a
batched evaluation, no degradation on clean runs; quarantine after two
injected kernel faults; and a timed open-loop run of 40 requests (sizes
128 and 2000 from seed 0, exponential arrivals at 200 a second, 15 %
poisoned) with the launch counters set to 0 before and read after, the
same at 400 requests for the tail, 400 clean requests offered at 5000 a
second for the rate the service sustains, ms per batched step a bucket and
a profile of one n2048 batched evaluation (the brute build's device time
beside its bound).  The durability phase drives
``repro_torch.launch.chaos.run_chaos_soak`` on the card: the reference's
CI plan at 2J = 2 (8 requests, 25 % poisoned, kernel faults from the
first step, crashes at dispatches 2 and 4, a 6-request burst; each step
charged 0.25 s of virtual time so the burst sheds as behind the
reference's interpret-mode steps) with its checks; then the tail run's
schedule through the serving table (400 requests, crashes at dispatches
60 and 180 with torn journal tails, a snapshot every 8 steps) with the
launch counters set to 0 before and read after: the five invariants,
three incarnations, every completed result bitwise equal to a fresh
server's solo evaluation, one build a bucket an incarnation, no degraded
step, one launch of each of U, Y, fused dE and the assembly in every
batched step after a restore, and no host synchronization in a batched
evaluation of replayed requests.  It times ``submit`` without and with a
journal (fsync every 16 appends and every append, 128 and 2000 atoms),
the tail and capacity runs without and with a journal in turns, a
snapshot of a full result store (256 results), the soak's restores and a
drain of a 16-request backlog; journals and snapshots go to a temporary
directory.  The sharded phase spawns 2 ranks on the one card over a gloo
group (``repro_torch.launch.sharding.spawn_ranks``; NCCL takes one card a
rank) and drives ``kernels.ops.make_sharded_force_fn`` on the half kernel
path in float64 and float32 and on the float64 adjoint: the gathered
forces and energies against the unsharded evaluation on the card, two
sharded evaluations bitwise equal, one launch of each kernel of the path
per rank per evaluation, the assembly kernel's offset form (a rank's 1000
rows into 2000 output rows) against its plain version; then
``run_nve(loop='device', shards=2)`` for 20 steps against the single-rank
device-loop run with the launch counters set to 0 before and read after,
and a single-rank checkpoint at step 10 read back as rank slices and
continued on both ranks.  The baseline phase holds ``impl='baseline'`` (Z
and dB stored) at snap-2j8 in float64 and float32 and at 2J = 14 in
float32 against the float64 adjoint, twice bitwise, times it beside the
adjoint and the half kernel path (CUDA events, median of 5) with each
one's peak ``torch.cuda.max_memory_allocated``, and runs 4 device-loop
steps of it against the adjoint.  The fit phase is the fit example's
``repro_torch.examples.fit_snap.fit`` at snap-2j8 width (4 perturbed
2000-atom cells labelled by the float64 adjoint, 40-wide lists,
``repro_torch.fit.fit_snap_linear``, a held-out cell) with the time and
peak memory of ``descriptor_rows`` a cell.  The analysis phase runs the
static-analysis registry (``python -m repro_torch.analysis``'s entries)
on the card with the launch counters set to 0 before and read after:
each entry built twice and called twice, the second call under the op and
launch recorders and CUDA sync debug mode, held to the ``cuda`` section
of ``src/repro_torch/analysis/budgets.json``; its sharded entry runs in
the sharded phase's two ranks.  The examples phase runs
``repro_torch.examples.md_nve --natoms 2000 --twojmax 8 --loop device
--impl kernel``, ``quickstart`` and ``serve_forces --impl kernel`` on the
card with the launch counters set to 0 before and read after.  The lm
phase drives the language-model serving path (``repro_torch.models``,
``repro_torch.launch.serve``; no kernel of its own, ``allow_tf32`` off):
each of the ten ``reduced()`` archs in float32 on the card against the
same code on the CPU with the same weights (prefill logits and cache, two
greedy decode steps) and one decode step twice bitwise; nine archs at
full width in bfloat16 with float32 master weights (gemma3-1b,
granite-moe-1b-a400m, seamless-m4t-medium at full depth; falcon-mamba-7b
at 8 layers, zamba2-7b at 2 groups, gemma2-2b at 4 layers with P = W =
4096, llama-3.2-vision-90b at one group over 1600 patch tokens,
deepseek-7b and glm4-9b at 2 layers; arctic-480b does not fit the card
and runs reduced only): finite logits, a decode step twice bitwise, no
host sync in the decode steps (CUDA sync debug mode), prefill and decode
ms and tok/s of ``generate`` and peak memory; gemma3-1b teacher forcing
at full width in float32 (8 greedy steps against ``forward`` over the
extended sequence); and one profiled gemma3-1b decode step.  At
2J = 14 (float32) it holds the half and full kernels against their plain
versions and times the half-plane pipeline (median of 5 evaluations after
warm-up).

Bars: kernel vs plain, max |difference| / max |plain| <= 1e-10 in float64
and <= 1e-5 in float32, <= 1e-3 for the bfloat16 option; pipelines vs the
float64 adjoint (assembled with ``index_add_``, not the assembly kernel)
at the same bars, <= 1e-2 for bfloat16; the bfloat16 kernel at least twice
its bar away from the unrounded plain Y; relative NVE drift <= 1e-5; the
full-plane run's potential energy at step 10 within 1e-10 of the
half-plane run's; cell-list kernel vs plain bitwise; device-loop drift
<= 1e-5, one chunk function for both chunks, the small-skin run >= 2
rebuilds and its PE and Etot within 1e-9 relative of the scan loop's,
split-run and rolled-back thermo rows bitwise equal to the straight run's;
serving: the bars above by dtype, float32 (1e-5) for the solo request,
the float32 adjoint and quarantine, batch peers vs solo bitwise;
durability: completed results vs solo evaluations bitwise, on both impl
paths; sharded vs unsharded (the reference's bars): 1e-12 relative in
float64, 1e-5 in float32, device-loop T, PE and Etot 1e-9; baseline vs the
float64 adjoint 1e-10 in float64, 1e-5 in float32, its MD PE 1e-9; the
held-out fit relE < 1e-6 and max |dF| < 1e-4 eV/A; analysis: no
unallowlisted finding (the sharded entry's gloo collectives allowlisted
by name), no host sync, one launch of each kernel of an entry's path a
call, every ``cuda`` budget met; examples: md_nve's relative drift
<= 1e-5, quickstart's float32 kernel energy within 1e-5 of the adjoint's
and the baseline's within 1e-10, every serve_forces request an outcome,
the poisoned ones typed errors; lm: card vs CPU 1e-4 relative to the
largest value (the CPU tests' bar), decode steps bitwise on repeat,
teacher forcing |d| <= 2e-3 + 2e-3 |ref| (the reference's bar).
Times are medians of CUDA-event timings after
warm-up (``ms``: one call between two events, wrapper host time
included) and, for each kernel and library call, device time alone
(``device_ms``: K back-to-back calls queued behind a spin kernel, between
two events, divided by K).  The U, Y and fused dE kernels' launch plans
(``kernels/launch_plan.py``) are printed with the blocks an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); each must launch at
least 132 blocks and hold at least one block per SM at snap-2j8.  The
registers and stack frame of each kernel come from ``-Xptxas -v``; every
fused dE kernel must keep its stack frame under 1 KB (its level state lives
in shared memory), and all 24 Y kernel instances (six variants x four lane
counts) must be in the report.  The
last two lines are one JSON object per kernel
(``{"kernels": [...]}``) and the result line; any failed check exits
nonzero without the result line.  Without a card it exits nonzero and
prints no result.
"""

import collections
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / 'src'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# one operation and byte count for the bounds here and the static analysis
from repro_torch.analysis.cost import (bound, de_flops, u_flops,  # noqa: E402
                                       y_flops)
from repro_torch.analysis.op_passes import first_sync  # noqa: E402

NATOMS, NNBOR, RCUT = 2000, 26, 4.7
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
BF16_TOL, BF16_ADJ_TOL = 1e-3, 1e-2
MD_STEPS, MD_REBUILD, MD_DRIFT_TOL, MD_PE_TOL = 10, 10, 1e-5, 1e-10
BF16_MD_STEPS = 4
# the device loop (the reference benchmark's settings, b_md_grind.py:68):
# skin 0.4 A, max_nbors 40 at rcut (52-wide lists at rcut + skin)
SKIN, DEVICE_NBORS, DEVICE_STEPS, DEVICE_LOG = 0.4, 40, 20, 10
# a skin small enough that rebuilds fire in 10 steps at 300 K (the fastest
# atom moves ~0.0023 A a step: half the skin in ~2 steps)
SMALL_SKIN, SMALL_STEPS, THERMO_TOL = 0.01, 10, 1e-9
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
    # the reference's jnp neighbor build (_bin_atoms, device_neighbors)
    'cell_bin': (CSRC + 'cell_list.cu', 'src/repro/md/cell_list.py:133'),
    'cell_build': (CSRC + 'cell_list.cu', 'src/repro/md/cell_list.py:159'),
}
HALF = ('snap_u_half', 'snap_y_half', 'snap_fused_de_half')
FULL = ('snap_u_full', 'snap_y_full', 'snap_fused_de_full')
# the kernels each path launches once per force evaluation
PATHS = {
    'half': HALF + ('assemble_forces',),
    'full': FULL + ('assemble_forces',),
    'bf16': ('snap_u_half', 'snap_y_half_bf16', 'snap_fused_de_half',
             'assemble_forces'),
    # run_nve(loop='device'): one gated rebuild (two launches) a step
    'device': HALF + ('assemble_forces', 'cell_bin', 'cell_build'),
    # ForceServer: one launch of each a batched step, whatever the batch
    'serve': HALF + ('assemble_forces',),
}
CELL = ('cell_bin', 'cell_build')
# kernels with a launch plan: name -> 'u' (u_plan), 'y' (y_plan) or 'de'
# (de_plan)
PLANNED = {'snap_u_half': 'u', 'snap_u_full': 'u',
           'snap_y_half': 'y', 'snap_y_half_bf16': 'y', 'snap_y_full': 'y',
           'snap_fused_de_half': 'de', 'snap_fused_de_full': 'de'}
SOURCE_OF_PLAN = {'u': 'snap_u', 'y': 'snap_y', 'de': 'snap_fused_de'}
# the service: snap-2j8's model class, buckets n_pad 128 and 2048, lists 32
# and 64 wide, batch 4; each lane of a batch its own beta (seeds x 5e-3);
# overflow: the same lattice at a = 2.7 A (52-58 neighbors within 4.7 A)
SERVE_NPADS, SERVE_LADDER, SERVE_BATCH = (128, 2048), (32, 64), 4
SERVE_SEEDS, SERVE_DENSE_A = (1, 3, 5, 7), 2.7
# the open-loop run: requests, sizes, arrival rate (1/s), poisoned share
OPEN_N, OPEN_SIZES, OPEN_RATE, OPEN_BAD = 40, (128, 2000), 200.0, 0.15
# the tail at the same rate, ~340 latencies (p99 is not the largest one);
# capacity: the same number of clean requests offered above it
TAIL_N, SATURATE_RATE = 400, 5000.0
# the durability phase: the reference's CI soak (tests/test_durability.py,
# 2J=2), each step charged SOAK_STEP_S of virtual time; the full-width soak
# of the tail run's schedule, two crashes, a snapshot every 8 steps; submits
# timed a size and journal setting, and the fsync settings
SOAK_CI = dict(n_requests=8, seed=1, fraction_bad=0.25, kernel_fault_step=1,
               crash_dispatches=(2, 4), overload_burst_at=0.05,
               overload_burst_n=6, torn_tail=True)
SOAK_STEP_S = 0.25
SOAK_CRASHES, SOAK_SNAP_EVERY = (60, 180), 8
JOURNAL_N, JOURNAL_FSYNC = 200, (16, 1)
# the sharded phase: 2 ranks on one card over gloo; the pipelines each rank
# runs sharded (tag: impl, options, bar vs the unsharded evaluation: the
# reference's 1e-12 in float64, 1e-5 in float32); timed evaluations
SHARDS, SHARD_REPS = 2, 5
SHARD_PATHS = {
    'half f64': ('kernel', dict(dtype=torch.float64), 1e-12),
    'half f32': ('kernel', dict(dtype=torch.float32), 1e-5),
    'adjoint f64': ('adjoint', {}, 1e-12),
}
# the baseline phase: (2J, dtypes); timed evaluations (CUDA events); MD
# steps against the adjoint, and their bar
BASELINE_CASES, BASELINE_REPS = ((8, (torch.float64, torch.float32)),
                                 (14, (torch.float32,))), 5
BASELINE_MD_STEPS = 4
# every arch reduced, card vs CPU (float32): the CPU tests' bar on prefill
# logits and cache and on two greedy decode steps' logits
LM_TOL, LM_B, LM_P, LM_STEPS = 1e-4, 2, 16, 2
# full width (bf16 compute, f32 master weights): arch -> (depth overrides,
# B, P, G).  P + G >= W and W | P for the local layers (gemma3 W=512,
# gemma2 W=4096); llama's 5 layers are one group (4 self + 1 cross) over
# 1600 patch tokens; arctic-480b does not fit (one layer's experts alone
# are 53.5 GB in f32 and 26.8 GB more in bf16) and runs reduced only
LM_FULL = {
    'gemma3-1b': ({}, 4, 512, 16),
    'granite-moe-1b-a400m': ({}, 4, 512, 16),
    'falcon-mamba-7b': (dict(n_layers=8), 4, 512, 16),
    'zamba2-7b': (dict(n_layers=6), 4, 512, 16),
    'seamless-m4t-medium': ({}, 4, 512, 16),
    'gemma2-2b': (dict(n_layers=4), 1, 4096, 8),
    'llama-3.2-vision-90b': (dict(n_layers=5), 1, 512, 16),
    'deepseek-7b': (dict(n_layers=2), 4, 512, 16),
    'glm4-9b': (dict(n_layers=2), 4, 512, 16),
}
# teacher forcing at full width in float32 (the reference's own check,
# tests/test_arch_smoke.py): gemma3-1b, full depth, B, P, decode steps, bar
LM_TF = (2, 512, 8, 2e-3)
HBM_TBS = 3.35               # TB/s, H100 SXM data sheet
SMS = 132                    # H100 SXM
STACK_MAX = 1024             # bytes of stack frame a fused dE kernel may use
DEVICE_REPS = 20             # K of device_ms
SPIN_CYCLES = int(2e8)       # ~0.1 s of spin ahead of the K calls
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


def device_ms(fn, k=DEVICE_REPS, warmup=3):
    """Device time of one call (ms): ``k`` calls queued behind a spin
    kernel, so the device runs them back to back whatever the wrapper's
    host time, timed between two events and divided by ``k``.  Returns
    (ms, hidden): ``hidden`` is False if the host took longer to queue the
    calls than the spin lasted (then host time leaks in)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    spin0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(k):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / k, host_ms < spin0.elapsed_time(start)


def plan_of(name, cfg, dtype, n, nnbor):
    """The launch plan of kernel ``name`` and the blocks an SM holds."""
    import ctypes

    from repro_torch.kernels import _build, launch_plan
    kind, full = PLANNED[name], name.endswith('_full')
    if kind == 'y':
        plan = launch_plan.y_plan(cfg.twojmax, dtype,
                                  'full' if full else 'half', n)
        # the Y query's variant: 0 half, 1 full, 2 half with bf16 operands
        variant = 2 if name.endswith('_bf16') else int(full)
    else:
        plan = (launch_plan.u_plan if kind == 'u' else launch_plan.de_plan)(
            cfg.twojmax, dtype, n, nnbor)
        variant = int(full)
    source = SOURCE_OF_PLAN[kind]
    # the Y kernel is built for each lane count: the query names it
    lanes = (plan.lanes,) if kind == 'y' else ()
    blocks = ctypes.c_int(0)
    _build.query(source, f'{source}_blocks_per_sm',
                 (_build.I,) * (4 + len(lanes)) + (_build.P,),
                 int(dtype == torch.float64), variant, *lanes,
                 plan.lanes * plan.threads, plan.smem, ctypes.byref(blocks))
    return plan, blocks.value


def ptxas_phase(built):
    """Registers and stack frame of every kernel from ``-Xptxas -v``; the
    fused dE kernels must keep their stack frame under STACK_MAX."""
    from repro_torch.kernels import _build
    report = {}
    for lib, info in built.items():
        for mangled, r in _build.ptxas_report(info['log']).items():
            if 'registers' not in r:    # a device function, not a kernel
                continue
            report[mangled] = r
            print(f'     ptxas {lib}: {mangled}: {r.get("registers")} '
                  f'registers, {r.get("stack")} B stack frame, '
                  f'{r.get("spill_stores")} / {r.get("spill_loads")} B spill '
                  'stores / loads', flush=True)
    de = {k: v for k, v in report.items() if 'snap_fused_de_kernel' in k}
    check(len(de) == 4 and all(v.get('stack', STACK_MAX) < STACK_MAX
                               for v in de.values()),
          f'ptxas: {len(de)} fused dE kernels, stack frames '
          f'{sorted(v.get("stack") for v in de.values())} B (< {STACK_MAX} B '
          'each: the level state lives in shared memory)')
    from repro_torch.kernels.launch_plan import Y_LANES
    y = {k: v for k, v in report.items() if 'snap_y_kernel' in k}
    check(len(y) == 6 * len(Y_LANES),
          f'ptxas: {len(y)} Y kernels (half, half bf16, full x f32, f64 x '
          f'lanes {Y_LANES}), registers '
          f'{sorted(set(v["registers"] for v in y.values()))}, stack frames '
          f'{sorted(set(v.get("stack") for v in y.values()))} B, spill stores '
          f'{sorted(set(v.get("spill_stores") for v in y.values()))} B')
    cell = {k: v for k, v in report.items()
            if 'cell_bin_kernel' in k or 'cell_build_kernel' in k}
    check(len(cell) == 4,
          f'ptxas: {len(cell)} cell-list kernels (bin, build x f32, f64), '
          + ', '.join(f'{k}: {v["registers"]} registers, {v.get("stack")} B '
                      'stack' for k, v in sorted(cell.items())))
    return report


def rel_err(a, b):
    """(max |a - b|, max |a - b| / max |b|) over tuples of tensors."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    num = max(float((x - y).abs().max()) for x, y in zip(a, b))
    den = max(float(y.abs().max()) for y in b)
    return num, num / den


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
    from repro_torch.kernels.launch_plan import y_plan
    from repro_torch.kernels.snap_y import (snap_y_full, snap_y_full_plain,
                                            snap_y_half, snap_y_half_plain,
                                            y_coef, y_coef_half,
                                            y_launch_tables)
    d = [torch.as_tensor(disp[..., c], device=dev, dtype=dtype)
         for c in range(3)]
    layout, ok, _ = ops._kernel_layout(
        cfg, *d, torch.as_tensor(mask, device=dev), dtype)
    geo = dict(twojmax=cfg.twojmax, rcut=cfg.rcut, rmin0=cfg.rmin0,
               rfac0=cfg.rfac0, switch_flag=cfg.switch_flag)
    tj, idx, pairs = cfg.twojmax, cfg.index, NNBOR * NATOMS
    stages = {}   # layout: (U planes, coef, Y planes, Y kernel tables)
    for lay, u_plain, y_plain, coef_of in (
            ('half', snap_u_half_plain, snap_y_half_plain, y_coef_half),
            ('full', snap_u_full_plain, snap_y_full_plain, y_coef)):
        u_r, u_i = u_plain(layout, **geo)
        ut = ((u_r + ops._self_planes(cfg, dtype, dev, lay)).contiguous(),
              u_i.contiguous())
        coef = coef_of(beta, tj).to(dtype)
        plan = y_plan(tj, dtype, lay, layout.shape[2])
        stages[lay] = (ut, coef, y_plain(*ut, coef, twojmax=tj),
                       y_launch_tables(tj, lay, dev, plan.groups,
                                       plan.threads))
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
            y_flops(cf.numel(), NATOMS), TOL[dtype], None),
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
        dev_ms, hidden = device_ms(kern)
        lib_ms = time_ms(library) if library is not None else None
        lib_dev_ms = device_ms(library)[0] if library is not None else None
        b_ms, b_by = bound(nb, flops, dtype)
        lib = (f', index_add_ form {lib_ms:.4f} ms, device {lib_dev_ms:.4f}'
               ' ms' if lib_ms else '')
        print(f'     {name}: {ms:.4f} ms per call, {dev_ms:.4f} ms device'
              f'{"" if hidden else " (host time leaked in)"} (plain '
              f'{plain_ms:.4f} ms{lib}, bound {b_ms:.4f} ms by {b_by}; '
              f'{flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB; natoms_pad '
              f'{layout.shape[2]})', flush=True)
        out[name] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, device_ms=dev_ms,
                         device_ms_hidden=hidden,
                         library_device_ms=lib_dev_ms)
        if name in PLANNED:
            plan, per_sm = plan_of(name, cfg, dtype, layout.shape[2], NNBOR)
            print(f'     {name} plan: {plan.describe()}; {per_sm} resident '
                  'per SM', flush=True)
            out[name].update(plan=plan.describe(), blocks=plan.blocks,
                             blocks_per_sm=per_sm)
            if tj == 8:
                check(plan.blocks >= SMS and per_sm >= 1,
                      f'{name} {str(dtype)[6:]} 2J=8: {plan.blocks} blocks '
                      f'(>= {SMS}), {per_sm} resident per SM (>= 1)')
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


def assemble_index_add(dedr, nbr_idx, mask, natoms, group=None):
    """The reference's single-shard force scatter in its one-call library
    form (``index_add_``, float atomics on the card)."""
    assert group is None, 'the index_add_ stand-in is single-shard'
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
            err = first_sync(lambda: ops.snap_force_pipeline(*args, **kw))
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


def profile_summary(prof, wall_us, reps, label, unit, top):
    """Print the device operations, device time and busy share of a
    profiled window of ``reps`` units, and the ``top`` operations by device
    time; returns {name: (count, us)}, or None without device events."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f'     {label}: no device events recorded (device time not '
              'measured)', flush=True)
        return None
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
    print(f'     {label} (per {unit}): {len(events) / reps:.0f} device '
          f'operations, {total / reps / 1e3:.3f} ms device time, wall '
          f'{wall_us / reps / 1e3:.3f} ms, device busy {busy / wall_us:.3f} '
          'of the profiled wall clock', flush=True)
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f'       {us / reps / 1e3:8.4f} ms  x{n / reps:5.1f}  '
              f'{name[:90]}', flush=True)
    return per


def profile_phase(cfg, beta, nbr_idx, mask, disp, dev, layout, reps=5):
    """Where the device time of one float64 force evaluation on ``layout``
    planes goes (torch.profiler over ``reps`` evaluations)."""
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
    per = profile_summary(prof, wall_us, reps, f'profile {layout} f64',
                          'evaluation', 8)
    if per is None:
        return
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


def device_grid(pos, box, skin=SKIN):
    """The device loop's grid at snap-2j8: run_nve's own sizing (cell_cap
    from the initial lattice, max_nbors scaled to the rcut + skin shell)."""
    from repro_torch.md import cell_list as cl
    rb = RCUT + skin
    k_build = int(np.ceil(DEVICE_NBORS * (rb / RCUT) ** 3 / 4.0)) * 4
    return cl.make_grid(box, RCUT, skin, cl.auto_cell_cap(pos, box, rb),
                        k_build)


def neighbor_phase(pos, box, dev, dtype):
    """The cell-list kernels at snap-2j8 in ``dtype``: device_neighbors'
    kernels against the plain version (bitwise), pair sets against the
    host build at rcut + skin, an overflow case, a gated call with trigger
    0, and each kernel against its plain version on the same inputs, with
    times and bounds."""
    from repro_torch.kernels import neighbors as kn
    from repro_torch.md import cell_list as cl
    from repro_torch.md.neighbor import brute_neighbors
    dt = str(dtype)[6:]
    grid = device_grid(pos, box)
    pos_t = torch.as_tensor(pos, dtype=dtype, device=dev)
    box_t = torch.as_tensor(box, dtype=dtype, device=dev)
    got = cl.device_neighbors(pos_t, box_t, grid)
    ref = kn.neighbors_plain(pos_t, box_t, grid)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f'neighbors {dt}: kernel vs plain bitwise equal on nbr_idx, mask, '
          f'shifts and flags (flags {got[3].tolist()}, nbins {grid.nbins}, '
          f'cell_cap {grid.cell_cap}, K {grid.max_nbors})')
    if dtype == torch.float64:
        rb = grid.rcut_build
        b_idx, b_mask, _, _ = brute_neighbors(pos, box, rb, grid.max_nbors)
        ni, m = got[0].cpu().numpy(), got[1].cpu().numpy()
        same = all(set(ni[i, m[i]]) == set(b_idx[i, b_mask[i]])
                   for i in range(NATOMS))
        check(same, f'neighbors {dt}: each atom\'s pair set equals the host '
              f'brute_neighbors at rcut + skin = {rb} A '
              f'({int(m.sum(1).min())}..{int(m.sum(1).max())} pairs)')
    small = cl.make_grid(box, RCUT, SKIN, 8, 12)
    over_k = cl.device_neighbors(pos_t, box_t, small)
    over_p = kn.neighbors_plain(pos_t, box_t, small)
    torch.cuda.synchronize()
    fl = over_k[3].tolist()
    check(all(torch.equal(a, b) for a, b in zip(over_k, over_p))
          and fl[0] > small.max_nbors and fl[1] > small.cell_cap,
          f'neighbors {dt} overflow (cell_cap 8, K 12): flags {fl} equal to '
          f'the plain version\'s {over_p[3].tolist()}, lists equal')
    bufs = dict(nbr_idx=got[0].clone(), shifts=got[2].clone(),
                mask=got[1].clone(), pos_ref=pos_t.clone(),
                flags=torch.zeros(6, dtype=torch.int32, device=dev))
    before = {k: v.clone() for k, v in bufs.items()}
    moved = (pos_t + 0.3).contiguous()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    cl.rebuild_if(zero, moved, box_t, grid, **bufs)
    torch.cuda.synchronize()
    check(all(torch.equal(bufs[k], before[k]) for k in bufs),
          f'neighbors {dt}: rebuild_if with trigger 0 leaves nbr_idx, '
          'shifts, mask, pos_ref and flags bitwise untouched')
    cl.rebuild_if(one, moved, box_t, grid, **bufs)
    want = kn.neighbors_plain(moved, box_t, grid)
    torch.cuda.synchronize()
    check(torch.equal(bufs['nbr_idx'], want[0])
          and torch.equal(bufs['mask'], want[1])
          and torch.equal(bufs['shifts'], want[2])
          and torch.equal(bufs['pos_ref'], moved)
          and bufs['flags'][:2].tolist() == want[3].tolist(),
          f'neighbors {dt}: rebuild_if with trigger 1 writes the plain '
          'lists of the moved atoms, copies pos_ref and raises the counts')
    # each kernel against its plain version on the same inputs
    N, K = NATOMS, grid.max_nbors
    flags_k, flags_p = (torch.zeros(2, dtype=torch.int32, device=dev)
                        for _ in range(2))
    table_k = kn.cell_bin(pos_t, box_t, grid, one, flags_k)
    table_p = kn.cell_bin_plain(pos_t, box_t, grid, one, flags_p)

    def outs():
        return (torch.empty((N, K), dtype=torch.int32, device=dev),
                torch.empty((N, K), dtype=torch.bool, device=dev),
                torch.empty((N, K, 3), dtype=dtype, device=dev),
                torch.zeros(2, dtype=torch.int32, device=dev),
                torch.empty((N, 3), dtype=dtype, device=dev))
    out_k, out_p = outs(), outs()
    kn.cell_build(pos_t, box_t, grid, table_p, one, *out_k)
    kn.cell_build_plain(pos_t, box_t, grid, table_p, one, *out_p)
    torch.cuda.synchronize()
    esz = pos_t.element_size()
    # bytes: each input read once, each output written once; operations:
    # the bin arithmetic once an atom (4 a coordinate), the pair test once
    # a candidate of this lattice's cells (20: 3 sub, 3 div, 3 rint, 3 mul,
    # 3 add, 5 for r2, 1 compare)
    b = kn.atom_bins(torch.as_tensor(pos), torch.as_tensor(box), grid)
    occ = np.zeros(grid.nbins, int)
    np.add.at(occ, tuple(b.numpy().T), 1)      # atoms per cell
    cand = int(sum((occ * np.roll(occ, [-x for x in o], axis=(0, 1, 2))).sum()
                   for o in grid.stencil))
    cases = {
        'cell_bin': (
            lambda: kn.cell_bin(pos_t, box_t, grid, one, flags_k),
            lambda: kn.cell_bin_plain(pos_t, box_t, grid, one, flags_p),
            (table_k, flags_k), (table_p, flags_p),
            N * 3 * esz + 3 * esz + table_k.numel() * 4 + 8, 12 * N),
        'cell_build': (
            lambda: kn.cell_build(pos_t, box_t, grid, table_p, one, *out_k),
            lambda: kn.cell_build_plain(pos_t, box_t, grid, table_p, one,
                                        *out_p),
            out_k, out_p,
            2 * N * 3 * esz + 3 * esz + table_p.numel() * 4
            + N * K * (4 + 1 + 3 * esz) + 8, 20 * cand),
    }
    stats = {}
    for name, (kern, plain, got_t, ref_t, nb, flops) in cases.items():
        same = all(torch.equal(a, b) for a, b in zip(got_t, ref_t))
        abs_err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got_t, ref_t))
        check(same, f'{name} {dt}: kernel vs plain bitwise equal on the same '
              f'inputs (max abs err {abs_err:.3e})')
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
        dev_ms, hidden = device_ms(kern)
        b_ms, b_by = bound(nb, flops, dtype)
        print(f'     {name} {dt}: {ms:.4f} ms per call, {dev_ms:.4f} ms '
              f'device{"" if hidden else " (host time leaked in)"} (plain '
              f'{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by}; '
              f'{flops / 1e6:.2f} MFLOP, {nb / 1e6:.3f} MB, {cand} '
              'candidate pairs)', flush=True)
        stats[name] = dict(max_abs_err=abs_err, max_rel_err=0.0 if same
                           else float('inf'), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           device_ms=dev_ms, device_ms_hidden=hidden,
                           library_device_ms=None)
    return stats


def device_loop_phase(cfg, beta, pos, box, dev):
    """run_nve(loop='device', impl='kernel') at snap-2j8, half f64 (this
    slice's main path): 20 steps with the launch counters set to 0 before
    and read after, then timed again; one chunk under CUDA sync debug mode
    (no host synchronization); a small-skin run with rebuilds firing against
    loop='scan', rebuild_every=1; a split run through a checkpoint; a
    nan_force fault rolled back.  Returns (counts, thermo)."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.md.cell_list import device_neighbors
    from repro_torch.md.fault_inject import Fault, FaultInjector
    from repro_torch.md.integrate import (W_MASS, MDState, _full_flags,
                                          _seed_force, init_velocities,
                                          make_device_chunk_fn,
                                          make_force_fn, run_nve)
    from repro_torch.md.resilience import RecoveryPolicy
    vel = init_velocities(NATOMS, 300.0)
    f64 = torch.float64

    def state():
        return MDState(pos=pos.copy(), vel=vel.copy(), box=box)

    kw = dict(impl='kernel', loop='device', skin=SKIN,
              max_nbors=DEVICE_NBORS, log_every=DEVICE_LOG, device=dev,
              dtype=f64)
    cache = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, thermo = run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS,
                        fn_cache=cache, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for row in thermo:
        print(f'     device step {row["step"]:>3}  T {row["T"]:9.3f} K  PE '
              f'{row["pe"]:.10f}  Etot {row["etot"]:.10f} eV', flush=True)
    e0, e1 = thermo[0]['etot'], thermo[-1]['etot']
    drift = abs(e1 - e0) / max(abs(e0), 1.0)
    check(np.isfinite(drift) and drift <= MD_DRIFT_TOL,
          f'device loop: relative NVE drift {drift:.3e} over {DEVICE_STEPS} '
          f'steps (bar {MD_DRIFT_TOL:.0e})')
    traces = cache['device_trace_count']['traces']
    check(traces == 1, f'device loop: {traces} chunk function(s) built for '
          f'{DEVICE_STEPS // DEVICE_LOG} chunks (1 expected)')
    n_eval = DEVICE_STEPS + 1   # one per step plus the seed
    want = {k: (n_eval if k in PATHS['device'] else 0) for k in counts}
    check(counts == want, f'device loop: launches {counts} == {n_eval} for '
          'each kernel of the path (the cell kernels once a step, gated, '
          'plus the seed build), 0 for the others')
    t0 = time.perf_counter()
    run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS, fn_cache=cache, **kw)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    for tag, w in (('first run', wall), ('second run, chunk function '
                                         'cached', wall2)):
        ms_step = w * 1e3 / DEVICE_STEPS
        print(f'     device loop ({tag}): {ms_step:.3f} ms per step, '
              f'{ms_step * 1e3 / NATOMS:.4f} us per atom-step (wall clock '
              f'of {DEVICE_STEPS} steps incl. the seed build and force, '
              f'ends in a sync; {cache["device_rebuilds"]} rebuilds)',
              flush=True)
    device_loop_profile(cfg, beta, state, cache, kw)

    # one chunk, called directly, under CUDA sync debug mode: the main
    # grid (no rebuild fires) without guards, and a small-skin grid (the
    # rebuilds fire) with the health guards armed
    force_fn = make_force_fn(cfg, beta, 0.0, 'kernel', device=dev, dtype=f64)
    pos_t = torch.tensor(pos, dtype=f64, device=dev)
    vel_t = torch.tensor(vel, dtype=f64, device=dev)
    box_t = torch.tensor(box, dtype=f64, device=dev)
    for skin, policy in ((SKIN, None),
                         (SMALL_SKIN, RecoveryPolicy(drift_tol=1.0))):
        grid = device_grid(pos, box, skin)
        ni, ms, sh, fl = device_neighbors(pos_t, box_t, grid)
        _, f = _seed_force(force_fn, cfg, pos_t, ni, sh, ms)
        chunk = make_device_chunk_fn(cfg, 0.0005, W_MASS, grid, force_fn,
                                     DEVICE_LOG, policy=policy)
        args = (pos_t, vel_t, f, box_t, ni, sh, ms, pos_t, _full_flags(fl),
                0.0)
        out = chunk(*args)   # warm-up
        err = first_sync(lambda: chunk(*args))
        check(err is None, f'device loop: no host synchronization in a '
              f'{DEVICE_LOG}-step chunk (skin {skin}, guards '
              f'{"on" if policy else "off"}, {int(out[-1])} rebuilds in it; '
              f'{err or "none raised"})')

    # rebuilds firing: the device loop against host rebuilds every step
    runs = {}
    for name, extra in (('device', dict(skin=SMALL_SKIN)),
                        ('scan', dict(loop='scan', rebuild_every=1))):
        runs[name] = {}
        _, th = run_nve(cfg, beta, 0.0, state(), SMALL_STEPS,
                        fn_cache=runs[name], **dict(kw, log_every=2,
                                                    **extra))
        runs[name]['thermo'] = th
    a, b = (np.array([[t['pe'], t['etot']] for t in runs[n]['thermo']])
            for n in ('device', 'scan'))
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    nreb = runs['device']['device_rebuilds']
    check(nreb >= 2 and err <= THERMO_TOL,
          f'device loop, skin {SMALL_SKIN} A: {nreb} rebuilds in '
          f'{SMALL_STEPS} steps (>= 2), PE and Etot rows vs loop=\'scan\', '
          f'rebuild_every=1: max rel diff {err:.3e} (bar {THERMO_TOL:.0e})')

    # split run through a checkpoint, and a rolled-back fault, both against
    # the straight run with the guards armed
    pol = RecoveryPolicy()
    _, straight = run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS, policy=pol,
                          **kw)
    check(straight == thermo, 'device loop: the guarded run\'s thermo rows '
          'equal the unguarded run\'s (bitwise)')
    k = DEVICE_STEPS // 2
    with tempfile.TemporaryDirectory() as d:
        _, head = run_nve(cfg, beta, 0.0, state(), k, policy=pol,
                          checkpoint_dir=d, checkpoint_every=k, **kw)
        st, tail = run_nve(cfg, beta, 0.0, state(), k, policy=pol,
                           checkpoint_dir=d, restore=True, **kw)
    merged = {t['step']: t for t in head + tail}
    check(st.step == DEVICE_STEPS
          and all(merged.get(r['step']) == r for r in straight),
          f'device loop: {k} steps + save_md_checkpoint + restore + {k} '
          f'steps give the straight run\'s thermo rows bitwise '
          f'({len(straight)} rows)')
    inj = FaultInjector([Fault(step=k, kind='nan_force')])
    fcache = {}
    _, faulted = run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS, policy=pol,
                         fault_hook=inj, fn_cache=fcache, **kw)
    kinds = [e.kind for e in fcache['recovery_events']]
    check(bool(inj.fired) and 'rollback' in kinds and faulted == straight,
          f'device loop: a nan_force fault at step {k} is rolled back '
          f'({kinds}) and the run reproduces the clean run bitwise')
    return counts, thermo


def device_loop_profile(cfg, beta, state, cache, kw):
    """Device time and busy share of the device loop (torch.profiler over
    one more 20-step run with the chunk function cached)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.md.integrate import run_nve
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS, fn_cache=cache, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per = profile_summary(prof, wall_us, DEVICE_STEPS, 'device loop profile',
                          'step', 10) or {}
    for name, (n, us) in sorted(per.items()):
        if 'cell_b' in name:   # the gated neighbor build
            print(f'       {us / n:8.2f} us a launch, {n} launches: '
                  f'{name[:70]}', flush=True)


def serve_request(rid, natoms, seed, a=3.1652, poison=False, beta_seed=None):
    """A snap-2j8 request: ``natoms`` bcc W atoms at lattice constant
    ``a`` perturbed 0.02 A (``seed``), beta from ``beta_seed`` x 5e-3."""
    from repro_torch.core.snap import SnapConfig
    from repro_torch.launch.request_queue import ForceRequest
    from repro_torch.md.fault_inject import poison_request_positions
    from repro_torch.md.lattice import paper_box, perturb
    pos, box = paper_box(natoms, a=a)
    pos = perturb(pos, 0.02, seed=seed)
    if poison:
        pos = poison_request_positions(pos)
    rng = np.random.default_rng(seed if beta_seed is None else beta_seed)
    beta = rng.normal(size=SnapConfig(twojmax=8).ncoeff) * 5e-3
    return ForceRequest(rid, pos=pos, box=np.asarray(box, float), beta=beta,
                        twojmax=8, rcut=RCUT)


def default_serve_table():
    """The serving table: snap-2j8's model class, SERVE_NPADS x
    SERVE_LADDER, batch SERVE_BATCH."""
    from repro_torch.launch.request_queue import BucketTable
    return BucketTable(((8, RCUT),), SERVE_NPADS, SERVE_LADDER, SERVE_BATCH)


def serve_fn(bucket, dev, dtype=torch.float32):
    """The batched kernel entry of ``bucket``, as the server builds it."""
    from repro_torch.core.snap import SnapConfig
    from repro_torch.kernels import ops
    cfg = SnapConfig(twojmax=8, rcut=RCUT, dtype=dtype)
    return ops.make_batched_force_fn(cfg, bucket.n_pad, bucket.max_nbors,
                                     dtype=dtype, device=dev)


def serve_batches(table, dev):
    """{n_pad: (bucket, packed batch on the card)}: four requests a bucket
    (128 and 2000 atoms), each lane with its own lattice seed and beta."""
    from repro_torch.launch.serve_forces import pack_batch
    out = {}
    for n_pad, natoms in zip(SERVE_NPADS, OPEN_SIZES):
        reqs = [serve_request(f'n{natoms}-{s}', natoms, s)
                for s in SERVE_SEEDS]
        bucket = table.select(reqs[0])
        out[n_pad] = (bucket, pack_batch(bucket, reqs, dev))
    return out


def serve_neighbor_checks(batches):
    """First contact of the batched brute build on the card: pair sets
    against the host build, flags (and lists) against the CPU run."""
    from repro_torch.md import cell_list as cl
    from repro_torch.md.neighbor import brute_neighbors
    for n_pad, (bucket, a) in batches.items():
        args = (a['pos'], a['box'], RCUT, bucket.max_nbors, a['n_valid'])
        got = cl.brute_neighbors_batched(*args)
        cpu = cl.brute_neighbors_batched(
            *(t.cpu() if isinstance(t, torch.Tensor) else t for t in args))
        got = [t.cpu() for t in got]
        same = all(torch.equal(g, c) for g, c in zip(got, cpu))
        ni, m = got[0].numpy(), got[1].numpy()
        pairs = True
        for b in range(SERVE_BATCH):
            n = int(a['n_valid'][b])
            h_idx, h_mask, _, _ = brute_neighbors(
                a['pos'][b, :n].cpu().numpy(), a['box'][b].cpu().numpy(),
                RCUT, bucket.max_nbors)
            pairs &= all(set(ni[b, i, m[b, i]]) == set(h_idx[i, h_mask[i]])
                         for i in range(n))
        check(pairs and torch.equal(got[3], cpu[3]),
              f'serve brute build n{n_pad} on the card: pair sets equal to '
              f'the host brute_neighbors in all {SERVE_BATCH} lanes, flags '
              f'{got[3].tolist()} equal to the CPU run\'s (lists bitwise '
              f'equal to the CPU run: {same})')


def serve_kernel_checks(batches, dev):
    """The batched kernel entry against the same batched function built
    from the plain stages and the plain assembly (f64 and f32, both
    buckets); the assembly kernel against its plain version on the dE/dr,
    lane-offset lists and sentinels the batched path gave it; the per-lane
    Y kernel against its plain version at 4 x 2048 with times and bound;
    one row a lane equal to one row (bitwise)."""
    from repro_torch.core import snap as core_snap
    from repro_torch.core.snap import SnapConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.assemble import assemble_forces_csr_plain
    from repro_torch.kernels.snap_y import (snap_y_half, snap_y_half_plain,
                                            y_coef_half, y_launch_tables)
    from repro_torch.kernels.launch_plan import y_plan
    from repro_torch.kernels.snap_u import snap_u_half_plain
    for n_pad, (bucket, a) in batches.items():
        for dtype in (torch.float64, torch.float32):
            fn = serve_fn(bucket, dev, dtype)
            seen = []

            def record(*args):
                seen.append(args)
                return core_snap.assemble_forces(*args)
            with mock.patch.object(ops, 'assemble_forces', record):
                e_k, f_k, fl_k = fn(**a)
            ops.reset_launch_counts()
            with mock.patch.object(ops, '_STAGES', ops._PLAIN_STAGES), \
                    mock.patch.object(core_snap, 'assemble_forces_csr',
                                      assemble_forces_csr_plain):
                e_p, f_p, fl_p = fn(**a)
            plain_launches = sum(ops.launch_counts().values())
            _, err_f = rel_err(f_k, f_p)
            _, err_e = rel_err(e_k, e_p)
            bar = TOL[dtype]
            check(err_f <= bar and err_e <= bar and torch.equal(fl_k, fl_p)
                  and plain_launches == 0,
                  f'serve batched kernel entry n{n_pad} {str(dtype)[6:]} vs '
                  f'the same function on the plain stages and assembly '
                  f'({plain_launches} kernel launches): forces {err_f:.3e}'
                  f', energies {err_e:.3e} (bar {bar:.0e}), flags equal; '
                  f'E {[round(float(x), 6) for x in e_k]} eV')
            # the assembly alone on the inputs the batched path gave it
            dedr, nbr, ok, natoms = seen[0]
            got = core_snap.assemble_forces(*seen[0])
            with mock.patch.object(core_snap, 'assemble_forces_csr',
                                   assemble_forces_csr_plain):
                ref = core_snap.assemble_forces(*seen[0])
            _, err_a = rel_err(got, ref)
            lanes_ok = bool(((nbr // (natoms // SERVE_BATCH))
                             == (torch.arange(natoms, device=dev)
                                 // (natoms // SERVE_BATCH))[:, None])
                            [ok].all())
            check(len(seen) == 1 and err_a <= bar and lanes_ok,
                  f'serve assembly kernel n{n_pad} {str(dtype)[6:]} on the '
                  f'batched path\'s inputs (dE/dr {list(dedr.shape)}, '
                  f'{natoms} atoms, {int(ok.sum())} live slots, each in its '
                  f'own lane: {lanes_ok}) vs its plain version: {err_a:.3e} '
                  f'(bar {bar:.0e})')
    # Y with a coefficient row a lane at the n2048 batch's width, on
    # snap-2j8 U planes (one 2000-atom configuration in each lane)
    cfg, beta, _, _, _, mask, disp = setup(8, dev)
    out = {}
    for dtype in (torch.float64, torch.float32):
        d = [torch.as_tensor(disp[..., c], device=dev, dtype=dtype)
             for c in range(3)]
        planes, _, _ = ops._kernel_layout(
            cfg, *d, torch.as_tensor(mask, device=dev), dtype)
        u_r, u_i = snap_u_half_plain(planes, twojmax=8, rcut=RCUT)
        u_r = u_r + ops._self_planes(cfg, dtype, dev, 'half')
        lane_atoms = planes.shape[2]
        ut = tuple(torch.cat([t] * SERVE_BATCH, dim=1).contiguous()
                   for t in (u_r, u_i))
        betas = torch.stack([beta * (1 + 0.1 * k)
                             for k in range(SERVE_BATCH)])
        rows = y_coef_half(betas, 8).to(dtype)
        kw = dict(twojmax=8, lane_atoms=lane_atoms)
        got = snap_y_half(*ut, rows, **kw)
        ref = snap_y_half_plain(*ut, rows, **kw)
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, ref)
        one = snap_y_half(*ut, rows[0], twojmax=8)
        same = snap_y_half(*ut, rows[0].expand(SERVE_BATCH, -1).contiguous(),
                           **kw)
        bitwise = all(torch.equal(x, y) for x, y in zip(one, same))
        check(err <= TOL[dtype] and bitwise,
              f'snap_y_half {str(dtype)[6:]}, a coefficient row a lane '
              f'({SERVE_BATCH} x {lane_atoms} atoms): max rel err vs plain '
              f'{err:.3e} (bar {TOL[dtype]:.0e}); equal rows a lane give the '
              f'one-row bits: {bitwise}')
        n = SERVE_BATCH * lane_atoms
        plan = y_plan(8, dtype, 'half', n)
        tables = y_launch_tables(8, 'half', dev, plan.groups, plan.threads)
        ms = time_ms(lambda: snap_y_half(*ut, rows, **kw))
        plain_ms = time_ms(lambda: snap_y_half_plain(*ut, rows, **kw),
                           reps=5)
        dev_ms, hidden = device_ms(lambda: snap_y_half(*ut, rows, **kw))
        b_ms, b_by = bound(2 * nbytes(*ut) + nbytes(rows, *tables),
                           y_flops(rows.shape[1], n), dtype)
        print(f'     snap_y_half {str(dtype)[6:]} rows a lane: {ms:.4f} ms '
              f'per call, {dev_ms:.4f} ms device'
              f'{"" if hidden else " (host time leaked in)"} (plain '
              f'{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; width '
              f'{n}; plan {plan.describe()})', flush=True)
        out[dtype] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                          plain_ms=plain_ms, device_ms=dev_ms,
                          device_ms_hidden=hidden, bound_ms=b_ms,
                          bound_by=b_by, width=n)
    return out


def serve_service_checks(table, dev):
    """The service on the card (f32, the server's default): a solo
    request against snap_force_pipeline and the f64 adjoint; the f32
    adjoint against the f64 one; a batch of a healthy, a NaN-poisoned, an
    overflowing and a second healthy request, the peers bitwise against
    solo evaluations; launches and builds a step; no host sync in a
    batched evaluation; the clean-run conditions; quarantine."""
    from dataclasses import replace

    from repro_torch.core.snap import SnapConfig, energy_forces_adjoint
    from repro_torch.kernels import ops
    from repro_torch.launch.request_queue import RequestFailedError
    from repro_torch.launch.serve_forces import (ForceResult, ForceServer,
                                                 pack_batch)
    from repro_torch.md import cell_list as cl
    from repro_torch.md.fault_inject import ServeFault, ServeFaultInjector
    f32, f64 = torch.float32, torch.float64
    srv = ForceServer(table, device=dev)

    # a solo 2000-atom request against the one-configuration pipeline on
    # the same lists, and against the f64 adjoint; the f32 adjoint (the
    # quarantine path of an f32 server) against the f64 one
    req = serve_request('solo', NATOMS, 21)
    res = srv.evaluate(req)
    pos = torch.as_tensor(req.pos, device=dev)
    box = torch.as_tensor(req.box, device=dev)
    ni, m, d, _ = cl.brute_neighbors_device(pos, box, RCUT,
                                            SERVE_LADDER[0])
    lists = (d[..., 0], d[..., 1], d[..., 2], ni, m)
    cfg = SnapConfig(twojmax=8, rcut=RCUT)
    beta = torch.as_tensor(req.beta, device=dev)
    e_p, _, f_p = ops.snap_force_pipeline(cfg, beta, 0.0, *lists,
                                          dtype=f32, device=dev)
    e_64, _, f_64 = energy_forces_adjoint(cfg, beta, 0.0, *lists,
                                          device=dev)
    e_32, _, f_32 = energy_forces_adjoint(replace(cfg, dtype=f32), beta,
                                          0.0, *lists, device=dev)
    ok = isinstance(res, ForceResult) and res.impl == 'kernel'
    check(ok, f'serve: solo {NATOMS}-atom request served on the kernel '
          f'path ({res!r:.120})')
    if ok:
        got = (res.energy, torch.as_tensor(res.forces, device=dev))
        for what, (e_g, f_g), (e_r, f_r) in (
                ('solo request vs snap_force_pipeline f32', got, (e_p, f_p)),
                ('solo request vs the f64 adjoint', got, (e_64, f_64)),
                ('the f32 adjoint (allow_tf32 '
                 f'{torch.backends.cuda.matmul.allow_tf32}) vs the f64 '
                 'adjoint', (float(e_32), f_32), (e_64, f_64))):
            _, err_f = rel_err(f_g.double(), f_r.double())
            err_e = abs(e_g - float(e_r)) / abs(float(e_r))
            check(err_f <= TOL[f32] and err_e <= TOL[f32],
                  f'serve: {what}, {NATOMS} atoms: forces {err_f:.3e}, '
                  f'energy {err_e:.3e} (bar {TOL[f32]:.0e})')

    # one batch: healthy, NaN-poisoned, overflowing, healthy (n2048)
    reqs = [serve_request('h1', NATOMS, 31),
            serve_request('nan', NATOMS, 32, poison=True),
            serve_request('ovf', NATOMS, 33, a=SERVE_DENSE_A),
            serve_request('h2', NATOMS, 34)]
    for r in reqs:
        srv.submit(r, now=1.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    done, _ = srv.step(1.0)
    counts = ops.launch_counts()
    want = {k: int(k in PATHS['serve']) for k in counts}
    check(counts == want, f'serve: one batched step of {len(reqs)} requests '
          f'launched {counts} (1 of each kernel of the path, 0 others)')
    err_nan, err_ovf = srv.result('nan'), srv.result('ovf')
    check(len(done) == 4 and isinstance(err_nan, RequestFailedError)
          and 'nan_state' in err_nan.diagnostics['issues'],
          f'serve: the NaN-poisoned request fails typed: {err_nan!r:.160}')
    check(isinstance(err_ovf, RequestFailedError)
          and err_ovf.diagnostics.get('observed', 0) > SERVE_LADDER[0]
          and err_ovf.diagnostics.get('suggested_max_nbors', 0)
          > err_ovf.diagnostics.get('observed', 0),
          f'serve: the overflowing request fails typed: {err_ovf!r:.200}')
    for r in (reqs[0], reqs[3]):
        batched = srv.result(r.req_id)
        ops.reset_launch_counts()
        solo = srv.evaluate(replace(r, req_id=r.req_id + '-solo'), now=2.0)
        counts = ops.launch_counts()
        check(isinstance(batched, ForceResult) and isinstance(solo,
                                                              ForceResult)
              and np.array_equal(batched.forces, solo.forces)
              and batched.energy == solo.energy,
              f'serve: peer {r.req_id} of the faulty batch: forces and '
              f'energy bitwise equal to its solo evaluation through the same'
              f' bucket (E {getattr(batched, "energy", None)} eV)')
        check(counts == want, f'serve: the solo step of {r.req_id} launched '
              f'{counts} (1 of each kernel of the path, 0 others)')
    bucket = table.select(reqs[0])
    arrays = pack_batch(bucket, [reqs[0], reqs[3]], dev)
    fn = serve_fn(bucket, dev)
    fn(**arrays)
    err = first_sync(lambda: fn(**arrays))
    check(err is None, f'serve: no host synchronization in a batched '
          f'evaluation ({err or "none raised"})')
    h = srv.health()
    results = [srv.result(rid) for rid in
               ('solo', 'h1', 'h2', 'h1-solo', 'h2-solo')]
    check(h.degraded_steps == 0 and h.kernel_faults == {}
          and all(r.impl == 'kernel' for r in results)
          and h.compile_counts == {f'{bucket.key}/kernel': 1},
          f'serve: clean run: degraded_steps {h.degraded_steps}, '
          f'kernel_faults {h.kernel_faults}, impls '
          f'{sorted({r.impl for r in results})}, builds {h.compile_counts}')

    # quarantine (n128): a persistent kernel fault, two strikes
    inj = ServeFaultInjector([ServeFault(step=1, kind='kernel_fault',
                                         persistent=True)])
    q = ForceServer(table, device=dev, quarantine_after=2, fault_hook=inj)
    worst, impls = 0.0, []
    for i in range(3):
        r = serve_request(f'q{i}', OPEN_SIZES[0], 40 + i)
        q.submit(r, now=float(i))
        q.step(float(i))
        res = q.result(r.req_id)
        ref = srv.evaluate(replace(r, req_id=r.req_id + '-kernel'),
                           now=3.0 + i)
        impls.append(getattr(res, 'impl', repr(res)))
        if isinstance(res, ForceResult):
            worst = max(worst, rel_err(torch.as_tensor(res.forces),
                                       torch.as_tensor(ref.forces))[1])
    qh = q.health()
    key = table.select(r).key
    check(impls == ['jnp'] * 3 and qh.quarantined == (key,)
          and qh.kernel_faults == {key: 2} and worst <= TOL[f32],
          f'serve: quarantine on the card: impls {impls}, quarantined '
          f'{qh.quarantined}, strikes {qh.kernel_faults}, degraded steps '
          f'{qh.degraded_steps}; f32 adjoint forces vs the kernel path\'s: '
          f'max rel err {worst:.3e} (bar {TOL[f32]:.0e})')
    return srv


def open_loop_schedule(n, rate, bad, tag):
    """``n`` requests ``tag``0 .. ``tag``(n-1), sizes drawn from seed 0,
    exponential arrivals at ``rate`` a second, a ``bad`` share poisoned
    by ``RequestFaultPlan``: (schedule, the plan's {index: kind})."""
    from repro_torch.md.fault_inject import RequestFaultPlan
    rng = np.random.default_rng(0)
    sizes = rng.choice(OPEN_SIZES, size=n)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    plan = RequestFaultPlan(fraction=bad, seed=0).assign(n)
    schedule = []
    for i in range(n):
        kind = plan.get(i)
        schedule.append((float(arrivals[i]), serve_request(
            f'{tag}{i}', int(sizes[i]), 100 + i, poison=kind == 'nan_pos',
            a=SERVE_DENSE_A if kind == 'overflow' else 3.1652)))
    return schedule, plan


def open_loop(table, dev, n, rate, bad, tag, journal=None):
    """A fresh f32 server (queue at least as deep as the run; ``journal``
    a path or None) driven by :func:`open_loop_schedule`; the launch
    counters set to 0 before and read after.  Fails unless every request
    ends typed as planned with no degradation.  Returns (health, launch
    counts, server)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_forces import (ForceResult, ForceServer,
                                                 run_open_loop)
    schedule, plan = open_loop_schedule(n, rate, bad, tag)
    ol = ForceServer(table, device=dev, queue_depth=max(n, 64),
                     journal=journal)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    h = run_open_loop(ol, schedule)
    counts = ops.launch_counts()
    steps = h.device_steps
    served = [r for r in (ol.result(f'{tag}{i}') for i in range(n))
              if isinstance(r, ForceResult)]
    want = {k: (steps if k in PATHS['serve'] else 0) for k in counts}
    check(counts == want and h.served == n - len(plan)
          and h.failed == len(plan) and h.shed_count == 0
          and h.degraded_steps == 0 and h.kernel_faults == {}
          and all(r.impl == 'kernel' for r in served)
          and h.compile_counts == {f'{table.select(r).key}/kernel': 1
                                   for _, r in schedule},
          f'serve open loop{" (journal)" if journal else ""}: {n} '
          f'requests offered at {rate:g}/s, '
          f'{len(plan)} poisoned: served {h.served}, failed {h.failed}, '
          f'{steps} batched steps, launches {counts}, degraded '
          f'{h.degraded_steps}, builds {h.compile_counts}')
    print(f'     serve open loop{" with a journal" if journal else ""} '
          f'({n} requests offered at {rate:g}/s): '
          f'p50 {h.p50_ms:.3f} ms, p99 {h.p99_ms:.3f} ms over {h.served} '
          f'latencies, {h.throughput_rps:.1f} req/s served over the run '
          f'({steps} steps, {h.served / steps:.2f} served a step)',
          flush=True)
    return h, counts, ol


def serve_timing(srv, table, batches, dev):
    """The open-loop run (the serving main path: launch counters set to 0
    before, read after); a ten times longer run at the same rate for the
    tail; a run offered above capacity for the rate the service sustains;
    ms per batched step a bucket; and a profile of one n2048 batched step.
    Returns (launch counts of the main path's run, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.md import cell_list as cl
    # every shared cache (libraries, tables, plans) is warm: srv served
    # both sizes; a fresh server times each run
    srv.evaluate(serve_request('warm', OPEN_SIZES[0], 99))
    h, counts, _ = open_loop(table, dev, OPEN_N, OPEN_RATE, OPEN_BAD, 'o')
    out = dict(p50_ms=h.p50_ms, p99_ms=h.p99_ms, rps=h.throughput_rps,
               steps=h.device_steps)
    h, _, _ = open_loop(table, dev, TAIL_N, OPEN_RATE, OPEN_BAD, 't')
    out.update(tail_n=TAIL_N, tail_latencies=h.served, tail_p50_ms=h.p50_ms,
               tail_p99_ms=h.p99_ms, tail_rps=h.throughput_rps,
               tail_steps=h.device_steps)
    h, _, _ = open_loop(table, dev, TAIL_N, SATURATE_RATE, 0.0, 's')
    out.update(capacity_rps=h.throughput_rps, capacity_steps=h.device_steps,
               capacity_per_step=h.served / h.device_steps)

    # ms per batched step a bucket: a full batch submitted, one step timed
    # on the host clock (it ends in the one readback), median of 5
    for n_pad, natoms in zip(SERVE_NPADS, OPEN_SIZES):
        times = []
        for rep in range(5):
            for s in SERVE_SEEDS:
                srv.submit(serve_request(f't{n_pad}-{rep}-{s}', natoms, s),
                           now=10.0 + rep)
            t0 = time.perf_counter()
            done, _ = srv.step(10.0 + rep)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f'step_ms_n{n_pad}'] = statistics.median(times)
        print(f'     serve step n{n_pad} (batch of {SERVE_BATCH} x {natoms} '
              f'atoms, f32): {out[f"step_ms_n{n_pad}"]:.3f} ms (median of 5,'
              f' host clock, incl. packing and the readback)', flush=True)

    # one n2048 batched evaluation: device time, the brute build's share
    bucket, a = batches[SERVE_NPADS[1]]
    fn = serve_fn(bucket, dev)
    fn(**a)
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(**a)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per = profile_summary(prof, wall_us, reps,
                          f'serve profile n{bucket.n_pad} f32',
                          'batched evaluation', 12) or {}
    stage = {k: sum(us for name, (_, us) in per.items() if k in name) / reps
             / 1e3 for k in ('snap_u', 'snap_y', 'snap_fused_de',
                             'assemble_forces')}
    build_args = (a['pos'], a['box'], RCUT, bucket.max_nbors, a['n_valid'])
    build_ms, hidden_b = device_ms(
        lambda: cl.brute_neighbors_batched(*build_args), k=5)
    eval_ms, hidden_e = device_ms(lambda: fn(**a), k=5)
    # the build's bound: positions, boxes and counts read once, lists,
    # masks, displacements and flags written once; 20 operations a pair
    # of the B x n_pad^2 it tests (3 sub, 3 div, 3 round, 3 mul, 3 sub, 5
    # for r2, 1 compare), f64
    lists = cl.brute_neighbors_batched(*build_args)
    pairs = a['pos'].shape[0] * a['pos'].shape[1] ** 2
    build_bound, build_by = bound(
        nbytes(a['pos'], a['box'], a['n_valid'], *lists), 20 * pairs,
        a['pos'].dtype)
    out.update(build_device_ms=build_ms, eval_device_ms=eval_ms,
               build_share=build_ms / eval_ms, build_bound_ms=build_bound,
               build_bound_by=build_by,
               **{f'{k}_device_ms': v for k, v in stage.items()})
    print(f'     serve n{bucket.n_pad}: brute build {build_ms:.4f} ms device '
          f'(bound {build_bound:.4f} ms by {build_by}: {pairs} pairs, '
          f'{nbytes(a["pos"], a["box"], a["n_valid"], *lists) / 1e6:.3f} '
          f'MB), batched evaluation {eval_ms:.4f} ms device (build share '
          f'{build_ms / eval_ms:.3f}; host hidden {hidden_b}/{hidden_e}); '
          'kernels in the profile: ' + ', '.join(
              f'{k} {v:.4f} ms' for k, v in stage.items()), flush=True)
    return counts, out


def serve_phase(dev):
    """The batched force service at snap-2j8 (see the module docstring)."""
    t0 = time.perf_counter()
    table = default_serve_table()
    batches = serve_batches(table, dev)
    serve_neighbor_checks(batches)
    y_lanes = serve_kernel_checks(batches, dev)
    srv = serve_service_checks(table, dev)
    counts, numbers = serve_timing(srv, table, batches, dev)
    print(f'     serve phase: {time.perf_counter() - t0:.1f} s wall',
          flush=True)
    return counts, numbers, y_lanes


def step_cost_timer():
    """A clock that advances SOAK_STEP_S a reading: each soak step lasts
    that long, so every arrival and the burst of the CI plan land before
    its first step ends and the bounded queue sheds, as behind the
    reference's interpret-mode steps (the card's take milliseconds)."""
    ticks = itertools.count()
    return lambda: next(ticks) * SOAK_STEP_S


def adjoint_bits(dev):
    """The adjoint path (the quarantine path, ``impl='jnp'``) twice on the
    same inputs: snap-2j8 in f64 and f32, and the serving table's batched
    adjoint on an n128 batch; equal bits each time."""
    from dataclasses import replace

    from repro_torch.core.snap import SnapConfig, energy_forces_adjoint
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_forces import pack_batch
    cfg, beta, _, _, nbr_idx, mask, disp = setup(8, dev)
    args = device_inputs(disp, nbr_idx, mask, dev)
    cases = {f'snap-2j8 {str(dt)[6:]}': (
        lambda dt=dt: energy_forces_adjoint(replace(cfg, dtype=dt), beta,
                                            0.0, *args, device=dev))
        for dt in (torch.float64, torch.float32)}
    table = default_serve_table()
    reqs = [serve_request(f'adj{s}', OPEN_SIZES[0], s) for s in SERVE_SEEDS]
    bucket = table.select(reqs[0])
    arrays = pack_batch(bucket, reqs, dev)
    fn = ops.make_batched_force_fn(
        SnapConfig(twojmax=bucket.twojmax, rcut=bucket.rcut,
                   dtype=torch.float32), bucket.n_pad, bucket.max_nbors,
        impl='adjoint', device=dev)
    cases[f'batched {bucket.key}'] = lambda: fn(**arrays)
    for what, run in cases.items():
        a, b = run(), run()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        check(same, f'durability: the adjoint path twice on the same inputs'
              f' ({what}): bitwise equal (max abs diff {diff:.3e})')


def soak_ci(dev, workdir):
    """The reference's CI soak (tests/test_durability.py's plan, 2J=2,
    its default table) on the card, with its checks."""
    from repro_torch.launch.chaos import run_chaos_soak
    from repro_torch.launch.journal import read_events
    from repro_torch.md.fault_inject import ChaosPlan
    rep = run_chaos_soak(ChaosPlan(**SOAK_CI), workdir, device=dev,
                         timer=step_cost_timer())
    impls = sorted({e['impl'] for e in read_events(workdir / 'journal.jsonl')
                    if e['ev'] == 'completed'})
    check(rep.ok and rep.crashes_fired == [2, 4] and rep.incarnations == 3
          and rep.replayed_total > 0 and rep.bitwise_checked > 0
          and bool(rep.quarantined) and rep.shed_or_rejected > 0
          and len(rep.outcomes) == rep.n_requests
          and 'LOST' not in rep.outcomes.values(),
          f'durability: the reference\'s CI soak on the card (2J=2, '
          f'{rep.n_requests} requests, crashes at dispatches '
          f'{rep.crashes_fired}): invariants hold {rep.ok} '
          f'({len(rep.violations)} violations {rep.violations[:4]}), '
          f'{rep.incarnations} incarnations, {rep.replayed_total} replayed, '
          f'{rep.bitwise_checked} completed results held bitwise against '
          f'solo evaluations (impl {impls}), '
          f'quarantined {rep.quarantined}, {rep.shed_or_rejected} shed, '
          f'outcomes {dict(collections.Counter(rep.outcomes.values()))}')


def replayed_requests(journal_path):
    """The requests a restore re-admitted, rebuilt from their journaled
    payloads."""
    from repro_torch.launch.journal import read_events, unpack_array
    from repro_torch.launch.request_queue import ForceRequest
    out = []
    for e in read_events(journal_path):
        if e['ev'] == 'accepted' and e.get('replayed'):
            p = e['req']
            out.append(ForceRequest(
                e['req_id'], pos=unpack_array(p['pos']),
                box=unpack_array(p['box']), beta=unpack_array(p['beta']),
                twojmax=p['twojmax'], rcut=p['rcut'], beta0=p['beta0']))
    return out


def soak_wide(table, dev, workdir):
    """The soak at full width: the tail run's schedule (snap-2j8 requests
    of 128 and 2000 atoms, 200 a second, 15 % poisoned) through the
    serving table, two crashes with torn tails, a snapshot every
    SOAK_SNAP_EVERY steps; the launch counters set to 0 before and read
    after, each batched step's launches recorded with the incarnation that
    ran it.  Returns (launch counts, numbers)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.chaos import run_chaos_soak
    from repro_torch.launch.serve_forces import ForceServer, pack_batch
    from repro_torch.md.fault_inject import ChaosPlan
    schedule, bad = open_loop_schedule(TAIL_N, OPEN_RATE, OPEN_BAD, 'd')
    plan = ChaosPlan(kernel_fault_step=None, crash_dispatches=SOAK_CRASHES,
                     torn_tail=True)
    steps = []                   # (server, impl, launches of the step)
    run = ForceServer._run

    def recorded(srv, bucket, impl, arrays):
        before = ops.launch_counts()
        res = run(srv, bucket, impl, arrays)
        after = ops.launch_counts()
        steps.append((srv, impl, {k: after[k] - before[k] for k in after}))
        return res
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with mock.patch.object(ForceServer, '_run', recorded):
        rep = run_chaos_soak(plan, workdir, table=table, device=dev,
                             queue_depth=TAIL_N,
                             snapshot_every=SOAK_SNAP_EVERY,
                             schedule=(schedule, bad))
    counts = ops.launch_counts()
    want = {k: int(k in PATHS['serve']) for k in counts}
    # the journaled servers in order: the first life, then each restore's
    lives = list(dict.fromkeys(s for s, _, _ in steps
                               if s._journal is not None))
    after_restore = [d for s, _, d in steps if s in lives[1:]]
    n_kernel = sum(impl == 'kernel' for _, impl, _ in steps)
    expect = {req.req_id: 'failed' if i in bad else 'completed'
              for i, (_, req) in enumerate(schedule)}
    n_done = sum(v == 'completed' for v in rep.outcomes.values())
    check(rep.ok and rep.incarnations == 3 and len(lives) == 3
          and rep.crashes_fired == list(SOAK_CRASHES)
          and rep.replayed_total > 0 and rep.outcomes == expect
          and rep.bitwise_checked == n_done > 0,
          f'durability: full-width soak ({len(schedule)} snap-2j8 requests '
          f'at {OPEN_RATE:g}/s, {len(bad)} poisoned, crashes at dispatches '
          f'{rep.crashes_fired}, torn tails, a snapshot every '
          f'{SOAK_SNAP_EVERY} steps): invariants hold {rep.ok} '
          f'({len(rep.violations)} violations {rep.violations[:4]}), '
          f'{rep.incarnations} incarnations, '
          f'{rep.replayed_total} replayed, outcomes as planned '
          f'{rep.outcomes == expect}, {rep.bitwise_checked} of {n_done} '
          f'completed results bitwise equal to a fresh server\'s solo '
          f'evaluation on the card')
    builds = [s.health().compile_counts for s in lives]
    health = [s.health() for s in lives]
    check(all(c and set(c.values()) == {1}
              and all(k.endswith('/kernel') for k in c) for c in builds)
          and all(h.degraded_steps == 0 and not h.kernel_faults
                  for h in health),
          f'durability: one build a bucket in each incarnation {builds}; '
          f'degraded steps {[h.degraded_steps for h in health]}')
    check(len(after_restore) > 0
          and all(d == want for d in after_restore)
          and all(impl == 'kernel' for _, impl, _ in steps)
          and counts == {k: n_kernel * want[k] for k in counts},
          f'durability: {len(after_restore)} batched steps after a restore, '
          f'each launched one of each of U, Y, fused dE and the assembly '
          f'({sum(d == want for d in after_restore)} did); the soak\'s '
          f'{n_kernel} kernel-path steps (with the bitwise check\'s solo '
          f'evaluations) launched {counts}')
    # a batch of replayed requests on the last life's batched function:
    # no host synchronization
    reqs = replayed_requests(workdir / 'journal.jsonl')
    bucket = table.select(reqs[0])
    reqs = [r for r in reqs if table.select(r) == bucket][:SERVE_BATCH]
    fn = lives[-1]._fn(bucket, 'kernel')
    arrays = pack_batch(bucket, reqs, dev)
    fn(**arrays)
    err = first_sync(lambda: fn(**arrays))
    check(err is None, f'durability: no host synchronization in a batched '
          f'evaluation of {len(reqs)} replayed requests ({bucket.key}) on '
          f'the restored server\'s function ({err or "none raised"})')
    out = dict(soak_requests=len(schedule), recovery_s=rep.recovery_s,
               replayed=rep.replayed_total, incarnations=rep.incarnations,
               journal_events=rep.journal_events, served=rep.served,
               failed=rep.failed, bitwise_checked=rep.bitwise_checked,
               steps_after_restore=len(after_restore))
    print(f'     durability soak: restore {rep.recovery_s * 1e3:.3f} ms for '
          f'{rep.incarnations - 1} restores ({rep.replayed_total} requests '
          f'replayed), {rep.journal_events} journal events, served '
          f'{rep.served}, failed {rep.failed}', flush=True)
    return counts, out


def journal_cost(table, dev, tmp):
    """Host time of ``submit`` (us, p50 and p99 of JOURNAL_N) for 128- and
    2000-atom requests without a journal and with one fsynced every 16
    appends and every append; the bytes of an ``accepted`` event."""
    from repro_torch.launch.journal import Journal
    from repro_torch.launch.serve_forces import ForceServer
    out = {}
    for natoms in OPEN_SIZES:
        reqs = [serve_request(f'j{natoms}-{i}', natoms, 200 + i)
                for i in range(JOURNAL_N)]
        for fsync in (None,) + JOURNAL_FSYNC:
            path = tmp / f'submit-{natoms}-{fsync}.jsonl'
            journal = None if fsync is None else Journal(path, fsync)
            srv = ForceServer(table, device=dev, queue_depth=JOURNAL_N,
                              journal=journal)
            times = []
            for r in reqs:
                t0 = time.perf_counter()
                srv.submit(r)
                times.append((time.perf_counter() - t0) * 1e6)
            tag = f'n{natoms}_' + ('none' if fsync is None
                                   else f'fsync{fsync}')
            out[f'submit_us_{tag}'] = [float(np.percentile(times, 50)),
                                       float(np.percentile(times, 99))]
            if journal is not None:
                journal.close()
                out[f'accepted_bytes_n{natoms}'] = \
                    path.stat().st_size / JOURNAL_N
            print(f'     submit {natoms} atoms, journal '
                  f'{"none" if fsync is None else f"fsync every {fsync}"}: '
                  f'p50 {out[f"submit_us_{tag}"][0]:.1f} us, p99 '
                  f'{out[f"submit_us_{tag}"][1]:.1f} us ({JOURNAL_N} '
                  f'submits)', flush=True)
        print(f'     accepted event, {natoms} atoms: '
              f'{out[f"accepted_bytes_n{natoms}"]:.0f} bytes', flush=True)
    return out


def durability_timing(table, dev, tmp):
    """The journal's cost per submit; the tail and capacity runs without
    and with a journal in turns (without, with, with, without); snapshot
    of a full result store; drain of a 16-request backlog."""
    from repro_torch.launch.serve_forces import ForceServer
    out = journal_cost(table, dev, tmp)
    journaled_servers = []
    for name, rate, bad in (('tail', OPEN_RATE, OPEN_BAD),
                            ('capacity', SATURATE_RATE, 0.0)):
        for k, journaled in enumerate((False, True, True, False)):
            jp = tmp / f'{name}{k}.jsonl' if journaled else None
            h, _, srv = open_loop(table, dev, TAIL_N, rate, bad,
                                  f'{name[0]}{k}-', journal=jp)
            key = f'{name}_{"journal" if journaled else "none"}'
            out.setdefault(key, []).append(dict(
                p50_ms=h.p50_ms, p99_ms=h.p99_ms, rps=h.throughput_rps))
            if journaled:
                journaled_servers.append(srv)
    # snapshot of the last journaled capacity server (its store is full)
    srv = journaled_servers[-1]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        srv.snapshot(tmp / 'snap')
        times.append((time.perf_counter() - t0) * 1e3)
    depth = srv.health().store_depth
    out.update(snapshot_ms=statistics.median(times), snapshot_results=depth)
    print(f'     snapshot of {depth} results: {out["snapshot_ms"]:.3f} ms '
          f'(median of 3)', flush=True)
    for srv in journaled_servers:
        srv._journal.close()
    # drain: a backlog of 8 + 8 requests, served, then a final snapshot
    srv = ForceServer(table, device=dev, journal=str(tmp / 'drain.jsonl'))
    for i in range(16):
        srv.submit(serve_request(f'dr{i}', OPEN_SIZES[i % 2], 300 + i))
    t0 = time.perf_counter()
    h = srv.drain(deadline=1e9, snapshot_dir=tmp / 'drain_snap')
    out['drain_ms'] = (time.perf_counter() - t0) * 1e3
    check(h.draining and h.queue_depth == 0 and h.served == 16,
          f'durability: drain served the backlog ({h.served} of 16) and '
          f'wrote its snapshot in {out["drain_ms"]:.3f} ms')
    srv._journal.close()
    return out


def durability_phase(dev):
    """The service's durability half at snap-2j8 width (see the module
    docstring).  Returns (launch counts of the full-width soak, numbers).
    Journals and snapshots go to a temporary directory."""
    t0 = time.perf_counter()
    table = default_serve_table()
    adjoint_bits(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        soak_ci(dev, tmp / 'ci')
        counts, out = soak_wide(table, dev, tmp / 'wide')
        out.update(durability_timing(table, dev, tmp))
    out.update(phase_s=time.perf_counter() - t0, card=card_identity())
    print(f'     durability phase: {out["phase_s"]:.1f} s wall on '
          f'{out["card"]}', flush=True)
    return counts, out


def big_phase(dev):
    """2J = 14 in float32: each half and full kernel vs plain, then the
    half-plane pipeline vs its plain pipeline, and its time."""
    from repro_torch.kernels import ops
    cfg, beta, _, _, nbr_idx, mask, disp = setup(14, dev)
    beta = beta * 1e-2
    stats = kernel_phase(cfg, beta, nbr_idx, mask, disp, torch.float32, dev,
                         HALF + FULL)
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    e_k, _, f_k = ops.snap_force_pipeline(*args, dtype=torch.float32,
                                          device=dev)
    ms = time_ms(lambda: ops.snap_force_pipeline(
        *args, dtype=torch.float32, device=dev), reps=5, warmup=1)
    e_p, _, f_p = ops.plain_force_pipeline(*args, dtype=torch.float32,
                                           device=dev)
    _, err = rel_err(f_k, f_p)
    finite = bool(torch.isfinite(f_k).all()) and np.isfinite(float(e_k))
    check(finite and err <= TOL[torch.float32],
          f'2J=14 pipeline f32: max |F| rel err vs plain {err:.3e} (bar '
          f'1e-05), E {float(e_k):.6f} vs {float(e_p):.6f} eV, '
          f'{ms:.3f} ms per evaluation (median of 5 after warm-up)')
    return stats


def sharded_rank(rank, dev, cfg, beta, disp, nbr_idx, mask, pos, box, vel,
                 ckpt_dir):
    """One rank of the sharded phase (a spawned process of a 2-rank gloo
    group, on cuda:0): each path of SHARD_PATHS through
    ``make_sharded_force_fn`` (launch counts of one evaluation, a second one
    bitwise, the gathered result, ms per evaluation), the offset assembly
    kernel against its plain version on this rank's rows, then
    ``run_nve(loop='device', shards=2)`` with the launch counters set to 0
    before and read after, timed again, and the continuation of the
    single-rank checkpoint in ``ckpt_dir`` from rank slices."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.kernels.assemble import (assemble_forces_csr,
                                              assemble_forces_csr_plain,
                                              destination_csr)
    from repro_torch.runtime.shard import gather_atoms, rank_rows
    from repro_torch.md.integrate import MDState, run_nve
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    beta = torch.as_tensor(beta, device=dev)
    inputs = device_inputs(disp, nbr_idx, mask, dev)
    out = dict(rank=rank, backend=dist.get_backend(),
               collective_tensors=str(inputs[0].device))
    for tag, (impl, kw, _) in SHARD_PATHS.items():
        fn = ops.make_sharded_force_fn(cfg, beta, 0.0, impl=impl,
                                       device=dev, **kw)
        fn(*inputs)                                  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        e, e_atom, f = fn(*inputs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        e2, _, f2 = fn(*inputs)
        times = []
        for _ in range(SHARD_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            fn(*inputs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[tag] = dict(
            e=float(e), e_atom=gather_atoms(e_atom).cpu().numpy(),
            f=gather_atoms(f).cpu().numpy(), local_rows=f.shape[0],
            counts=counts, ms=statistics.median(times),
            bitwise=bool(torch.equal(f, f2) and torch.equal(e, e2)))

    # the offset assembly on this rank's rows of the main path's lists:
    # d of the shape the half pipeline hands it, from a seeded generator,
    # in f64 (the timed form) and f32 (the 'half f32' path's)
    offset, n_local = rank_rows(NATOMS)
    rows = slice(offset, offset + n_local)
    nbr, ok = inputs[3][rows].long(), inputs[4][rows]
    g = torch.Generator(device=dev).manual_seed(rank)
    d64 = (torch.randn((n_local, NNBOR, 3), generator=g, dtype=torch.float64,
                       device=dev) * ok[..., None]).contiguous()
    csr = destination_csr(torch.where(ok, nbr, NATOMS), NATOMS)
    asm = {}
    for dtype, sfx in ((torch.float64, ''), (torch.float32, '_f32')):
        d = d64.to(dtype)

        def library():   # the index_add_ form of the same partial
            part = d.new_zeros((NATOMS, 3))
            part[rows] = d.sum(dim=1)
            return part.index_add_(0, nbr.reshape(-1), -d.reshape(-1, 3))

        got = assemble_forces_csr(d, *csr, offset)
        want = assemble_forces_csr_plain(d, *csr, offset)
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, want)
        asm.update({f'max_abs_err{sfx}': abs_err, f'max_rel_err{sfx}': err,
                    f'shape{sfx}': list(got.shape),
                    f'dtype{sfx}': str(got.dtype)[6:],
                    f'bitwise{sfx}': bool(torch.equal(got, want))})
        for who in range(SHARDS):   # one rank at a time on the card
            dist.barrier()
            if who == rank == 0:
                asm.update({
                    f'ms{sfx}': time_ms(lambda: assemble_forces_csr(
                        d, *csr, offset)),
                    f'device_ms{sfx}': device_ms(lambda: assemble_forces_csr(
                        d, *csr, offset))[0],
                    f'plain_ms{sfx}': time_ms(
                        lambda: assemble_forces_csr_plain(d, *csr, offset),
                        reps=10),
                    f'library_ms{sfx}': time_ms(library),
                    f'library_device_ms{sfx}': device_ms(library)[0]})
                asm[f'bound_ms{sfx}'], asm[f'bound_by{sfx}'] = bound(
                    nbytes(d, *csr) + NATOMS * 3 * d.element_size(),
                    6 * int(ok.sum()), dtype)
    out['assemble'] = asm

    kw = dict(impl='kernel', loop='device', skin=SKIN,
              max_nbors=DEVICE_NBORS, log_every=DEVICE_LOG, device=dev,
              dtype=torch.float64, shards=SHARDS)

    def state():
        return MDState(pos=pos.copy(), vel=vel.copy(), box=box)

    cache = {}
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    _, thermo = run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS,
                        fn_cache=cache, **kw)
    torch.cuda.synchronize()
    out['md_counts'] = ops.launch_counts()
    out['md_thermo'] = thermo
    dist.barrier()
    t0 = time.perf_counter()
    run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS, fn_cache=cache, **kw)
    torch.cuda.synchronize()
    out['md_ms_step'] = (time.perf_counter() - t0) * 1e3 / DEVICE_STEPS
    st, tail = run_nve(cfg, beta, 0.0, state(), DEVICE_STEPS // 2,
                       checkpoint_dir=ckpt_dir, restore=True, **kw)
    out['tail'], out['tail_step'] = tail, st.step
    # the analysis suite's sharded entry, in step on both ranks
    from repro_torch.analysis.budgets import DEFAULT_PATH, load_budgets
    from repro_torch.analysis.registry import default_registry
    from repro_torch.analysis.runner import run_registry
    dist.barrier()
    (ep,) = [e for e in default_registry(dev)
             if e.name == 'force.torch.sharded']
    report = run_registry([ep], budgets=load_budgets(
        DEFAULT_PATH, torch.device(dev).type))
    out['analysis'] = dict(
        errors=[str(f) for f in report.all_findings()
                if f.severity == 'error'],
        suppressed=[f.detail.get('op', f.code)
                    for f in report.entries[0].suppressed],
        metrics=report.entries[0].metrics)
    dist.barrier()
    return out


def sharded_phase(cfg, beta, pos, box, nbr_idx, mask, disp, dev, straight):
    """The atom-sharded path on 2 ranks of one card over a gloo group
    (NCCL takes one card a rank): each path of SHARD_PATHS gathered
    against the unsharded evaluation on the card, two sharded evaluations
    bitwise, one launch of each kernel of the path per rank per
    evaluation, the offset assembly kernel against its plain version,
    ``run_nve(loop='device', shards=2)`` against the single-rank run
    ``straight`` (T, PE, Etot at 1e-9 relative), and a single-rank
    checkpoint continued on the 2 ranks from rank slices.  Returns rank
    0's MD launch counts and the offset assembly's numbers."""
    from repro_torch.core import snap as core_snap
    from repro_torch.launch.sharding import spawn_ranks
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    vel = init_velocities(NATOMS, 300.0)
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    ref = {tag: core_snap.energy_forces(*args, impl=impl, device=dev, **kw)
           for tag, (impl, kw, _) in SHARD_PATHS.items()}
    k = DEVICE_STEPS // 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        run_nve(cfg, beta, 0.0, MDState(pos=pos.copy(), vel=vel.copy(),
                                        box=box), k, impl='kernel',
                loop='device', skin=SKIN, max_nbors=DEVICE_NBORS,
                log_every=DEVICE_LOG, device=dev, dtype=torch.float64,
                checkpoint_dir=d, checkpoint_every=k)
        torch.cuda.empty_cache()    # room for the ranks' own contexts
        ranks = spawn_ranks(sharded_rank, SHARDS, str(dev), cfg,
                            beta.cpu().numpy(), disp, nbr_idx, mask, pos,
                            box, vel, d)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f'     sharded: {SHARDS} ranks on {torch.cuda.get_device_name(0)} '
          f'over {r0["backend"]}, {r0["collective_tensors"]} tensors handed '
          f'to the collectives (gloo moves them through host memory); '
          f'{wall:.1f} s wall with the spawn', flush=True)
    for tag, (impl, _, bar) in SHARD_PATHS.items():
        e_ref, ea_ref, f_ref = (t.double().cpu() for t in ref[tag])
        path = PATHS['half'] if impl == 'kernel' else ('assemble_forces',)
        want = {n: (1 if n in path else 0) for n in r0[tag]['counts']}
        for r in ranks:
            got = r[tag]
            _, f_err = rel_err(torch.as_tensor(got['f']).double(), f_ref)
            _, a_err = rel_err(torch.as_tensor(got['e_atom']).double(),
                               ea_ref)
            e_err = abs(got['e'] - float(e_ref)) / abs(float(e_ref))
            check(max(f_err, a_err, e_err) <= bar
                  and got['local_rows'] == NATOMS // SHARDS,
                  f'sharded {tag} rank {r["rank"]}: gathered forces, per-atom '
                  f'and total energy vs the unsharded evaluation: max rel '
                  f'err {f_err:.3e}, {a_err:.3e}, {e_err:.3e} (bar '
                  f'{bar:.0e}); {got["local_rows"]} local rows')
            check(got['bitwise'] and got['counts'] == want,
                  f'sharded {tag} rank {r["rank"]}: two evaluations '
                  f'bitwise equal; launches of one evaluation '
                  f'{got["counts"]} == 1 for each kernel of the path')
        check(all(np.array_equal(r[tag]['f'], r0[tag]['f'])
                  for r in ranks),
              f'sharded {tag}: both ranks hold the same gathered forces '
              '(bitwise)')
        print(f'     sharded {tag}: {r0[tag]["ms"]:.3f} / '
              f'{ranks[1][tag]["ms"]:.3f} ms per sharded evaluation on rank '
              f'0 / 1 (host clock, ends in a sync, median of {SHARD_REPS})',
              flush=True)
    for r in ranks:
        a = r['assemble']
        for dtype, sfx in ((torch.float64, ''), (torch.float32, '_f32')):
            check(a[f'max_rel_err{sfx}'] <= TOL[dtype]
                  and a[f'shape{sfx}'] == [NATOMS, 3]
                  and a[f'dtype{sfx}'] == str(dtype)[6:],
                  f'assemble_forces offset form {a[f"dtype{sfx}"]}, rank '
                  f'{r["rank"]} (rows {r["rank"] * NATOMS // SHARDS}.., '
                  f'{NATOMS} output rows): max rel err vs plain '
                  f'{a[f"max_rel_err{sfx}"]:.3e} (bar {TOL[dtype]:.0e}), '
                  f'bitwise {a[f"bitwise{sfx}"]}')
    a = r0['assemble']
    for sfx in ('', '_f32'):
        print(f'     assemble_forces offset form (rank 0, '
              f'{a[f"dtype{sfx}"]}): {a[f"ms{sfx}"]:.4f} ms per call, '
              f'{a[f"device_ms{sfx}"]:.4f} ms device (plain '
              f'{a[f"plain_ms{sfx}"]:.4f} ms, index_add_ form '
              f'{a[f"library_ms{sfx}"]:.4f} ms, device '
              f'{a[f"library_device_ms{sfx}"]:.4f} ms; bound '
              f'{a[f"bound_ms{sfx}"]:.5f} ms by {a[f"bound_by{sfx}"]})',
              flush=True)

    def rows(thermo):
        return np.array([[t['T'], t['pe'], t['etot']] for t in thermo])

    want = rows(straight)
    by_step = {t['step']: t for t in straight}
    n_eval = DEVICE_STEPS + 1
    for r in ranks:
        got = rows(r['md_thermo'])
        err = (float(np.max(np.abs(got - want) / np.abs(want)))
               if got.shape == want.shape else float('inf'))
        counts = r['md_counts']
        cwant = {n: (n_eval if n in PATHS['device'] else 0) for n in counts}
        check(err <= THERMO_TOL and counts == cwant,
              f'sharded device loop rank {r["rank"]}: {DEVICE_STEPS} steps '
              f'of run_nve(shards={SHARDS}): T, PE, Etot vs shards=1 max rel '
              f'diff {err:.3e} (bar {THERMO_TOL:.0e}); launches {counts} == '
              f'{n_eval} for each kernel of the path')
        tail = r['tail']
        terr = (float(np.max(np.abs(rows(tail) - rows(
            [by_step[t['step']] for t in tail])) / np.abs(rows(tail))))
            if tail and all(t['step'] in by_step for t in tail)
            else float('inf'))
        check(r['tail_step'] == DEVICE_STEPS and terr <= THERMO_TOL,
              f'sharded restore rank {r["rank"]}: a shards=1 checkpoint at '
              f'step {k} read as rank slices and continued {k} steps on '
              f'{SHARDS} ranks: thermo vs the straight run max rel diff '
              f'{terr:.3e} (bar {THERMO_TOL:.0e})')
    for r in ranks:
        an = r['analysis']
        check(not an['errors'] and an['metrics'].get('launches') == 1,
              f'analysis force.torch.sharded rank {r["rank"]}: '
              f'{len(an["errors"])} unallowlisted finding(s) or budget '
              f'error(s) of the cuda section {an["errors"][:3]}, '
              f'{an["metrics"].get("launches")} launch a call (the '
              f'assembly), peak bytes {an["metrics"].get("peak_bytes")}; '
              f'allowlisted by name: {sorted(set(an["suppressed"]))}')
    print(f'     sharded device loop: {r0["md_ms_step"]:.3f} / '
          f'{ranks[1]["md_ms_step"]:.3f} ms per step on rank 0 / 1 '
          f'({DEVICE_STEPS} steps, chunk function cached, host clock, ends '
          'in a sync)', flush=True)
    return r0['md_counts'], dict(
        {f'{key}_sharded{sfx}': a[f'{key}{sfx}']
         for key in ('max_abs_err', 'ms', 'device_ms', 'plain_ms',
                     'bound_ms', 'bound_by', 'library_ms',
                     'library_device_ms')
         for sfx in ('', '_f32')},
        sharded_eval_ms={tag: r0[tag]['ms'] for tag in SHARD_PATHS},
        sharded_md_ms_step=r0['md_ms_step'],
        sharded_backend=r0['backend'])


def peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def measured(fn):
    """(result, ms, peak GB): one call from an emptied allocator with the
    peak reset, then the median of BASELINE_REPS CUDA-event timings."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = peak_gb()
    return out, time_ms(fn, reps=BASELINE_REPS, warmup=1), peak


def baseline_phase(dev):
    """impl='baseline' (Z and dB stored) at snap-2j8 in float64 and float32
    and at 2J = 14 in float32: against the float64 adjoint, two
    evaluations bitwise, ms and peak memory beside the adjoint's and the
    half kernel path's; then 4 device-loop MD steps against the
    adjoint."""
    from dataclasses import replace

    from repro_torch.core import snap as core_snap
    from repro_torch.kernels import ops
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    out = {}
    for twojmax, dtypes in BASELINE_CASES:
        cfg, beta, pos, box, nbr_idx, mask, disp = setup(twojmax, dev)
        if twojmax == 14:
            beta = beta * 1e-2
        args = (beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
        e_ref, _, f_ref = core_snap.energy_forces_adjoint(
            replace(cfg, dtype=torch.float64), *args, device=dev)
        for dtype in dtypes:
            c = replace(cfg, dtype=dtype)
            fns = {
                'baseline': lambda c=c: core_snap.energy_forces(
                    c, *args, impl='baseline', device=dev),
                'adjoint': lambda c=c: core_snap.energy_forces(
                    c, *args, impl='adjoint', device=dev),
                'kernel': lambda dtype=dtype: ops.snap_force_pipeline(
                    cfg, *args, dtype=dtype, device=dev),
            }
            tag = f'2J={twojmax} {str(dtype)[6:]}'
            row = {}
            for name, fn in fns.items():
                (e, _, f), ms, peak = measured(fn)
                row[name] = dict(ms=ms, peak_gb=peak)
                if name != 'baseline':
                    continue
                _, err = rel_err(f.double(), f_ref)
                de = abs(float(e) - float(e_ref)) / abs(float(e_ref))
                check(max(err, de) <= TOL[dtype] and f.dtype == dtype,
                      f'baseline {tag}: forces vs the f64 adjoint max rel err '
                      f'{err:.3e}, energy {de:.3e} (bar {TOL[dtype]:.0e})')
                e2, _, f2 = fn()
                check(torch.equal(f, f2) and torch.equal(e, e2),
                      f'baseline {tag}: two evaluations give equal forces '
                      'and energies (bitwise)')
                del e, f, e2, f2
            print(f'     {tag}: ' + '; '.join(
                f'{n} {v["ms"]:.3f} ms, peak {v["peak_gb"]:.3f} GB'
                for n, v in row.items()) + f' (median of {BASELINE_REPS}, '
                'CUDA events; peak torch.cuda.max_memory_allocated)',
                flush=True)
            out[tag] = row
    cfg, beta, pos, box, _, _, _ = setup(8, dev)
    vel = init_velocities(NATOMS, 300.0)
    pe = {}
    for impl in ('baseline', 'adjoint'):
        _, thermo = run_nve(cfg, beta, 0.0, MDState(pos=pos.copy(),
                                                    vel=vel.copy(), box=box),
                            BASELINE_MD_STEPS, impl=impl, loop='device',
                            skin=SKIN, max_nbors=DEVICE_NBORS, log_every=2,
                            device=dev)
        pe[impl] = np.array([t['pe'] for t in thermo])
    err = float(np.max(np.abs(pe['baseline'] - pe['adjoint'])
                       / np.abs(pe['adjoint'])))
    check(err <= THERMO_TOL, f'baseline md: {BASELINE_MD_STEPS} steps of '
          f"run_nve(loop='device', impl='baseline'): PE vs impl='adjoint' "
          f'max rel diff {err:.3e} (bar {THERMO_TOL:.0e})')
    return out


def fit_phase(dev):
    """The fit example (``repro_torch.examples.fit_snap.fit``) at snap-2j8
    width on the card: 4 perturbed 2000-atom cells labelled by the
    float64 adjoint, ``fit_snap_linear`` (dB rows on the card, the ridge
    solve on the host in float64), then a held-out cell, held to the
    example's bars; ms and peak memory of ``descriptor_rows`` per cell."""
    from repro_torch.core.snap import SnapConfig
    from repro_torch.examples import fit_snap
    from repro_torch.fit import descriptor_rows, fit_snap_linear
    cfg = SnapConfig(twojmax=8, rcut=RCUT)
    t0 = time.perf_counter()
    out = fit_snap.fit(cfg, NATOMS, dev)
    example_s = time.perf_counter() - t0
    data = out['data']
    times, peaks = [], []
    for d in data:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        descriptor_rows(cfg, d, dev)          # ends in the rows' readback
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(peak_gb())
    t0 = time.perf_counter()
    fit_snap_linear(cfg, data, device=dev)
    fit_s = time.perf_counter() - t0
    rel_e, max_df = out['rel_e'], out['max_df']
    check(rel_e < fit_snap.MAX_REL_E and max_df < fit_snap.MAX_DF,
          f'fit snap-2j8 (examples/fit_snap.fit): {len(data)} cells x '
          f'{NATOMS} atoms, rms E {out["rms_e"]:.3e} eV, rms F '
          f'{out["rms_f"]:.3e} eV/A; held-out relE {rel_e:.3e} (bar '
          f'{fit_snap.MAX_REL_E:.0e}), max |dF| {max_df:.3e} eV/A (bar '
          f'{fit_snap.MAX_DF:.0e})')
    print(f'     fit: descriptor_rows {statistics.median(times):.1f} ms a '
          f'cell (median of {len(data)}, host clock incl. the readback; '
          f'{", ".join(f"{t:.1f}" for t in times)}), peak '
          f'{max(peaks):.3f} GB; fit_snap_linear {fit_s:.2f} s for '
          f'{len(data)} cells; the whole example {example_s:.1f} s',
          flush=True)
    return dict(rows_ms=times, rows_peak_gb=peaks, fit_s=fit_s,
                example_s=example_s, rel_e=rel_e, max_df=max_df)


def analysis_phase(dev):
    """The static-analysis registry on the card (``python -m
    repro_torch.analysis``'s run): every entry built twice, called twice,
    the second call under the op and launch recorders and CUDA sync
    debug mode, held to the ``cuda`` budgets of ``budgets.json``, with
    the launch counters set to 0 before and read after."""
    from repro_torch.analysis.budgets import DEFAULT_PATH, load_budgets
    from repro_torch.analysis.registry import default_registry
    from repro_torch.analysis.runner import run_registry
    from repro_torch.kernels import ops
    budgets = load_budgets(DEFAULT_PATH, 'cuda')
    check(bool(budgets and budgets.get('entries')),
          f'analysis: the cuda section of {DEFAULT_PATH} is checked in')
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = run_registry(default_registry(dev), budgets=budgets)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    errors = [f for f in report.all_findings() if f.severity == 'error']
    syncs = [f for f in report.all_findings() if f.pass_name == 'host_sync']
    launch = [f for f in report.all_findings() if f.code == 'launch-count']
    check(not errors, f'analysis registry: {len(report.entries)} entries, '
          f'{len(errors)} unallowlisted finding(s) '
          f'{[str(f) for f in errors][:4]}')
    check(not syncs and not launch,
          'analysis registry: no host sync (op recorder and CUDA sync debug '
          'mode) and one launch of each kernel of the path a call in every '
          f'entry ({len(syncs)} sync, {len(launch)} launch-count '
          'finding(s))')
    metrics = {}
    for e in report.entries:
        m = e.metrics
        metrics[e.entry] = {k: m[k] for k in (
            'launches', 'plane_bytes', 'peak_bytes', 'total_bytes',
            'pad_waste_frac', 'broadcast_bytes_max', 'compile_count')
            if k in m}
        print(f'     analysis {e.entry}: launches {m.get("launches")}, '
              f'plane bytes {m.get("plane_bytes", "-")}, peak bytes '
              f'{m.get("peak_bytes", "-")}, bytes allocated '
              f'{m.get("total_bytes")}, pad waste '
              f'{m.get("pad_waste_frac", 0):.4f}; suppressed '
              f'{[f.detail.get("op", f.code) for f in e.suppressed]}',
              flush=True)
    print(f'     analysis: {wall:.1f} s for {len(report.entries)} entries; '
          f'launches {counts}', flush=True)
    return counts, metrics


def examples_phase(dev):
    """The four examples as a user runs them, on the card, with the
    launch counters set to 0 before and read after: md_nve at snap-2j8
    width (``--natoms 2000 --twojmax 8 --loop device --impl kernel``,
    relative NVE drift <= MD_DRIFT_TOL), quickstart (its f32 kernel energy
    within 1e-5 of the adjoint's, the baseline's within 1e-10), and
    serve_forces with the kernel path (every request reaches an outcome,
    the poisoned ones a typed error).  The fit example runs in the fit
    phase."""
    from repro_torch.examples import md_nve, quickstart, serve_forces
    from repro_torch.kernels import ops
    from repro_torch.launch.request_queue import ServiceError
    from repro_torch.launch.serve_forces import ForceResult
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    md = md_nve.main(['--natoms', str(NATOMS), '--twojmax', '8', '--loop',
                      'device', '--impl', 'kernel'])
    md_s = time.perf_counter() - t0
    check(np.isfinite(md['rel_drift']) and md['rel_drift'] <= MD_DRIFT_TOL,
          f'examples md_nve --natoms {NATOMS} --twojmax 8 --loop device '
          f'--impl kernel: {md["thermo"][-1]["step"]} steps, relative NVE '
          f'drift {md["rel_drift"]:.3e} (bar {MD_DRIFT_TOL:.0e}), '
          f'{md["rebuilds"]} rebuilds, {md_s:.1f} s')
    qs = quickstart.main([])
    e = qs['energy']
    d_kernel = abs(e['kernel'] - e['adjoint']) / abs(e['adjoint'])
    d_base = abs(e['baseline'] - e['adjoint']) / abs(e['adjoint'])
    check(d_kernel <= TOL[torch.float32] and d_base <= TOL[torch.float64],
          f'examples quickstart (2J=8, 54 atoms): kernel (f32) vs adjoint '
          f'rel diff {d_kernel:.3e} (bar {TOL[torch.float32]:.0e}), '
          f'baseline vs adjoint {d_base:.3e} (bar '
          f'{TOL[torch.float64]:.0e})')
    sv = serve_forces.main(['--impl', 'kernel'])
    ok = all((isinstance(res, ServiceError) if i in sv['plan']
              else isinstance(res, ForceResult) and np.isfinite(res.energy))
             for i, res in enumerate(sv['outcomes'].values()))
    check(ok and sv['health']['degraded_steps'] == 0,
          f'examples serve_forces --impl kernel: {len(sv["outcomes"])} '
          f'requests, every one an outcome ({sv["health"]["served"]} '
          f'served, {sv["health"]["failed"]} poisoned failed typed), '
          f'{sv["health"]["degraded_steps"]} degraded steps')
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f'     examples: launches {counts}', flush=True)
    return counts, dict(md_rel_drift=md['rel_drift'], md_s=md_s,
                        quickstart=e, serve=sv['health'])


# ---------------------------------------------------------------------------
# the language-model serving path (repro_torch.models, launch/serve.py)
# ---------------------------------------------------------------------------

def lm_bytes(tree):
    from repro_torch.models.transformer import tree_leaves
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def lm_clone(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(torch.clone, tree)


def lm_equal(a, b):
    from repro_torch.models.transformer import tree_leaves
    return all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_leaves(a), tree_leaves(b)))


def lm_reduced(dev):
    """Each of the ten reduced archs (float32) on the card against the
    same port code on the CPU with the same weights (drawn on the CPU from
    one seed and moved): prefill logits and cache, two greedy decode steps
    (the CPU's tokens fed to both), and one decode step twice from one
    cache, bitwise on the card."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.serve import random_inputs, widen_cache
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill, tree_leaves,
                                                tree_map)
    worst = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        g = torch.Generator().manual_seed(ARCHS.index(arch))
        params = init_params(cfg, g, 'cpu')
        prompts, front = random_inputs(cfg, LM_B, LM_P, g, 'cpu')
        runs = {}
        for d in ('cpu', dev):
            p = tree_map(lambda t: t.to(d), params)
            f = None if front is None else front.to(d)
            last, pcache = prefill(cfg, p, prompts.to(d), frontend_embeds=f)
            out = [last] + [a for _, a in tree_leaves(pcache)]
            cache = widen_cache(cfg, pcache, LM_B, LM_P + LM_STEPS)
            tok = (torch.argmax(last, -1) if d == 'cpu'
                   else runs['cpu']['tokens'][0].to(d))
            tokens, steps = [tok], []
            for i in range(LM_STEPS):
                if d != 'cpu' and i == 0:
                    twice = [decode_step(cfg, p, lm_clone(cache), tok,
                                         LM_P)[0] for _ in range(2)]
                logits, cache = decode_step(cfg, p, cache, tok, LM_P + i)
                steps.append(logits)
                tok = (torch.argmax(logits, -1) if d == 'cpu'
                       else runs['cpu']['tokens'][i + 1].to(d))
                tokens.append(tok)
            runs[d] = dict(out=out, steps=steps, tokens=tokens)
        errs = [float((a.cpu() - b).abs().max())
                / max(float(b.abs().max()), 1e-30) for a, b in
                zip(runs[dev]['out'] + runs[dev]['steps'],
                    runs['cpu']['out'] + runs['cpu']['steps'])]
        worst[arch] = max(errs)
        check(worst[arch] <= LM_TOL and torch.equal(*twice),
              f'lm reduced {arch}: card vs CPU, prefill logits and '
              f'{len(runs["cpu"]["out"]) - 1} cache leaves and '
              f'{LM_STEPS} decode steps, max rel err {worst[arch]:.3e} '
              f'(bar {LM_TOL:.0e}); a decode step twice bitwise '
              f'{torch.equal(*twice)}')
    return worst


def lm_full(dev, arch, over, B, P, G):
    """One arch at full width (bf16 compute, f32 master weights drawn on
    the card): finite logits at every step, one decode step twice from one
    cache bitwise, no host sync in the decode steps (CUDA sync debug mode,
    the greedy token kept on the card), then ``launch.serve.generate``
    timed (the second of two calls) and the peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, random_inputs, widen_cache
    from repro_torch.models.transformer import (cast_for_compute,
                                                decode_step, init_params,
                                                param_count, prefill)
    cfg = dataclasses.replace(get_config(arch), **over)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, dev)
    prompts, front = random_inputs(cfg, B, P, g, dev)
    n_params = param_count(params)
    cp = cast_for_compute(params, cfg.adtype)
    weight_gb = lm_bytes(cp) / 1e9
    last, pcache = prefill(cfg, cp, prompts, frontend_embeds=front)
    cache = widen_cache(cfg, pcache, B, P + G)
    del pcache
    finite = torch.isfinite(last).all()
    tok = torch.argmax(last, -1)
    twice = [decode_step(cfg, cp, lm_clone(cache), tok, P) for _ in range(2)]
    bitwise = (torch.equal(twice[0][0], twice[1][0])
               and lm_equal(twice[0][1], twice[1][1]))
    del twice
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode('error')
    try:
        for i in range(G - 1):
            logits, cache = decode_step(cfg, cp, cache, tok, P + i)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits, -1)
    except RuntimeError as e:
        sync_error = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del cache, cp
    runs = [generate(cfg, params, prompts, G, frontend=front, device=dev)
            for _ in range(2)]
    out = runs[-1]
    torch.cuda.synchronize()
    peak = peak_gb()
    depth = (f'{cfg.n_layers} layers' + (f' + {cfg.enc_layers} encoder'
                                         if cfg.enc_layers else ''))
    row = dict(arch=arch, layers=cfg.n_layers, enc_layers=cfg.enc_layers,
               params=n_params, B=B, P=P, G=G,
               prefill_ms=out['prefill_s'] * 1e3,
               prefill_tok_s=B * P / out['prefill_s'],
               decode_ms_step=out['decode_s'] * 1e3 / (G - 1),
               decode_tok_s=B * (G - 1) / out['decode_s'],
               peak_gb=peak, weight_gb=weight_gb,
               weight_read_ms=weight_gb / HBM_TBS)
    check(bool(finite) and bitwise and sync_error is None
          and bool(torch.isfinite(out['logits']).all()),
          f'lm full {arch} ({depth}, {n_params / 1e9:.2f} B params, B={B} '
          f'P={P} G={G}, bf16): logits finite {bool(finite)}, a decode '
          f'step twice bitwise {bitwise}, host syncs in {G - 1} decode '
          f'steps: {"none" if sync_error is None else sync_error}')
    print(f'     lm {arch}: prefill {row["prefill_ms"]:.2f} ms '
          f'({row["prefill_tok_s"]:.0f} tok/s), decode '
          f'{row["decode_ms_step"]:.3f} ms a step ({row["decode_tok_s"]:.1f}'
          f' tok/s), peak {peak:.3f} GB; its {weight_gb:.3f} GB of '
          f'compute weights read once take {weight_gb / HBM_TBS:.3f} ms',
          flush=True)
    del params, runs, out
    return row


def lm_teacher_forcing(dev):
    """gemma3-1b at full width and depth in float32: a P-token prefill and
    8 greedy decode steps against ``forward`` over the extended sequence
    (positions P-1 .. P+7), |a - b| <= bar + bar * |b|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import widen_cache
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_params, prefill)
    B, P, G, bar = LM_TF
    cfg = dataclasses.replace(get_config('gemma3-1b'), dtype='float32')
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, g, dev)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)
    last, pcache = prefill(cfg, params, prompts)
    cache = widen_cache(cfg, pcache, B, P + G)
    del pcache
    steps, toks = [last[:, 0]], [torch.argmax(last, -1)]
    for i in range(G):
        logits, cache = decode_step(cfg, params, cache, toks[-1], P + i)
        steps.append(logits[:, 0])
        toks.append(torch.argmax(logits, -1))
    del cache
    seq = torch.cat([prompts] + toks[:G], dim=1)
    full, _ = forward(cfg, params, seq)
    got, want = torch.stack(steps, 1), full[:, P - 1:P + G]
    excess = float(((got - want).abs() - bar * want.abs()).max())
    check(excess <= bar, f'lm teacher forcing gemma3-1b (full width, '
          f'{cfg.n_layers} layers, f32, B={B} P={P}): {G} decode steps and '
          f'the prefill vs forward over {P + G} tokens, max |d| - {bar:.0e}'
          f'|ref| = {excess:.3e} (bar {bar:.0e}), max |d| '
          f'{float((got - want).abs().max()):.3e}')
    return excess


def lm_profile(dev, reps=5):
    """Where the device time of one gemma3-1b decode step goes (full
    width, bf16, B=4, a 512-token cache): torch.profiler over ``reps``
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import random_inputs, widen_cache
    from repro_torch.models.transformer import (cast_for_compute,
                                                decode_step, init_params,
                                                prefill)
    _, B, P, G = LM_FULL['gemma3-1b']
    cfg = get_config('gemma3-1b')
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    cp = cast_for_compute(init_params(cfg, g, dev), cfg.adtype)
    prompts, _ = random_inputs(cfg, B, P, g, dev)
    last, pcache = prefill(cfg, cp, prompts)
    cache = widen_cache(cfg, pcache, B, P + reps + 2)
    tok = torch.argmax(last, -1)
    decode_step(cfg, cp, cache, tok, P)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            logits, cache = decode_step(cfg, cp, cache, tok, P + 1 + i)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per = profile_summary(prof, wall_us, reps, 'lm profile gemma3-1b decode '
                          f'(B={B}, bf16)', 'step', 10)
    if per is None:
        return None
    bytes_ms = lm_bytes(cp) / 1e9 / HBM_TBS
    print(f'     lm profile: the step\'s compute weights read once take '
          f'{bytes_ms:.3f} ms at {HBM_TBS} TB/s', flush=True)
    return dict(device_ops=sum(n for n, _ in per.values()) / reps,
                device_ms=sum(us for _, us in per.values()) / reps / 1e3,
                wall_ms=wall_us / reps / 1e3, weight_read_ms=bytes_ms)


def lm_phase(dev):
    """The language-model serving path on the card: every arch reduced
    against the CPU, the full-width runs, teacher forcing in float32 and
    one profiled decode step.  ``allow_tf32`` is off (main sets it)."""
    numbers = dict(reduced_max_rel_err=lm_reduced(dev))
    numbers['full'] = [lm_full(dev, arch, *spec)
                       for arch, spec in LM_FULL.items()]
    numbers['teacher_forcing_excess'] = lm_teacher_forcing(dev)
    numbers['profile'] = lm_profile(dev)
    return numbers


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
    ptxas_phase(built)

    cfg, beta, pos, box, nbr_idx, mask, disp = setup(8, dev)
    print(f'snap-2j8: {NATOMS} atoms, neighbors per atom '
          f'{int(mask.sum(1).min())}..{int(mask.sum(1).max())}, '
          f'idxu_half_max {cfg.index.idxu_half_max}, idxu_max '
          f'{cfg.index.idxu_max}', flush=True)
    snap = [k for k in KERNELS if k not in CELL]
    stats = {dtype: kernel_phase(cfg, beta, nbr_idx, mask, disp, dtype, dev,
                                 snap)
             for dtype in (torch.float64, torch.float32)}
    pipeline_phase(cfg, beta, nbr_idx, mask, disp, dev)
    for layout in ('half', 'full'):
        profile_phase(cfg, beta, nbr_idx, mask, disp, dev, layout)
    runs = {path: md_phase(cfg, beta, pos, box, dev, path, steps, dtype)
            for path, steps, dtype in (
                ('half', MD_STEPS, torch.float64),
                ('full', MD_STEPS, torch.float64),
                ('bf16', BF16_MD_STEPS, torch.float32))}
    for dtype in (torch.float64, torch.float32):
        stats[dtype].update(neighbor_phase(pos, box, dev, dtype))
    runs['device'] = device_loop_phase(cfg, beta, pos, box, dev)
    sharded_counts, sharded_numbers = sharded_phase(
        cfg, beta, pos, box, nbr_idx, mask, disp, dev, runs['device'][1])
    serve_counts, serve_numbers, y_lanes = serve_phase(dev)
    print('serve: ' + json.dumps(serve_numbers), flush=True)
    durable_counts, durable_numbers = durability_phase(dev)
    print('durability: ' + json.dumps(durable_numbers), flush=True)
    pe = {p: runs[p][1][-1]['pe'] for p in ('half', 'full')}
    d_pe = abs(pe['full'] - pe['half']) / abs(pe['half'])
    check(d_pe <= MD_PE_TOL, f'md: full-plane PE at step {MD_STEPS} '
          f'{pe["full"]:.12f} vs half-plane {pe["half"]:.12f} eV (rel diff '
          f'{d_pe:.3e}, bar {MD_PE_TOL:.0e})')
    big = big_phase(dev)
    print('baseline: ' + json.dumps(baseline_phase(dev)), flush=True)
    print('fit: ' + json.dumps(fit_phase(dev)), flush=True)
    analysis_counts, analysis_numbers = analysis_phase(dev)
    print('analysis: ' + json.dumps(analysis_numbers), flush=True)
    example_counts, example_numbers = examples_phase(dev)
    print('examples: ' + json.dumps(example_numbers, default=str),
          flush=True)
    print('lm: ' + json.dumps(lm_phase(dev)), flush=True)
    # each phase of this slice launched every kernel of its path
    check(all(analysis_counts[k] > 0 for k in KERNELS),
          f'analysis: every kernel launched ({analysis_counts})')
    check(all(example_counts[k] > 0 for k in PATHS['device']),
          f'examples: every kernel of the device-loop and serving path '
          f'launched ({example_counts})')

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
                     dtype=dt, path=path,
                     launches_device_loop=runs['device'][0][name],
                     launches_serve=serve_counts[name],
                     launches_durability=durable_counts[name],
                     launches_analysis=analysis_counts[name],
                     launches_examples=example_counts[name])
        other, sfx = ((torch.float32, 'f32') if dt == 'float64'
                      else (torch.float64, 'f64'))
        entry.update({f'{k}_{sfx}': v
                      for k, v in stats[other][name].items()})
        if name in big:
            entry.update({f'{k}_2j14_f32': v for k, v in big[name].items()})
        if name == 'assemble_forces':   # the offset form, on 2 ranks
            entry.update(sharded_numbers,
                         launches_sharded=sharded_counts[name])
        if name == 'snap_y_half':   # a coefficient row a lane (serving)
            for dtype, st in y_lanes.items():
                entry.update({f'{k}_lanes_{str(dtype)[6:]}': v
                              for k, v in st.items()})
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
