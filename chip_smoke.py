#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SNAP on one NVIDIA card.

    python3 chip_smoke.py

Builds every hand-written CUDA kernel of the port from
``src/repro_torch/kernels/csrc`` (U, Y and fused dE on half and on full
planes, the bfloat16 Y operand option, the by-destination index and the
deterministic force assembly), holds each one against its plain PyTorch
version (the index bitwise) at the paper's
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
in an overflow case, on positions with signed zeros (atoms at +0.0 and
-0.0, two at one place, one 2.5 boxes out) and in a gated call with
trigger 0 (its device time over 400 calls); 20 steps of the device loop's
chunk on them (skin 0.01 A, rebuilds firing) are bitwise equal to the same
steps on their plain versions in float64 and float32.  Then this slice's
main path, ``run_nve(loop='device', impl='kernel')`` (half planes, float64,
skin 0.4 A, max_nbors 40, 300 K), runs 20 steps in chunks of 10 with the
counters set to 0 before and read after, is timed again and profiled; one
chunk runs under CUDA sync debug mode; a run with a 0.01 A skin (rebuilds
firing) is held against ``loop='scan', rebuild_every=1``; 10 steps +
``save_md_checkpoint`` + restore + 10 steps against 20 straight; and a
``nan_force`` fault is rolled back.  The serving phase drives
``repro_torch.launch.serve_forces.ForceServer`` (snap-2j8's model class,
buckets n_pad 128 and 2048, lists 32 and 64 wide, batch 4, each lane its
own beta): the batched brute build's kernel (``csrc/brute_neighbors.cu``)
bitwise against its plain version on the card and on the CPU in float64
and float32, in every lane of both buckets and on the edge-case batch
(``repro_torch.md.edge_cases``), its pair sets against the host build, and
a batched evaluation on the kernel's lists bitwise against the same
function on the plain build's; the batched kernel entry
(``make_batched_force_fn``) against the same function on the plain build,
stages and assembly in float64 and float32, and the assembly kernel
against its plain version on the batched path's own inputs (8192 atoms,
lane-offset lists); the Y kernel with a coefficient row a lane at 4 x 2048
against its plain version (equal rows give the one-row bits); a solo
2000-atom request against ``snap_force_pipeline`` and the float64 adjoint,
and the float32 adjoint against the float64 one; a batch of a healthy, a
NaN-poisoned, an overflowing and a healthy request (typed failures, the
peers bitwise equal to solo evaluations), one launch of each of the brute
build, U, Y, fused dE and the assembly a batched step, one build a bucket,
no host synchronization in a batched evaluation, no degradation on clean
runs; quarantine after two injected kernel faults; and a timed open-loop
run of 40 requests (sizes 128 and 2000 from seed 0, exponential arrivals
at 200 a second, 15 % poisoned) with the launch counters set to 0 before
and read after, the same at 400 requests for the tail, 400 clean requests
offered at 5000 a second for the rate the service sustains, ms per batched
step a bucket and a profile of one n2048 batched evaluation (the brute
build's kernel and plain device times, in float64 and float32, beside its
bound).  The durability phase drives
``repro_torch.launch.chaos.run_chaos_soak`` on the card: the reference's
CI plan at 2J = 2 (8 requests, 25 % poisoned, kernel faults from the first
step, crashes at dispatches 2 and 4, a 6-request burst; each step charged
0.25 s of virtual time so the burst sheds as behind the reference's
interpret-mode steps) with its checks; then the tail run's schedule
through the serving table (400 requests, crashes at dispatches 60 and 180
with torn journal tails, a snapshot every 8 steps) with the launch
counters set to 0 before and read after: the five invariants, three
incarnations, every completed result bitwise equal to a fresh server's
solo evaluation, one build a bucket an incarnation, no degraded step, one
launch of each of the brute build, U, Y, fused dE and the assembly in
every batched step after a restore, and no host synchronization in a
batched evaluation of replayed requests.  It times ``submit`` without and
with a journal (fsync every 16 appends and every append, 128 and 2000
atoms), the tail and capacity runs without and with a journal in turns, a
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
extended sequence); and one profiled gemma3-1b decode step.  The train
phase drives the language-model training path (``train_loss`` with
remat, ``launch.steps.make_train_step``, ``optim``, ``launch.train``; no
kernel of its own): each reduced arch's loss and every gradient leaf in
float32 on the card against the CPU, a step twice from one state bitwise
(on a miss it names the ops without a deterministic path) and a step
under CUDA sync debug mode; ``launch.train.main`` on the card for
gemma3-1b, granite-moe-1b-a400m and arctic-480b (int8 moments, bf16
parameters) reduced, 4 steps with checkpoints, the same command resumed
to 6, and 6 straight, bitwise; ``make_dp_compressed_grad`` on 2 gloo
ranks of the card; gemma3-1b at full width and depth (B=4, S=4096, bf16
compute, f32 master weights and moments) with and without
``REPRO_FLASH_VJP=1``, and granite-moe-1b-a400m at full width and depth
with its 4 microbatches: 3 steps each, the last two timed and under CUDA
sync debug mode, tok/s and peak memory; one more step of gemma3-1b
(without the flash backward) and of granite-moe profiled.  The mesh
phase drives the mesh slice (``launch/compat``, ``mesh``, ``sharding``,
``dryrun``; ``models/specs``, ``shard_utils``; no kernel of its own):
granite-moe-1b-a400m and gemma3-1b reduced (float32 state) on a (2, 2)
('data', 'model') mesh of 4 gloo ranks of the card, parameters and
moments DTensors placed by ``param_shardings`` and ``opt_shardings``,
3 steps of ``make_train_step`` under ``set_mesh`` against the one-rank
step on the card (the first step's loss and gradients, the parameters
after each step), ms a step of both; a checkpoint saved from a (4,)
mesh and restored onto (2, 2) with P('model', 'data'); ``launch.train``
on 2 ranks of the card (its debug mesh (1, 2)): 4 steps and a
checkpoint, then 2 from the restore, against 6 straight; and the dry
run, started in two subprocesses at the beginning of the run (it needs
no card): the one-rank prediction of gemma3-1b's full-width B=4,
S=4096 step held against the train phase's measured peak of that step,
with the achieved TFLOP/s of the measured step time, and ``python -m
repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh
both`` writing two ``ok`` records.  At
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
teacher forcing |d| <= 2e-3 + 2e-3 |ref| (the reference's bar); train:
card vs CPU 1e-4 relative to each leaf's largest value, steps and
restarts bitwise, the compressed gradient < 2e-2 relative (the
reference test's bar), the flash backward's first loss within 1e-3 of
plain autograd's; mesh: sharded vs one rank 1e-4 relative to each
leaf's largest value (the train phase's card bar) for the first step's
loss and gradients and the parameters after the 3 steps, the loss
falling and
the same on every rank, the reshard and the driver's restart bitwise,
the dry run's predicted peak within 25 % of the card's.
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

    python3 chip_smoke.py --neighbors

runs the neighbor builds' checks and times alone (build, ``ptxas``, the
cell kernels, ``cell_bin`` bitwise in every case of ``cell_bin_cases``,
the device loop on them against the plain build, the brute build on both
buckets and the edge-case batch) in about a minute, and exits nonzero if
a check failed.

    python3 chip_smoke.py --assembly

runs the force assembly's and ``cell_bin``'s checks and times alone: the
by-destination index's kernels bitwise against the plain
``destination_csr`` (snap-2j8's 26-wide lists, the device loop's 52-wide
ones, both serving buckets' lane-offset lists with sentinels, both ranks'
offset rows, a 16,000-atom box, atoms named 126 and 626 times, n_out 1,
every pair masked), the assembly against its plain version at the bars
above on the fused dE planes' view and on a contiguous copy (bitwise the
view's), twice bitwise and with a NaN in a masked slot, ``cell_bin``
bitwise; then the times of the stretch from the fused dE planes to the
forces (per call, device, device operations), of the two kernels, of
``index_add_`` and of ``cell_bin`` (2000 and 16,000 atoms, gated), the
half f64 profile's stretch and the device loop's ms a step, as one
``assembly: {...}`` line.  The times use entry points an older tree has
too: copied into an older tree, it times that tree's package (and skips
the checks), for A/B runs parent / change / change / parent in one call.
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
    # jnp scatter in the reference, no Pallas kernel: the by-destination
    # index (a counting sort) and the assembly on it
    'destination_csr': (CSRC + 'assemble_forces.cu',
                        'src/repro/core/snap.py:95'),
    'assemble_forces': (CSRC + 'assemble_forces.cu',
                        'src/repro/core/snap.py:95'),
    # the reference's jnp neighbor build (_bin_atoms, device_neighbors)
    'cell_bin': (CSRC + 'cell_list.cu', 'src/repro/md/cell_list.py:133'),
    'cell_build': (CSRC + 'cell_list.cu', 'src/repro/md/cell_list.py:159'),
    # the reference's jnp O(N^2) build, vmapped over a serving batch
    'brute_build': (CSRC + 'brute_neighbors.cu',
                    'src/repro/md/cell_list.py:204'),
}
HALF = ('snap_u_half', 'snap_y_half', 'snap_fused_de_half')
FULL = ('snap_u_full', 'snap_y_full', 'snap_fused_de_full')
ASSEMBLY = ('destination_csr', 'assemble_forces')
# the kernels each path launches once per force evaluation
PATHS = {
    'half': HALF + ASSEMBLY,
    'full': FULL + ASSEMBLY,
    'bf16': ('snap_u_half', 'snap_y_half_bf16', 'snap_fused_de_half')
    + ASSEMBLY,
    # run_nve(loop='device'): one gated rebuild (two launches) a step
    'device': HALF + ASSEMBLY + ('cell_bin', 'cell_build'),
    # ForceServer: one launch of each a batched step, whatever the batch
    'serve': HALF + ASSEMBLY + ('brute_build',),
}
# the neighbor builds: held against their plain versions in their own
# phases (neighbor, serve), not in the kernel phase
NEIGHBOR = ('cell_bin', 'cell_build', 'brute_build')
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
# the train phase: reduced archs at B x S (float32, card vs CPU); the archs
# whose restarts through launch.train are checked (their policies: f32,
# f32 with 4 microbatches, int8 moments with bf16 parameters and 4
# microbatches);
# full width and depth at train_4k's S = 4096, the batch cut from 256 to
# 4 for one card; steps a run (the first untimed); the bar on the loss
# with the flash backward against plain autograd
TRAIN_B, TRAIN_S = 2, 32
TRAIN_RESTART = ('gemma3-1b', 'granite-moe-1b-a400m', 'arctic-480b')
TRAIN_FULL = {'gemma3-1b': (4, 4096), 'granite-moe-1b-a400m': (4, 4096)}
TRAIN_STEPS = 3
TRAIN_FLASH_TOL = 1e-3
HBM_TBS = 3.35               # TB/s, H100 SXM data sheet
SMS = 132                    # H100 SXM
STACK_MAX = 1024             # bytes of stack frame a fused dE kernel may use
DEVICE_REPS = 20             # K of device_ms
GATED_REPS = 400             # K of device_ms for a ~2 us gated launch
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
    asm = {k: v for k, v in report.items()
           if 'csr_' in k or 'assemble_forces_kernel' in k}
    check(len(asm) == 8,
          f'ptxas: {len(asm)} assembly kernels (CSR count, place and sort x '
          'int32, int64 index; the assembly x f32, f64), '
          + ', '.join(f'{k}: {v["registers"]} registers, {v.get("stack")} B '
                      'stack' for k, v in sorted(asm.items())))
    nbr = {k: v for k, v in report.items()
           if any(f'{n}_kernel' in k for n in NEIGHBOR)}
    check(len(nbr) == 10,
          f'ptxas: {len(nbr)} neighbor kernels (cell bin with its arrays in '
          'shared memory or scratch, cell build, brute build with 1 and 2 '
          'atoms a warp x f32, f64), '
          + ', '.join(f'{k}: {v["registers"]} registers, {v.get("stack")} B '
                      'stack' for k, v in sorted(nbr.items())))
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
    # the assembly reads the fused dE planes where they lie
    dview = dedr[:, :3, :NATOMS].permute(2, 0, 1)
    dmask = (dview * ok[..., None].to(dtype)).contiguous()
    nbr_t = torch.as_tensor(nbr_idx, device=dev)
    csr = destination_csr(nbr_t, NATOMS, ok)
    dest = nbr_t.reshape(-1).long()
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
        # the by-destination index: bitwise (bar 0); no one-call library
        # form computes it
        'destination_csr': (
            lambda: destination_csr(nbr_t, NATOMS, ok),
            lambda: plain_csr(nbr_t, NATOMS, ok),
            nbytes(nbr_t, ok, *csr), 4 * pairs, 0.0, None),
        'assemble_forces': (
            lambda: assemble_forces_csr(dview, *csr, 0, ok),
            lambda: assemble_forces_csr_plain(dview, *csr, 0, ok),
            nbytes(dmask, ok, *csr) + NATOMS * 3 * dmask.element_size(),
            12 * pairs, TOL[dtype],
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


# library sort kernels (cub's radix sort, ATen's sorts and searchsorted)
SORT_NAMES = ('RadixSort', 'cub::', 'Sort', 'searchsorted')


def stretch_of(prof):
    """The device operations from just after each fused dE kernel to the
    assembly kernel that ends the force evaluation, in a profile: (ops per
    stretch, device ms per stretch, wall ms per stretch from the fused dE
    kernel's end to the assembly's end, the names of one stretch), or None
    without device events."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    runs, cur = [], None
    for e in events:
        if 'snap_fused_de' in e.name:
            cur = dict(start=e.time_range.end, ops=[])
        elif cur is not None:
            cur['ops'].append(e)
            if 'assemble_forces' in e.name:
                runs.append(cur)
                cur = None
    if not runs:
        return None
    n = len(runs)
    return (sum(len(r['ops']) for r in runs) / n,
            sum(e.time_range.elapsed_us() for r in runs for e in r['ops'])
            / n / 1e3,
            sum(r['ops'][-1].time_range.end - r['start'] for r in runs)
            / n / 1e3,
            [f'{e.name[:60]} {e.time_range.elapsed_us():.2f} us'
             for e in runs[0]['ops']])


def print_stretch(label, st):
    """Print and check :func:`stretch_of`'s result: no library sort
    between the fused dE kernel and the forces."""
    if st is None:
        print(f'     {label}: no fused dE -> assembly stretch in the '
              'profile (device time not measured)', flush=True)
        return None
    n_ops, dev_ms, wall_ms, names = st
    print(f'     {label}: {n_ops:.1f} device operations from the fused dE '
          f'kernel to the forces, {dev_ms:.4f} ms device, {wall_ms:.4f} ms '
          f'from the fused dE kernel\'s end to the forces: {names}',
          flush=True)
    sorts = [n for n in names if any(k in n for k in SORT_NAMES)]
    check(not sorts, f'{label}: no library sort or searchsorted between the '
          f'fused dE kernel and the forces ({sorts or "none"})')
    return dict(ops=n_ops, device_ms=dev_ms, wall_ms=wall_ms, names=names)


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
    print_stretch(f'profile {layout} f64 assembly stretch', stretch_of(prof))
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


def signed_zero_positions(pos, box):
    """snap-2j8's positions with signed zeros where the minimum image must
    keep the division's bits: atoms 0 and 1 at +0.0 and -0.0, atoms 2 and
    3 at one place, -0.0 coordinates on atom 4, atom 5 2.5 boxes out."""
    z = np.array(pos, dtype=np.float64)
    z[0], z[1], z[3] = 0.0, -0.0, z[2]
    z[4, [0, 2]] = -0.0
    z[5] += 2.5 * np.asarray(box)
    return z


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
    # signed zeros: atoms at +0.0 and -0.0, two at one place, -0.0
    # coordinates, an atom 2.5 boxes out (the minimum image's division)
    zpos = signed_zero_positions(pos, box)
    z_t = torch.as_tensor(zpos, dtype=dtype, device=dev)
    z_k = cl.device_neighbors(z_t, box_t, grid)
    z_p = kn.neighbors_plain(z_t, box_t, grid)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(z_k, z_p)),
          f'neighbors {dt} signed zeros: kernel vs plain bitwise equal on '
          f'nbr_idx, mask, shifts (signs of zero included) and flags '
          f'(flags {z_k[3].tolist()})')
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
    gated = {   # trigger 0: the launch of a step that does not rebuild
        'cell_bin': lambda: kn.cell_bin(pos_t, box_t, grid, zero, flags_k),
        'cell_build': lambda: kn.cell_build(pos_t, box_t, grid, table_p,
                                            zero, *out_k)}
    stats = {}
    for name, (kern, plain, got_t, ref_t, nb, flops) in cases.items():
        same = all(torch.equal(a, b) for a, b in zip(got_t, ref_t))
        abs_err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got_t, ref_t))
        check(same, f'{name} {dt}: kernel vs plain bitwise equal on the same '
              f'inputs (max abs err {abs_err:.3e})')
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
        dev_ms, hidden = device_ms(kern)
        gated_ms, _ = device_ms(gated[name], k=GATED_REPS)
        b_ms, b_by = bound(nb, flops, dtype)
        print(f'     {name} {dt}: {ms:.4f} ms per call, {dev_ms:.4f} ms '
              f'device{"" if hidden else " (host time leaked in)"}, '
              f'{gated_ms * 1e3:.2f} us device a gated launch (plain '
              f'{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by}; '
              f'{flops / 1e6:.2f} MFLOP, {nb / 1e6:.3f} MB, {cand} '
              'candidate pairs)', flush=True)
        stats[name] = dict(max_abs_err=abs_err, max_rel_err=0.0 if same
                           else float('inf'), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           device_ms=dev_ms, device_ms_hidden=hidden,
                           gated_device_ms=gated_ms,
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


def device_loop_bitwise(cfg, beta, pos, box, dev):
    """20 steps of the device loop's chunk (two chunks of 10, skin 0.01 A so
    that rebuilds fire) on the cell kernels, against the same chunks with
    md/cell_list's cell_bin and cell_build swapped for their plain versions,
    in float64 and float32: positions, velocities, forces, energies, lists,
    pos_ref and flags bitwise equal, and the kernel run launched cell_build
    once a step."""
    from repro_torch.kernels import neighbors as kn
    from repro_torch.kernels import ops
    from repro_torch.md import cell_list as cl
    from repro_torch.md.integrate import (W_MASS, _full_flags, _seed_force,
                                          init_velocities,
                                          make_device_chunk_fn,
                                          make_force_fn)
    vel = init_velocities(NATOMS, 300.0)
    grid = device_grid(pos, box, SMALL_SKIN)
    for dtype in (torch.float64, torch.float32):
        force_fn = make_force_fn(cfg, beta, 0.0, 'kernel', device=dev,
                                 dtype=dtype)
        chunk = make_device_chunk_fn(cfg, 0.0005, W_MASS, grid, force_fn,
                                     DEVICE_LOG)

        def run():
            p, v, b = (torch.tensor(a, dtype=dtype, device=dev)
                       for a in (pos, vel, box))
            ni, ms, sh, fl = cl.device_neighbors(p, b, grid)
            _, f = _seed_force(force_fn, cfg, p, ni, sh, ms)
            carry, rows, rebuilt = (p, v, f, ni, sh, ms, p,
                                    _full_flags(fl)), [], 0
            for _ in range(DEVICE_STEPS // DEVICE_LOG):
                out = chunk(*carry[:3], b, *carry[3:], 0.0)
                carry = out[:3] + out[3:8]
                rows.append(out[8])
                rebuilt += int(out[9])
            torch.cuda.synchronize()
            return carry + (torch.cat(rows),), rebuilt
        ops.reset_launch_counts()
        got, rebuilt = run()
        launched = ops.launch_counts()['cell_build']
        with mock.patch.object(cl, 'cell_bin', kn.cell_bin_plain), \
                mock.patch.object(cl, 'cell_build', kn.cell_build_plain):
            want, rebuilt_p = run()
        names = ('pos', 'vel', 'forces', 'nbr_idx', 'shifts', 'mask',
                 'pos_ref', 'flags', 'energies')
        diff = [n for n, a, b in zip(names, got, want)
                if not torch.equal(a, b)]
        check(not diff and rebuilt == rebuilt_p > 0
              and launched == DEVICE_STEPS + 1,
              f'device loop {str(dtype)[6:]}, skin {SMALL_SKIN} A: '
              f'{DEVICE_STEPS} steps on the cell kernels ({rebuilt} rebuilds, '
              f'{launched} cell_build launches incl. the seed build) bitwise '
              f'equal to the same steps on the plain cell build in '
              f'{", ".join(names)} (differ: {diff or "none"})')


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


def plain_brute_build(*args, out=None):
    """The plain build in the kernel wrapper's place (a batched step passes
    its own outputs; the plain version returns new ones)."""
    from repro_torch.kernels import neighbors as kn
    return kn.brute_build_plain(*args)


def serve_neighbor_checks(batches, dev):
    """The batched brute build on the card: the kernel's four outputs
    bitwise against its plain version on the card and on the CPU (float64
    and float32, every lane of both buckets and the edge-case batch), its
    pair sets against the host build (float64), and the batched
    evaluation on the kernel's lists bitwise against the same function on
    the plain build's (float32 and float64 compute, both buckets)."""
    from repro_torch.kernels import neighbors as kn
    from repro_torch.kernels import ops
    from repro_torch.md import cell_list as cl
    from repro_torch.md.edge_cases import (EDGE_K, EDGE_RCUT,
                                           brute_edge_batch)
    from repro_torch.md.neighbor import brute_neighbors
    cases = []      # (what, bucket n_pad for the pair-set check, args)
    for n_pad, (bucket, a) in batches.items():
        for dtype in (torch.float64, torch.float32):
            cases.append((f'n{n_pad} {str(dtype)[6:]}',
                          n_pad if dtype == torch.float64 else None,
                          (a['pos'].to(dtype), a['box'].to(dtype), RCUT,
                           bucket.max_nbors, a['n_valid'])))
    for dtype in (np.float64, np.float32):
        pos, box, n_valid = brute_edge_batch(dtype)
        cases.append((f'edge-case batch {dtype.__name__}', None, (
            torch.as_tensor(pos, device=dev), torch.as_tensor(box, device=dev),
            EDGE_RCUT, EDGE_K, torch.as_tensor(n_valid, device=dev))))
    for what, n_pad, args in cases:
        got = kn.brute_build(*args)
        plain = kn.brute_build_plain(*args)
        cpu = kn.brute_build_plain(*(t.cpu() if isinstance(t, torch.Tensor)
                                     else t for t in args))
        torch.cuda.synchronize()
        on_card = all(torch.equal(g, p) for g, p in zip(got, plain))
        on_cpu = all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu))
        check(on_card and on_cpu,
              f'serve brute_build {what}: kernel vs plain bitwise on nbr_idx '
              f'{list(got[0].shape)}, mask, disp and flags, on the card '
              f'({on_card}) and on the CPU ({on_cpu}); counts '
              f'{got[3][:, 0].tolist()} (K {got[0].shape[2]}), n_valid '
              f'{args[4].tolist()}')
        if n_pad is None:
            continue
        ni, m = got[0].cpu().numpy(), got[1].cpu().numpy()
        pairs = True
        for b in range(SERVE_BATCH):
            n = int(args[4][b])
            h_idx, h_mask, _, _ = brute_neighbors(
                args[0][b, :n].cpu().numpy(), args[1][b].cpu().numpy(),
                RCUT, args[3])
            pairs &= all(set(ni[b, i, m[b, i]]) == set(h_idx[i, h_mask[i]])
                         for i in range(n))
        check(pairs, f'serve brute_build n{n_pad} float64 on the card: pair '
              f'sets equal to the host brute_neighbors in all '
              f'{SERVE_BATCH} lanes')
    # the batched evaluation on the kernel's lists vs on the plain build's
    for n_pad, (bucket, a) in batches.items():
        for dtype in (torch.float32, torch.float64):
            fn = serve_fn(bucket, dev, dtype)
            ops.reset_launch_counts()
            e_k, f_k, fl_k = fn(**a)
            kernel_launches = ops.launch_counts()['brute_build']
            with mock.patch.object(cl, 'brute_build', plain_brute_build):
                e_p, f_p, fl_p = fn(**a)
            torch.cuda.synchronize()
            plain_launches = ops.launch_counts()['brute_build'] - \
                kernel_launches
            check(torch.equal(e_k, e_p) and torch.equal(f_k, f_p)
                  and torch.equal(fl_k, fl_p) and kernel_launches == 1
                  and plain_launches == 0,
                  f'serve batched evaluation n{n_pad} {str(dtype)[6:]}: on '
                  f'the brute_build kernel\'s lists ({kernel_launches} '
                  f'launch) bitwise equal to the same function on the plain '
                  f'build\'s ({plain_launches} launches): energies, forces, '
                  f'flags')


def serve_kernel_checks(batches, dev):
    """The batched kernel entry against the same batched function built
    from the plain neighbor build, stages and assembly (f64 and f32, both
    buckets); the assembly kernel against its plain version on the dE/dr,
    lane-offset lists and sentinels the batched path gave it; the per-lane
    Y kernel against its plain version at 4 x 2048 with times and bound;
    one row a lane equal to one row (bitwise)."""
    from repro_torch.core import snap as core_snap
    from repro_torch.core.snap import SnapConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import neighbors as kn
    from repro_torch.kernels.assemble import assemble_forces_csr_plain
    from repro_torch.kernels.snap_y import (snap_y_half, snap_y_half_plain,
                                            y_coef_half, y_launch_tables)
    from repro_torch.kernels.launch_plan import y_plan
    from repro_torch.kernels.snap_u import snap_u_half_plain
    from repro_torch.md import cell_list as cl
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
                                      assemble_forces_csr_plain), \
                    mock.patch.object(core_snap, 'destination_csr',
                                      plain_csr), \
                    mock.patch.object(cl, 'brute_build',
                                      plain_brute_build):
                e_p, f_p, fl_p = fn(**a)
            plain_launches = sum(ops.launch_counts().values())
            _, err_f = rel_err(f_k, f_p)
            _, err_e = rel_err(e_k, e_p)
            bar = TOL[dtype]
            check(err_f <= bar and err_e <= bar and torch.equal(fl_k, fl_p)
                  and plain_launches == 0,
                  f'serve batched kernel entry n{n_pad} {str(dtype)[6:]} vs '
                  f'the same function on the plain build, stages and assembly '
                  f'({plain_launches} kernel launches): forces {err_f:.3e}'
                  f', energies {err_e:.3e} (bar {bar:.0e}), flags equal; '
                  f'E {[round(float(x), 6) for x in e_k]} eV')
            # the assembly alone on the inputs the batched path gave it
            dedr, nbr, ok, natoms = seen[0]
            got = core_snap.assemble_forces(*seen[0])
            with mock.patch.object(core_snap, 'assemble_forces_csr',
                                   assemble_forces_csr_plain), \
                    mock.patch.object(core_snap, 'destination_csr',
                                      plain_csr):
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


def brute_timing(bucket, a):
    """The brute build alone on a packed batch ``a`` of ``bucket``, kernel
    and plain version, on its float64 positions and on the same positions
    in float32: {dtype: numbers of the kernels line}; ``ms`` per call into
    outputs kept from call to call (``brute_outputs``, as a bucket's step
    calls it; an older package without them allocates), ``ms_outputs_made``
    with outputs made at the call.  The bound: positions,
    boxes and counts read once, lists, masks, displacements and flags
    written once; 20 operations (3 sub, 3 div, 3 rint, 3 mul, 3 sub, 5 for
    r2, 1 compare) a pair the kernel tests, each valid atom of a lane
    against the lane's other valid atoms."""
    from repro_torch.kernels import neighbors as kn
    n_valid = a['n_valid'].tolist()
    pairs = sum(n * (n - 1) for n in n_valid)
    dev = a['pos'].device
    brute = {}
    for dtype in (torch.float64, torch.float32):
        args = (a['pos'].to(dtype), a['box'].to(dtype), RCUT,
                bucket.max_nbors, a['n_valid'])
        got, ref = kn.brute_build(*args), kn.brute_build_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        abs_err = max(float((g.double() - r.double()).abs().max())
                      for g, r in zip(got, ref))
        nb = nbytes(*args[:2], args[4], *got)
        b_ms, b_by = bound(nb, 20 * pairs, dtype)
        # per call as a bucket's step calls it: into the outputs it keeps
        # (brute_outputs), and with outputs made at the call
        out = (kn.brute_outputs(*got[0].shape[:2], args[3], dtype, dev)
               if hasattr(kn, 'brute_outputs') else None)
        kern = ((lambda: kn.brute_build(*args, out=out)) if out is not None
                else (lambda: kn.brute_build(*args)))
        ms, ms_made = time_ms(kern), time_ms(lambda: kn.brute_build(*args))
        plain_ms = time_ms(lambda: kn.brute_build_plain(*args), reps=5)
        dev_ms, hidden = device_ms(kern, k=5)
        plain_dev, plain_hidden = device_ms(
            lambda: kn.brute_build_plain(*args), k=5)
        dt = str(dtype)[6:]
        print(f'     brute_build n{bucket.n_pad} {dt} ({SERVE_BATCH} lanes, '
              f'n_valid {n_valid}): {ms:.4f} ms per call ({ms_made:.4f} with '
              f'its outputs made at the call), {dev_ms:.4f} ms '
              f'device{"" if hidden else " (host time leaked in)"}; plain '
              f'{plain_ms:.4f} ms per call, {plain_dev:.4f} ms device; bound '
              f'{b_ms:.5f} ms by {b_by} ({pairs} pairs, {nb / 1e6:.3f} MB); '
              f'kernel vs plain bitwise {same}', flush=True)
        brute[dtype] = dict(max_abs_err=abs_err, max_rel_err=0.0 if same
                            else float('inf'), ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            device_ms=dev_ms, device_ms_hidden=hidden,
                            plain_device_ms=plain_dev,
                            plain_device_ms_hidden=plain_hidden,
                            ms_outputs_made=ms_made,
                            library_device_ms=None, pairs=pairs)
    return brute


def serve_timing(srv, table, batches, dev):
    """The open-loop run (the serving main path: launch counters set to 0
    before, read after); a ten times longer run at the same rate for the
    tail; a run offered above capacity for the rate the service sustains;
    ms per batched step a bucket; a profile of one n2048 batched step; the
    brute build's kernel and plain version timed on that batch.  Returns
    (launch counts of the main path's run, numbers, the build's kernel
    numbers a dtype)."""
    from torch.profiler import ProfilerActivity, profile

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
             / 1e3 for k in ('brute_build', 'snap_u', 'snap_y',
                             'snap_fused_de', 'csr_', 'assemble_forces')}
    eval_ms, hidden_e = device_ms(lambda: fn(**a), k=5)
    brute = brute_timing(bucket, a)
    st = brute[a['pos'].dtype]          # the service's positions
    build_ms = st['device_ms']
    out.update(build_device_ms=build_ms, eval_device_ms=eval_ms,
               build_share=build_ms / eval_ms,
               build_plain_device_ms=st['plain_device_ms'],
               build_bound_ms=st['bound_ms'], build_bound_by=st['bound_by'],
               **{f'{k}_device_ms': v for k, v in stage.items()})
    print(f'     serve n{bucket.n_pad}: brute build {build_ms:.4f} ms device '
          f'({str(a["pos"].dtype)[6:]} positions), batched evaluation '
          f'{eval_ms:.4f} ms device (build share {build_ms / eval_ms:.3f}; '
          f'host hidden {hidden_e}); kernels in the profile: ' + ', '.join(
              f'{k} {v:.4f} ms' for k, v in stage.items()), flush=True)
    return counts, out, brute


def serve_phase(dev):
    """The batched force service at snap-2j8 (see the module docstring)."""
    t0 = time.perf_counter()
    table = default_serve_table()
    batches = serve_batches(table, dev)
    serve_neighbor_checks(batches, dev)
    y_lanes = serve_kernel_checks(batches, dev)
    srv = serve_service_checks(table, dev)
    counts, numbers, brute = serve_timing(srv, table, batches, dev)
    print(f'     serve phase: {time.perf_counter() - t0:.1f} s wall',
          flush=True)
    return counts, numbers, y_lanes, brute


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
          f'each launched one of each of the brute build, U, Y, fused dE '
          f'and the assembly '
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
    d64 = torch.randn((n_local, NNBOR, 3), generator=g, dtype=torch.float64,
                      device=dev)
    csr = destination_csr(nbr, NATOMS, ok)
    asm = dict(csr_bitwise=all(torch.equal(a, b) for a, b in zip(
        csr, plain_csr(nbr, NATOMS, ok))))
    dm = ok[..., None]
    for dtype, sfx in ((torch.float64, ''), (torch.float32, '_f32')):
        d = d64.to(dtype)

        def library():   # the index_add_ form of the same partial
            part = d.new_zeros((NATOMS, 3))
            dd = d * dm
            part[rows] = dd.sum(dim=1)
            return part.index_add_(0, nbr.reshape(-1), -dd.reshape(-1, 3))

        got = assemble_forces_csr(d, *csr, offset, ok)
        want = assemble_forces_csr_plain(d, *csr, offset, ok)
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
                        d, *csr, offset, ok)),
                    f'device_ms{sfx}': device_ms(lambda: assemble_forces_csr(
                        d, *csr, offset, ok))[0],
                    f'plain_ms{sfx}': time_ms(
                        lambda: assemble_forces_csr_plain(d, *csr, offset,
                                                          ok), reps=10),
                    f'library_ms{sfx}': time_ms(library),
                    f'library_device_ms{sfx}': device_ms(library)[0]})
                asm[f'bound_ms{sfx}'], asm[f'bound_by{sfx}'] = bound(
                    nbytes(d, ok, *csr) + NATOMS * 3 * d.element_size(),
                    12 * n_local * NNBOR, dtype)
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
        path = PATHS['half'] if impl == 'kernel' else ASSEMBLY
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
        check(a['csr_bitwise'], f'destination_csr offset form, rank '
              f'{r["rank"]} (rows {r["rank"] * NATOMS // SHARDS}.. of the '
              f'global lists, {NATOMS} output rows): bitwise the plain '
              'version')
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
        check(not an['errors'] and
              an['metrics'].get('launches') == len(ASSEMBLY),
              f'analysis force.torch.sharded rank {r["rank"]}: '
              f'{len(an["errors"])} unallowlisted finding(s) or budget '
              f'error(s) of the cuda section {an["errors"][:3]}, '
              f'{an["metrics"].get("launches")} launches a call (the '
              f'by-destination index and the assembly), peak bytes '
              f'{an["metrics"].get("peak_bytes")}; '
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


# ---------------------------------------------------------------------------
# the language-model training path (models' losses and remat, flash_vjp,
# optim/, launch/steps.py, launch/train.py)
# ---------------------------------------------------------------------------

def train_grads(cfg, params, batch):
    """(loss, {path: gradient}) of ``train_loss`` (remat on)."""
    from repro_torch.models.transformer import train_loss, value_and_grad
    return value_and_grad(lambda p: train_loss(cfg, p, batch), params)


def train_batch(cfg, B, S, g, dev):
    """tokens, labels and the frontend stream (as the serving CLI draws
    it), drawn on the generator's device and placed on ``dev``."""
    from repro_torch.launch.serve import random_inputs
    tokens, front = random_inputs(cfg, B, S, g, dev)
    batch = dict(tokens=tokens, labels=torch.randint(
        0, cfg.vocab, (B, S), generator=g, device=g.device).to(dev))
    if front is not None:
        batch['frontend'] = front
    return batch


def nondeterministic_ops(fn):
    """The ops ``fn`` runs that have no deterministic path on the card
    (``torch.use_deterministic_algorithms``' warnings)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:160] for w in caught})


def step_without_sync(step, params, opt, batch):
    """One train step under CUDA sync debug mode 'error': (its output,
    None) or (None, the first line of the sync error)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        return step(params, opt, batch), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def train_reduced(dev):
    """Each reduced arch in float32: ``train_loss`` and every gradient
    leaf on the card against the CPU from the same weights and batch
    (drawn on the CPU); one ``make_train_step`` step twice from one state,
    bitwise (on a miss, the ops without a deterministic path are named);
    one step under CUDA sync debug mode."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params, tree_map
    from repro_torch.optim.adamw import adamw_init
    worst = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        g = torch.Generator().manual_seed(100 + ARCHS.index(arch))
        params = init_params(cfg, g, 'cpu')
        batch = train_batch(cfg, TRAIN_B, TRAIN_S, g, 'cpu')
        out = {}
        for d in ('cpu', dev):
            out[d] = train_grads(cfg, tree_map(lambda t: t.to(d), params),
                                 {k: v.to(d) for k, v in batch.items()})
        errs = [rel_err(out[dev][0].cpu(), out['cpu'][0])[1]] + [
            rel_err(gr.cpu(), out['cpu'][1][p])[1]
            for p, gr in out[dev][1].items()]
        worst[arch] = max(errs)
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        step = make_train_step(cfg, device=dev)

        def run():
            pp = lm_clone(p)
            return step(pp, adamw_init(pp), b)
        twice = [run() for _ in range(2)]
        bitwise = all(lm_equal(twice[0][i], twice[1][i]) for i in (0, 1)) \
            and torch.equal(twice[0][2]['loss'], twice[1][2]['loss'])
        del twice
        pp = lm_clone(p)
        _, sync_error = step_without_sync(step, pp, adamw_init(pp), b)
        check(worst[arch] <= LM_TOL and bitwise and sync_error is None,
              f'train reduced {arch}: card vs CPU, train_loss and '
              f'{len(out["cpu"][1])} gradient leaves, max rel err '
              f'{worst[arch]:.3e} (bar {LM_TOL:.0e}); a step twice bitwise '
              f'{bitwise}; host syncs in a step: '
              f'{"none" if sync_error is None else sync_error}')
        if not bitwise:
            print(f'     train reduced {arch}: ops without a deterministic '
                  f'path: {nondeterministic_ops(run)}', flush=True)
    return worst


def train_restart(dev, tmp):
    """``python -m repro_torch.launch.train`` on the card (its main, in
    process), per arch of TRAIN_RESTART under its policy: 4 steps with a
    checkpoint every 2, the same command to 6 (it restores step 4), and 6
    straight; the parameters and AdamW state bitwise equal."""
    import contextlib
    import io
    from repro_torch.launch import train
    from repro_torch.runtime.checkpoint import _flatten, latest_step
    ok = {}
    for arch in TRAIN_RESTART:
        argv = ['--arch', arch, '--reduced', '--steps', '4', '--batch', '4',
                '--seq', '32', '--ckpt', f'{tmp}/{arch}', '--ckpt-every',
                '2', '--log-every', '100', '--device', dev.type]
        with contextlib.redirect_stdout(io.StringIO()) as log:
            train.main(argv)
            argv[argv.index('--steps') + 1] = '6'
            resumed = train.main(argv)
            straight = train.main(argv[:argv.index('--ckpt')]
                                  + ['--device', dev.type])
        a = dict(_flatten({'p': resumed['params'], 'o': resumed['opt']}))
        b = dict(_flatten({'p': straight['params'], 'o': straight['opt']}))
        ok[arch] = (sorted(a) == sorted(b)
                    and all(torch.equal(a[k], b[k]) for k in a)
                    and resumed['start_step'] == 4
                    and latest_step(f'{tmp}/{arch}') == 6)
        policy = log.getvalue().splitlines()[0].split('policy=')[-1]
        check(ok[arch], f'train restart {arch} (reduced, policy {policy}): '
              f'4 steps + checkpoint + 2 from the restore vs 6 straight, '
              f'{len(a)} leaves bitwise {ok[arch]}')
    return ok


def train_full(dev, arch, B, S, flash, profile=False):
    """One arch at full width and depth under its policy (bf16 compute,
    its master and moment dtypes, its microbatches), weights drawn on the
    card: TRAIN_STEPS steps from an emptied allocator, the steps after the
    first under CUDA sync debug mode and timed (host clock, each ending in
    a synchronize); ``flash`` sets REPRO_FLASH_VJP=1.  Returns the row."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          train_policy)
    from repro_torch.models.transformer import param_count
    cfg = get_config(arch)
    pol = train_policy(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if flash:
        os.environ['REPRO_FLASH_VJP'] = '1'
    try:
        params, opt = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0),
            state_dtype=pol['state_dtype'], param_dtype=pol['param_dtype'],
            device=dev)
        n_params = param_count(params)
        data = SyntheticTokens(vocab=cfg.vocab, seq=S, global_batch=B)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in data.next_batch().items()}
                   for _ in range(TRAIN_STEPS + profile)]
        step = make_train_step(cfg, state_dtype=pol['state_dtype'],
                               microbatches=pol['microbatches'], device=dev)
        losses, times, sync_error = [], [], None
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i:
                out, sync_error = step_without_sync(step, params, opt,
                                                    batches[i])
                if sync_error is not None:
                    break
            else:
                out = step(params, opt, batches[i])
            params, opt, metrics = out
            out = None
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics['loss'])
        losses = [float(x) for x in losses]
        peak = peak_gb()
        if profile and sync_error is None:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, opt, batches[-1])
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            profile_summary(prof, wall_us, 1, f'train profile {arch} '
                            f'(B={B} S={S}, bf16)', 'step', 10)
    finally:
        os.environ.pop('REPRO_FLASH_VJP', None)
    del params, opt, batches
    ms = statistics.mean(times[1:]) * 1e3 if len(times) > 1 else None
    row = dict(arch=arch, layers=cfg.n_layers, params=n_params, B=B, S=S,
               flash_vjp=flash, policy=pol, losses=losses,
               step_ms=[t * 1e3 for t in times], ms_step=ms,
               tok_s=B * S / ms * 1e3 if ms else None, peak_gb=peak)
    finite = len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
    check(finite and sync_error is None,
          f'train full {arch} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B '
          f'params, B={B} S={S}, microbatches {pol["microbatches"]}, '
          f'REPRO_FLASH_VJP {int(flash)}): {len(losses)} steps, losses '
          f'{[round(x, 4) for x in losses]} finite {finite}; host syncs in '
          f'steps 2-{TRAIN_STEPS}: '
          f'{"none" if sync_error is None else sync_error}')
    if ms:
        print(f'     train {arch}{" flash_vjp" if flash else ""}: '
              f'{ms:.1f} ms a step (steps 2-{TRAIN_STEPS}: '
              f'{[round(t * 1e3, 1) for t in times[1:]]}), '
              f'{row["tok_s"]:.0f} tok/s, peak {peak:.3f} GB', flush=True)
    return row


def train_compressed_rank(rank, dev):
    """One rank of a 2-rank gloo group on one card: the compressed
    data-parallel gradient of reduced gemma3-1b's ``train_loss`` on this
    rank's half of the batch, and of the reference test's linear least
    squares."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (init_params, train_loss,
                                                tree_leaves, tree_map)
    from repro_torch.optim.compression import make_dp_compressed_grad
    cfg = get_config('gemma3-1b').reduced()
    g = torch.Generator().manual_seed(7)
    params = tree_map(lambda t: t.to(dev), init_params(cfg, g, 'cpu'))
    batch = train_batch(cfg, 2 * TRAIN_B, TRAIN_S, g, dev)
    half = {k: v[rank * TRAIN_B:(rank + 1) * TRAIN_B]
            for k, v in batch.items()}
    loss, grads = make_dp_compressed_grad(
        lambda p, b: train_loss(cfg, p, b))(params, half)
    rng = np.random.default_rng(11)
    w, x, y = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=dev)
               for s in ((16, 4), (32, 16), (32, 4)))
    lin_loss, lin = make_dp_compressed_grad(
        lambda p, b: torch.mean((b[0] @ p['w'] - b[1]) ** 2))(
        {'w': w}, (x[rank * 16:(rank + 1) * 16], y[rank * 16:(rank + 1) * 16]))
    return dict(backend=dist.get_backend(), device=str(loss.device),
                loss=float(loss),
                grads={p: t.cpu().numpy() for p, t in tree_leaves(grads)},
                lin=lin['w'].cpu().numpy(), lin_loss=float(lin_loss))


def train_compressed(dev):
    """``make_dp_compressed_grad`` over the 2 gloo ranks of one card
    against the exact gradient on the card: max |error| / max |exact|
    below 0.02 (the reference test's bar) in every leaf."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import spawn_ranks
    from repro_torch.models.transformer import init_params, tree_map
    cfg = get_config('gemma3-1b').reduced()
    g = torch.Generator().manual_seed(7)
    params = tree_map(lambda t: t.to(dev), init_params(cfg, g, 'cpu'))
    batch = train_batch(cfg, 2 * TRAIN_B, TRAIN_S, g, dev)
    loss, exact = train_grads(cfg, params, batch)
    rng = np.random.default_rng(11)
    w, x, y = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=dev).requires_grad_(s == (16, 4))
               for s in ((16, 4), (32, 16), (32, 4)))
    lin_loss = torch.mean((x @ w - y) ** 2)
    (lin,) = torch.autograd.grad(lin_loss, [w])
    t0 = time.perf_counter()
    ranks = spawn_ranks(train_compressed_rank, 2, str(dev))
    wall = time.perf_counter() - t0
    worst = max(float(np.abs(r['grads'][p] - e.cpu().numpy()).max()
                      / float(e.abs().max())) for r in ranks
                for p, e in exact.items())
    lin_err = max(float(np.abs(r['lin'] - lin.cpu().numpy()).max()
                        / float(lin.abs().max())) for r in ranks)
    d_loss = max(abs(r['loss'] - float(loss)) / float(loss) for r in ranks)
    ok = worst < 0.02 and lin_err < 0.02 and d_loss <= 1e-5
    check(ok, f'train compressed: make_dp_compressed_grad on 2 '
          f'{ranks[0]["backend"]} ranks of one card (tensors on '
          f'{ranks[0]["device"]}), reduced gemma3-1b {len(exact)} leaves '
          f'max rel err {worst:.3e}, linear {lin_err:.3e} (bar 2e-2); loss '
          f'vs the full batch {d_loss:.3e} (bar 1e-5); {wall:.1f} s wall')
    return dict(backend=ranks[0]['backend'], max_rel_err=worst,
                linear_rel_err=lin_err, loss_rel_err=d_loss, wall_s=wall)


def train_phase(dev):
    """The language-model training path on the card: every arch reduced
    against the CPU, restarts through ``launch.train``, gemma3-1b at full
    width with and without the flash backward, granite-moe at full width,
    and the compressed reduction on 2 ranks.  ``allow_tf32`` is off (main sets
    it)."""
    t0 = time.perf_counter()
    numbers = dict(reduced_max_rel_err=train_reduced(dev))
    with tempfile.TemporaryDirectory() as tmp:
        numbers['restart_bitwise'] = train_restart(dev, tmp)
    numbers['compressed'] = train_compressed(dev)
    full = [train_full(dev, 'gemma3-1b', *TRAIN_FULL['gemma3-1b'], False,
                       profile=True),
            train_full(dev, 'gemma3-1b', *TRAIN_FULL['gemma3-1b'], True)]
    d = abs(full[1]['losses'][0] - full[0]['losses'][0]) / abs(
        full[0]['losses'][0])
    check(d <= TRAIN_FLASH_TOL, f'train full gemma3-1b: the first step\'s '
          f'loss with REPRO_FLASH_VJP=1 vs without, rel diff {d:.3e} (bar '
          f'{TRAIN_FLASH_TOL:.0e}); peak {full[1]["peak_gb"]:.3f} vs '
          f'{full[0]["peak_gb"]:.3f} GB')
    full.append(train_full(dev, 'granite-moe-1b-a400m',
                           *TRAIN_FULL['granite-moe-1b-a400m'], False,
                           profile=True))
    numbers.update(full=full, flash_loss_rel_diff=d,
                   phase_s=time.perf_counter() - t0, card=card_identity())
    print(f'     train phase: {numbers["phase_s"]:.1f} s wall', flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the mesh (launch/compat, mesh, sharding, dryrun; models/specs,
# shard_utils): the sharded train step over gloo ranks of the card, the
# checkpoint reshard, the driver on a debug mesh, and the dry run
# ---------------------------------------------------------------------------

MESH_ARCHS = ('granite-moe-1b-a400m', 'gemma3-1b', 'falcon-mamba-7b')
# granite's capacity: 32 slots an expert for its 256 (token, choice) pairs
# over 4 experts, so the expert-parallel MoE drops at least half of them
MESH_OVER = {'granite-moe-1b-a400m': dict(capacity_factor=0.5)}
MESH_B, MESH_S, MESH_STEPS = 4, 32, 3
DRYRUN_TOL = 0.25        # the dry run's predicted peak vs the card's
DRYRUN_CLI = ['--arch', 'gemma3-1b', '--shape', 'train_4k', '--mesh', 'both']


def start_dryruns(out_dir):
    """The dry run's two subprocesses, started at once (they need no card
    and run beside the card's phases): the one-rank prediction of
    gemma3-1b's TRAIN_FULL step through ``dryrun.lower``, and the CLI on
    DRYRUN_CLI.  Returns {name: (Popen, its output file)}."""
    import os
    B, S = TRAIN_FULL['gemma3-1b']
    code = (
        'import json; from repro_torch.launch import dryrun; '
        'from repro_torch.configs import get_config; '
        'from repro_torch.launch.compat import make_auto_mesh; '
        'dryrun.fake_world(1); '
        "m = make_auto_mesh((1, 1), ('data', 'model'), 'cpu'); "
        f"r = dryrun.lower(get_config('gemma3-1b'), m, 'train', {S}, {B}); "
        "print('DRYRUN ' + json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / 'src'))
    procs = {}
    for name, argv in (('one_rank', ['-c', code]),
                       ('cli', ['-m', 'repro_torch.launch.dryrun',
                                *DRYRUN_CLI, '--force', '--out',
                                f'{out_dir}/cells'])):
        log = open(f'{out_dir}/{name}.log', 'w+')
        procs[name] = (subprocess.Popen([sys.executable, *argv], env=env,
                                        stdout=log, stderr=subprocess.STDOUT),
                       log)
    return procs


def stop_dryruns(procs):
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def mesh_rank(rank, tmp, dev_type):
    """One of 4 gloo ranks of the card: each MESH_ARCHS arch reduced on a
    (2, 2) ('data', 'model') mesh (MESH_OVER's changes to it), float32
    state, weights drawn on the CPU: MESH_STEPS sharded steps, each step's
    whole parameters and its host time, and the (token, choice) pairs
    that the expert-parallel MoE kept of this rank's; then a checkpoint
    saved from a (4,) mesh and restored onto (2, 2) with P('model',
    'data')."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.compat import make_auto_mesh, set_mesh
    from repro_torch.launch.sharding import (NamedSharding, P,
                                             batch_shardings, opt_shardings,
                                             param_shardings, place)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params, tree_leaves
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, 0)
    mesh = make_auto_mesh((2, 2), ('data', 'model'), dev_type)
    out = dict(backend=dist.get_backend(), archs={})
    on_mesh, kept = moe._moe_on_mesh, []

    def spy(*a):    # the expert-parallel MoE's calls and kept pairs
        y, probs, k = on_mesh(*a)
        kept.append((int(k.to_local().sum()), k.to_local().numel()))
        return y, probs, k
    moe._moe_on_mesh = spy
    for arch in MESH_ARCHS:
        cfg = get_config(arch).reduced(**MESH_OVER.get(arch, {}))
        kept.clear()
        g = torch.Generator().manual_seed(200 + MESH_ARCHS.index(arch))
        params = init_params(cfg, g, 'cpu')
        batch = train_batch(cfg, MESH_B, MESH_S, g, 'cpu')
        opt = adamw_init(params)
        pshard = param_shardings(params, mesh)
        p = place(_to(params, dev), pshard)
        o = place(_to(opt, dev), opt_shardings(opt, pshard, mesh))
        step = make_train_step(cfg, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        with set_mesh(mesh):    # the first step's loss and gradients
            loss0, grads0 = train_grads(cfg, p, place(b, batch_shardings(
                b, mesh)))
        grads0 = {k: v.full_tensor().cpu().numpy().copy()
                  for k, v in grads0.items()}
        loss0 = float(loss0.full_tensor())
        losses, whole, times = [], [], []
        for _ in range(MESH_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            with set_mesh(mesh):
                p, o, m = step(p, o, b)
            sync(dev)
            times.append(time.perf_counter() - t0)
            losses.append(float(m['loss'].full_tensor()))
            whole.append({k: v.full_tensor().cpu().numpy().copy()
                          for k, v in tree_leaves(p)})
        out['archs'][arch] = dict(
            kept=[sum(k for k, _ in kept), sum(n for _, n in kept)],
            losses=losses, whole=whole if rank == 0 else None, times=times,
            loss0=loss0, grads0=grads0 if rank == 0 else None,
            local_device=str(next(iter(tree_leaves(p)))[1]
                             .to_local().device))
    moe._moe_on_mesh = on_mesh
    tree = {'w': torch.arange(64, dtype=torch.float32,
                              device=dev).reshape(8, 8)}
    mesh1 = make_auto_mesh((4,), ('data',), dev_type)
    ckpt.save(f'{tmp}/step_00000001',
              place(tree, {'w': NamedSharding(mesh1, P('data'))}), 1)
    sh2 = {'w': NamedSharding(mesh, P('model', 'data'))}
    got = ckpt.restore(f'{tmp}/step_00000001', tree, sh2)['w']
    out['reshard'] = dict(bitwise=torch.equal(got.full_tensor(), tree['w']),
                          placed=got.placements == sh2['w'].placements,
                          device=str(got.to_local().device))
    return out


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def _to(tree, dev):
    from repro_torch.launch.sharding import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def mesh_driver_rank(rank, root, dev_type):
    """One of 2 gloo ranks of the card: ``launch.train`` with its debug
    mesh on gemma3-1b reduced: 4 steps and a checkpoint every 2, the same
    command to 6, and 6 straight; the whole parameters and state back."""
    from repro_torch.launch import train
    from repro_torch.runtime.checkpoint import _flatten, latest_step
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ['--arch', 'gemma3-1b', '--reduced', '--batch', '4', '--seq',
            '32', '--log-every', '100', '--device', dev_type]
    ck = ['--ckpt', f'{root}/run', '--ckpt-every', '2']
    train.main(argv + ['--steps', '4'] + ck)
    resumed = train.main(argv + ['--steps', '6'] + ck)
    straight = train.main(argv + ['--steps', '6'])

    def whole(r):
        return {k: v.full_tensor().cpu().numpy() for k, v in
                _flatten({'p': r['params'], 'o': r['opt']})}
    return dict(latest=latest_step(f'{root}/run'),
                start=resumed['start_step'],
                mesh=tuple(resumed['params']['embed'].device_mesh.shape),
                resumed=whole(resumed), straight=whole(straight))


def mesh_steps(dev, tmp):
    """The sharded step on 4 gloo ranks of the card against the one-rank
    step on the card (1e-4 relative to each leaf's largest value after
    each step, the loss falling; the leaf that sets each step's largest
    error named), the reshard bitwise, and ms a step of both."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import spawn_ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params, tree_leaves
    from repro_torch.optim.adamw import adamw_init
    numbers = {}
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, 4, tmp, dev.type)
        wall = time.perf_counter() - t0
    except RuntimeError as e:
        check(False, f'mesh step: 4 gloo ranks of the card failed: '
              f'{str(e)[-1500:]}')
        return dict(error=str(e)[-3000:])
    r0 = ranks[0]
    for arch in MESH_ARCHS:
        cfg = get_config(arch).reduced(**MESH_OVER.get(arch, {}))
        g = torch.Generator().manual_seed(200 + MESH_ARCHS.index(arch))
        params = _to(init_params(cfg, g, 'cpu'), dev)
        batch = {k: v.to(dev) for k, v in
                 train_batch(cfg, MESH_B, MESH_S, g, 'cpu').items()}
        opt = adamw_init(params)
        step = make_train_step(cfg, device=dev)
        loss0, grads0 = train_grads(cfg, params, batch)
        got = r0['archs'][arch]
        grad_err = max([abs(got['loss0'] - float(loss0)) / abs(float(loss0))]
                       + [float(np.abs(got['grads0'][k] - v.cpu().numpy())
                                .max() / max(float(v.abs().max()), 1e-30))
                          for k, v in grads0.items()])
        errs, worst, times = [], [], []
        for i in range(MESH_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            sync(dev)
            times.append(time.perf_counter() - t0)
            whole = got['whole'][i]
            diff = {k: np.abs(whole[k] - v.cpu().numpy()) / max(
                float(v.abs().max()), 1e-30) for k, v in tree_leaves(params)}
            k = max(diff, key=lambda k: diff[k].max())
            errs.append(float(diff[k].max()))
            worst.append(k)
            if i == 0:    # the first step's first moment is its gradient
                j = np.unravel_index(diff[k].argmax(), diff[k].shape)
                grad1 = [float(grads0[k].cpu().numpy()[j]),
                         float(got['grads0'][k][j])]
        losses = [r['archs'][arch]['losses'] for r in ranks]
        falls = all(x[-1] < x[0] for x in losses)
        same = all(x == losses[0] for x in losses)
        sharded_ms = statistics.mean(
            r0['archs'][arch]['times'][1:]) * 1e3
        one_ms = statistics.mean(times[1:]) * 1e3
        kept, pairs = got['kept']
        ep = '' if cfg.family != 'moe' else (
            f'; the expert-parallel MoE ran (all-to-alls over \'data\'), '
            f'{pairs - kept} of {pairs} (token, choice) pairs of rank 0 '
            f'dropped over its calls')
        check(errs[-1] <= LM_TOL and grad_err <= LM_TOL and falls
              and same and (cfg.family != 'moe' or 0 < kept < pairs),
              f'mesh step {arch} (reduced, B={MESH_B} S={MESH_S}, float32 '
              f'state): 4 {r0["backend"]} ranks of one card on a (2, 2) '
              f'mesh (local tensors on {got["local_device"]}) vs the '
              f'one-rank step on the card: train_loss and '
              f'{len(grads0)} gradient leaves max rel err {grad_err:.3e}; '
              f'parameters after the {MESH_STEPS} steps {errs[-1]:.3e} '
              f'(after each: {[f"{e:.3e}" for e in errs]}, largest in '
              f'{worst}; bar {LM_TOL:.0e}; the gradient at step 1\'s '
              f'largest, one rank vs sharded: {grad1[0]:.4e} vs '
              f'{grad1[1]:.4e}, AdamW\'s eps 1e-8); losses '
              f'{[round(x, 5) for x in losses[0]]} falling {falls}, the '
              f'same on every rank {same}; {sharded_ms:.1f} ms a sharded '
              f'step vs {one_ms:.1f} ms one rank (steps 2-{MESH_STEPS}; '
              f'each sharded step '
              f'{[round(t * 1e3, 1) for t in got["times"]]} ms){ep}')
        numbers[arch] = dict(max_rel_err=errs, worst_leaf=worst,
                             step1_grad=grad1, grad_rel_err=grad_err,
                             kept_pairs=got['kept'],
                             losses=losses[0],
                             sharded_ms=sharded_ms, one_rank_ms=one_ms,
                             sharded_step_s=r0['archs'][arch]['times'])
    ok = all(r['reshard'] == dict(bitwise=True, placed=True,
                                  device=str(dev)) for r in ranks)
    check(ok, f'mesh reshard: a checkpoint saved from a (4,) mesh restored '
          f'onto (2, 2) P(model, data) on the card, bitwise with the target '
          f'placements on every rank: {[r["reshard"] for r in ranks]}')
    numbers.update(reshard_ok=ok, spawn_wall_s=wall, backend=r0['backend'])
    return numbers


def mesh_driver(dev, tmp):
    """``launch.train`` on 2 gloo ranks of the card, its debug mesh (1, 2):
    4 steps + a checkpoint + 2 vs 6 straight, bitwise."""
    from repro_torch.launch.sharding import spawn_ranks
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_driver_rank, 2, tmp, dev.type)
        wall = time.perf_counter() - t0
    except RuntimeError as e:
        check(False, f'mesh driver: 2 gloo ranks of the card failed: '
              f'{str(e)[-1500:]}')
        return dict(error=str(e)[-3000:])
    ok = all(r['latest'] == 6 and r['start'] == 4 and r['mesh'] == (1, 2)
             and sorted(r['resumed']) == sorted(r['straight'])
             and all(np.array_equal(v, r['straight'][k])
                     for k, v in r['resumed'].items()) for r in ranks)
    check(ok, f'mesh driver: launch.train --debug-mesh on 2 ranks of the '
          f'card, mesh {ranks[0]["mesh"]}: 4 steps + checkpoint + 2 from '
          f'the restore vs 6 straight, {len(ranks[0]["resumed"])} leaves '
          f'bitwise {ok}; {wall:.1f} s wall')
    return dict(bitwise=ok, wall_s=wall)


def dryrun_vs_card(dry, train_row):
    """The one-rank dry run of gemma3-1b at TRAIN_FULL against the train
    phase's own gemma3-1b step on the card: predicted peak vs
    ``max_memory_allocated`` within DRYRUN_TOL; its FLOP over the measured
    step time (achieved TFLOP/s); and the CLI's two records."""
    proc, log = dry['one_rank']
    proc.wait()
    log.seek(0)
    text = log.read()
    lines = [x for x in text.splitlines() if x.startswith('DRYRUN ')]
    if proc.returncode or not lines:
        check(False, f'mesh dry run: the one-rank prediction failed (exit '
              f'{proc.returncode}): {text[-1500:]}')
        rec = None
    else:
        rec = json.loads(lines[-1][len('DRYRUN '):])
        pred = rec['memory']['peak_size_in_bytes'] / 1e9
        card = train_row['peak_gb']
        miss = abs(pred - card) / card
        tflops = rec['cost']['flops'] / (train_row['ms_step'] / 1e3) / 1e12
        check(miss <= DRYRUN_TOL, f'mesh dry run: gemma3-1b B={train_row["B"]}'
              f' S={train_row["S"]} one rank, predicted peak {pred:.3f} GB '
              f'(arguments {rec["memory"]["argument_size_in_bytes"] / 1e9:.3f}'
              f' GB) vs the card\'s {card:.3f} GB, off by {miss:.1%} (bar '
              f'{DRYRUN_TOL:.0%}); {rec["cost"]["flops"]:.4e} FLOP a step over '
              f'{train_row["ms_step"]:.1f} ms = {tflops:.1f} TFLOP/s achieved; '
              f'{rec["step_s"]} s to run')
        rec.update(card_peak_gb=card, miss=miss, achieved_tflops=tflops)
    proc, log = dry['cli']
    proc.wait()
    log.seek(0)
    text = log.read()
    cells = sorted(Path(log.name).parent.glob('cells/*.json'))
    recs = [json.loads(c.read_text()) for c in cells]
    ok = proc.returncode == 0 and len(recs) == 2 and all(
        r['status'] == 'ok' for r in recs)
    check(ok, f'mesh dry run CLI: python -m repro_torch.launch.dryrun '
          f'{" ".join(DRYRUN_CLI)} on torch {torch.__version__}: exit '
          f'{proc.returncode}, records '
          f'{[(c.name, r["status"]) for c, r in zip(cells, recs)]}'
          + ('' if ok else f': {text[-1500:]}'))
    for c, r in zip(cells, recs):
        if r['status'] == 'ok':
            print(f'     dry run {c.stem}: peak '
                  f'{r["memory"]["peak_size_in_bytes"] / 1e9:.3f} GB a '
                  f'device, {r["cost"]["flops"]:.4e} FLOP, collectives '
                  f'{r["collectives"]["total_bytes"] / 1e9:.3f} GB, '
                  f'{r["step_s"]} s', flush=True)
    return dict(one_rank=rec, cli=[dict(cell=c.stem, **{
        k: r.get(k) for k in ('status', 'memory', 'cost', 'collectives',
                              'step_s')}) for c, r in zip(cells, recs)])


def mesh_phase(dev, train=None, dry=None):
    """The mesh on the card: the sharded train step on 4 gloo ranks
    against one rank, the reshard, the driver's debug mesh on 2 ranks,
    and the dry run against the card and its CLI (started beforehand by
    ``start_dryruns``; started here when not).  ``train``: the train
    phase's numbers (its gemma3-1b TRAIN_FULL step is measured here when
    absent)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        own = dry is None
        if own:
            dry = start_dryruns(tmp)
        try:
            numbers = dict(step=mesh_steps(dev, f'{tmp}'))
            numbers['driver'] = mesh_driver(dev, tmp)
            row = (train['full'][0] if train is not None else
                   train_full(dev, 'gemma3-1b', *TRAIN_FULL['gemma3-1b'],
                              False))
            numbers['dryrun'] = dryrun_vs_card(dry, row)
        finally:
            if own:
                stop_dryruns(dry)
    numbers.update(phase_s=time.perf_counter() - t0, card=card_identity())
    print(f'     mesh phase: {numbers["phase_s"]:.1f} s wall', flush=True)
    return numbers


def plain_csr(nbr_idx, n_out, mask):
    """The plain by-destination index of ``destination_csr``'s arguments:
    the sentinel where, then ``destination_csr_plain``."""
    from repro_torch.kernels.assemble import destination_csr_plain
    return destination_csr_plain(torch.where(mask, nbr_idx, n_out), n_out)


def new_assembly():
    """True where the package has the by-destination kernels (the checks
    below need them; an older tree runs the timings alone)."""
    from repro_torch.kernels import assemble
    return hasattr(assemble, 'destination_csr_plain')


def big_box(natoms, seed=3):
    """snap-2j8's lattice at ``natoms`` atoms (16000: 2 x 2 x 2 of it),
    perturbed 0.02 A."""
    from repro_torch.md.lattice import paper_box, perturb
    pos, box = paper_box(natoms)
    return perturb(pos, 0.02, seed=seed), box


def csr_cases(dev):
    """(what, nbr_idx, n_out, mask) on the card: snap-2j8's 26-wide lists,
    the device loop's 52-wide ones (int32, as the loop holds them), each
    serving bucket's lane-offset lists (masked slots get the sentinel B x
    lane_atoms), both ranks' rows of the offset form, a 16,000-atom box's
    lists, atoms named 126 and 626 times, one atom named by every pair,
    n_out = 1 and every pair masked."""
    from repro_torch.kernels import ops
    from repro_torch.md import cell_list as cl
    _, _, pos, box, nbr_idx, mask, _ = setup(8, dev)
    nbr = torch.as_tensor(nbr_idx, device=dev)
    ok = torch.as_tensor(mask, device=dev)
    out = [('snap-2j8 26-wide', nbr, NATOMS, ok),
           ('snap-2j8 26-wide int32', nbr.int(), NATOMS, ok)]
    pos_t, box_t = (torch.as_tensor(a, device=dev) for a in (pos, box))
    ni, ms, _, _ = cl.device_neighbors(pos_t, box_t, device_grid(pos, box))
    out += [('device loop 52-wide int32', ni, NATOMS, ms),
            ('device loop 52-wide', ni.long(), NATOMS, ms)]
    for n_pad, (bucket, a) in serve_batches(default_serve_table(),
                                            dev).items():
        bn, bm, _, _ = cl.brute_neighbors_batched(
            a['pos'], a['box'], RCUT, bucket.max_nbors, a['n_valid'])
        lane_atoms = -(-n_pad // 128) * 128
        base = torch.arange(bn.shape[0], device=dev) * lane_atoms
        out.append((f'serve n{n_pad} lane-offset',
                    ops._lanes_flat(bn.long() + base[:, None, None],
                                    lane_atoms),
                    bn.shape[0] * lane_atoms, ops._lanes_flat(bm, lane_atoms)))
    half = NATOMS // 2
    out += [(f'offset form rows {r * half}..', nbr[r * half:(r + 1) * half],
             NATOMS, ok[r * half:(r + 1) * half]) for r in range(2)]
    p16, b16 = big_box(16000)
    p16_t, b16_t = (torch.as_tensor(a, device=dev) for a in (p16, b16))
    n16, m16, _, _ = cl.device_neighbors(p16_t, b16_t, device_grid(p16, b16))
    out.append(('16000 atoms 52-wide', n16.long(), 16000, m16))
    many = nbr.clone()
    many[:100, 1] = 11
    many[:600, 0] = 7
    out.append(('atoms 11 and 7 named 126 and 626 times', many, NATOMS,
                torch.ones_like(ok)))
    out.append(('atom 0 named by every pair', torch.zeros_like(nbr), NATOMS,
                torch.ones_like(ok)))
    g = torch.Generator(device=dev).manual_seed(4)
    out.append(('n_out 1', torch.zeros((40, NNBOR), dtype=torch.long,
                                       device=dev), 1,
                torch.rand((40, NNBOR), generator=g, device=dev) < 0.5))
    out.append(('every pair masked', nbr, NATOMS, torch.zeros_like(ok)))
    return out


def assembly_checks(dev):
    """The by-destination index and the assembly on the card: the CSR
    kernels bitwise against the plain version in every case of
    :func:`csr_cases`; the assembly against its plain version at TOL on
    the fused dE planes' view (f64, f32), on a contiguous copy (bitwise the
    view's), in the offset form, on the serving lanes and the 16,000-atom
    lists, with a NaN in a masked slot, and twice bitwise."""
    from repro_torch.kernels.assemble import (assemble_forces_csr,
                                              assemble_forces_csr_plain,
                                              destination_csr)
    cases = csr_cases(dev)
    for what, nbr, n_out, mask in cases:
        got = destination_csr(nbr, n_out, mask)
        want = plain_csr(nbr, n_out, mask)
        torch.cuda.synchronize()
        seg = (want[1][1:] - want[1][:-1]).max() if n_out else 0
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f'destination_csr {what}: kernel vs plain bitwise on order '
              f'and rowptr ({nbr.numel()} pairs, {n_out} rows, '
              f'{int(want[1][-1])} kept, longest segment {int(seg)}, '
              f'{str(nbr.dtype)[6:]} index)')
    g = torch.Generator(device=dev).manual_seed(0)
    for what, nbr, n_out, mask in cases:
        if what.startswith(('snap-2j8 26-wide int32', 'device loop 52-wide '
                            'int32', 'n_out', 'every', 'atom 0')):
            continue
        n_local, k = nbr.shape
        offset = n_local if what.startswith('offset form rows 1000') else 0
        npad = -(-n_local // 128) * 128
        csr = destination_csr(nbr, n_out, mask)
        for dtype in (torch.float64, torch.float32):
            planes = torch.randn((k, 4, npad), generator=g, dtype=dtype,
                                 device=dev)
            view = planes[:, :3, :n_local].permute(2, 0, 1)
            got = assemble_forces_csr(view, *csr, offset, mask)
            got2 = assemble_forces_csr(view, *csr, offset, mask)
            flat = assemble_forces_csr(view.contiguous(), *csr, offset, mask)
            want = assemble_forces_csr_plain(view, *csr, offset, mask)
            torch.cuda.synchronize()
            abs_err, err = rel_err(got, want)
            check(err <= TOL[dtype] and torch.equal(got, got2)
                  and torch.equal(got, flat),
                  f'assemble_forces {what} {str(dtype)[6:]} on the planes\' '
                  f'view (strides {view.stride()}): vs plain max rel err '
                  f'{err:.3e} (bar {TOL[dtype]:.0e}), max abs err '
                  f'{abs_err:.3e}; twice bitwise, a contiguous copy bitwise '
                  'the same')
            if what == 'device loop 52-wide':
                i, j = (~mask).nonzero()[0].tolist()
                bad = planes.clone()
                bad[j, 1, i] = float('nan')
                bview = bad[:, :3, :n_local].permute(2, 0, 1)
                got = assemble_forces_csr(bview, *csr, 0, mask)
                want = assemble_forces_csr_plain(bview, *csr, 0, mask)
                torch.cuda.synchronize()
                same_nan = torch.equal(got.isnan(), want.isnan())
                fin = ~want.isnan()
                _, err = rel_err(got[fin], want[fin])
                check(same_nan and bool(want.isnan().any())
                      and err <= TOL[dtype],
                      f'assemble_forces {str(dtype)[6:]}: a NaN dE/dr in a '
                      f'masked slot (atom {i}, slot {j}) gives the plain '
                      f'version\'s NaN rows ({int(want.isnan().any(1).sum())}'
                      f'), the other rows within {err:.3e}')


def cell_bin_cases(dev):
    """(what, pos, box, grid): snap-2j8 (the device loop's grid), signed
    zeros, an overflow (cell_cap 8), a one-cell box below and past its
    count (54 atoms, ranked) and past the ranked size (128 atoms, walked),
    the 16,000-atom box and a 54,000-atom box (its arrays in scratch)."""
    from repro_torch.md import cell_list as cl
    _, _, pos, box, *_ = setup(8, dev)
    out = [('snap-2j8', pos, box, device_grid(pos, box)),
           ('snap-2j8 signed zeros', signed_zero_positions(pos, box), box,
            device_grid(pos, box)),
           ('snap-2j8 overflow', pos, box, cl.make_grid(box, RCUT, SKIN, 8,
                                                        12))]
    for n, skin, caps in ((54, SKIN, (64, 16)), (128, 3.0, (160, 100))):
        p, b = big_box(n)
        out += [(f'one-cell box {n} atoms cell_cap {c}', p, b,
                 cl.make_grid(b, RCUT, skin, c, 12)) for c in caps]
    for n in (16000, 54000):
        p, b = big_box(n)
        out.append((f'{n} atoms', p, b, device_grid(p, b)))
    return out


def cell_bin_checks(dev):
    """cell_bin bitwise against its plain version (table and flags) in
    every case of :func:`cell_bin_cases`, float64 and float32."""
    from repro_torch.kernels import neighbors as kn
    one = torch.ones((), dtype=torch.int32, device=dev)
    for what, pos, box, grid in cell_bin_cases(dev):
        for dtype in (torch.float64, torch.float32):
            p, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (pos, box))
            fk, fp = (torch.zeros(2, dtype=torch.int32, device=dev)
                      for _ in range(2))
            tk = kn.cell_bin(p, b, grid, one, fk)
            tp = kn.cell_bin_plain(p, b, grid, one, fp)
            torch.cuda.synchronize()
            check(torch.equal(tk, tp) and torch.equal(fk, fp),
                  f'cell_bin {what} {str(dtype)[6:]}: kernel vs plain '
                  f'bitwise on the table and flags (nbins {grid.nbins}, '
                  f'cell_cap {grid.cell_cap}, largest count '
                  f'{int(fp[1])})')


def assembly_timing(dev):
    """Times of the assembly stretch, its kernels and cell_bin at snap-2j8
    in this tree's package, through the entry points an older tree has
    too (for A/B runs: this file copied into the older tree)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import snap as core_snap
    from repro_torch.kernels import assemble
    from repro_torch.kernels import neighbors as kn
    from repro_torch.kernels import ops
    new = new_assembly()
    cfg, beta, pos, box, nbr_idx, mask, disp = setup(8, dev)
    nbr = torch.as_tensor(nbr_idx, device=dev)
    ok = torch.as_tensor(mask, device=dev)
    npad = -(-NATOMS // 128) * 128
    g = torch.Generator(device=dev).manual_seed(0)
    out = dict(tree=str(Path(__file__).resolve().parent), new_api=new,
               card=card_identity())
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype)[6:]
        planes = torch.randn((NNBOR, 4, npad), generator=g, dtype=dtype,
                             device=dev)
        view = planes[:, :3, :NATOMS].permute(2, 0, 1)
        d = (view * ok[..., None]).contiguous()

        def stretch():
            return core_snap.assemble_forces(view, nbr, ok, NATOMS)
        if new:
            csr = assemble.destination_csr(nbr, NATOMS, ok)

            def kern():
                return assemble.assemble_forces_csr(view, *csr, 0, ok)

            def csr_fn():
                return assemble.destination_csr(nbr, NATOMS, ok)
        else:
            dest = torch.where(ok, nbr, NATOMS)
            csr = assemble.destination_csr(dest, NATOMS)

            def kern():
                return assemble.assemble_forces_csr(d, *csr)

            def csr_fn():
                return assemble.destination_csr(torch.where(ok, nbr, NATOMS),
                                                NATOMS)
        flat = nbr.reshape(-1)

        def library():
            return d.sum(dim=1).index_add_(0, flat, -d.reshape(-1, 3))
        for name, fn in (('stretch', stretch), ('assemble_forces', kern),
                         ('destination_csr', csr_fn), ('index_add', library)):
            if name == 'destination_csr' and dtype == torch.float32:
                continue
            out[f'{name}_ms_{dt}'] = time_ms(fn)
            out[f'{name}_device_ms_{dt}'] = device_ms(fn)[0]
        stretch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                stretch()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[f'stretch_ops_{dt}'] = len(ev) / 10
        out[f'stretch_profile_device_ms_{dt}'] = sum(
            e.time_range.elapsed_us() for e in ev) / 10 / 1e3
        per = collections.defaultdict(float)
        for e in ev:
            per[e.name[:50]] += e.time_range.elapsed_us() / 10
        out[f'stretch_us_{dt}'] = dict(per)
    # one half-layout f64 evaluation's stretch from the fused dE kernel
    args = (cfg, beta, 0.0, *device_inputs(disp, nbr_idx, mask, dev))
    kw = dict(dtype=torch.float64, device=dev, layout='half')
    ops.snap_force_pipeline(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            ops.snap_force_pipeline(*args, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_summary(prof, wall_us, 5, 'assembly A/B: profile half f64',
                    'evaluation', 6)
    st = print_stretch('assembly A/B: half f64 stretch', stretch_of(prof))
    out['half_stretch'] = st
    out['half_eval_device_ms'] = device_ms(
        lambda: ops.snap_force_pipeline(*args, **kw), k=5)[0]
    # cell_bin: snap-2j8 and 16,000 atoms, a launch and a gated launch
    one = torch.ones((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for tag, (p, b) in (('2000', (pos, box)), ('16000', big_box(16000))):
        grid = device_grid(p, b)
        for dtype in (torch.float64, torch.float32):
            dt = str(dtype)[6:]
            p_t, b_t = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in (p, b))
            fl = torch.zeros(2, dtype=torch.int32, device=dev)
            k = f'cell_bin_{tag}_{dt}'
            out[f'{k}_ms'] = time_ms(lambda: kn.cell_bin(p_t, b_t, grid, one,
                                                         fl))
            out[f'{k}_device_ms'] = device_ms(
                lambda: kn.cell_bin(p_t, b_t, grid, one, fl))[0]
            out[f'{k}_gated_device_ms'] = device_ms(
                lambda: kn.cell_bin(p_t, b_t, grid, zero, fl),
                k=GATED_REPS)[0]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    kn.cell_bin(p_t, b_t, grid, one, fl)
                torch.cuda.synchronize()
            out[f'{k}_profile_us'] = sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA) / 10
            if tag == '2000':
                out[f'{k}_plain_ms'] = time_ms(
                    lambda: kn.cell_bin_plain(p_t, b_t, grid, one, fl),
                    reps=10)
    # the device loop, 20 steps with the chunk function cached
    from repro_torch.md.integrate import MDState, init_velocities, run_nve
    vel = init_velocities(NATOMS, 300.0)
    kw = dict(impl='kernel', loop='device', skin=SKIN,
              max_nbors=DEVICE_NBORS, log_every=DEVICE_LOG, device=dev,
              dtype=torch.float64)
    cache = {}
    _, thermo = run_nve(cfg, beta, 0.0, MDState(pos.copy(), vel.copy(), box),
                        DEVICE_STEPS, fn_cache=cache, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_nve(cfg, beta, 0.0, MDState(pos.copy(), vel.copy(), box),
            DEVICE_STEPS, fn_cache=cache, **kw)
    torch.cuda.synchronize()
    out['device_loop_ms_step'] = (time.perf_counter() - t0) * 1e3 / \
        DEVICE_STEPS
    out['device_loop_thermo'] = [(t['step'], t['pe'], t['etot'])
                                 for t in thermo]
    return out


def assembly_main(dev):
    """``--assembly``: the assembly's and cell_bin's checks (where the tree
    has the by-destination kernels) and times alone.  Returns an exit
    code."""
    from repro_torch.kernels import _build
    print(f'card: {card_identity()}; torch {torch.__version__}', flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f'build: {time.perf_counter() - t0:.1f} s', flush=True)
    for lib in ('assemble_forces', 'cell_list'):
        for k, r in _build.ptxas_report(built[lib]['log']).items():
            if 'registers' in r:
                print(f'     ptxas {lib}: {k}: {r["registers"]} registers, '
                      f'{r.get("stack")} B stack, {r.get("spill_stores")} B '
                      'spill stores', flush=True)
    if new_assembly():
        assembly_checks(dev)
    else:
        print('     (an older tree: timings only)', flush=True)
    cell_bin_checks(dev)
    print('assembly: ' + json.dumps(assembly_timing(dev), default=str),
          flush=True)
    print(f'chip_smoke --assembly: {len(FAILURES)} check(s) failed',
          flush=True)
    return 1 if FAILURES else 0


def neighbor_checks(dev):
    """``--neighbors``: the neighbor builds alone (the cell kernels at
    snap-2j8 in both dtypes, the device loop on them against the plain
    build, the brute build on both serving buckets and the edge-case batch,
    the batched evaluation on its lists, its times on both buckets).
    Returns an exit code."""
    from repro_torch.kernels import _build
    print(f'card: {card_identity()}; torch {torch.__version__}', flush=True)
    ptxas_phase(_build.build())
    cfg, beta, pos, box, *_ = setup(8, dev)
    for dtype in (torch.float64, torch.float32):
        neighbor_phase(pos, box, dev, dtype)
    cell_bin_checks(dev)
    device_loop_bitwise(cfg, beta, pos, box, dev)
    batches = serve_batches(default_serve_table(), dev)
    serve_neighbor_checks(batches, dev)
    for bucket, a in batches.values():
        brute_timing(bucket, a)
    print(f'chip_smoke --neighbors: {len(FAILURES)} check(s) failed',
          flush=True)
    return 1 if FAILURES else 0


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'run needs an NVIDIA card', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # no kernel here uses a
    torch.backends.cudnn.allow_tf32 = False         # matmul; stated anyway
    dev = torch.device('cuda', 0)
    if sys.argv[1:] == ['--neighbors']:
        return neighbor_checks(dev)
    if sys.argv[1:] == ['--assembly']:
        return assembly_main(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dry = start_dryruns(tmp)
        try:
            return run_phases(dev, dry)
        finally:
            stop_dryruns(dry)


def run_phases(dev, dry):
    from repro_torch.kernels import _build
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
    snap = [k for k in KERNELS if k not in NEIGHBOR]
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
    cell_bin_checks(dev)
    assembly_checks(dev)
    runs['device'] = device_loop_phase(cfg, beta, pos, box, dev)
    device_loop_bitwise(cfg, beta, pos, box, dev)
    sharded_counts, sharded_numbers = sharded_phase(
        cfg, beta, pos, box, nbr_idx, mask, disp, dev, runs['device'][1])
    serve_counts, serve_numbers, y_lanes, brute = serve_phase(dev)
    for dtype, st in brute.items():
        stats[dtype]['brute_build'] = st
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
    train = train_phase(dev)
    print('train: ' + json.dumps(train, default=str), flush=True)
    print('mesh: ' + json.dumps(mesh_phase(dev, train, dry), default=str),
          flush=True)
    # each phase of this slice launched every kernel of its path
    check(all(analysis_counts[k] > 0 for k in KERNELS),
          f'analysis: every kernel launched ({analysis_counts})')
    check(all(example_counts[k] > 0
              for k in PATHS['device'] + PATHS['serve']),
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
        # the serving path's main run is the open loop (serve_counts)
        main = serve_counts if path == 'serve' else runs[path][0]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=main[name], **top,
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
