"""Launch plans of the port's U, Y and fused dE kernels (pure Python, no
card).

``kernels/launch_plan.py`` chooses each kernel's block, grid and dynamic
shared memory; the CUDA launchers refuse a plan whose numbers disagree with
their own arithmetic.  Here, for every 2J the kernels take, in float32 and
float64: the default plan fits an H100 block (232,448 B of shared memory,
1,024 threads), the element-to-thread map covers every left-row element of
every level exactly once, in contiguous runs along the rows (the kernels
carry the previous column's element from one element to the next); at
snap-2j8 (2048 padded atoms x 26 neighbors) each kernel launches at least
one block per SM; and requests that do not fit raise.  For Y, at 2J = 8
and 14, half and full tables: the plan fits, launches at least 132 blocks
at snap-2j8, and its row groups and slot shares cover every row and every
table entry exactly once, in order, each group within 1.25 x the mean
count of entries.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_plan as lp
from repro_torch.kernels.snap_y import y_full_csr, y_half_csr

TWOJ = range(0, 15)
DTYPES = {'f32': torch.float32, 'f64': torch.float64}
PLANS = {'u': lp.u_plan, 'de': lp.de_plan}
N, NNBOR = 2048, 26          # snap-2j8: 2000 atoms padded to 128-lane tiles
SMS = 132


def _cases():
    return [(tj, dt, kind) for tj in TWOJ for dt in DTYPES for kind in PLANS]


def _ids(case):
    tj, dt, kind = case
    return f'{kind}-2j{tj}-{dt}'


@pytest.mark.parametrize('case', _cases(), ids=_ids)
def test_default_plan_fits_the_card(case):
    tj, dt, kind = case
    plan = PLANS[kind](tj, DTYPES[dt], N, NNBOR)
    assert plan.smem <= lp.SMEM_MAX == 232_448
    assert plan.lanes * plan.threads <= lp.THREADS_MAX == 1024
    assert plan.block == (plan.lanes, plan.threads, 1)
    assert plan.grid[0] * plan.lanes >= N
    assert plan.grid[1] == (plan.groups if kind == 'u' else NNBOR)
    assert 1 <= plan.groups <= NNBOR


@pytest.mark.parametrize('case', _cases(), ids=_ids)
def test_element_map_covers_each_level_once(case):
    tj, dt, kind = case
    threads = PLANS[kind](tj, DTYPES[dt], N, NNBOR).threads
    for j in range(1, tj + 1):
        cols = j + 1
        want = [(mb, ma) for mb in range(j // 2 + 1) for ma in range(cols)]
        got = []
        for y in range(threads):
            run = lp.element_map(j, threads, y)
            flat = [mb * cols + ma for mb, ma in run]
            # one contiguous run along the rows, as the kernels walk it
            assert not flat or flat == list(
                range(flat[0], flat[0] + len(flat))), (j, y, run)
            got += run
        assert sorted(got) == want, (j, threads)
        assert len(got) == len(set(got)), (j, threads)


@pytest.mark.parametrize('threads', [1, 3, 8, 16, 32, 64])
def test_element_map_any_thread_count(threads):
    """The map holds for widths other than the defaults (the sweep's)."""
    for j in range(1, 15):
        got = [e for y in range(threads)
               for e in lp.element_map(j, threads, y)]
        assert sorted(got) == [(mb, ma) for mb in range(j // 2 + 1)
                               for ma in range(j + 1)]


@pytest.mark.parametrize('kind', PLANS)
@pytest.mark.parametrize('dt', DTYPES)
def test_snap_2j8_fills_the_sms(kind, dt):
    plan = PLANS[kind](8, DTYPES[dt], N, NNBOR)
    assert plan.blocks >= SMS, plan.describe()
    assert lp.resident_blocks(plan.smem, plan.lanes * plan.threads) >= 1


def test_snap_2j8_shared_memory_by_term():
    """The plans' byte counts at snap-2j8 f64, recounted term by term."""
    f64, rootpq = 8, 15 * 15
    # U, 16 atoms x 8 threads: rootpq, Cayley-Klein parameters of 8
    # neighbors, the level ping-pong of the largest level (5 x 9 = 45
    # elements, re and im) and the sum over idxu_half_max = 155 rows
    u = lp.u_plan(8, torch.float64, N, NNBOR)
    assert (u.lanes, u.threads) == (16, 8)
    assert u.smem == f64 * (rootpq + 5 * 8 * 16 + 2 * 2 * 45 * 16
                            + 2 * 155 * 16) == 69_640
    # fused dE, 16 pairs x 8 threads: geometry (20 values a pair), the
    # stored levels 6 (28 elements) and 7 (32), 8 arrays each (level 8 is
    # never read back), and a 155-entry table of 5 values and one int
    de = lp.de_plan(8, torch.float64, N, NNBOR)
    assert (de.lanes, de.threads) == (16, 8)
    assert de.smem == f64 * (20 * 16 + 8 * (28 + 32) * 16 + 5 * 155) \
        + 4 * 155 == 70_820


@pytest.mark.parametrize('request_', [
    ('u', dict(lanes=64)),                  # 2J=14 f64: sums over 652 rows
    ('u', dict(lanes=64, threads=32)),      # 2048 threads a block
    ('u', dict(groups=NNBOR + 1)),          # more groups than neighbors
    ('de', dict(lanes=32)),                 # 2J=14 f64 state, 32 pairs
    ('de', dict(lanes=128, threads=16)),    # 2048 threads a block
], ids=['u-smem', 'u-threads', 'u-groups', 'de-smem', 'de-threads'])
def test_over_budget_request_raises(request_):
    kind, kw = request_
    with pytest.raises(ValueError):
        PLANS[kind](14, torch.float64, N, NNBOR, **kw)


@pytest.mark.parametrize('kind', PLANS)
def test_unplanned_inputs_raise(kind):
    with pytest.raises(ValueError):
        PLANS[kind](15, torch.float32, N, NNBOR)
    with pytest.raises(TypeError):
        PLANS[kind](8, torch.float16, N, NNBOR)


Y_CASES = [(tj, dt, layout) for tj in (8, 14) for dt in DTYPES
           for layout in ('half', 'full')]
Y_CSR = {'half': y_half_csr, 'full': y_full_csr}
GROUP_SPREAD = 1.25     # a row group's entries at most this x the mean


def _y_ids(case):
    tj, dt, layout = case
    return f'y-2j{tj}-{dt}-{layout}'


@pytest.mark.parametrize('case', Y_CASES, ids=_y_ids)
def test_y_plan_fits_the_card(case):
    tj, dt, layout = case
    plan = lp.y_plan(tj, DTYPES[dt], layout, N)
    rows = len(Y_CSR[layout](tj).rowptr) - 1
    assert rows == lp.y_rows(tj, layout)
    assert plan.smem == lp.y_smem(rows, DTYPES[dt].itemsize, plan.lanes,
                                  plan.threads) <= lp.SMEM_MAX
    assert plan.lanes in lp.Y_LANES
    assert plan.lanes * plan.threads <= lp.Y_THREADS_MAX <= lp.THREADS_MAX
    assert plan.block == (plan.lanes, plan.threads, 1)
    atoms = lp.y_atoms(DTYPES[dt].itemsize, plan.lanes)
    assert atoms == plan.lanes * 16 // DTYPES[dt].itemsize
    assert plan.grid == (-(-N // atoms), plan.groups, 1)
    assert 1 <= plan.groups <= rows
    resident = lp.resident_blocks(plan.smem, plan.lanes * plan.threads)
    assert resident >= 1
    if tj == 8:
        assert plan.blocks >= SMS, plan.describe()


@pytest.mark.parametrize('case', Y_CASES, ids=_y_ids)
def test_y_row_groups_and_slots_cover_the_table(case):
    tj, dt, layout = case
    plan = lp.y_plan(tj, DTYPES[dt], layout, N)
    rowptr = Y_CSR[layout](tj).rowptr.astype(np.int64)
    rows, nnz = len(rowptr) - 1, int(rowptr[-1])
    bounds = lp.y_row_groups(rowptr, plan.groups)
    # contiguous groups, in order, every row exactly once, none empty
    assert bounds[0] == 0 and bounds[-1] == rows
    assert (np.diff(bounds) >= 1).all()
    counts = np.diff(rowptr[bounds])
    assert counts.sum() == nnz
    assert counts.max() <= GROUP_SPREAD * nnz / plan.groups, counts
    assert counts.max() < nnz / plan.groups + np.diff(rowptr).max()
    seg_e, seg_r = lp.y_segments(rowptr, plan.groups, plan.threads)
    slots, total = plan.threads, plan.groups * plan.threads
    assert len(seg_e) == len(seg_r) == total + 1
    # the slots' shares tile the entries, and their owned rows the rows
    assert seg_e[0] == 0 and seg_e[-1] == nnz and (np.diff(seg_e) >= 0).all()
    assert seg_r[0] == 0 and seg_r[-1] == rows and (np.diff(seg_r) >= 0).all()
    for g in range(plan.groups):
        share = np.diff(seg_e[g * slots:(g + 1) * slots + 1])
        assert seg_e[g * slots] == rowptr[bounds[g]]
        assert seg_r[g * slots] == bounds[g]
        assert share.max() - share.min() <= 1
    # a slot owns the rows whose first entry lies in its share
    for s in range(total):
        owned = np.arange(seg_r[s], seg_r[s + 1])
        starts = rowptr[owned]
        assert ((starts >= seg_e[s]) & (starts <= seg_e[s + 1])).all()
        assert (starts[starts == seg_e[s + 1]]
                == rowptr[owned[starts == seg_e[s + 1]] + 1]).all()


def test_y_snap_2j8_shared_memory_by_term():
    """The Y plan's bytes at snap-2j8 f64, recounted term by term: 32 lanes
    of 2 doubles, so the U column tile of 64 atoms over idxu_half_max = 155
    rows (re and im), and 16 slots' partial sums of 64 atoms."""
    plan = lp.y_plan(8, torch.float64, 'half', N)
    assert (plan.lanes, plan.threads, plan.groups) == (32, 16, 8)
    assert plan.smem == 8 * 2 * 64 * (155 + 16) == 175_104


@pytest.mark.parametrize('request_', [
    ('full', 14, dict(lanes=32)),           # 1,240 rows x 32 atoms f64
    ('half', 14, dict(lanes=32)),           # 652 rows x 32 atoms f64
    ('half', 8, dict(lanes=32, slots=32)),  # 1024 threads a block
    ('half', 8, dict(lanes=2)),             # no kernel built for 2 lanes
    ('half', 8, dict(groups=156)),          # more groups than rows
    ('diag', 8, {}),                        # no such table
], ids=['full-smem', 'half-smem', 'threads', 'lanes', 'groups', 'layout'])
def test_y_over_budget_request_raises(request_):
    layout, tj, kw = request_
    with pytest.raises(ValueError):
        lp.y_plan(tj, torch.float64, layout, N, **kw)


def test_ptxas_report_reads_each_kernel():
    """``chip_smoke.py`` reads registers and stack frames from the build
    log (``-Xptxas -v``); device functions without a register line are
    kept apart from kernels."""
    from repro_torch.kernels._build import ptxas_report
    log = '\n'.join([
        "ptxas info    : Compiling entry function '_Z20snap_fused_de_"
        "kernelIdLb0EEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _Z20snap_fused_de_kernel"
        "IdLb0EEvPKT_",
        '    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 128 registers, used 1 barriers, 40 bytes '
        'cumulative stack size',
        'ptxas info    : Function properties for __internal_trig_reduction_'
        'slowpathd',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
    ])
    report = ptxas_report(log)
    assert report['_Z20snap_fused_de_kernelIdLb0EEvPKT_'] == dict(
        stack=40, spill_stores=0, spill_loads=0, registers=128)
    assert 'registers' not in report['__internal_trig_reduction_slowpathd']
