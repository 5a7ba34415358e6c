"""The Y kernels' table on the CPU: the packed CSR table against the
reference's COO tables, and the kernels' walk over it.

``kernels/snap_y.py`` sorts each Clebsch-Gordan table by destination and,
inside a row, by (src1, src2), and packs each entry's sources and
conjugation signs into one int32 (``csrc/snap_y.cu`` reads it).  Here: the
packed words decode, through ``order``, to the reference's own table
(``repro.core.indices``: ``z_half_*``, and ``z_coo_*`` with the destination
``idxz_jju[z_coo_dest]``) entry for entry; each row is sorted by (src1,
src2); the packing round-trips every source index and sign; and the
kernel's walk (each row-group slot sums its share of the entries, owns the
rows whose first entry lies in it, and adds the later slots' heads of a row
it owns in slot order), replayed in numpy over
``launch_plan.y_segments``, gives the plain Y exactly as a sum of the same
products (float64, 1e-13).
"""
import numpy as np
import pytest
import torch

from repro.core.indices import build_index as r_build_index
from repro_torch.kernels import launch_plan as lp
from repro_torch.kernels.snap_y import (SRC_BITS, pack_entries,
                                        snap_y_full_plain, snap_y_half_plain,
                                        unpack_entries, y_full_csr,
                                        y_half_csr)

CSR = {'half': y_half_csr, 'full': y_full_csr}


def _reference_table(twojmax, layout):
    """(dest, src1, src2, sig1, sig2) of the reference's COO table, in its
    own order (signs +1 on the full table)."""
    idx = r_build_index(twojmax)
    if layout == 'half':
        return (idx.z_half_dest, idx.z_half_src1, idx.z_half_src2,
                idx.z_half_sig1, idx.z_half_sig2)
    ones = np.ones(len(idx.z_coo_dest))
    return (idx.idxz_jju[idx.z_coo_dest], idx.z_coo_src1, idx.z_coo_src2,
            ones, ones)


@pytest.mark.parametrize('layout', ['half', 'full'])
@pytest.mark.parametrize('twojmax', [2, 8, 14])
def test_packed_table_decodes_to_the_reference(twojmax, layout):
    t = CSR[layout](twojmax)
    dest, src1, src2, sig1, sig2 = _reference_table(twojmax, layout)
    assert len(t.packed) == len(dest) and t.packed.dtype == np.int32
    assert sorted(t.order.tolist()) == list(range(len(dest)))
    got = unpack_entries(t.packed)
    for g, want in zip(got, (src1, src2, sig1, sig2)):
        np.testing.assert_array_equal(g, np.asarray(want)[t.order])
    np.testing.assert_array_equal(t.dest, np.asarray(dest)[t.order])
    np.testing.assert_array_equal(np.diff(t.rowptr),
                                  np.bincount(t.dest,
                                              minlength=len(t.rowptr) - 1))


@pytest.mark.parametrize('layout', ['half', 'full'])
@pytest.mark.parametrize('twojmax', [2, 8, 14])
def test_rows_sorted_by_sources(twojmax, layout):
    """Inside each row the entries run in (src1, src2) order (equal pairs
    keep the reference's order), so the kernel keeps u[src1] across a
    run."""
    t = CSR[layout](twojmax)
    key = (t.dest.astype(np.int64) << 32) | (t.src1.astype(np.int64) << 16) \
        | t.src2
    assert (np.diff(key) >= 0).all()
    tie = np.diff(key) == 0
    assert (np.diff(t.order)[tie] > 0).all()


def test_packing_round_trips():
    rng = np.random.default_rng(5)
    top = (1 << SRC_BITS) - 1
    src1 = np.concatenate([[0, top, top, 0], rng.integers(0, top, 500)])
    src2 = np.concatenate([[top, 0, top, 0], rng.integers(0, top, 500)])
    sig1 = np.concatenate([[-1, 1, -1, 1], rng.choice([-1.0, 1.0], 500)])
    sig2 = np.concatenate([[1, -1, -1, 1], rng.choice([-1.0, 1.0], 500)])
    for got, want in zip(unpack_entries(pack_entries(src1, src2, sig1, sig2)),
                         (src1, src2, sig1, sig2)):
        np.testing.assert_array_equal(got, want)
    _, _, s1, s2 = unpack_entries(pack_entries(src1, src2))
    assert (s1 == 1).all() and (s2 == 1).all()
    with pytest.raises(ValueError):
        pack_entries([top + 1], [0])


def _walk(t, ut_r, ut_i, coef, groups, slots):
    """The kernel's walk (``csrc/snap_y.cu: snap_y_kernel``) in numpy, all
    atoms at once: the float64 Y planes, and the count of writes a row."""
    segs = lp.y_segments(t.rowptr, groups, slots)
    seg_e, seg_r = segs[0], segs[1]
    rows, n = ut_r.shape
    y_r, y_i = np.full((rows, n), np.nan), np.full((rows, n), np.nan)
    writes = np.zeros(rows, int)
    src1, src2, sig1, sig2 = unpack_entries(t.packed)

    def total(lo, hi):
        acc_r, acc_i = np.zeros(n), np.zeros(n)
        for e in range(lo, hi):
            v1r, v1i = ut_r[src1[e]], sig1[e] * ut_i[src1[e]]
            v2r, v2i = ut_r[src2[e]], sig2[e] * ut_i[src2[e]]
            acc_r += coef[e] * (v1r * v2r - v1i * v2i)
            acc_i += coef[e] * (v1r * v2i + v1i * v2r)
        return acc_r, acc_i

    for g in range(groups):
        first, heads, open_rows = g * slots, {}, []
        for y in range(slots):
            s = first + y
            e_lo, e_hi, r_lo, r_hi = seg_e[s], seg_e[s + 1], seg_r[s], \
                seg_r[s + 1]
            e = min(t.rowptr[r_lo], e_hi)
            heads[y] = total(e_lo, e)
            for r in range(r_lo, r_hi):
                stop = min(t.rowptr[r + 1], e_hi)
                acc = total(e, stop)
                e = stop
                if t.rowptr[r + 1] > e_hi:
                    open_rows.append((y, r, acc))
                else:
                    y_r[r], y_i[r] = acc
                    writes[r] += 1
        for y, r, (acc_r, acc_i) in open_rows:     # after the barrier
            k = y + 1
            while seg_e[first + k] < t.rowptr[r + 1]:
                acc_r, acc_i = acc_r + heads[k][0], acc_i + heads[k][1]
                k += 1
            y_r[r], y_i[r] = acc_r, acc_i
            writes[r] += 1
    return y_r, y_i, writes


@pytest.mark.parametrize('plan', [(1, 1), (1, 8), (3, 4), (5, 32), (7, 2)],
                         ids=lambda p: f'{p[0]}groups-{p[1]}slots')
@pytest.mark.parametrize('layout', ['half', 'full'])
def test_kernel_walk_matches_plain(layout, plan):
    """Every row written exactly once (the empty mirror rows of the full
    table as 0), and the sums equal the plain Y's: a slot share may start
    and end inside a row, and a share may be empty (32 slots)."""
    twojmax, n = 4, 3
    groups, slots = plan
    t = CSR[layout](twojmax)
    rows = len(t.rowptr) - 1
    rng = np.random.default_rng(groups * 10 + slots)
    ut_r, ut_i = rng.normal(size=(rows, n)), rng.normal(size=(rows, n))
    coef = rng.normal(size=len(t.packed))
    y_r, y_i, writes = _walk(t, ut_r, ut_i, coef, groups, slots)
    assert (writes == 1).all()
    plain = snap_y_half_plain if layout == 'half' else snap_y_full_plain
    want = plain(torch.as_tensor(ut_r), torch.as_tensor(ut_i),
                 torch.as_tensor(coef), twojmax=twojmax)
    scale = max(float(w.abs().max()) for w in want)
    for got, w in zip((y_r, y_i), want):
        assert np.abs(got - w.numpy()).max() <= 1e-13 * scale
    empty = np.diff(t.rowptr) == 0
    assert (y_r[empty] == 0).all() and (y_i[empty] == 0).all()
