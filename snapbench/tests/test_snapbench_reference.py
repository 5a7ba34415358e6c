"""The float64 reference against the port's plain pipelines at 2J=4 on the
CPU, and the yardstick's counts."""

import pytest
import torch

from snapbench import cost, inputs, trace
from snapbench.reference.md import count_pairs, forces_of, pairs_within
from snapbench.reference.snap import Snap
from snapbench.roofline import idle_share, mfu, stage_share

SNAP = dict(twojmax=4, rcut=4.7, rfac0=0.99363, rmin0=0.0, switch_flag=True,
            bzero_flag=True, wself=1.0)


@pytest.fixture(scope='module')
def system():
    base, box = inputs.bcc(3, 3.1652)
    pos = base + inputs.rng(5, 0).normal(scale=0.05, size=base.shape)
    beta = inputs.rng(5, 1).normal(size=14) * 5e-3
    return pos, box, beta


@pytest.mark.parametrize('impl', ['adjoint', 'kernel'])
def test_reference_matches_the_port_plain_pipeline(system, impl):
    from repro_torch.core.snap import SnapConfig, energy_forces
    from repro_torch.md.neighbor import brute_neighbors
    pos, box, beta = system
    cfg = SnapConfig(twojmax=4, rcut=4.7)
    nbr, mask, disp, _ = brute_neighbors(pos, box, 4.7, 40)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    kw = dict(device='cpu') if impl == 'adjoint' else dict(
        device='cpu', dtype=torch.float64)
    e, _, f = energy_forces(cfg, t(beta), 0.0, t(disp[..., 0]),
                            t(disp[..., 1]), t(disp[..., 2]), t(nbr),
                            t(mask), impl=impl, **kw)
    ref = Snap(SNAP, beta, 0.0, 'cpu')
    er, fr = forces_of(ref, torch.as_tensor(pos), box)
    assert abs(float(e) - float(er)) <= 1e-12 * abs(float(er))
    assert torch.max(torch.abs(f - fr)) <= 1e-12 * torch.max(torch.abs(fr))


def test_pairs_match_the_port_lists(system):
    from repro_torch.md.neighbor import brute_neighbors
    pos, box, _ = system
    nbr, mask, _, _ = brute_neighbors(pos, box, 4.7, 40)
    i, k, _ = pairs_within(torch.as_tensor(pos), box, 4.7)
    mine = sorted(zip(i.tolist(), k.tolist()))
    theirs = sorted((a, int(nbr[a, s])) for a in range(len(pos))
                    for s in range(nbr.shape[1]) if mask[a, s])
    assert mine == theirs


def test_work_is_the_same_for_26_and_52_wide_lists(system):
    """The yardstick counts the pairs the inputs need: the same for lists
    of any width, where the port's analysis counted the padded slots."""
    from repro_torch.analysis import cost as port_cost
    from repro_torch.md.neighbor import brute_neighbors
    pos, box, _ = system
    n = len(pos)
    pairs = count_pairs(torch.as_tensor(pos), box, 4.7)
    works = []
    for width in (26, 52):
        _, mask, disp, _ = brute_neighbors(pos, box, 4.7, width)
        assert int(mask.sum()) == pairs
        works.append(cost.stage_work(4, n, pairs, 'float64'))
        padded = port_cost.u_flops(4, width * n)
        assert padded == pytest.approx(cost.u_flops(4, width * n))
    assert works[0] == works[1]
    assert port_cost.u_flops(4, 52 * n) == 2 * port_cost.u_flops(4, 26 * n)


def test_y_terms_are_the_port_half_table():
    from repro_torch.core.indices import build_index
    for tj in (2, 4):
        assert cost.y_terms(tj) == len(build_index(tj).z_half_dest)
        assert cost.half_elements(tj) == build_index(tj).idxu_half_max


def test_readers_on_a_synthetic_window():
    sec = 10 ** 9
    dev = [('void snap_u_kernel<double>', 0, sec // 10),
           ('void snap_y_kernel<double>', sec // 10, sec // 5),
           ('aten::add', sec // 2, sec // 2 + sec // 10)]
    rec = trace.Record(dev, {}, [], (0, sec),
                       dict(evaluations=2, atoms=100, pairs=2600,
                            twojmax=8, dtype='float64'))
    assert idle_share(rec) == pytest.approx(70.0)
    f, b = cost.stage_work(8, 100, 2600, 'float64')['u']
    assert stage_share(rec, 'u') == pytest.approx(
        100 * 2 * cost.bound_s(f, b, 'float64') / 0.1)
    assert 0 < mfu(rec, 2, 100, 2600) < 100
    assert stage_share(rec, 'de') is None
    gaps = rec.breakdown()['idle_gaps']
    assert sum(t for _, t in gaps) == pytest.approx(0.7)


def test_union_of_intervals():
    s, e = trace.merge([30, 5, 0], [40, 20, 10])
    assert s.tolist() == [0, 30] and e.tolist() == [20, 40]
    rec = trace.Record([('a', 0, 10), ('b', 5, 20), ('c', 30, 40)], {}, [],
                       (0, 50), {})
    assert rec.busy_s == pytest.approx(30e-9)
    assert rec.busy_within(8, 12) == 4 and rec.busy_within(20, 30) == 0
    assert rec.busy_within(15, 35) == 10
