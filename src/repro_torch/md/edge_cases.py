"""Inputs on which a neighbor build's rounding decides the lists.

The O(N^2) build (:func:`repro_torch.kernels.neighbors.brute_build`) must
give bitwise the lists of its plain version, since the force service's
peers-vs-solo contract and the journal's force digests rest on them.
:func:`brute_edge_batch` is one batch of four lanes made from a seed,
where a kernel that rounded otherwise would split from the plain version:

- lane 0 (``n_valid = N``, box 6): atoms 1-3 exactly half a box from atom
  0 along x, y and z, so ``d / box`` is +-0.5 and ``rint`` (half to even)
  gives 0 where ``round`` (half away) gives +-1;
- lane 1 (``n_valid = N - 3``, box 20): atom 1 at r^2 == rcut^2 in the
  working type (out; a float32 build that compared in float64 would take
  it in), atoms 2 and 3 one ulp closer (in), atom 4 valid with a NaN x
  (no pairs), atom 5 in only when r^2 is rounded a step at a time (an FMA
  puts it out), a NaN in the padding;
- lane 2: ``n_valid = 0`` (an inert lane, as ``pack_batch`` fills);
- lane 3 (``n_valid = N - 4``, box 2.5): every valid atom sees all the
  others, more than ``EDGE_K``; among them signed zeros, where the
  minimum image must keep the division's bits: atoms 0 and 1 at +0.0 and
  -0.0 (d = -0.0 one way, +0.0 the other; d - box * rint(d / box) is
  +0.0 both ways), atoms 2 and 3 at one place (d = +0.0), atom 4 with
  -0.0 coordinates, and atom 5 more than 1.5 boxes out (rint of 2 and
  3: the division itself decides).

The CPU tests hold the plain version against the reference on it, and
``chip_smoke.py`` the kernel against the plain version on the card.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

EDGE_RCUT, EDGE_N, EDGE_K = 3.1, 20, 12
HALF_BOX, ULP_BOX, DENSE_BOX = 6.0, 20.0, 2.5


def square_edge(rcut, dtype):
    """(x_eq, x_below): fl(x_eq^2) is rcut^2 rounded to ``dtype`` and
    x_below the next value under x_eq (its square below rcut^2)."""
    rc2 = dtype(rcut * rcut)
    x = dtype(np.sqrt(rc2))
    for _ in range(64):
        if x * x == rc2:
            return x, np.nextafter(x, dtype(0))
        x = np.nextafter(x, dtype(10) if x * x < rc2 else dtype(0))
    raise ValueError(f'no {dtype.__name__} square equals {rcut}^2')


def stepwise_pair(rcut, dtype):
    """(a, b): a pair at (a, b, 0) is within rcut when r^2 = fl(fl(a^2) +
    fl(b^2)), and out when either product is contracted into an FMA
    (fl(a^2 + fl(b^2)) or fl(b^2 + fl(a^2)))."""
    rc2 = dtype(rcut * rcut)

    def fused(p, q):                    # fl(p^2 + fl(q^2)), rounded once
        exact = Fraction(float(p)) ** 2 + Fraction(float(q * q))
        return dtype(exact.numerator / exact.denominator)
    for a in np.linspace(0.6 * rcut, 0.8 * rcut, 4001).astype(dtype):
        b = dtype(np.sqrt(rc2 - a * a))
        for _ in range(8):
            if a * a + b * b < rc2 and fused(a, b) >= rc2 and \
                    fused(b, a) >= rc2:
                return a, b
            b = np.nextafter(b, dtype(10))
    raise ValueError(f'no {dtype.__name__} pair tells an FMA apart')


def brute_edge_batch(dtype=np.float64, seed=0):
    """(pos [4, EDGE_N, 3], box [4, 3], n_valid [4] int32) numpy arrays in
    ``dtype`` for a build at ``EDGE_RCUT`` (lanes as the module says)."""
    N = EDGE_N
    rng = np.random.default_rng(seed)
    pos = np.zeros((4, N, 3))
    box = np.array([[HALF_BOX] * 3, [ULP_BOX] * 3, [HALF_BOX] * 3,
                    [DENSE_BOX] * 3])
    pos[0] = rng.uniform(0.0, HALF_BOX, (N, 3))
    pos[0, :4] = [[1, 1, 1], [4, 1, 1], [1, 4, 1], [1, 1, 4]]
    x_eq, x_below = square_edge(EDGE_RCUT, dtype)
    pos[1] = rng.uniform(5.0, 15.0, (N, 3))     # far from atoms 0-5
    pos[1, :6] = [[0, 0, 0], [x_eq, 0, 0], [0, x_below, 0],
                  [0, 0, -x_below], [np.nan, 0.5, 0.5],
                  [*stepwise_pair(EDGE_RCUT, dtype), 0]]
    pos[1, N - 1, 0] = np.nan                   # padding
    pos[2] = rng.uniform(0.0, HALF_BOX, (N, 3))
    pos[3] = rng.uniform(0.0, DENSE_BOX, (N, 3))
    pos[3, :6] = [[0.0, 0.0, 0.0], [-0.0, -0.0, -0.0], [1.1, 0.7, 2.2],
                  [1.1, 0.7, 2.2], [-0.0, 1.25, -0.0],
                  [0.4 + 2 * DENSE_BOX, 0.9 - 2 * DENSE_BOX,
                   1.0 + 3 * DENSE_BOX]]
    n_valid = np.array([N, N - 3, 0, N - 4], np.int32)
    return pos.astype(dtype), box.astype(dtype), n_valid
