"""The yardstick: the operations and bytes that SNAP's stages need, and the
peaks of the card they are held against.

The per-pair and per-term operation counts are a frozen copy of
``repro_torch.analysis.cost`` (``u_flops``, ``y_flops``, ``de_flops``; the
CSR's 4 and the assembly's 12 operations a pair; the brute build's 20 a
pair).  Changed from the original:

- the work is counted as the inputs need it: the pairs are the ordered
  pairs closer than rcut, which the benchmark counts itself from the
  positions it generated, never the padded width of a list the program
  built; the Y terms are those whose destination the force contraction
  weighs; the brute build's pairs are the B x N^2 of each lane's valid
  atoms;
- the peaks are the highest the H100 SXM reaches in each type: 67 TFLOP/s
  in float64 (its tensor cores), 67 TFLOP/s in float32, 989 TFLOP/s in
  bfloat16, and 3.35 TB/s of HBM3 (NVIDIA's data sheet, dense, 700 W).

So a share of these bounds reads the same work whatever implements it, and
cannot pass 100 % unless a count is wrong.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

HBM_BPS = 3.35e12
PEAK_FLOPS = {'float64': 67e12, 'float32': 67e12, 'bfloat16': 989e12}
ITEMSIZE = {'float64': 8, 'float32': 4, 'bfloat16': 2}


def _levels(twojmax):
    for j in range(1, twojmax + 1):
        rows = j // 2 + 1
        weighted = sum(1 for mb in range(rows) for ma in range(j + 1)
                       if 2 * mb < j or 2 * ma <= j)
        yield j, rows, weighted


def u_flops(twojmax: int, pairs: float) -> float:
    """U: geometry ~40; per recursion term 10; per left element 4 to add
    sfac * u into the atom's sum."""
    per = 40 + 1 + sum(10 * 2 * j * rows + 4 * rows * (j + 1)
                       for j, rows, _ in _levels(twojmax))
    return per * pairs


def y_flops(y_terms: int, atoms: float) -> float:
    """Y: 6 for the complex product, 2 for the coefficient, 2 to add."""
    return 10 * y_terms * atoms


def de_flops(twojmax: int, pairs: float) -> float:
    """Fused dE: geometry and gradient ~80; per term 10 for u and 3 x 18
    for the tangents; per weighted element 2 + 3 x 10 to contract."""
    per = 80 + 4 + sum((10 + 54) * 2 * j * rows + 32 * w
                       for j, rows, w in _levels(twojmax))
    return per * pairs


def asm_flops(pairs: float) -> float:
    """The by-destination index (4 a pair) and the assembly (12 a pair)."""
    return 16 * pairs


def brute_flops(pairs: float) -> float:
    """The all-pairs neighbour build: 20 a candidate pair."""
    return 20 * pairs


@lru_cache(maxsize=None)
def half_elements(twojmax: int) -> int:
    """The left rows (2 mb <= j) of every layer: the U and Y planes."""
    return sum((j // 2 + 1) * (j + 1) for j in range(twojmax + 1))


@lru_cache(maxsize=None)
def y_terms(twojmax: int) -> int:
    """The Z terms (one a (jjz, mb1, ma1)) whose destination the force
    contraction weighs."""
    from .reference.indices import build_tables
    t = build_tables(twojmax)
    return int(np.count_nonzero(t.dedr_weight[t.idxz_jju[t.z_dest]]))


def stage_work(twojmax: int, atoms: float, pairs: float, dtype: str):
    """{stage: (flops, bytes)} of one force evaluation of ``atoms`` atoms
    with ``pairs`` ordered pairs within rcut.  Bytes count each input read
    once and each output written once."""
    it = ITEMSIZE[dtype]
    plane = half_elements(twojmax) * 2 * it * atoms
    return {
        'u': (u_flops(twojmax, pairs), 3 * it * pairs + plane),
        'y': (y_flops(y_terms(twojmax), atoms), 2 * plane),
        'de': (de_flops(twojmax, pairs), 6 * it * pairs + plane),
        'asm': (asm_flops(pairs), (3 * it + 4) * pairs + 3 * it * atoms),
    }


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BPS)
