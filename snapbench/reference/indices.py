"""SU(2) index tables of the SNAP bispectrum, in numpy.

A frozen copy of ``repro_torch.core.indices`` (the LAMMPS ``sna.cpp``
conventions: every ``j`` is the doubled angular momentum).  Changed from
the original: the half-space COO tables and the dB tables are left out
(the reference uses neither), and nothing is cached between calls, so the
benchmark works every table out again from the configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _fact(n: int) -> float:
    return float(math.factorial(n))


def deltacg(j1: int, j2: int, j: int) -> float:
    """The triangle coefficient Delta(j1 j2 j) (doubled-j arguments)."""
    return math.sqrt(_fact((j1 + j2 - j) // 2) * _fact((j1 - j2 + j) // 2)
                     * _fact((-j1 + j2 + j) // 2)
                     / _fact((j1 + j2 + j) // 2 + 1))


def clebsch_gordan_block(j1: int, j2: int, j: int) -> np.ndarray:
    """``cg[m1, m2]``: the coefficient coupling u_j1(m1) and u_j2(m2) into
    element ``(2 m1 - j1 + 2 m2 - j2 + j) / 2`` of the rank-(j+1) product
    (the Racah formula, LAMMPS ``init_clebsch_gordan``)."""
    out = np.zeros((j1 + 1, j2 + 1))
    for m1 in range(j1 + 1):
        aa2 = 2 * m1 - j1
        for m2 in range(j2 + 1):
            bb2 = 2 * m2 - j2
            m = (aa2 + bb2 + j) // 2
            if (aa2 + bb2 + j) % 2 or m < 0 or m > j:
                continue
            z_min = max(0, -(j - j2 + aa2) // 2, -(j - j1 - bb2) // 2)
            z_max = min((j1 + j2 - j) // 2, (j1 - aa2) // 2, (j2 + bb2) // 2)
            total = 0.0
            for z in range(z_min, z_max + 1):
                total += (-1.0 if z % 2 else 1.0) / (
                    _fact(z) * _fact((j1 + j2 - j) // 2 - z)
                    * _fact((j1 - aa2) // 2 - z) * _fact((j2 + bb2) // 2 - z)
                    * _fact((j - j2 + aa2) // 2 + z)
                    * _fact((j - j1 - bb2) // 2 + z))
            cc2 = 2 * m - j
            sfac = math.sqrt(
                _fact((j1 + aa2) // 2) * _fact((j1 - aa2) // 2)
                * _fact((j2 + bb2) // 2) * _fact((j2 - bb2) // 2)
                * _fact((j + cc2) // 2) * _fact((j - cc2) // 2) * (j + 1))
            out[m1, m2] = total * deltacg(j1, j2, j) * sfac
    return out


def triples_of(twojmax: int):
    """Every (j1, j2, j) with j1 >= j2 and |j1-j2| <= j <= min(2J, j1+j2)."""
    return [(j1, j2, j) for j1 in range(twojmax + 1) for j2 in range(j1 + 1)
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2)]


def half_weights(j: int) -> np.ndarray:
    """LAMMPS' half-plane sum over a (j+1)^2 layer: rows 2mb < j weigh 1;
    for even j the middle row weighs 1 below ma = j/2, 0.5 at it, 0 past
    it; rows 2mb > j weigh 0."""
    w = np.zeros((j + 1, j + 1))
    for mb in range(j + 1):
        if 2 * mb < j:
            w[mb] = 1.0
        elif 2 * mb == j:
            w[mb, :j // 2] = 1.0
            w[mb, j // 2] = 0.5
    return w


@dataclass
class ULevel:
    """The recursion's maps for layer j (its left rows 2mb <= j, then the
    mirror u(mb, ma) = (-1)^(mb+ma) conj u(j-mb, j-ma) for the others)."""
    a_src: np.ndarray
    b_src: np.ndarray
    a_coef: np.ndarray
    b_coef: np.ndarray
    full_src: np.ndarray
    full_conj: np.ndarray
    full_sign: np.ndarray


def ulevel(j: int) -> ULevel:
    rows = j // 2 + 1
    n_left, n_full = rows * (j + 1), (j + 1) ** 2
    a_src, b_src = np.zeros(n_left, np.int64), np.zeros(n_left, np.int64)
    a_coef, b_coef = np.zeros(n_left), np.zeros(n_left)
    for mb in range(rows):
        for ma in range(j + 1):
            e = mb * (j + 1) + ma
            if ma < j:
                a_src[e] = mb * j + ma
                a_coef[e] = math.sqrt((j - ma) / (j - mb))
            if ma > 0:
                b_src[e] = mb * j + ma - 1
                b_coef[e] = -math.sqrt(ma / (j - mb))
    full_src = np.zeros(n_full, np.int64)
    full_conj = np.zeros(n_full, bool)
    full_sign = np.ones(n_full)
    for mb in range(j + 1):
        for ma in range(j + 1):
            f = mb * (j + 1) + ma
            if 2 * mb <= j:
                full_src[f] = f
            else:
                full_src[f] = (j - mb) * (j + 1) + (j - ma)
                full_conj[f] = True
                full_sign[f] = 1.0 if (mb + ma) % 2 == 0 else -1.0
    return ULevel(a_src, b_src, a_coef, b_coef, full_src, full_conj,
                  full_sign)


@dataclass
class Tables:
    """Everything the reference reads for one 2J."""
    twojmax: int
    idxu_max: int
    self_diag: np.ndarray       # flat u index of each diagonal element
    dedr_weight: np.ndarray     # [idxu_max] half-plane weights
    ulevels: list
    # the left rows (2 mb <= j) of every layer, stacked: the "half" space
    idxu_half_max: int
    half_to_full: np.ndarray    # [idxu_half_max] full index of each
    full_to_half: np.ndarray    # [idxu_max] the left element mirroring it
    full_conj: np.ndarray       # [idxu_max] the mirror conjugates
    full_sign: np.ndarray       # [idxu_max] (-1)^(mb+ma) on mirrored rows
    # Z = CG-contracted U products: one COO entry per (jjz, mb1, ma1)
    z_dest: np.ndarray          # -> jjz
    z_src1: np.ndarray          # -> flat u index (layer j1)
    z_src2: np.ndarray          # -> flat u index (layer j2)
    z_cg: np.ndarray
    idxz_max: int
    idxz_jju: np.ndarray        # flat u index of (j, mb, ma) of each jjz
    y_jjb: np.ndarray           # [idxz_max] the beta entry of each jjz
    y_fac: np.ndarray           # [idxz_max] multiplicity factor
    idxb_max: int
    b_dest: np.ndarray          # B = sum w Re(conj(u[usrc]) z[zsrc])
    b_zsrc: np.ndarray
    b_usrc: np.ndarray
    b_w: np.ndarray
    bzero: np.ndarray           # [idxb_max] self-contribution of each B


def build_tables(twojmax: int, wself: float = 1.0) -> Tables:
    block, c = [], 0
    for j in range(twojmax + 1):
        block.append(c)
        c += (j + 1) ** 2
    idxu_max = c
    self_diag = np.array([block[j] + m * (j + 2) for j in range(twojmax + 1)
                          for m in range(j + 1)], np.int64)
    half_to_full, full_to_half = [], np.zeros(idxu_max, np.int64)
    full_conj, full_sign = np.zeros(idxu_max, bool), np.ones(idxu_max)
    for j in range(twojmax + 1):
        for mb in range(j // 2 + 1):
            for ma in range(j + 1):
                full_to_half[block[j] + mb * (j + 1) + ma] = len(half_to_full)
                half_to_full.append(block[j] + mb * (j + 1) + ma)
        for mb in range(j // 2 + 1, j + 1):
            for ma in range(j + 1):
                f = block[j] + mb * (j + 1) + ma
                full_to_half[f] = full_to_half[block[j] + (j - mb) * (j + 1)
                                               + (j - ma)]
                full_conj[f] = True
                full_sign[f] = 1.0 if (mb + ma) % 2 == 0 else -1.0
    dedr_weight = np.concatenate([half_weights(j).ravel()
                                  for j in range(twojmax + 1)])
    triples = triples_of(twojmax)
    cgs = {t: clebsch_gordan_block(*t) for t in triples}
    zblock, rows = {}, []
    for (j1, j2, j) in triples:
        zblock[(j1, j2, j)] = len(rows)
        rows += [(j1, j2, j, mb, ma) for mb in range(j // 2 + 1)
                 for ma in range(j + 1)]
    idxz_jju = np.array([block[j] + mb * (j + 1) + ma
                         for (_, _, j, mb, ma) in rows], np.int64)
    zd, z1, z2, zc = [], [], [], []
    for jjz, (j1, j2, j, mb, ma) in enumerate(rows):
        cg = cgs[(j1, j2, j)]
        ma1min = max(0, (2 * ma - j - j2 + j1) // 2)
        ma2max = (2 * ma - j - (2 * ma1min - j1) + j2) // 2
        na = min(j1, (2 * ma - j + j2 + j1) // 2) - ma1min + 1
        mb1min = max(0, (2 * mb - j - j2 + j1) // 2)
        mb2max = (2 * mb - j - (2 * mb1min - j1) + j2) // 2
        nb = min(j1, (2 * mb - j + j2 + j1) // 2) - mb1min + 1
        for ib in range(nb):
            mb1, mb2 = mb1min + ib, mb2max - ib
            for ia in range(na):
                ma1, ma2 = ma1min + ia, ma2max - ia
                zd.append(jjz)
                z1.append(block[j1] + mb1 * (j1 + 1) + ma1)
                z2.append(block[j2] + mb2 * (j2 + 1) + ma2)
                zc.append(cg[mb1, mb2] * cg[ma1, ma2])
    btriples = [t for t in triples if t[2] >= t[0]]
    bindex = {t: i for i, t in enumerate(btriples)}
    y_jjb = np.zeros(len(rows), np.int64)
    y_fac = np.zeros(len(rows))
    for jjz, (j1, j2, j, _, _) in enumerate(rows):
        if j >= j1:
            y_jjb[jjz] = bindex[(j1, j2, j)]
            y_fac[jjz] = (3.0 if j2 == j else 2.0) if j1 == j else 1.0
        elif j >= j2:
            y_jjb[jjz] = bindex[(j, j2, j1)]
            y_fac[jjz] = (j1 + 1) / (j + 1.0) * (2.0 if j2 == j else 1.0)
        else:
            y_jjb[jjz] = bindex[(j2, j, j1)]
            y_fac[jjz] = (j1 + 1) / (j + 1.0)
    bd, bz, bu, bw = [], [], [], []
    for jjb, (j1, j2, j) in enumerate(btriples):
        w = half_weights(j)
        for mb in range(j // 2 + 1):
            for ma in range(j + 1):
                if w[mb, ma]:
                    bd.append(jjb)
                    bz.append(zblock[(j1, j2, j)] + mb * (j + 1) + ma)
                    bu.append(block[j] + mb * (j + 1) + ma)
                    bw.append(2.0 * w[mb, ma])
    bzero = np.array([wself ** 3 * (j + 1) for (_, _, j) in btriples])
    arr = lambda x, t=np.int64: np.array(x, t)  # noqa: E731
    return Tables(
        twojmax=twojmax, idxu_max=idxu_max, self_diag=self_diag,
        dedr_weight=dedr_weight,
        ulevels=[ulevel(j) for j in range(1, twojmax + 1)],
        idxu_half_max=len(half_to_full), half_to_full=arr(half_to_full),
        full_to_half=full_to_half, full_conj=full_conj, full_sign=full_sign,
        z_dest=arr(zd), z_src1=arr(z1), z_src2=arr(z2),
        z_cg=arr(zc, np.float64), idxz_max=len(rows), idxz_jju=idxz_jju,
        y_jjb=y_jjb, y_fac=y_fac, idxb_max=len(btriples), b_dest=arr(bd),
        b_zsrc=arr(bz), b_usrc=arr(bu), b_w=arr(bw, np.float64),
        bzero=bzero)
