"""SU(2) index machinery for SNAP bispectrum calculations.

A verbatim copy of ``repro.core.indices`` (numpy only): the port keeps its
own copy so that it imports nothing of the reference package, and the
parity tests check that both build identical tables.

All tables here are pure-numpy, computed once per ``twojmax`` and treated as
compile-time constants by the JAX pipelines.  The conventions follow LAMMPS
``sna.cpp`` exactly (all ``j`` variables are the *doubled* angular momenta,
i.e. integers ``2j``):

- ``idxu``:  flattened storage of the (2j+1)x(2j+1) Wigner-U layers,
  row-major ``(mb, ma)`` within each layer, layers stacked by ``j``.
- ``idxz``:  one entry per (j1, j2, j, mb, ma) with ``j1 >= j2``,
  ``|j1-j2| <= j <= min(twojmax, j1+j2)`` (step 2) and ``2*mb <= j``.
- ``idxb``:  the unique bispectrum triples, i.e. idxz triples restricted to
  ``j >= j1`` (so ``j >= j1 >= j2``).
- Clebsch-Gordan coefficients per triple via the Racah factorial formula.

On top of the canonical tables we precompute *vectorized* gather/scatter maps
(COO triplets, per-recursion-level slices, symmetry mirrors) that let JAX and
Pallas express the same loops as dense array ops.  This is the TPU analogue
of the paper's index flattening (Sec. V) and AoSoA layout (Sec. VI-B).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np


def _factorial(n: int) -> float:
    return float(math.factorial(n))


def deltacg(j1: int, j2: int, j: int) -> float:
    """The triangle coefficient Delta(j1 j2 j) (doubled-j integer args)."""
    sfaccg = _factorial((j1 + j2 + j) // 2 + 1)
    return math.sqrt(
        _factorial((j1 + j2 - j) // 2)
        * _factorial((j1 - j2 + j) // 2)
        * _factorial((-j1 + j2 + j) // 2)
        / sfaccg
    )


def clebsch_gordan_block(j1: int, j2: int, j: int) -> np.ndarray:
    """Dense CG block ``cg[m1, m2]`` of shape (j1+1, j2+1), LAMMPS convention.

    ``cg[m1, m2]`` couples ``u_{j1}(.., m1)`` and ``u_{j2}(.., m2)`` into the
    ``m = (aa2 + bb2 + j)/2`` element of the rank-(j+1) product; entries whose
    target ``m`` falls outside [0, j] are zero.
    """
    out = np.zeros((j1 + 1, j2 + 1), dtype=np.float64)
    for m1 in range(j1 + 1):
        aa2 = 2 * m1 - j1
        for m2 in range(j2 + 1):
            bb2 = 2 * m2 - j2
            m = (aa2 + bb2 + j) // 2
            if (aa2 + bb2 + j) % 2 != 0:
                # parity mismatch cannot happen for valid (j1,j2,j) triples
                continue
            if m < 0 or m > j:
                continue
            z_min = max(0, max(-(j - j2 + aa2) // 2, -(j - j1 - bb2) // 2))
            z_max = min(
                (j1 + j2 - j) // 2,
                min((j1 - aa2) // 2, (j2 + bb2) // 2),
            )
            total = 0.0
            for z in range(z_min, z_max + 1):
                ifac = -1.0 if z % 2 else 1.0
                total += ifac / (
                    _factorial(z)
                    * _factorial((j1 + j2 - j) // 2 - z)
                    * _factorial((j1 - aa2) // 2 - z)
                    * _factorial((j2 + bb2) // 2 - z)
                    * _factorial((j - j2 + aa2) // 2 + z)
                    * _factorial((j - j1 - bb2) // 2 + z)
                )
            cc2 = 2 * m - j
            dcg = deltacg(j1, j2, j)
            sfaccg = math.sqrt(
                _factorial((j1 + aa2) // 2)
                * _factorial((j1 - aa2) // 2)
                * _factorial((j2 + bb2) // 2)
                * _factorial((j2 - bb2) // 2)
                * _factorial((j + cc2) // 2)
                * _factorial((j - cc2) // 2)
                * (j + 1)
            )
            out[m1, m2] = total * dcg * sfaccg
    return out


def valid_triples(twojmax: int):
    """All (j1, j2, j) with j1 >= j2, |j1-j2| <= j <= min(twojmax, j1+j2)."""
    out = []
    for j1 in range(twojmax + 1):
        for j2 in range(j1 + 1):
            for j in range(j1 - j2, min(twojmax, j1 + j2) + 1, 2):
                out.append((j1, j2, j))
    return out


@dataclass(frozen=True)
class ULevelMaps:
    """Vectorized maps for one level ``j`` of the Wigner-U recursion.

    The recursion (paper eq. 9 / LAMMPS compute_uarray) for the "left" rows
    (2*mb <= j) is

        u_j(mb, ma) =  sqrt((j-ma)/(j-mb)) * conj(a) * u_{j-1}(mb, ma)
                     - sqrt(  ma  /(j-mb)) * conj(b) * u_{j-1}(mb, ma-1)

    followed by the symmetry fill
        u_j(mb', ma') = (-1)^(mb'+ma') conj(u_j(j-mb', j-ma'))   (2*mb' > j)
    """

    j: int
    n_left: int              # (j//2 + 1) * (j + 1)
    n_full: int              # (j + 1)**2
    a_src: np.ndarray        # [n_left] flat index into previous *full* layer
    b_src: np.ndarray        # [n_left]
    a_coef: np.ndarray       # [n_left] sqrt((j-ma)/(j-mb)), 0 where absent
    b_coef: np.ndarray       # [n_left] -sqrt(ma/(j-mb)),    0 where absent
    full_src: np.ndarray     # [n_full] index into the left array
    full_conj: np.ndarray    # [n_full] bool: apply conj
    full_sign: np.ndarray    # [n_full] +-1.0


def _build_ulevel(j: int) -> ULevelMaps:
    n_rows_left = j // 2 + 1
    n_left = n_rows_left * (j + 1)
    n_full = (j + 1) * (j + 1)
    a_src = np.zeros(n_left, dtype=np.int32)
    b_src = np.zeros(n_left, dtype=np.int32)
    a_coef = np.zeros(n_left, dtype=np.float64)
    b_coef = np.zeros(n_left, dtype=np.float64)
    for mb in range(n_rows_left):
        for ma in range(j + 1):
            e = mb * (j + 1) + ma
            if ma < j:  # a-term from u_{j-1}(mb, ma); prev row stride = j
                a_src[e] = mb * j + ma
                a_coef[e] = math.sqrt((j - ma) / (j - mb))
            if ma > 0:  # b-term from u_{j-1}(mb, ma-1)
                b_src[e] = mb * j + (ma - 1)
                b_coef[e] = -math.sqrt(ma / (j - mb))
    full_src = np.zeros(n_full, dtype=np.int32)
    full_conj = np.zeros(n_full, dtype=bool)
    full_sign = np.ones(n_full, dtype=np.float64)
    for mb in range(j + 1):
        for ma in range(j + 1):
            f = mb * (j + 1) + ma
            if 2 * mb <= j:
                full_src[f] = f  # identity into left array
            else:
                mbs, mas = j - mb, j - ma
                full_src[f] = mbs * (j + 1) + mas
                full_conj[f] = True
                full_sign[f] = 1.0 if (mb + ma) % 2 == 0 else -1.0
    return ULevelMaps(
        j=j, n_left=n_left, n_full=n_full,
        a_src=a_src, b_src=b_src, a_coef=a_coef, b_coef=b_coef,
        full_src=full_src, full_conj=full_conj, full_sign=full_sign,
    )


@dataclass(frozen=True)
class SnapIndex:
    """All static tables for a given ``twojmax`` (= 2J)."""

    twojmax: int
    # --- idxu ---
    idxu_block: np.ndarray        # [twojmax+1] start offset of layer j
    idxu_max: int
    idxu_j: np.ndarray            # [idxu_max] layer of each flat u element
    idxu_mb: np.ndarray           # [idxu_max]
    idxu_ma: np.ndarray           # [idxu_max]
    self_diag: np.ndarray         # flat indices of (ma == mb) diagonal elems
    dedr_weight: np.ndarray       # [idxu_max] half-plane contraction weights
    # --- idxu_half: compacted storage of the symmetric left rows 2mb <= j ---
    # Every full element is recoverable through the j-mirror
    #     u(j, mb, ma) = (-1)^(mb+ma) conj(u(j, j-mb, j-ma))      (2mb > j)
    # so the pipeline stores only rows mb <= j/2 of each layer, contiguous
    # per layer at ``idxu_half_block[j]`` in the same row-major (mb, ma)
    # order (it is the flattened left storage of the recursion).
    idxu_half_block: np.ndarray   # [twojmax+1] start offset of half layer j
    idxu_half_max: int
    half_to_full: np.ndarray      # [idxu_half_max] flat full-space index
    full_to_half: np.ndarray      # [idxu_max] half-space source of each elem
    full_to_half_conj: np.ndarray  # [idxu_max] bool: mirror applies conj
    full_to_half_sign: np.ndarray  # [idxu_max] (-1)^(mb+ma) on mirrored rows
    self_diag_half: np.ndarray    # half-space indices of (ma == mb, 2mb<=j)
    dedr_weight_half: np.ndarray  # [idxu_half_max] contraction weights
    # --- u recursion levels ---
    ulevels: tuple
    # --- triples / cg ---
    triples: tuple                # canonical (j1, j2, j) list (j1 >= j2)
    # --- idxz ---
    idxz_max: int
    idxz_j1: np.ndarray
    idxz_j2: np.ndarray
    idxz_j: np.ndarray
    idxz_jju: np.ndarray          # target flat-u index of (j, mb, ma)
    idxz_block: dict              # (j1,j2,j) -> start index into idxz
    # COO expansion of the CG contraction: one entry per (jjz, ib, ia)
    z_coo_dest: np.ndarray        # [nnz] -> jjz
    z_coo_src1: np.ndarray        # [nnz] -> flat u index (layer j1)
    z_coo_src2: np.ndarray        # [nnz] -> flat u index (layer j2)
    z_coo_cg: np.ndarray          # [nnz] cg(mb-pair) * cg(ma-pair)
    # Half-space COO: the same contraction with every source remapped into
    # idxu_half space (mirror signs folded into the CG weight, per-source
    # conjugation as +-1 factors on the imaginary part), the destination in
    # half space, and dest entries that no contraction ever reads (middle
    # row 2mb == j, columns 2ma > j — weight 0 everywhere) dropped.
    z_half_dest: np.ndarray       # [nnz_half] -> idxu_half index
    z_half_src1: np.ndarray       # [nnz_half] -> idxu_half index
    z_half_src2: np.ndarray       # [nnz_half] -> idxu_half index
    z_half_sig1: np.ndarray       # [nnz_half] +-1 conj factor on Im(u1)
    z_half_sig2: np.ndarray       # [nnz_half] +-1 conj factor on Im(u2)
    z_half_cg: np.ndarray         # [nnz_half] cg * mirror signs s1*s2
    z_half_jjz: np.ndarray        # [nnz_half] idxz row (runtime beta gather)
    # --- idxb ---
    idxb_max: int
    idxb_triples: tuple           # (j1, j2, j) with j >= j1 >= j2
    idxb_block: dict              # (j1,j2,j) -> jjb
    # Y accumulation: per-jjz beta gather index and multiplicity factor
    y_jjb: np.ndarray             # [idxz_max] index into beta vector
    y_fac: np.ndarray             # [idxz_max] multiplicity / (j+1) factors
    # B contraction COO: B[jjb] = sum w * Re(conj(u[usrc]) * z[zsrc])
    b_coo_dest: np.ndarray
    b_coo_zsrc: np.ndarray        # index into idxz
    b_coo_usrc: np.ndarray        # flat u index
    b_coo_w: np.ndarray
    # dB contraction COO: dB[jjb] += w * Re(conj(du[dusrc]) * z[zsrc])
    db_coo_dest: np.ndarray
    db_coo_zsrc: np.ndarray
    db_coo_dusrc: np.ndarray
    db_coo_w: np.ndarray
    bzero: np.ndarray             # [twojmax+1] self-contribution shift

    @property
    def ncoeff(self) -> int:
        return self.idxb_max


def _half_weights(j: int) -> np.ndarray:
    """Weights over a full (j+1)^2 layer implementing LAMMPS' half-plane sum:
    rows 2mb<j get 1; for even j the middle row gets 1 for ma<j/2, 0.5 at
    ma=j/2, 0 beyond; rows 2mb>j get 0.  (Caller applies the overall 2x.)
    """
    w = np.zeros((j + 1, j + 1), dtype=np.float64)
    for mb in range(j + 1):
        if 2 * mb < j:
            w[mb, :] = 1.0
        elif 2 * mb == j:
            w[mb, : j // 2] = 1.0
            w[mb, j // 2] = 0.5
    return w


@lru_cache(maxsize=8)
def build_index(twojmax: int, wself: float = 1.0) -> SnapIndex:
    # ---- idxu ----
    idxu_block = np.zeros(twojmax + 1, dtype=np.int32)
    c = 0
    for j in range(twojmax + 1):
        idxu_block[j] = c
        c += (j + 1) * (j + 1)
    idxu_max = c
    idxu_j = np.zeros(idxu_max, dtype=np.int32)
    idxu_mb = np.zeros(idxu_max, dtype=np.int32)
    idxu_ma = np.zeros(idxu_max, dtype=np.int32)
    for j in range(twojmax + 1):
        for mb in range(j + 1):
            for ma in range(j + 1):
                f = idxu_block[j] + mb * (j + 1) + ma
                idxu_j[f], idxu_mb[f], idxu_ma[f] = j, mb, ma
    self_diag = np.array(
        [idxu_block[j] + m * (j + 1) + m
         for j in range(twojmax + 1) for m in range(j + 1)],
        dtype=np.int32,
    )
    dedr_weight = np.zeros(idxu_max, dtype=np.float64)
    for j in range(twojmax + 1):
        w = _half_weights(j).reshape(-1)
        dedr_weight[idxu_block[j]: idxu_block[j] + (j + 1) ** 2] = w

    # ---- idxu_half: compacted left rows (2mb <= j) + mirror maps ----
    idxu_half_block = np.zeros(twojmax + 1, dtype=np.int32)
    c = 0
    for j in range(twojmax + 1):
        idxu_half_block[j] = c
        c += (j // 2 + 1) * (j + 1)
    idxu_half_max = c
    full_to_half = np.zeros(idxu_max, dtype=np.int32)
    full_to_half_conj = np.zeros(idxu_max, dtype=bool)
    full_to_half_sign = np.ones(idxu_max, dtype=np.float64)
    half_to_full = np.zeros(idxu_half_max, dtype=np.int32)
    for j in range(twojmax + 1):
        for mb in range(j + 1):
            for ma in range(j + 1):
                f = idxu_block[j] + mb * (j + 1) + ma
                if 2 * mb <= j:
                    h = idxu_half_block[j] + mb * (j + 1) + ma
                    full_to_half[f] = h
                    half_to_full[h] = f
                else:
                    mbs, mas = j - mb, j - ma
                    full_to_half[f] = idxu_half_block[j] + mbs * (j + 1) + mas
                    full_to_half_conj[f] = True
                    full_to_half_sign[f] = 1.0 if (mb + ma) % 2 == 0 else -1.0
    self_diag_half = np.array(
        [idxu_half_block[j] + m * (j + 1) + m
         for j in range(twojmax + 1) for m in range(j // 2 + 1)],
        dtype=np.int32,
    )
    dedr_weight_half = dedr_weight[half_to_full]

    ulevels = tuple(_build_ulevel(j) for j in range(1, twojmax + 1))

    # ---- triples + CG blocks ----
    triples = tuple(valid_triples(twojmax))
    cg_blocks = {t: clebsch_gordan_block(*t) for t in triples}

    # ---- idxz ----
    idxz_block: dict = {}
    rows = []
    for (j1, j2, j) in triples:
        idxz_block[(j1, j2, j)] = len(rows)
        for mb in range(j // 2 + 1):
            for ma in range(j + 1):
                rows.append((j1, j2, j, mb, ma))
    idxz_max = len(rows)
    idxz_j1 = np.array([r[0] for r in rows], dtype=np.int32)
    idxz_j2 = np.array([r[1] for r in rows], dtype=np.int32)
    idxz_j = np.array([r[2] for r in rows], dtype=np.int32)
    idxz_jju = np.array(
        [idxu_block[r[2]] + r[3] * (r[2] + 1) + r[4] for r in rows],
        dtype=np.int32,
    )

    # COO expansion of the CG double sum (LAMMPS compute_zi inner loops)
    zd, zs1, zs2, zcg = [], [], [], []
    for jjz, (j1, j2, j, mb, ma) in enumerate(rows):
        cg = cg_blocks[(j1, j2, j)]
        ma1min = max(0, (2 * ma - j - j2 + j1) // 2)
        ma2max = (2 * ma - j - (2 * ma1min - j1) + j2) // 2
        na = min(j1, (2 * ma - j + j2 + j1) // 2) - ma1min + 1
        mb1min = max(0, (2 * mb - j - j2 + j1) // 2)
        mb2max = (2 * mb - j - (2 * mb1min - j1) + j2) // 2
        nb = min(j1, (2 * mb - j + j2 + j1) // 2) - mb1min + 1
        for ib in range(nb):
            mb1 = mb1min + ib
            mb2 = mb2max - ib
            for ia in range(na):
                ma1 = ma1min + ia
                ma2 = ma2max - ia
                zd.append(jjz)
                zs1.append(idxu_block[j1] + mb1 * (j1 + 1) + ma1)
                zs2.append(idxu_block[j2] + mb2 * (j2 + 1) + ma2)
                zcg.append(cg[mb1, mb2] * cg[ma1, ma2])
    z_coo_dest = np.array(zd, dtype=np.int32)
    z_coo_src1 = np.array(zs1, dtype=np.int32)
    z_coo_src2 = np.array(zs2, dtype=np.int32)
    z_coo_cg = np.array(zcg, dtype=np.float64)

    # ---- half-space COO: fold the j-mirror into the tables ----
    # u_full[s] = sign * conj^c(u_half[full_to_half[s]]) turns each product
    #     u1 * u2  ->  s1*s2 * (v1r*v2r - (σ1 v1i)(σ2 v2i)
    #                           + i (v1r (σ2 v2i) + (σ1 v1i) v2r))
    # with σ = -1 where the mirror conjugates: the complex-multiply form is
    # unchanged if Im gathers carry the σ factor, and s1*s2 folds into cg.
    # Dest rows are left rows by construction (idxz stores 2mb <= j only);
    # entries scattering to (2mb == j, 2ma > j) are dropped — every
    # consumer weights them by exactly 0 (see _half_weights).
    jjz_all = z_coo_dest
    dest_full = idxz_jju[jjz_all]
    dead = ((2 * idxu_mb[dest_full] == idxu_j[dest_full])
            & (2 * idxu_ma[dest_full] > idxu_j[dest_full]))
    live = ~dead
    sig = np.where(full_to_half_conj, -1.0, 1.0)
    z_half_dest = full_to_half[dest_full[live]]
    z_half_src1 = full_to_half[z_coo_src1[live]]
    z_half_src2 = full_to_half[z_coo_src2[live]]
    z_half_sig1 = sig[z_coo_src1[live]]
    z_half_sig2 = sig[z_coo_src2[live]]
    z_half_cg = (z_coo_cg[live] * full_to_half_sign[z_coo_src1[live]]
                 * full_to_half_sign[z_coo_src2[live]])
    z_half_jjz = jjz_all[live].astype(np.int32)

    # ---- idxb ----
    idxb_triples = tuple(t for t in triples if t[2] >= t[0])
    idxb_block = {t: i for i, t in enumerate(idxb_triples)}
    idxb_max = len(idxb_triples)

    # ---- Y accumulation factors (LAMMPS compute_yi) ----
    y_jjb = np.zeros(idxz_max, dtype=np.int32)
    y_fac = np.zeros(idxz_max, dtype=np.float64)
    for jjz, (j1, j2, j, mb, ma) in enumerate(rows):
        if j >= j1:
            jjb = idxb_block[(j1, j2, j)]
            if j1 == j:
                fac = 3.0 if j2 == j else 2.0
            else:
                fac = 1.0
        elif j >= j2:
            jjb = idxb_block[(j, j2, j1)]
            if j2 == j:
                fac = 2.0 * (j1 + 1) / (j + 1.0)
            else:
                fac = (j1 + 1) / (j + 1.0)
        else:
            jjb = idxb_block[(j2, j, j1)]
            fac = (j1 + 1) / (j + 1.0)
        y_jjb[jjz] = jjb
        y_fac[jjz] = fac

    # ---- B contraction COO (LAMMPS compute_bi): B = 2 * sum w * z . u* ----
    bd, bz, bu, bw = [], [], [], []
    for jjb, (j1, j2, j) in enumerate(idxb_triples):
        z0 = idxz_block[(j1, j2, j)]
        w = _half_weights(j)
        for mb in range(j // 2 + 1):
            for ma in range(j + 1):
                wt = w[mb, ma]
                if wt == 0.0:
                    continue
                bd.append(jjb)
                bz.append(z0 + mb * (j + 1) + ma)
                bu.append(idxu_block[j] + mb * (j + 1) + ma)
                bw.append(2.0 * wt)
    b_coo_dest = np.array(bd, dtype=np.int32)
    b_coo_zsrc = np.array(bz, dtype=np.int32)
    b_coo_usrc = np.array(bu, dtype=np.int32)
    b_coo_w = np.array(bw, dtype=np.float64)

    # ---- dB contraction COO (LAMMPS compute_dbidrj, three terms) ----
    dd, dz, du, dw = [], [], [], []
    for jjb, (j1, j2, j) in enumerate(idxb_triples):
        terms = (
            ((j1, j2, j), j, 2.0),                              # du(j)  . z(j1,j2,j)
            ((j, j2, j1), j1, 2.0 * (j + 1) / (j1 + 1.0)),      # du(j1) . z(j,j2,j1)
            ((j, j1, j2), j2, 2.0 * (j + 1) / (j2 + 1.0)),      # du(j2) . z(j,j1,j2)
        )
        for (zt, ju, fac) in terms:
            # canonical z block lookup: first index must be >= second
            za, zb, zc = zt
            assert (za, zb, zc) in idxz_block, (zt, (j1, j2, j))
            z0 = idxz_block[(za, zb, zc)]
            w = _half_weights(ju)
            for mb in range(ju // 2 + 1):
                for ma in range(ju + 1):
                    wt = w[mb, ma]
                    if wt == 0.0:
                        continue
                    dd.append(jjb)
                    dz.append(z0 + mb * (ju + 1) + ma)
                    du.append(idxu_block[ju] + mb * (ju + 1) + ma)
                    dw.append(fac * wt)
    db_coo_dest = np.array(dd, dtype=np.int32)
    db_coo_zsrc = np.array(dz, dtype=np.int32)
    db_coo_dusrc = np.array(du, dtype=np.int32)
    db_coo_w = np.array(dw, dtype=np.float64)

    bzero = np.array(
        [wself ** 3 * (j + 1) for j in range(twojmax + 1)], dtype=np.float64
    )

    return SnapIndex(
        twojmax=twojmax,
        idxu_block=idxu_block, idxu_max=idxu_max,
        idxu_j=idxu_j, idxu_mb=idxu_mb, idxu_ma=idxu_ma,
        self_diag=self_diag, dedr_weight=dedr_weight,
        idxu_half_block=idxu_half_block, idxu_half_max=idxu_half_max,
        half_to_full=half_to_full, full_to_half=full_to_half,
        full_to_half_conj=full_to_half_conj,
        full_to_half_sign=full_to_half_sign,
        self_diag_half=self_diag_half, dedr_weight_half=dedr_weight_half,
        ulevels=ulevels, triples=triples,
        idxz_max=idxz_max, idxz_j1=idxz_j1, idxz_j2=idxz_j2, idxz_j=idxz_j,
        idxz_jju=idxz_jju, idxz_block=idxz_block,
        z_coo_dest=z_coo_dest, z_coo_src1=z_coo_src1,
        z_coo_src2=z_coo_src2, z_coo_cg=z_coo_cg,
        z_half_dest=z_half_dest, z_half_src1=z_half_src1,
        z_half_src2=z_half_src2, z_half_sig1=z_half_sig1,
        z_half_sig2=z_half_sig2, z_half_cg=z_half_cg,
        z_half_jjz=z_half_jjz,
        idxb_max=idxb_max, idxb_triples=idxb_triples, idxb_block=idxb_block,
        y_jjb=y_jjb, y_fac=y_fac,
        b_coo_dest=b_coo_dest, b_coo_zsrc=b_coo_zsrc,
        b_coo_usrc=b_coo_usrc, b_coo_w=b_coo_w,
        db_coo_dest=db_coo_dest, db_coo_zsrc=db_coo_zsrc,
        db_coo_dusrc=db_coo_dusrc, db_coo_w=db_coo_w,
        bzero=bzero,
    )
