"""The plain SNAP energy and forces, in float64, on a list of pairs.

A frozen copy of the port's plain adjoint pipeline
(``repro_torch.core.geometry``, ``core.ulist.compute_dulist``,
``core.bispectrum.compute_ylist`` / ``compute_zlist`` / ``compute_blist``,
``compute_dedr``): the LAMMPS ``compute_ui`` / ``compute_yi`` /
``compute_deidrj`` / ``compute_bi`` loops as dense gathers.  Changed from
the original:

- it takes a compacted list of the pairs within ``rcut`` (atom ``i``,
  neighbour ``k``, displacement), not padded per-atom lists;
- every array holds its element index first and its pair or atom index
  last, so each gather reads whole rows;
- per pair only the left rows (2 mb <= j) of each layer are made, with
  their derivatives, as LAMMPS ``compute_uarray`` does; an atom's other
  rows come from its sums by the mirror;
- Y is one sparse product: the distinct products u[s1] u[s2] its terms
  read, times the matrix of their coefficients by destination (the terms
  whose destination the force contraction weighs by 0 are left out);
- sums over pairs use ``index_add_`` in any order (no bitwise contract);
- the energy comes from the bispectrum, E_i = beta0 + beta . (B_i - bzero),
  not from the adjoint identity the port uses;
- it imports nothing of the port: its tables come from
  :mod:`snapbench.reference.indices`.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .indices import build_tables

F64, C128 = torch.float64, torch.complex128
BLOCK_BYTES = 4 << 30        # bound on one intermediate of a block


def _csr(rows, cols, vals, shape, device):
    """A float64 CSR matrix; duplicate (row, col) entries are summed."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        m = torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([rows, cols])), torch.as_tensor(vals),
            shape, dtype=F64).coalesce()
        return m.to_sparse_csr().to(device)


def _spmm(mat, dense):
    """``mat`` [R, K] (CSR, real) times ``dense`` [K, n] (complex)."""
    k, n = dense.shape
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = mat @ torch.view_as_real(dense).reshape(k, 2 * n)
    return torch.view_as_complex(out.reshape(-1, n, 2))


class Snap:
    """One SNAP potential (configuration, beta, beta0) on ``device``."""

    def __init__(self, snap_cfg: dict, beta, beta0: float, device):
        self.rcut = float(snap_cfg['rcut'])
        self.rmin0 = float(snap_cfg['rmin0'])
        self.rfac0 = float(snap_cfg['rfac0'])
        self.switch = bool(snap_cfg['switch_flag'])
        self.bzero_flag = bool(snap_cfg['bzero_flag'])
        self.wself = float(snap_cfg.get('wself', 1.0))
        self.dev = dev = torch.device(device)
        self.t = t = build_tables(int(snap_cfg['twojmax']), self.wself)
        L = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa
        R = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa
        # each level keeps its left rows and the rows the next level reads
        # (one mirrored row past the left ones where j is odd)
        self.levels = []
        for j, lv in enumerate(t.ulevels, start=1):
            n_ext = ((j + 1) // 2 + 1) * (j + 1)
            self.levels.append((
                L(lv.a_src), L(lv.b_src), R(lv.a_coef)[:, None],
                R(lv.b_coef)[:, None], L(lv.full_src[:n_ext]),
                torch.as_tensor(lv.full_conj[:n_ext], device=dev)[:, None],
                R(lv.full_sign[:n_ext])[:, None]))
        self.to_half = L(t.full_to_half)
        self.mirror = (torch.as_tensor(t.full_conj, device=dev)[:, None],
                       R(t.full_sign)[:, None])
        beta = np.asarray(beta, np.float64)
        self.beta, self.beta0 = R(beta), float(beta0)
        self.self_diag = L(t.self_diag)
        self.w = R(t.dedr_weight[t.half_to_full])
        # Y = C @ (u[s1] u[s2]) over the distinct (s1, s2) its terms read
        coef = t.z_cg * t.y_fac[t.z_dest] * beta[t.y_jjb[t.z_dest]]
        ydest = t.idxz_jju[t.z_dest]
        live = t.dedr_weight[ydest] != 0
        key = t.z_src1[live] * t.idxu_max + t.z_src2[live]
        uniq, col = np.unique(key, return_inverse=True)
        self.y_src = (L(uniq // t.idxu_max), L(uniq % t.idxu_max))
        self.y_cols = []          # (first column, CSR block) in column blocks
        per = 65536
        for lo in range(0, len(uniq), per):
            sel = (col >= lo) & (col < lo + per)
            self.y_cols.append((lo, _csr(
                t.full_to_half[ydest[live][sel]], col[sel] - lo,
                coef[live][sel], (t.idxu_half_max, min(per, len(uniq) - lo)),
                dev)))
        order = np.argsort(t.z_dest, kind='stable')
        self.z = (L(t.z_src1[order]), L(t.z_src2[order]), R(t.z_cg[order]),
                  L(t.z_dest[order]))
        self.b = (L(t.b_usrc), L(t.b_zsrc), R(t.b_w), L(t.b_dest))
        self.bzero = R(t.bzero if self.bzero_flag else np.zeros(t.idxb_max))

    # -- pair geometry and the Wigner-U recursion ---------------------------

    def _geometry(self, d):
        """Cayley-Klein parameters a, b [P], the switching factor [P] and
        their derivatives by the displacement's components [3, P]."""
        x, y, z = d
        rsq = x * x + y * y + z * z
        r = torch.sqrt(rsq)
        rscale0 = self.rfac0 * math.pi / (self.rcut - self.rmin0)
        theta0 = (r - self.rmin0) * rscale0
        z0 = r * torch.cos(theta0) / torch.sin(theta0)
        dz0dr = z0 / r - r * rscale0 * (rsq + z0 * z0) / rsq
        r0inv = 1.0 / torch.sqrt(rsq + z0 * z0)
        dr0invdr = -(r0inv ** 3) * (r + z0 * dz0dr)
        unit = d / r
        dr0inv = dr0invdr * unit
        dz0 = dz0dr * unit
        eye = torch.eye(3, dtype=F64, device=d.device)[:, :, None]
        r0e = r0inv * eye                                  # [3, 3, P]
        a = torch.complex(r0inv * z0, -r0inv * z)
        b = torch.complex(r0inv * y, -r0inv * x)
        da = torch.complex(dz0 * r0inv + z0 * dr0inv, -z * dr0inv - r0e[2])
        db = torch.complex(y * dr0inv + r0e[1], -x * dr0inv - r0e[0])
        if self.switch:
            c = math.pi / (self.rcut - self.rmin0)
            t = (r - self.rmin0) * c
            inside = (r > self.rmin0) & (r <= self.rcut)
            sfac = torch.where(r <= self.rmin0, torch.ones_like(r),
                               torch.where(inside, 0.5 * (torch.cos(t) + 1),
                                           torch.zeros_like(r)))
            dsfac = torch.where(inside, -0.5 * torch.sin(t) * c,
                                torch.zeros_like(r)) * unit
        else:
            sfac, dsfac = torch.ones_like(r), torch.zeros_like(d)
        return a, b, da, db, sfac, dsfac

    def _ulist(self, d, grad: bool):
        """(u [idxu_half, P], d(sfac u)/dr [idxu_half, 3, P] or None,
        sfac [P]) of the pairs ``d`` [3, P]: the left rows (2 mb <= j) of
        every layer, as LAMMPS ``compute_uarray`` makes them."""
        a, b, da, db, sfac, dsfac = self._geometry(d)
        P = d.shape[1]
        ac, bc = torch.conj(a), torch.conj(b)
        dac, dbc = torch.conj(da), torch.conj(db)
        ext = torch.ones((1, P), dtype=C128, device=d.device)
        dext = torch.zeros((1, 3, P), dtype=C128, device=d.device)
        us, dus = [ext], [dext]
        for a_src, b_src, a_coef, b_coef, fsrc, fconj, fsgn in self.levels:
            pa = ext[a_src] * a_coef
            pb = ext[b_src] * b_coef
            left = ac * pa + bc * pb
            m = left[fsrc]
            ext = torch.where(fconj, fsgn * torch.conj(m), m)
            us.append(left)
            if grad:
                dpa = dext[a_src] * a_coef[..., None]
                dpb = dext[b_src] * b_coef[..., None]
                dleft = (dac * pa[:, None] + ac * dpa
                         + dbc * pb[:, None] + bc * dpb)
                dm = dleft[fsrc]
                dext = torch.where(fconj[..., None],
                                   fsgn[..., None] * torch.conj(dm), dm)
                dus.append(dleft)
        u = torch.cat(us)
        if not grad:
            return u, None, sfac
        du = torch.cat(dus)
        du = dsfac * u[:, None] + sfac * du
        return u, du, sfac

    # -- the Clebsch-Gordan stages ------------------------------------------

    def _ylist(self, ut):
        """Y [idxu_half, n]: the beta-weighted Z terms by destination."""
        s1, s2 = self.y_src
        y = torch.zeros((self.t.idxu_half_max, ut.shape[1]), dtype=C128,
                        device=ut.device)
        for lo, mat in self.y_cols:
            k = mat.shape[1]
            y += _spmm(mat, ut[s1[lo:lo + k]] * ut[s2[lo:lo + k]])
        return y

    def _zlist(self, ut):
        """Z [idxz, n] (LAMMPS compute_zi), in blocks of terms."""
        s1, s2, cg, dest = self.z
        n = ut.shape[1]
        z = torch.zeros((self.t.idxz_max, n), dtype=C128, device=ut.device)
        step = max(1, BLOCK_BYTES // (16 * n))
        for lo in range(0, s1.shape[0], step):
            sl = slice(lo, lo + step)
            p = ut[s1[sl]] * ut[s2[sl]]
            p.mul_(cg[sl, None])
            z.index_add_(0, dest[sl], p)
        return z

    def energy_forces(self, d, atom, nbr, natoms: int, energy=True,
                      forces=True):
        """(E total, forces [natoms, 3]) of the pairs ``d`` [P, 3]
        (displacement r_k - r_i, |d| < rcut), ``atom`` [P] (i) and ``nbr``
        [P] (k), in float64.  Either may be skipped (None)."""
        d = d.to(F64).T.contiguous()
        P = d.shape[1]
        step = max(1, BLOCK_BYTES // (self.t.idxu_half_max * 3 * 16 * 4))
        half = torch.zeros((self.t.idxu_half_max, natoms), dtype=C128,
                           device=self.dev)
        dus = []
        for lo in range(0, P, step):
            u, du, sfac = self._ulist(d[:, lo:lo + step], grad=forces)
            half.index_add_(1, atom[lo:lo + step], u * sfac)
            dus.append(du)
            del u
        # every layer's other rows by the mirror, then the self term
        conj, sign = self.mirror
        m = half[self.to_half]
        ut = torch.where(conj, sign * torch.conj(m), m)
        ut[self.self_diag] += self.wself
        f = e = None
        if forces:
            y = self._ylist(ut)
            dedr = torch.empty((3, P), dtype=F64, device=self.dev)
            for k, lo in enumerate(range(0, P, step)):
                yp = y[:, atom[lo:lo + step]][:, None]
                du, dus[k] = dus[k], None
                dedr[:, lo:lo + step] = 2.0 * torch.einsum(
                    'e,ecp->cp', self.w,
                    du.real * yp.real + du.imag * yp.imag)
            f = torch.zeros((natoms, 3), dtype=F64, device=self.dev)
            f.index_add_(0, atom, dedr.T)
            f.index_add_(0, nbr, -dedr.T)
        if energy:
            z = self._zlist(ut)
            usrc, zsrc, w, bdest = self.b
            uu, zz = ut[usrc], z[zsrc]
            b = torch.zeros((self.t.idxb_max, natoms), dtype=F64,
                            device=self.dev)
            b.index_add_(0, bdest, w[:, None] * (uu.real * zz.real
                                                 + uu.imag * zz.imag))
            e = torch.sum(self.beta0 + (b - self.bzero[:, None]).T @ self.beta)
        return e, f
