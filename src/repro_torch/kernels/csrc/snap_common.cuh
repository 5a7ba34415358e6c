// Shared device code of the SNAP kernels (sm_90a).
//
// Layout (kept from the reference so every stage compares like with like):
// planes are [rows, n] with the atom index on the fast axis, so a warp of
// consecutive atoms reads and writes consecutive addresses.  The Wigner-U
// recursion keeps only the left rows 2*mb <= j of each level ("half"
// storage, row-major (mb, ma), stride j+1).  A half plane holds just those
// rows, a full plane every row of every level; in both, level j starts at
// the summed sizes of the levels below it (level_size) and its left rows
// come first, so element (mb, ma) of the left rows sits at
//     level start + mb * (j + 1) + ma
// in either layout.
#pragma once

#include <cuda_runtime.h>

#define SNAP_MAXJ 14
// largest half level: (14/2 + 1) * (14 + 1)
#define SNAP_HALF_LEVEL_MAX 120
#define SNAP_PI 3.141592653589793

__device__ __forceinline__ float snap_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double snap_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float snap_sin(float x) { return sinf(x); }
__device__ __forceinline__ double snap_sin(double x) { return sin(x); }
__device__ __forceinline__ float snap_cos(float x) { return cosf(x); }
__device__ __forceinline__ double snap_cos(double x) { return cos(x); }

// Cayley-Klein parameters a, b and the switching value of one pair
// (LAMMPS compute_ui; reference kernels/common.geom_ck).
template <typename T>
struct PairCK {
  T a_r, a_i, b_r, b_i, sfac;
};

template <typename T>
__device__ __forceinline__ T snap_switch(T r, T rcut, T rmin0,
                                         int switch_flag, T* dsf) {
  if (!switch_flag) {
    *dsf = T(0);
    return T(1);
  }
  const T c = T(SNAP_PI) / (rcut - rmin0);
  const T t = (r - rmin0) * c;
  if (r <= rmin0 || r > rcut) {
    *dsf = T(0);
    return r <= rmin0 ? T(1) : T(0);
  }
  *dsf = T(-0.5) * snap_sin(t) * c;
  return T(0.5) * (snap_cos(t) + T(1));
}

template <typename T>
__device__ __forceinline__ PairCK<T> geom_ck(T x, T y, T z, T rcut, T rmin0,
                                             T rfac0, int switch_flag) {
  const T rsq = x * x + y * y + z * z;
  const T r = snap_sqrt(rsq);
  const T rscale0 = rfac0 * T(SNAP_PI) / (rcut - rmin0);
  const T theta0 = (r - rmin0) * rscale0;
  const T z0 = r * snap_cos(theta0) / snap_sin(theta0);
  const T r0inv = T(1) / snap_sqrt(rsq + z0 * z0);
  T dsf;
  PairCK<T> g;
  g.a_r = r0inv * z0;
  g.a_i = -r0inv * z;
  g.b_r = r0inv * y;
  g.b_i = -r0inv * x;
  g.sfac = snap_switch(r, rcut, rmin0, switch_flag, &dsf);
  return g;
}

// d(a, b, sfac)/d(x, y, z) (LAMMPS compute_duidrj; reference
// kernels/common.geom_ck_grad).
template <typename T>
struct PairCKGrad {
  T da_r[3], da_i[3], db_r[3], db_i[3], dsfac[3];
};

template <typename T>
__device__ __forceinline__ PairCK<T> geom_ck_grad(T x, T y, T z, T rcut,
                                                  T rmin0, T rfac0,
                                                  int switch_flag,
                                                  PairCKGrad<T>* d) {
  const T rsq = x * x + y * y + z * z;
  const T r = snap_sqrt(rsq);
  const T rscale0 = rfac0 * T(SNAP_PI) / (rcut - rmin0);
  const T theta0 = (r - rmin0) * rscale0;
  const T z0 = r * snap_cos(theta0) / snap_sin(theta0);
  const T dz0dr = z0 / r - r * rscale0 * (rsq + z0 * z0) / rsq;
  const T r0inv = T(1) / snap_sqrt(rsq + z0 * z0);
  const T dr0invdr = -(r0inv * r0inv * r0inv) * (r + z0 * dz0dr);
  const T unit[3] = {x / r, y / r, z / r};
  T dsf;
  PairCK<T> g;
  g.a_r = r0inv * z0;
  g.a_i = -r0inv * z;
  g.b_r = r0inv * y;
  g.b_i = -r0inv * x;
  g.sfac = snap_switch(r, rcut, rmin0, switch_flag, &dsf);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T dr0inv = dr0invdr * unit[k];
    const T dz0 = dz0dr * unit[k];
    d->da_r[k] = dz0 * r0inv + z0 * dr0inv;
    d->da_i[k] = -z * dr0inv - (k == 2 ? r0inv : T(0));
    d->db_r[k] = y * dr0inv + (k == 1 ? r0inv : T(0));
    d->db_i[k] = -x * dr0inv - (k == 0 ? r0inv : T(0));
    d->dsfac[k] = dsf * unit[k];
  }
  return g;
}

// Element (mb, ma) of full layer j-1, read from its half storage `prev`
// (rows 0..(j-1)/2, stride j).  The one row past the half (mb = j/2 at
// even j) comes from its mirror:
//     u(mb, ma) = (-1)^(mb+ma) conj(u(j-1-mb, j-1-ma))
// (reference kernels/common.half_prev_rows).
template <typename T>
__device__ __forceinline__ void prev_elem(const T* prev_r, const T* prev_i,
                                          int j, int mb, int ma, T* pr,
                                          T* pi) {
  if (2 * mb <= j - 1) {
    *pr = prev_r[mb * j + ma];
    *pi = prev_i[mb * j + ma];
  } else {
    const int e = (j - 1 - mb) * j + (j - 1 - ma);
    const T s = ((mb + ma) & 1) ? T(-1) : T(1);
    *pr = s * prev_r[e];
    *pi = -s * prev_i[e];
  }
}

// Half-plane contraction weight of element (mb, ma) at level j: 1 on rows
// 2mb < j; on the middle row of even j, 1 for ma < j/2, 0.5 at ma = j/2,
// 0 beyond; 0.5 for the single element of j = 0.
template <typename T>
__device__ __forceinline__ T half_weight(int j, int mb, int ma) {
  if (j == 0) return T(0.5);
  if (2 * mb < j) return T(1);
  if (2 * ma < j) return T(1);
  return 2 * ma == j ? T(0.5) : T(0);
}

// Plane rows of level j: (j/2 + 1)(j + 1) left rows in the half layout,
// (j + 1)^2 in the full one.
__device__ __forceinline__ int level_size(int j, bool full) {
  return full ? (j + 1) * (j + 1) : (j / 2 + 1) * (j + 1);
}

extern "C" const char* snap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
