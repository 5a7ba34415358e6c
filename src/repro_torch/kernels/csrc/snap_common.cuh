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
// rootpq table: [SNAP_MAXJ + 1]^2, row stride SNAP_RP_STRIDE
#define SNAP_RP_STRIDE (SNAP_MAXJ + 1)
#define SNAP_RP_SIZE (SNAP_RP_STRIDE * SNAP_RP_STRIDE)
#define SNAP_PI 3.141592653589793
// Largest block the launch plans may ask for (H100: 227 KB of dynamic
// shared memory, 1024 threads); kernels/launch_plan.py holds the same.
#define SNAP_SMEM_MAX 232448
#define SNAP_THREADS_MAX 1024
// devices whose shared-memory grant a launcher remembers
#define SNAP_DEVICES 16

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

// The level state of the U and fused dE kernels lives in shared memory,
// [element][lane] with the block's lanes (atoms or pairs) on the fast axis,
// sized per launch by their launch plans for the largest level of the
// launch's 2J.  The recursion of left-rows element
// (mb, ma) of level j reads the previous level's elements (mb, ma) (conj(a)
// term, ma < j) and (mb, ma - 1) (conj(b) term, ma > 0) from its half
// storage (rows 0..(j-1)/2, stride j).  The one row past the half (mb = j/2
// at even j) comes from its mirror:
//     u(mb, ma) = (-1)^(mb+ma) conj(u(j-1-mb, j-1-ma))
// (reference kernels/common.half_prev_rows).  prev_index gives the stored
// element; the term coefficients carry the mirror's signs, so
//     u_j(mb, ma) = conj(a) (c_r u_r + i c_i u_i)[a term]
//                 + conj(b) (c_r u_r + i c_i u_i)[b term]
// with (u_r, u_i) the stored values and c = 0 for an absent term.

// Half-storage index in level j - 1 of full element (mb, ma), 2 mb <= j.
__device__ __forceinline__ int prev_index(int j, int mb, int ma) {
  return 2 * mb <= j - 1 ? mb * j + ma : (j - 1 - mb) * j + (j - 1 - ma);
}

template <typename T>
struct TermCoef {
  T c_r, c_i;
};

// rootpq coefficient c times the mirror signs of stored element (mb, ma')
// of level j - 1: (c, c) on a stored row, (s c, -s c) on the mirrored one,
// s = (-1)^(mb + ma').
template <typename T>
__device__ __forceinline__ TermCoef<T> signed_coef(T c, int j, int mb,
                                                   int ma_prev) {
  if (2 * mb <= j - 1) return {c, c};
  const T s = ((mb + ma_prev) & 1) ? -c : c;
  return {s, -s};
}

// conj(a) term of element (mb, ma) of level j: rootpq[j - ma][j - mb] on
// stored element (mb, ma); 0 at ma = j.
template <typename T>
__device__ __forceinline__ TermCoef<T> a_term_coef(const T* rp, int j,
                                                   int mb, int ma) {
  if (ma >= j) return {T(0), T(0)};
  return signed_coef(rp[(j - ma) * SNAP_RP_STRIDE + (j - mb)], j, mb, ma);
}

// conj(b) term: -rootpq[ma][j - mb] on stored element (mb, ma - 1); 0 at
// ma = 0.
template <typename T>
__device__ __forceinline__ TermCoef<T> b_term_coef(const T* rp, int j,
                                                   int mb, int ma) {
  if (ma <= 0) return {T(0), T(0)};
  return signed_coef(-rp[ma * SNAP_RP_STRIDE + (j - mb)], j, mb, ma - 1);
}

// The contiguous run [*lo, *hi) of a level's `size` left-rows elements that
// thread y of `threads` computes: runs of ceil(size / threads), so a thread
// walks along rows and carries the previous column's stored element from
// one element to the next (kernels/launch_plan.element_map repeats it).
__device__ __forceinline__ void run_bounds(int size, int threads, int y,
                                           int* lo, int* hi) {
  const int c = (size + threads - 1) / threads;
  *lo = min(y * c, size);
  *hi = min(*lo + c, size);
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
__host__ __device__ __forceinline__ int level_size(int j, bool full) {
  return full ? (j + 1) * (j + 1) : (j / 2 + 1) * (j + 1);
}

// Rows of a whole plane up to 2J = twojmax (idxu_half_max / idxu_max).
__host__ __device__ __forceinline__ int plane_rows(int twojmax, bool full) {
  int rows = 0;
  for (int j = 0; j <= twojmax; ++j) rows += level_size(j, full);
  return rows;
}

// Dynamic shared memory above the 48 KB default must be granted to a kernel
// on each device before a launch uses it.  Every kernel is granted the most
// a launch plan may ask for, SNAP_SMEM_MAX, so no grant lowers another (the
// attribute is an upper limit and does not change occupancy); *granted, a
// launcher's static where given, skips the call after the first success.
template <typename K>
static cudaError_t allow_smem(K kernel, bool* granted = nullptr) {
  if (granted && *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SNAP_SMEM_MAX);
  if (granted) *granted = err == cudaSuccess;
  return err;
}

extern "C" const char* snap_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
