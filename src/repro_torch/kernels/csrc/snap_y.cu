// Adjoint Y kernels (paper Sec. IV, LAMMPS compute_yi):
//     Y[dest] += coef * (u1r + i s1 u1i) * (u2r + i s2 u2i)
// over a Clebsch-Gordan table, with u the Ulisttot planes.
//
// Replaces two TPU kernels:
//   snap_y_half_{f32,f64}       repro/kernels/snap_y.py:snap_y_half_pallas
//     (the mirror-folded half-space table; s = +-1 conjugation factors on
//     the imaginary gathers);
//   snap_y_half_bf16_{f32,f64}  the same kernel's mxu_dtype=bfloat16 option,
//     rounding where the TPU kernel rounds its matmul operands: u to bf16
//     before the gather (one rounding, also from float64), s applied after
//     it, the complex product formed in the plane type and rounded to bf16,
//     the coefficient rounded to bf16, the sum kept in the plane type;
//   snap_y_full_{f32,f64}       repro/kernels/snap_y.py:snap_y_pallas
//     (the full-space table, no s; rows no entry reaches, the mirror rows,
//     are written 0 as compute_ylist leaves them).
// The TPU kernels turned the COO table into one-hot matmuls because the TPU
// has no fast in-kernel gather; Hopper gathers directly.  The table is
// sorted by destination (CSR row pointers, built once per 2J on the host),
// and one thread owns one (destination row, atom) output: it walks its
// row's entries in a fixed order and writes once.  No atomics, no one-hot,
// deterministic.  The table entries are uniform across a warp (broadcast
// loads); the four U gathers per entry are coalesced across atoms.
//
// Bound on the H100: ~12 flops per (entry, atom) against the U/Y planes,
// so operations bound it (38,358 half or 41,889 full entries x 2048 atoms
// at snap-2j8); the gathers hit L1/L2, since one atom column of U is 155
// (half) or 285 (full) rows.  The bf16 option gains nothing here: a scalar
// gather reads and multiplies at the plane type's rate whatever it rounds
// to; the option existed for the TPU's matrix unit.

#include <cuda_bf16.h>

#include "snap_common.cuh"

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) {
  return static_cast<double>(__bfloat162float(__double2bfloat16(x)));
}

template <typename T, bool SIGMA, bool BF16>
__global__ void snap_y_kernel(const T* __restrict__ ut_r,
                              const T* __restrict__ ut_i,
                              const int* __restrict__ rowptr,
                              const int* __restrict__ src1,
                              const int* __restrict__ src2,
                              const T* __restrict__ sig1,
                              const T* __restrict__ sig2,
                              const T* __restrict__ coef,
                              T* __restrict__ y_r, T* __restrict__ y_i,
                              int n) {
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (atom >= n) return;
  T acc_r = T(0), acc_i = T(0);
  const int end = rowptr[row + 1];
  for (int e = rowptr[row]; e < end; ++e) {
    const size_t s1 = (size_t)src1[e] * n + atom;
    const size_t s2 = (size_t)src2[e] * n + atom;
    T v1r = ut_r[s1], v1i = ut_i[s1], v2r = ut_r[s2], v2i = ut_i[s2];
    T c = coef[e];
    if (BF16) {
      v1r = round_bf16(v1r);
      v1i = round_bf16(v1i);
      v2r = round_bf16(v2r);
      v2i = round_bf16(v2i);
    }
    if (SIGMA) {
      v1i = sig1[e] * v1i;
      v2i = sig2[e] * v2i;
    }
    T pr = v1r * v2r - v1i * v2i;
    T pi = v1r * v2i + v1i * v2r;
    if (BF16) {
      pr = round_bf16(pr);
      pi = round_bf16(pi);
      c = round_bf16(c);
    }
    acc_r += c * pr;
    acc_i += c * pi;
  }
  y_r[(size_t)row * n + atom] = acc_r;
  y_i[(size_t)row * n + atom] = acc_i;
}

template <typename T, bool SIGMA, bool BF16>
static int launch(const void* ut_r, const void* ut_i, const void* rowptr,
                  const void* src1, const void* src2, const void* sig1,
                  const void* sig2, const void* coef, void* y_r, void* y_i,
                  int nrows, int n, int device, void* stream) {
  if (n < 0 || nrows < 0 || nrows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || nrows == 0) return 0;
  const int block = 128;
  const dim3 grid((n + block - 1) / block, nrows);
  snap_y_kernel<T, SIGMA, BF16><<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ut_r), static_cast<const T*>(ut_i),
      static_cast<const int*>(rowptr), static_cast<const int*>(src1),
      static_cast<const int*>(src2), static_cast<const T*>(sig1),
      static_cast<const T*>(sig2), static_cast<const T*>(coef),
      static_cast<T*>(y_r), static_cast<T*>(y_i), n);
  return static_cast<int>(cudaGetLastError());
}

// sig1/sig2 are read only by the half-space symbols (null for the full)
#define SNAP_Y_SYMBOL(name, T, SIGMA, BF16)                                  \
  extern "C" int name(const void* ut_r, const void* ut_i, const void* rowptr, \
                      const void* src1, const void* src2, const void* sig1,  \
                      const void* sig2, const void* coef, void* y_r,         \
                      void* y_i, int nrows, int n, int device,               \
                      void* stream) {                                        \
    return launch<T, SIGMA, BF16>(ut_r, ut_i, rowptr, src1, src2, sig1,      \
                                  sig2, coef, y_r, y_i, nrows, n, device,    \
                                  stream);                                   \
  }

SNAP_Y_SYMBOL(snap_y_half_f32, float, true, false)
SNAP_Y_SYMBOL(snap_y_half_f64, double, true, false)
SNAP_Y_SYMBOL(snap_y_half_bf16_f32, float, true, true)
SNAP_Y_SYMBOL(snap_y_half_bf16_f64, double, true, true)
SNAP_Y_SYMBOL(snap_y_full_f32, float, false, false)
SNAP_Y_SYMBOL(snap_y_full_f64, double, false, false)
