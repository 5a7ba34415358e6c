// Half-plane adjoint Y kernel:
//     Y_half[dest] += coef * (u1r + i s1 u1i) * (u2r + i s2 u2i)
// over the mirror-folded Clebsch-Gordan table, with u = U_half planes.
//
// Replaces the TPU kernel repro/kernels/snap_y.py:snap_y_half_pallas.
// The TPU kernel turned the COO table into one-hot matmuls because the TPU
// has no fast in-kernel gather; Hopper gathers directly.  The table is
// sorted by destination (CSR row pointers, built once per 2J on the host),
// and one thread owns one (destination row, atom) output: it walks its
// row's entries in a fixed order and writes once.  No atomics, no one-hot,
// deterministic.  The table entries are uniform across a warp (broadcast
// loads); the four U gathers per entry are coalesced across atoms.
//
// Bound on the H100: ~12 flops per (entry, atom) against the U/Y planes,
// so operations bound it (38,358 entries x 2048 atoms at snap-2j8); the
// gathers hit L1/L2, since one atom column of U is 155 rows.

#include "snap_common.cuh"

template <typename T>
__global__ void snap_y_half_kernel(const T* __restrict__ ut_r,
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
    const T v1r = ut_r[s1], v1i = sig1[e] * ut_i[s1];
    const T v2r = ut_r[s2], v2i = sig2[e] * ut_i[s2];
    const T c = coef[e];
    acc_r += c * (v1r * v2r - v1i * v2i);
    acc_i += c * (v1r * v2i + v1i * v2r);
  }
  y_r[(size_t)row * n + atom] = acc_r;
  y_i[(size_t)row * n + atom] = acc_i;
}

template <typename T>
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
  snap_y_half_kernel<T><<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ut_r), static_cast<const T*>(ut_i),
      static_cast<const int*>(rowptr), static_cast<const int*>(src1),
      static_cast<const int*>(src2), static_cast<const T*>(sig1),
      static_cast<const T*>(sig2), static_cast<const T*>(coef),
      static_cast<T*>(y_r), static_cast<T*>(y_i), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snap_y_half_f32(const void* ut_r, const void* ut_i,
                               const void* rowptr, const void* src1,
                               const void* src2, const void* sig1,
                               const void* sig2, const void* coef, void* y_r,
                               void* y_i, int nrows, int n, int device,
                               void* stream) {
  return launch<float>(ut_r, ut_i, rowptr, src1, src2, sig1, sig2, coef, y_r,
                       y_i, nrows, n, device, stream);
}

extern "C" int snap_y_half_f64(const void* ut_r, const void* ut_i,
                               const void* rowptr, const void* src1,
                               const void* src2, const void* sig1,
                               const void* sig2, const void* coef, void* y_r,
                               void* y_i, int nrows, int n, int device,
                               void* stream) {
  return launch<double>(ut_r, ut_i, rowptr, src1, src2, sig1, sig2, coef, y_r,
                        y_i, nrows, n, device, stream);
}
