// U kernels: per atom, sum over its masked neighbors of sfac * u_j(mb, ma),
// the self term left out.
//
// Replaces two TPU kernels:
//   snap_u_half_{f32,f64}  repro/kernels/snap_u.py:snap_u_half_pallas
//                          (the left rows 2mb <= j, [idxu_half_max, n]);
//   snap_u_full_{f32,f64}  repro/kernels/snap_u.py:snap_u_pallas
//                          (every row, [idxu_max, n]).
// One thread per atom walks its neighbors in order and runs the Wigner
// recursion level by level on the left rows, in two ping-pong local arrays,
// adding each level into the output planes in place.  The full layout adds
// the same left rows at their full-plane rows and, once the neighbor sum is
// done, fills each mirror row from its source,
//     u(j - mb, j - ma) = (-1)^(mb + ma) conj(u(mb, ma)),
// which is exact: the sum of mirrors is the mirror of the sum, and the fill
// only flips signs.  (The TPU kernel mirrored every level of every
// neighbor; the result is the same.)  A warp covers 32 consecutive atoms,
// so every plane access is coalesced; there are no atomics and the sum
// order is fixed, so the result is deterministic.
//
// Bound on the H100: a few hundred flops per (pair, level) against a few
// bytes per atom, so operations bound it in principle; in practice the
// grid is one thread per atom (2048 threads at snap-2j8, 64 blocks of 32)
// and under-fills the 132 SMs, so the kernel runs latency-bound.  Spreading
// an atom's neighbors over threads is later work.

#include "snap_common.cuh"

template <typename T, bool FULL>
__global__ void snap_u_kernel(const T* __restrict__ disp,
                              T* __restrict__ out_r, T* __restrict__ out_i,
                              const T* __restrict__ rootpq, int nnbor, int n,
                              int twojmax, T rcut, T rmin0, T rfac0,
                              int switch_flag) {
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  if (atom >= n) return;
  const int rp = SNAP_MAXJ + 1;  // rootpq row stride
  // zero the left rows of every level (the mirror rows are filled last)
  for (int j = 0, base = 0; j <= twojmax; base += level_size(j, FULL), ++j) {
    for (int e = 0; e < (j / 2 + 1) * (j + 1); ++e) {
      out_r[(size_t)(base + e) * n + atom] = T(0);
      out_i[(size_t)(base + e) * n + atom] = T(0);
    }
  }

  T buf_r[2][SNAP_HALF_LEVEL_MAX], buf_i[2][SNAP_HALF_LEVEL_MAX];
  for (int k = 0; k < nnbor; ++k) {
    const T* d = disp + (size_t)k * 4 * n + atom;
    const PairCK<T> g = geom_ck(d[0], d[n], d[2 * n], rcut, rmin0, rfac0,
                                switch_flag);
    const T sfac = g.sfac * d[3 * n];
    out_r[atom] += sfac;  // level 0: u = 1
    int cur = 0;
    buf_r[0][0] = T(1);
    buf_i[0][0] = T(0);
    int base = 1;
    for (int j = 1; j <= twojmax; ++j) {
      const T* pr_ = buf_r[cur];
      const T* pi_ = buf_i[cur];
      T* cr = buf_r[cur ^ 1];
      T* ci = buf_i[cur ^ 1];
      const int rows = j / 2 + 1;
      for (int mb = 0; mb < rows; ++mb) {
        for (int ma = 0; ma <= j; ++ma) {
          T vr = T(0), vi = T(0), pr, pi;
          if (ma < j) {  // conj(a) term into column ma
            prev_elem(pr_, pi_, j, mb, ma, &pr, &pi);
            const T c = rootpq[(j - ma) * rp + (j - mb)];
            vr += c * (g.a_r * pr + g.a_i * pi);
            vi += c * (g.a_r * pi - g.a_i * pr);
          }
          if (ma > 0) {  // conj(b) term of column ma-1 into column ma
            prev_elem(pr_, pi_, j, mb, ma - 1, &pr, &pi);
            const T c = -rootpq[ma * rp + (j - mb)];
            vr += c * (g.b_r * pr + g.b_i * pi);
            vi += c * (g.b_r * pi - g.b_i * pr);
          }
          const int e = mb * (j + 1) + ma;
          cr[e] = vr;
          ci[e] = vi;
          out_r[(size_t)(base + e) * n + atom] += sfac * vr;
          out_i[(size_t)(base + e) * n + atom] += sfac * vi;
        }
      }
      base += level_size(j, FULL);
      cur ^= 1;
    }
  }

  if (FULL) {  // mirror rows mb > j/2 from their sources (j - mb, j - ma)
    for (int j = 1, base = 1; j <= twojmax; base += level_size(j, true), ++j) {
      for (int mb = j / 2 + 1; mb <= j; ++mb) {
        for (int ma = 0; ma <= j; ++ma) {
          const size_t src = (size_t)(base + (j - mb) * (j + 1) + (j - ma)) * n;
          const size_t dst = (size_t)(base + mb * (j + 1) + ma) * n;
          const T s = ((mb + ma) & 1) ? T(-1) : T(1);
          out_r[dst + atom] = s * out_r[src + atom];
          out_i[dst + atom] = -s * out_i[src + atom];
        }
      }
    }
  }
}

template <typename T, bool FULL>
static int launch(const void* disp, void* out_r, void* out_i,
                  const void* rootpq, int nnbor, int n, int twojmax,
                  double rcut, double rmin0, double rfac0, int switch_flag,
                  int device, void* stream) {
  if (twojmax < 0 || twojmax > SNAP_MAXJ || n < 0 || nnbor < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int block = 32;
  snap_u_kernel<T, FULL><<<(n + block - 1) / block, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(disp), static_cast<T*>(out_r),
      static_cast<T*>(out_i), static_cast<const T*>(rootpq), nnbor, n,
      twojmax, T(rcut), T(rmin0), T(rfac0), switch_flag);
  return static_cast<int>(cudaGetLastError());
}

#define SNAP_U_SYMBOL(name, T, FULL)                                         \
  extern "C" int name(const void* disp, void* out_r, void* out_i,            \
                      const void* rootpq, int nnbor, int n, int twojmax,     \
                      double rcut, double rmin0, double rfac0,               \
                      int switch_flag, int device, void* stream) {           \
    return launch<T, FULL>(disp, out_r, out_i, rootpq, nnbor, n, twojmax,    \
                           rcut, rmin0, rfac0, switch_flag, device, stream); \
  }

SNAP_U_SYMBOL(snap_u_half_f32, float, false)
SNAP_U_SYMBOL(snap_u_half_f64, double, false)
SNAP_U_SYMBOL(snap_u_full_f32, float, true)
SNAP_U_SYMBOL(snap_u_full_f64, double, true)
