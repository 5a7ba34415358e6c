// Fused dE kernels: for each (neighbor, atom) pair, the Wigner recursion of
// u and of du/dx, du/dy, du/dz on the left rows 2mb <= j, contracted level
// by level against that atom's adjoint Y:
//     dedr[k, d, atom] = 2 sum_{j, mb, ma} w * Re(conj(dU_d) Y),
//     dU_d = dsfac_d * u + sfac * du_d,
// with row 3 of the output written 0.  No per-pair dU leaves the thread.
//
// Replaces two TPU kernels:
//   snap_fused_de_half_{f32,f64}
//     repro/kernels/snap_fused_de_half.py:snap_fused_de_half_pallas
//     (Y as half planes [idxu_half_max, n]);
//   snap_fused_de_full_{f32,f64}
//     repro/kernels/snap_fused_de.py:snap_fused_de_pallas
//     (Y as full planes [idxu_max, n]).
// The contraction weight w is 0 on every mirror row (rows 2mb > j), so both
// carry only the left rows of the recursion; the full kernel reads Y at the
// left rows' full-plane positions (level start + mb (j+1) + ma).  Its TPU
// counterpart carried all (j+1)^2 elements x 4 (u and three tangents), for
// the same result; here that would double the local-memory frame below.
// One thread per pair (k, atom): a warp covers 32 consecutive atoms of one
// neighbor slot, so the displacement, Y and output accesses are coalesced.
// The level state (u and three tangents, current and previous level) lives
// in local arrays sized for 2J = 14: 1920 values a thread.  At 2J = 8 the
// touched part is 720 values; it spills from registers to local memory
// (L1/L2), which is accepted for this first version.
//
// Bound on the H100: ~100 flops per (pair, half element) against a few
// bytes per pair and the Y planes, so operations bound it.

#include "snap_common.cuh"

template <typename T, bool FULL>
__global__ void snap_fused_de_kernel(const T* __restrict__ disp,
                                     const T* __restrict__ y_r,
                                     const T* __restrict__ y_i,
                                     T* __restrict__ out,
                                     const T* __restrict__ rootpq, int nnbor,
                                     int n, int twojmax, T rcut, T rmin0,
                                     T rfac0, int switch_flag) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)nnbor * n) return;
  const int k = (int)(tid / n);
  const int atom = (int)(tid % n);
  const int rp = SNAP_MAXJ + 1;
  const T* dsp = disp + (size_t)k * 4 * n + atom;
  PairCKGrad<T> dg;
  const PairCK<T> g = geom_ck_grad(dsp[0], dsp[n], dsp[2 * n], rcut, rmin0,
                                   rfac0, switch_flag, &dg);
  const T m = dsp[3 * n];
  const T sfac = g.sfac * m;
  T dsfac[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) dsfac[d] = dg.dsfac[d] * m;

  T u_r[2][SNAP_HALF_LEVEL_MAX], u_i[2][SNAP_HALF_LEVEL_MAX];
  T du_r[2][3][SNAP_HALF_LEVEL_MAX], du_i[2][3][SNAP_HALF_LEVEL_MAX];
  T acc[3];
  // level 0: u = 1, du = 0, weight 0.5
  {
    const T y0 = y_r[atom];
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = T(0.5) * (dsfac[d] * y0);
  }
  int cur = 0;
  u_r[0][0] = T(1);
  u_i[0][0] = T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    du_r[0][d][0] = T(0);
    du_i[0][d][0] = T(0);
  }
  int base = 1;
  for (int j = 1; j <= twojmax; ++j) {
    const int nx = cur ^ 1;
    const int rows = j / 2 + 1;
    for (int mb = 0; mb < rows; ++mb) {
      for (int ma = 0; ma <= j; ++ma) {
        T vr = T(0), vi = T(0), dvr[3] = {T(0), T(0), T(0)},
          dvi[3] = {T(0), T(0), T(0)};
        T pr, pi, dpr, dpi;
        if (ma < j) {  // conj(a) term into column ma
          const T c = rootpq[(j - ma) * rp + (j - mb)];
          prev_elem(u_r[cur], u_i[cur], j, mb, ma, &pr, &pi);
          vr += c * (g.a_r * pr + g.a_i * pi);
          vi += c * (g.a_r * pi - g.a_i * pr);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            prev_elem(du_r[cur][d], du_i[cur][d], j, mb, ma, &dpr, &dpi);
            dvr[d] += c * ((dg.da_r[d] * pr + dg.da_i[d] * pi) +
                           (g.a_r * dpr + g.a_i * dpi));
            dvi[d] += c * ((dg.da_r[d] * pi - dg.da_i[d] * pr) +
                           (g.a_r * dpi - g.a_i * dpr));
          }
        }
        if (ma > 0) {  // conj(b) term of column ma-1 into column ma
          const T c = -rootpq[ma * rp + (j - mb)];
          prev_elem(u_r[cur], u_i[cur], j, mb, ma - 1, &pr, &pi);
          vr += c * (g.b_r * pr + g.b_i * pi);
          vi += c * (g.b_r * pi - g.b_i * pr);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            prev_elem(du_r[cur][d], du_i[cur][d], j, mb, ma - 1, &dpr,
                      &dpi);
            dvr[d] += c * ((dg.db_r[d] * pr + dg.db_i[d] * pi) +
                           (g.b_r * dpr + g.b_i * dpi));
            dvi[d] += c * ((dg.db_r[d] * pi - dg.db_i[d] * pr) +
                           (g.b_r * dpi - g.b_i * dpr));
          }
        }
        const int e = mb * (j + 1) + ma;
        u_r[nx][e] = vr;
        u_i[nx][e] = vi;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          du_r[nx][d][e] = dvr[d];
          du_i[nx][d][e] = dvi[d];
        }
        const T w = half_weight<T>(j, mb, ma);
        if (w != T(0)) {
          const T yr = w * y_r[(size_t)(base + e) * n + atom];
          const T yi = w * y_i[(size_t)(base + e) * n + atom];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const T dur = dsfac[d] * vr + sfac * dvr[d];
            const T dui = dsfac[d] * vi + sfac * dvi[d];
            acc[d] += dur * yr + dui * yi;
          }
        }
      }
    }
    base += level_size(j, FULL);
    cur = nx;
  }
  T* o = out + (size_t)k * 4 * n + atom;
#pragma unroll
  for (int d = 0; d < 3; ++d) o[(size_t)d * n] = T(2) * acc[d];
  o[(size_t)3 * n] = T(0);
}

template <typename T, bool FULL>
static int launch(const void* disp, const void* y_r, const void* y_i,
                  void* out, const void* rootpq, int nnbor, int n,
                  int twojmax, double rcut, double rmin0, double rfac0,
                  int switch_flag, int device, void* stream) {
  if (twojmax < 0 || twojmax > SNAP_MAXJ || n < 0 || nnbor < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = (long long)nnbor * n;
  if (pairs == 0) return 0;
  const int block = 128;
  snap_fused_de_kernel<T, FULL>
      <<<(unsigned)((pairs + block - 1) / block), block, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(disp), static_cast<const T*>(y_r),
          static_cast<const T*>(y_i), static_cast<T*>(out),
          static_cast<const T*>(rootpq), nnbor, n, twojmax, T(rcut),
          T(rmin0), T(rfac0), switch_flag);
  return static_cast<int>(cudaGetLastError());
}

#define SNAP_DE_SYMBOL(name, T, FULL)                                        \
  extern "C" int name(const void* disp, const void* y_r, const void* y_i,    \
                      void* out, const void* rootpq, int nnbor, int n,       \
                      int twojmax, double rcut, double rmin0, double rfac0,  \
                      int switch_flag, int device, void* stream) {           \
    return launch<T, FULL>(disp, y_r, y_i, out, rootpq, nnbor, n, twojmax,   \
                           rcut, rmin0, rfac0, switch_flag, device, stream); \
  }

SNAP_DE_SYMBOL(snap_fused_de_half_f32, float, false)
SNAP_DE_SYMBOL(snap_fused_de_half_f64, double, false)
SNAP_DE_SYMBOL(snap_fused_de_full_f32, float, true)
SNAP_DE_SYMBOL(snap_fused_de_full_f64, double, true)
