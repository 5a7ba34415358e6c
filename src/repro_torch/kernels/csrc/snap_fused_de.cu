// Fused dE kernels: for each (neighbor, atom) pair, the Wigner recursion of
// u and of du/dx, du/dy, du/dz on the left rows 2mb <= j, contracted level
// by level against that atom's adjoint Y:
//     dedr[k, d, atom] = 2 sum_{j, mb, ma} w * Re(conj(dU_d) Y),
//     dU_d = dsfac_d * u + sfac * du_d,
// with row 3 of the output written 0.  No per-pair dU leaves the block.
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
// left rows' full-plane positions (level start + mb (j+1) + ma).
//
// Design (pairs x level elements, the state in shared memory).  A block
// is P pairs on threadIdx.x, consecutive atoms of one neighbor slot k
// (blockIdx.y), so the displacement, Y and output accesses are coalesced
// and every shared-memory access of a warp is conflict-free, x T threads
// on threadIdx.y that share the elements of each level.  Thread y walks a
// contiguous run of each level's left-rows elements (run_bounds), so the
// conj(b) term of element (mb, ma) reuses from registers the previous
// level's element (mb, ma - 1) that the conj(a) term of its left neighbor
// loaded: 8 shared-memory reads an element instead of 16.  Each block
// first builds a table of every element's two term coefficients (rootpq
// with the mirror signs of the previous level's half storage folded in),
// the stored index its conj(a) term reads, and its contraction weight, so
// the element loop only looks them up and has no branch.  Thread row 0
// computes each pair's geometry and its gradient into shared memory once.
// The level state (u and three tangents) lives in shared memory, one
// buffer for the even and one for the odd levels, [8][L_b][P] each
// (de_buf_size: the largest level of that parity that a later level reads;
// level 2J is contracted and never stored), one __syncthreads() per level.
// Each element is contracted with w Y, read one element ahead, at once into
// three registers.  At the end the T partial sums of a pair are added in
// the order y = 0 .. T - 1 through shared memory (over the level state).
// No atomics, fixed orders: deterministic.
//
// Bound on the H100: ~100 flops per (pair, half element) against a few
// bytes per pair and the Y planes, so operations bound it (33 us f64 at
// snap-2j8).  In practice each element's dependent chain (shared-memory
// reads, ~90 f64 multiply-adds, the Y read from L2) runs latency-bound:
// the stored state (3,840 B a pair in f64 at 2J = 8, 12,096 B at 2J = 14)
// and ~128 registers a thread cap an SM at 3 blocks of 16 x 8 in f64 (12
// warps); the launch plan (kernels/launch_plan.py: P, T and the shared-
// memory bytes) sizes the block to fit 227 KB.

#include "snap_common.cuh"

// Geometry fields per pair: a_r, a_i, b_r, b_i, sfac, then da_r[3],
// da_i[3], db_r[3], db_i[3], dsfac[3].
#define DE_GEO 20
// State arrays per level buffer: u_r, u_i, du_r[3], du_i[3].
#define DE_STATE 8
// Table values per half element: conj(a) and conj(b) coefficients (re, im
// signs folded in) and the contraction weight; plus one int, the index.
#define DE_TAB 5

// Elements of the level buffer of parity `parity` (0 even, 1 odd): the
// largest left-rows level of that parity below twojmax (level twojmax is
// never read back), at least 1 (level 0 sits in buffer 0).
__host__ __device__ __forceinline__ int de_buf_size(int twojmax,
                                                    int parity) {
  int j = twojmax - 1;
  if (j >= 0 && (j & 1) != parity) --j;
  return j >= 0 ? level_size(j, false) : 1;
}

// Elements of T in the state region: both level buffers, or the
// end-of-pair reduction [3][threads][lanes] that reuses it, per lane.
__host__ __device__ __forceinline__ int de_state_elems(int twojmax,
                                                       int threads) {
  const int st = DE_STATE * (de_buf_size(twojmax, 0) +
                             de_buf_size(twojmax, 1));
  return st > 3 * threads ? st : 3 * threads;
}

// Shared memory of one block, in bytes for elements of `size` bytes: the
// geometry, the state region, the element table (kernels/launch_plan.
// de_smem computes the same).
static int de_smem_bytes(int size, int twojmax, int lanes, int threads) {
  const int h = plane_rows(twojmax, false);
  return size * (DE_GEO * lanes + de_state_elems(twojmax, threads) * lanes +
                 DE_TAB * h) +
         (int)sizeof(int) * h;
}

template <typename T, bool FULL>
__global__ void snap_fused_de_kernel(const T* __restrict__ disp,
                                     const T* __restrict__ y_r,
                                     const T* __restrict__ y_i,
                                     T* __restrict__ out,
                                     const T* __restrict__ rootpq, int nnbor,
                                     int n, int twojmax, T rcut, T rmin0,
                                     T rfac0, int switch_flag) {
  extern __shared__ __align__(16) unsigned char snap_smem[];
  const int P = blockDim.x, TT = blockDim.y;
  const int p = threadIdx.x, y = threadIdx.y;
  const int tid = y * P + p, nthreads = P * TT;
  const int k = blockIdx.y;
  const int atom = blockIdx.x * P + p;
  const bool live = atom < n;
  const int col = live ? atom : n - 1;  // padding lanes read a real column
  const int H = plane_rows(twojmax, false);
  const int lb0 = de_buf_size(twojmax, 0), lb1 = de_buf_size(twojmax, 1);
  T* geo = reinterpret_cast<T*>(snap_smem);       // [DE_GEO][P]
  T* buf0 = geo + DE_GEO * P;                     // [DE_STATE][lb0][P]
  T* buf1 = buf0 + DE_STATE * lb0 * P;            // [DE_STATE][lb1][P]
  T* red = buf0;                                  // [3][TT][P], at the end
  T* tab = buf0 + de_state_elems(twojmax, TT) * P;  // [DE_TAB][H]
  int* tab_i = reinterpret_cast<int*>(tab + DE_TAB * H);  // [H]

  // the element table: level j, element e at h = (half start of j) + e
  for (int h = tid; h < H; h += nthreads) {
    int j = 0, e = h;
    while (e >= level_size(j, false)) e -= level_size(j++, false);
    T ca_r = T(0), ca_i = T(0), cb_r = T(0), cb_i = T(0), w = T(0.5);
    int i = 0;
    if (j > 0) {
      const int mb = e / (j + 1), ma = e % (j + 1);
      const TermCoef<T> a = a_term_coef(rootpq, j, mb, ma);
      const TermCoef<T> b = b_term_coef(rootpq, j, mb, ma);
      ca_r = a.c_r;
      ca_i = a.c_i;
      cb_r = b.c_r;
      cb_i = b.c_i;
      w = half_weight<T>(j, mb, ma);
      i = prev_index(j, mb, ma < j ? ma : 0);
    }
    tab[h] = ca_r;
    tab[H + h] = ca_i;
    tab[2 * H + h] = cb_r;
    tab[3 * H + h] = cb_i;
    tab[4 * H + h] = w;
    tab_i[h] = i;
  }
  if (y == 0) {
    PairCKGrad<T> dg;
    PairCK<T> g;
    T m = T(0);
    if (live) {
      const T* d = disp + (size_t)k * 4 * n + atom;
      g = geom_ck_grad(d[0], d[n], d[2 * n], rcut, rmin0, rfac0, switch_flag,
                       &dg);
      m = d[3 * n];
    } else {  // padding lane: a regular radius, masked out
      g = geom_ck_grad(T(0.5) * rcut, T(0), T(0), rcut, rmin0, rfac0,
                       switch_flag, &dg);
    }
    geo[0 * P + p] = g.a_r;
    geo[1 * P + p] = g.a_i;
    geo[2 * P + p] = g.b_r;
    geo[3 * P + p] = g.b_i;
    geo[4 * P + p] = g.sfac * m;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      geo[(5 + d) * P + p] = dg.da_r[d];
      geo[(8 + d) * P + p] = dg.da_i[d];
      geo[(11 + d) * P + p] = dg.db_r[d];
      geo[(14 + d) * P + p] = dg.db_i[d];
      geo[(17 + d) * P + p] = dg.dsfac[d] * m;
    }
    // level 0: u = 1, du = 0 in buffer 0
    buf0[p] = T(1);
#pragma unroll
    for (int q = 1; q < DE_STATE; ++q) buf0[q * lb0 * P + p] = T(0);
  }
  __syncthreads();
  const T a_r = geo[0 * P + p], a_i = geo[1 * P + p];
  const T b_r = geo[2 * P + p], b_i = geo[3 * P + p];
  const T sfac = geo[4 * P + p];
  T da_r[3], da_i[3], db_r[3], db_i[3], dsfac[3], acc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    da_r[d] = geo[(5 + d) * P + p];
    da_i[d] = geo[(8 + d) * P + p];
    db_r[d] = geo[(11 + d) * P + p];
    db_i[d] = geo[(14 + d) * P + p];
    dsfac[d] = geo[(17 + d) * P + p];
    acc[d] = T(0);
  }
  if (y == 0) {  // level 0: weight 0.5
    const T y0 = y_r[col];
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = T(0.5) * (dsfac[d] * y0);
  }

  int hb = 1;    // half-plane start of level j: its table entries
  int base = 1;  // plane start of level j (half or full layout)
  for (int j = 1; j <= twojmax; ++j) {
    const bool odd = j & 1;
    const T* pv = (odd ? buf0 : buf1) + p;   // level j - 1
    const int lp = (odd ? lb0 : lb1) * P;    // its array stride
    T* cv = (odd ? buf1 : buf0) + p;         // level j
    const int lc = (odd ? lb1 : lb0) * P;
    const bool keep = j < twojmax;           // read back by level j + 1
    int e, e_end;
    run_bounds(level_size(j, false), TT, y, &e, &e_end);
    // previous-level element of the first element's conj(b) term: the
    // conj(a) element of the table entry before it (b is 0 at ma = 0)
    T q[DE_STATE];
    {
      const T* s0 = pv + tab_i[hb + e - 1] * P;
#pragma unroll
      for (int s = 0; s < DE_STATE; ++s) q[s] = e < e_end ? s0[s * lp] : T(0);
    }
    // Y of the run's first element, then always one element ahead
    const T* yr_ = y_r + (size_t)(base + e) * n + col;
    const T* yi_ = y_i + (size_t)(base + e) * n + col;
    T ynr = T(0), yni = T(0);
    if (e < e_end) {
      ynr = *yr_;
      yni = *yi_;
    }
    for (; e < e_end; ++e) {
      const T ycr = ynr, yci = yni;
      yr_ += n;
      yi_ += n;
      if (e + 1 < e_end) {
        ynr = *yr_;
        yni = *yi_;
      }
      const int h = hb + e;
      const T ca_r = tab[h], ca_i = tab[H + h];
      const T cb_r = tab[2 * H + h], cb_i = tab[3 * H + h];
      const T w = tab[4 * H + h];
      T u[DE_STATE];  // the conj(a) element of the previous level, raw
      {
        const T* s0 = pv + tab_i[h] * P;
#pragma unroll
        for (int s = 0; s < DE_STATE; ++s) u[s] = s0[s * lp];
      }
      // conj(c) x, with the previous level's mirror signs in c_r, c_i
      const T par = ca_r * u[0], pai = ca_i * u[1];
      const T pbr = cb_r * q[0], pbi = cb_i * q[1];
      const T vr = a_r * par + a_i * pai + b_r * pbr + b_i * pbi;
      const T vi = a_r * pai - a_i * par + b_r * pbi - b_i * pbr;
      T dvr[3], dvi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T dar = ca_r * u[2 + d], dai = ca_i * u[5 + d];
        const T dbr = cb_r * q[2 + d], dbi = cb_i * q[5 + d];
        dvr[d] = da_r[d] * par + da_i[d] * pai + a_r * dar + a_i * dai +
                 db_r[d] * pbr + db_i[d] * pbi + b_r * dbr + b_i * dbi;
        dvi[d] = da_r[d] * pai - da_i[d] * par + a_r * dai - a_i * dar +
                 db_r[d] * pbi - db_i[d] * pbr + b_r * dbi - b_i * dbr;
      }
      if (keep) {
        cv[e * P] = vr;
        cv[lc + e * P] = vi;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          cv[(2 + d) * lc + e * P] = dvr[d];
          cv[(5 + d) * lc + e * P] = dvi[d];
        }
      }
      const T yr = w * ycr, yi = w * yci;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T dur = dsfac[d] * vr + sfac * dvr[d];
        const T dui = dsfac[d] * vi + sfac * dvi[d];
        acc[d] += dur * yr + dui * yi;
      }
#pragma unroll
      for (int s = 0; s < DE_STATE; ++s) q[s] = u[s];
    }
    hb += level_size(j, false);
    base += level_size(j, FULL);
    __syncthreads();
  }

  // the level state is free: the T partial sums of each pair, in order
#pragma unroll
  for (int d = 0; d < 3; ++d) red[(d * TT + y) * P + p] = acc[d];
  __syncthreads();
  if (y != 0 || !live) return;
  T* o = out + (size_t)k * 4 * n + atom;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T s = red[(d * TT) * P + p];
    for (int t = 1; t < TT; ++t) s += red[(d * TT + t) * P + p];
    o[(size_t)d * n] = T(2) * s;
  }
  o[(size_t)3 * n] = T(0);
}

// The launch plan (pairs per block, threads per pair, shared-memory bytes)
// comes from kernels/launch_plan.de_plan; it is checked here against this
// file's own arithmetic.
template <typename T, bool FULL>
static int launch(const void* disp, const void* y_r, const void* y_i,
                  void* out, const void* rootpq, int nnbor, int n,
                  int twojmax, double rcut, double rmin0, double rfac0,
                  int switch_flag, int lanes, int threads, int smem,
                  int device, void* stream) {
  if (twojmax < 0 || twojmax > SNAP_MAXJ || n < 0 || nnbor < 0 ||
      nnbor > 65535 || lanes < 1 || threads < 1 ||
      lanes * threads > SNAP_THREADS_MAX ||
      smem != de_smem_bytes((int)sizeof(T), twojmax, lanes, threads) ||
      smem > SNAP_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || nnbor == 0) return 0;
  static bool granted[SNAP_DEVICES] = {};  // per kernel instance, device
  err = allow_smem(snap_fused_de_kernel<T, FULL>,
                   device < SNAP_DEVICES ? &granted[device] : nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + lanes - 1) / lanes, nnbor), block(lanes, threads);
  snap_fused_de_kernel<T, FULL>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
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
                      int switch_flag, int lanes, int threads, int smem,     \
                      int device, void* stream) {                            \
    return launch<T, FULL>(disp, y_r, y_i, out, rootpq, nnbor, n, twojmax,   \
                           rcut, rmin0, rfac0, switch_flag, lanes, threads,  \
                           smem, device, stream);                            \
  }

SNAP_DE_SYMBOL(snap_fused_de_half_f32, float, false)
SNAP_DE_SYMBOL(snap_fused_de_half_f64, double, false)
SNAP_DE_SYMBOL(snap_fused_de_full_f32, float, true)
SNAP_DE_SYMBOL(snap_fused_de_full_f64, double, true)

// Blocks of snap_fused_de_kernel resident per SM for a block of `threads`
// threads and `smem` bytes of dynamic shared memory.
extern "C" int snap_fused_de_blocks_per_sm(int f64, int full, int threads,
                                           int smem, int* blocks, int device,
                                           void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f64) {
    auto k = full ? snap_fused_de_kernel<double, true>
                  : snap_fused_de_kernel<double, false>;
    err = allow_smem(k);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads,
                                                          smem);
  } else {
    auto k = full ? snap_fused_de_kernel<float, true>
                  : snap_fused_de_kernel<float, false>;
    err = allow_smem(k);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads,
                                                          smem);
  }
  return static_cast<int>(err);
}
