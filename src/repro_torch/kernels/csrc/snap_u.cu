// U kernels: per atom, sum over its masked neighbors of sfac * u_j(mb, ma),
// the self term left out.
//
// Replaces two TPU kernels:
//   snap_u_half_{f32,f64}  repro/kernels/snap_u.py:snap_u_half_pallas
//                          (the left rows 2mb <= j, [idxu_half_max, n]);
//   snap_u_full_{f32,f64}  repro/kernels/snap_u.py:snap_u_pallas
//                          (every row, [idxu_max, n]).
//
// Design (the paper's hierarchical parallelism, atoms x neighbors x the
// elements of a Wigner level).  A block is a tile of A consecutive atoms on
// threadIdx.x (plane accesses coalesced) x T threads on threadIdx.y that
// share the elements of each level: thread y computes a contiguous run of
// the level's left rows (run_bounds), carrying the previous level's
// element (mb, ma - 1) of its conj(b) term from the element before; the
// terms' coefficients carry the mirror signs (snap_common.cuh).  The grid
// is atom tiles x G neighbor groups (blockIdx.y); group g walks neighbors
// [nnbor g / G, nnbor (g+1) / G) in order.  Per chunk of T neighbors,
// thread (x, y) computes the Cayley-Klein parameters of neighbor y of atom
// x into shared memory.  Per neighbor, the recursion runs level by level
// on a shared ping-pong [2][re, im][L][A] (L = the largest left-rows
// level), one __syncthreads() per level.  The group's sum lives in shared
// memory as [re, im][idxu_half_max][A]; each (element, atom) of it is owned
// by one thread and added in neighbor order.  The full layout keeps the
// same left-rows sum and writes each mirror row from its source,
//     u(j - mb, j - ma) = (-1)^(mb + ma) conj(u(mb, ma)),
// which is exact: the sum of mirrors is the mirror of the sum.  Each block
// writes its group's partial plane [2][G][idxu_half_max][n], and a second
// kernel sums the G partials in the order g = 0 .. G - 1 and writes the
// output (mirror rows included), one thread per (output row, atom); only
// that kernel differs between the layouts.  No atomics, fixed orders: the
// result is deterministic.  rootpq is read from shared memory.
//
// Bound on the H100: ~3,260 flops per (atom, neighbor) pair at 2J = 8
// against a few bytes per pair, so operations bound it in principle
// (5 us f64 at snap-2j8).  In practice shared-memory traffic (~64 B per
// element and neighbor in f64: the previous-level read, the level write,
// the read-modify-write of the sum) and the per-level barriers hold it;
// the sum's [idxu_half_max][A] caps the blocks an SM holds.  The launch
// plan (kernels/launch_plan.py: A, T, G and the shared-memory bytes) sizes
// the block to fit 227 KB and the grid to fill the 132 SMs.

#include "snap_common.cuh"

// Shared memory of one block, in elements of T: rootpq, the Cayley-Klein
// parameters of T neighbors, the level ping-pong and the group's sum
// (kernels/launch_plan.u_smem computes the same).
static int u_smem_elems(int twojmax, int lanes, int threads) {
  return SNAP_RP_SIZE + 5 * threads * lanes +
         4 * level_size(twojmax, false) * lanes +
         2 * plane_rows(twojmax, false) * lanes;
}

template <typename T>
__global__ void snap_u_kernel(const T* __restrict__ disp,
                              T* __restrict__ part,
                              const T* __restrict__ rootpq, int nnbor, int n,
                              int twojmax, T rcut, T rmin0, T rfac0,
                              int switch_flag) {
  extern __shared__ __align__(16) unsigned char snap_smem[];
  const int A = blockDim.x, TT = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y;
  const int tid = y * A + x, nthreads = A * TT;
  const int atom = blockIdx.x * A + x;
  const bool live = atom < n;
  const int G = gridDim.y, g = blockIdx.y;
  const int L = level_size(twojmax, false);
  const int H = plane_rows(twojmax, false);
  T* rp = reinterpret_cast<T*>(snap_smem);  // [RP_SIZE]
  T* geo = rp + SNAP_RP_SIZE;               // [5][TT][A]
  T* lvl = geo + 5 * TT * A;                // [2 buf][re, im][L][A]
  T* acc_r = lvl + 4 * L * A;               // [H][A]
  T* acc_i = acc_r + H * A;                 // [H][A]
  for (int i = tid; i < SNAP_RP_SIZE; i += nthreads) rp[i] = rootpq[i];
  for (int i = tid; i < 2 * H * A; i += nthreads) acc_r[i] = T(0);

  const int k_lo = (int)((long long)nnbor * g / G);
  const int k_hi = (int)((long long)nnbor * (g + 1) / G);
  for (int k0 = k_lo; k0 < k_hi; k0 += TT) {
    // every reader of the previous chunk passed a barrier since
    if (k0 + y < k_hi) {
      PairCK<T> ck;
      T m = T(0);
      if (live) {
        const T* d = disp + (size_t)(k0 + y) * 4 * n + atom;
        ck = geom_ck(d[0], d[n], d[2 * n], rcut, rmin0, rfac0, switch_flag);
        m = d[3 * n];
      } else {  // padding lane: a regular radius, masked out
        ck = geom_ck(T(0.5) * rcut, T(0), T(0), rcut, rmin0, rfac0,
                     switch_flag);
      }
      geo[(0 * TT + y) * A + x] = ck.a_r;
      geo[(1 * TT + y) * A + x] = ck.a_i;
      geo[(2 * TT + y) * A + x] = ck.b_r;
      geo[(3 * TT + y) * A + x] = ck.b_i;
      geo[(4 * TT + y) * A + x] = ck.sfac * m;
    }
    __syncthreads();
    const int kn = min(TT, k_hi - k0);
    for (int t = 0; t < kn; ++t) {
      const T a_r = geo[(0 * TT + t) * A + x];
      const T a_i = geo[(1 * TT + t) * A + x];
      const T b_r = geo[(2 * TT + t) * A + x];
      const T b_i = geo[(3 * TT + t) * A + x];
      const T sfac = geo[(4 * TT + t) * A + x];
      if (y == 0) {  // level 0: u = 1
        acc_r[x] += sfac;
        lvl[x] = T(1);
        lvl[L * A + x] = T(0);
      }
      __syncthreads();
      int base = 1;  // half-plane start of level j
      for (int j = 1; j <= twojmax; ++j) {
        const T* pr_ = lvl + ((j - 1) & 1) * 2 * L * A + x;
        const T* pi_ = pr_ + L * A;
        T* cr = lvl + (j & 1) * 2 * L * A + x;
        T* ci = cr + L * A;
        const int cols = j + 1, size = level_size(j, false);
        int e, e_end;
        run_bounds(size, TT, y, &e, &e_end);
        int mb = e / cols, ma = e % cols;
        // previous-level element (mb, ma - 1), as the conj(b) term reads it
        T qr = T(0), qi = T(0);
        if (e < e_end && ma > 0) {
          const int i = prev_index(j, mb, ma - 1);
          qr = pr_[i * A];
          qi = pi_[i * A];
        }
        for (; e < e_end; ++e) {
          const TermCoef<T> ca = a_term_coef(rp, j, mb, ma);
          const TermCoef<T> cb = b_term_coef(rp, j, mb, ma);
          const int i = prev_index(j, mb, ma < j ? ma : 0);
          const T ur = pr_[i * A], ui = pi_[i * A];
          if (ma == 0) qr = qi = T(0);  // no conj(b) term
          const T par = ca.c_r * ur, pai = ca.c_i * ui;
          const T pbr = cb.c_r * qr, pbi = cb.c_i * qi;
          const T vr = a_r * par + a_i * pai + b_r * pbr + b_i * pbi;
          const T vi = a_r * pai - a_i * par + b_r * pbi - b_i * pbr;
          cr[e * A] = vr;
          ci[e * A] = vi;
          acc_r[(base + e) * A + x] += sfac * vr;
          acc_i[(base + e) * A + x] += sfac * vi;
          qr = ur;
          qi = ui;
          if (++ma == cols) {
            ma = 0;
            ++mb;
          }
        }
        base += size;
        __syncthreads();
      }
    }
  }

  __syncthreads();  // the sum is read below in another thread order
  if (!live) return;
  // this group's partial plane; snap_u_sum_kernel adds them
  T* p_r = part + (size_t)g * H * n + atom;
  T* p_i = part + (size_t)(G + g) * H * n + atom;
  for (int r = y; r < H; r += TT) {
    p_r[(size_t)r * n] = acc_r[r * A + x];
    p_i[(size_t)r * n] = acc_i[r * A + x];
  }
}

// Sum of the G partial planes [2][G][H][n] in the order g = 0 .. G - 1,
// one thread per (output row, atom); a full-layout mirror row takes the
// sum of its source row with the sign flips.
template <typename T, bool FULL>
__global__ void snap_u_sum_kernel(const T* __restrict__ part,
                                  T* __restrict__ out_r,
                                  T* __restrict__ out_i, int groups, int n,
                                  int twojmax) {
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (atom >= n) return;
  int j = 0, hb = 0, ob = 0;
  while (row >= ob + level_size(j, FULL)) {
    hb += level_size(j, false);
    ob += level_size(j, FULL);
    ++j;
  }
  const int cols = j + 1, e = row - ob, mb = e / cols, ma = e % cols;
  int src = hb + e;
  T s_r = T(1), s_i = T(1);  // the mirror's signs: s, -s (conjugate)
  if (2 * mb > j) {
    src = hb + (j - mb) * cols + (j - ma);
    s_r = ((mb + ma) & 1) ? T(-1) : T(1);
    s_i = -s_r;
  }
  const int H = plane_rows(twojmax, false);
  const T* p_r = part + (size_t)src * n + atom;
  const T* p_i = part + ((size_t)groups * H + src) * n + atom;
  T vr = p_r[0], vi = p_i[0];
  for (int g = 1; g < groups; ++g) {
    vr += p_r[(size_t)g * H * n];
    vi += p_i[(size_t)g * H * n];
  }
  out_r[(size_t)row * n + atom] = s_r * vr;
  out_i[(size_t)row * n + atom] = s_i * vi;
}

// The launch plan (atoms per block, threads per atom, neighbor groups,
// shared-memory bytes) comes from kernels/launch_plan.u_plan; it is checked
// here against this file's own arithmetic.
template <typename T, bool FULL>
static int launch(const void* disp, void* out_r, void* out_i,
                  const void* rootpq, int nnbor, int n, int twojmax,
                  double rcut, double rmin0, double rfac0, int switch_flag,
                  int lanes, int threads, int groups, int smem, void* part,
                  int device, void* stream) {
  if (twojmax < 0 || twojmax > SNAP_MAXJ || n < 0 || nnbor < 0 ||
      lanes < 1 || threads < 1 || lanes * threads > SNAP_THREADS_MAX ||
      groups < 1 || groups > (nnbor > 1 ? nnbor : 1) || part == nullptr ||
      smem != (int)sizeof(T) * u_smem_elems(twojmax, lanes, threads) ||
      smem > SNAP_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  static bool granted[SNAP_DEVICES] = {};  // per kernel instance, device
  err = allow_smem(snap_u_kernel<T>,
                   device < SNAP_DEVICES ? &granted[device] : nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + lanes - 1) / lanes, groups), block(lanes, threads);
  snap_u_kernel<T><<<grid, block, smem, s>>>(
      static_cast<const T*>(disp), static_cast<T*>(part),
      static_cast<const T*>(rootpq), nnbor, n, twojmax, T(rcut), T(rmin0),
      T(rfac0), switch_flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_block = 128;
  snap_u_sum_kernel<T, FULL>
      <<<dim3((n + sum_block - 1) / sum_block, plane_rows(twojmax, FULL)),
         sum_block, 0, s>>>(static_cast<const T*>(part),
                            static_cast<T*>(out_r), static_cast<T*>(out_i),
                            groups, n, twojmax);
  return static_cast<int>(cudaGetLastError());
}

#define SNAP_U_SYMBOL(name, T, FULL)                                        \
  extern "C" int name(const void* disp, void* out_r, void* out_i,           \
                      const void* rootpq, int nnbor, int n, int twojmax,    \
                      double rcut, double rmin0, double rfac0,              \
                      int switch_flag, int lanes, int threads, int groups,  \
                      int smem, void* part, int device, void* stream) {     \
    return launch<T, FULL>(disp, out_r, out_i, rootpq, nnbor, n, twojmax,   \
                           rcut, rmin0, rfac0, switch_flag, lanes, threads, \
                           groups, smem, part, device, stream);             \
  }

SNAP_U_SYMBOL(snap_u_half_f32, float, false)
SNAP_U_SYMBOL(snap_u_half_f64, double, false)
SNAP_U_SYMBOL(snap_u_full_f32, float, true)
SNAP_U_SYMBOL(snap_u_full_f64, double, true)

// Blocks of snap_u_kernel resident per SM for a block of `threads` threads
// and `smem` bytes of dynamic shared memory (the launch plan's occupancy);
// one kernel serves both layouts, so `full` changes nothing.
extern "C" int snap_u_blocks_per_sm(int f64, int full, int threads, int smem,
                                    int* blocks, int device, void* stream) {
  (void)full;
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f64) {
    err = allow_smem(snap_u_kernel<double>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, snap_u_kernel<double>, threads, smem);
  } else {
    err = allow_smem(snap_u_kernel<float>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, snap_u_kernel<float>, threads, smem);
  }
  return static_cast<int>(err);
}
