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
//     (one rounding, also from float64, done once as the tile is staged), s
//     applied after it, the complex product formed in the plane type and
//     rounded to bf16, the coefficient rounded to bf16, the sum kept in the
//     plane type;
//   snap_y_full_{f32,f64}       repro/kernels/snap_y.py:snap_y_pallas
//     (the full-space table, no s; rows no entry reaches, the mirror rows,
//     are written 0 as compute_ylist leaves them).
// The TPU kernels turned the COO table into one-hot matmuls because the TPU
// has no fast in-kernel gather; Hopper gathers directly, from shared memory.
//
// Table (kernels/snap_y.py, built once per 2J on the host): sorted by
// destination (CSR row pointers) and, inside a row, by (src1, src2); one
// packed int32 an entry, src1 | s1 < 0 << 15 | src2 << 16 | s2 < 0 << 31,
// and the coefficient beside it.
//
// Coefficients: one row [nnz] for every atom (lane_atoms 0), or one row a
// lane of lane_atoms atoms, [n / lane_atoms][coef_stride] (the batched force
// entry: B requests side by side on one atom axis, each with its own beta).
// A lane is a whole number of atom tiles (the launcher checks it), so a
// block reads the one row of its tile's lane: one pointer offset a block.
//
// Design.  A block owns an atom tile and one row group
// (kernels/launch_plan.y_row_groups: a contiguous range of destination rows
// with about equal entries).  It first stages the tile's whole U column
// [rows][re, im][atoms] (odd rows [im, re] at 4 lanes, tile_re) in shared
// memory (cp.async): every row is a source, and the column of a 128-atom
// block (317 KB at 2J=8 f64) would not stay in L1, so gathers from the
// planes themselves would be served by L2.
// Threads are (lane x row slot), a lane owning one 16-byte vector of atoms
// (4 f32, 2 f64), so the per-entry work (the warp-uniform loads of the
// packed entry and its coefficient, decoding, addressing) is paid once for
// 4 or 2 atoms.  Slot y walks an equal share of the group's entries
// (launch_plan.y_segments) in table order, keeping u[src1]
// in registers across a run of one src1, so an entry reads u[src2] and, at a
// new src1, u[src1] from shared memory as 16-byte vectors.  A slot owns and
// writes the rows whose first entry lies in its share (rows without entries
// included: they are written 0); the entries of a share that precede its
// first owned row are the tail of a row an earlier slot owns, left as a
// partial sum in shared memory, which the owner adds after one barrier in
// slot order.  Every output (row, atom) is written by one thread and summed
// in a fixed order: deterministic, no atomics.
//
// Bound on the H100: 10 flops per (entry, atom) (s is a sign-bit flip)
// against the U/Y planes, so operations bound it (38,358 half or 41,889
// full entries x 2048 atoms at snap-2j8).  What the design meets first is
// instruction issue and the shared-memory rate: ~2 + 2/run values an entry
// (run: the entries of one src1 in a row, 2.3 on average at 2J=8), 128 B a
// clock an SM (PERF.md).

#include <cuda_bf16.h>

#include "snap_common.cuh"

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) {
  return static_cast<double>(__bfloat162float(__double2bfloat16(x)));
}

// Packed table entry: bits 0-14 src1, 15 s1 < 0, 16-30 src2, 31 s2 < 0.
#define SNAP_Y_SRC_MASK 0x7fffu
#define SNAP_Y_ROWS_MAX 0x8000
#define SNAP_Y_SIGN 0x80000000u
// Threads a block: the launch bound, so ptxas may give a thread up to 128
// registers (kernels/launch_plan.Y_THREADS_MAX holds the same).
#define SNAP_Y_THREADS_MAX 512

// A thread's atoms: one 16-byte vector, 4 floats or 2 doubles.
template <typename T>
struct YVec;
template <>
struct YVec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct YVec<double> {
  using type = double2;
  static constexpr int width = 2;
};

// Shared-memory bytes of a block of `lanes` x `slots` threads: the U column
// tile [rows][re, im][atoms] and the slots' partial sums
// [re, im][slots][atoms], atoms = lanes * 16 / itemsize
// (kernels/launch_plan.y_smem repeats it).
__host__ __device__ __forceinline__ long long y_smem_bytes(int rows,
                                                           int itemsize,
                                                           int lanes,
                                                           int slots) {
  return (long long)itemsize * 2 * (lanes * 16 / itemsize) * (rows + slots);
}

// One element of the tile, global -> shared without a register (sm_80+).
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x with its sign flipped where bit 31 of `sign` is set (one integer op).
__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __int_as_float(__float_as_int(x) ^ static_cast<int>(sign));
}
__device__ __forceinline__ double flip(double x, unsigned sign) {
  return __longlong_as_double(
      __double_as_longlong(x) ^
      static_cast<long long>(static_cast<unsigned long long>(sign) << 32));
}

template <typename T, int W>
struct Lanes {
  T v[W];
};

template <typename T>
__device__ __forceinline__ Lanes<T, YVec<T>::width> load_vec(const T* p) {
  const typename YVec<T>::type q =
      *reinterpret_cast<const typename YVec<T>::type*>(p);
  Lanes<T, YVec<T>::width> out;
  if constexpr (YVec<T>::width == 4) {
    out.v[0] = q.x, out.v[1] = q.y, out.v[2] = q.z, out.v[3] = q.w;
  } else {
    out.v[0] = q.x, out.v[1] = q.y;
  }
  return out;
}

// Row `row` of a Y plane at this thread's atoms [atom, atom + W).
template <typename T, int W>
__device__ __forceinline__ void store_vec(T* plane, int row, int n, int atom,
                                          const Lanes<T, W>& a) {
  T* p = plane + (size_t)row * n + atom;
  if (n % W == 0 && atom + W <= n) {
    typename YVec<T>::type q;
    if constexpr (W == 4) {
      q.x = a.v[0], q.y = a.v[1], q.z = a.v[2], q.w = a.v[3];
    } else {
      q.x = a.v[0], q.y = a.v[1];
    }
    *reinterpret_cast<typename YVec<T>::type*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (atom + k < n) p[k] = a.v[k];
  }
}

// Entries a step of the walk where no piece ends inside it: their table
// values and shared-memory loads are issued together.  SNAP_Y_AHEAD: how
// far ahead of a step its table lines are prefetched (two 128-byte lines
// of packed entries).
#define SNAP_Y_BATCH 4
#define SNAP_Y_AHEAD 64

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Offset of row `row`'s real part in the tile; its imaginary part is the
// other half of the row (tile_im).  Where a half-row is 64 bytes (4 lanes),
// the two slots of a quarter-warp read 64 bytes each from rows of their own,
// so odd rows are stored [im, re]: rows of unlike parity then fall on unlike
// banks and their 16-byte loads share one wavefront.
template <typename T, int ATOMS>
__device__ __forceinline__ int tile_re(int row) {
  if constexpr (ATOMS * sizeof(T) < 128) return (2 * row + (row & 1)) * ATOMS;
  return 2 * row * ATOMS;
}
template <typename T, int ATOMS>
__device__ __forceinline__ int tile_im(int re) {
  if constexpr (ATOMS * sizeof(T) < 128) return re ^ ATOMS;
  return re + ATOMS;
}

// acc += coef c times the product of entry p at this thread's W atoms.
// tile: the U column tile at this thread's atoms, [rows][re, im][ATOMS]
// (tile_re), so a source row is a shift-add or two away; u[src1] is kept
// in (src1, u1r, u1i) across a run of one src1.
template <typename T, int ATOMS, bool SIGMA, bool BF16, int W>
__device__ __forceinline__ void add_entry(unsigned p, T c, const T* tile,
                                          int* src1, Lanes<T, W>* u1r,
                                          Lanes<T, W>* u1i,
                                          Lanes<T, W>* acc_r,
                                          Lanes<T, W>* acc_i) {
  const int s1 = static_cast<int>(p & SNAP_Y_SRC_MASK);
  const int s2 = static_cast<int>((p >> 16) & SNAP_Y_SRC_MASK);
  if (s1 != *src1) {
    const int o1 = tile_re<T, ATOMS>(s1);
    *src1 = s1;
    *u1r = load_vec(tile + o1);
    *u1i = load_vec(tile + tile_im<T, ATOMS>(o1));
  }
  const int o2 = tile_re<T, ATOMS>(s2);
  const Lanes<T, W> u2r = load_vec(tile + o2);
  const Lanes<T, W> u2i = load_vec(tile + tile_im<T, ATOMS>(o2));
  const unsigned sign1 = SIGMA ? (p << 16) & SNAP_Y_SIGN : 0u;
  const unsigned sign2 = SIGMA ? p & SNAP_Y_SIGN : 0u;
  if (BF16) {  // the product rounded before the coefficient multiplies
    c = round_bf16(c);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T v1i = flip(u1i->v[k], sign1), v2i = flip(u2i.v[k], sign2);
      const T pr = round_bf16(u1r->v[k] * u2r.v[k] - v1i * v2i);
      const T pi = round_bf16(u1r->v[k] * v2i + v1i * u2r.v[k]);
      acc_r->v[k] += c * pr;
      acc_i->v[k] += c * pi;
    }
  } else {
    // c (u1r + i s1 u1i)(u2r + i s2 u2i) with a = c u1r, b = s1 c u1i:
    //   re = a u2r - b (s2 u2i),  im = a (s2 u2i) + b u2r
    const T c1 = flip(c, sign1);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T a = c * u1r->v[k], b = c1 * u1i->v[k];
      const T v2i = flip(u2i.v[k], sign2);
      acc_r->v[k] = fma(a, u2r.v[k], acc_r->v[k]);
      acc_r->v[k] = fma(-b, v2i, acc_r->v[k]);
      acc_i->v[k] = fma(a, v2i, acc_i->v[k]);
      acc_i->v[k] = fma(b, u2r.v[k], acc_i->v[k]);
    }
  }
}

// grid (atom tiles, row groups), block (LANES, slots); a thread owns W
// consecutive atoms of its tile of ATOMS = LANES * W.  segs: [2][S + 1]
// (first entry, first owned row of each slot s = group * slots + y, S the
// slots of the grid; kernels/launch_plan.y_segments).
template <typename T, int LANES, bool SIGMA, bool BF16>
__global__ void __launch_bounds__(SNAP_Y_THREADS_MAX)
    snap_y_kernel(const T* __restrict__ ut_r, const T* __restrict__ ut_i,
                  const int* __restrict__ rowptr,
                  const unsigned* __restrict__ packed,
                  const T* __restrict__ coef, const int* __restrict__ segs,
                  T* __restrict__ y_r, T* __restrict__ y_i, int rows,
                  int n, int lane_atoms, int coef_stride) {
  constexpr int W = YVec<T>::width, ATOMS = LANES * W;
  extern __shared__ __align__(16) unsigned char snap_smem[];
  const int slots = blockDim.y, lane = threadIdx.x, slot = threadIdx.y;
  T* const tile = reinterpret_cast<T*>(snap_smem);  // [rows][2][ATOMS]
  T* const part_r = tile + rows * 2 * ATOMS;        // [slots][ATOMS]
  T* const part_i = part_r + slots * ATOMS;
  const int atom0 = blockIdx.x * ATOMS;
  if (lane_atoms > 0)  // the coefficient row of this tile's lane
    coef += (size_t)(atom0 / lane_atoms) * coef_stride;

  // the U column tile: row stride n in the planes
  const int tid = slot * LANES + lane, nthreads = slots * LANES;
  for (int k = tid; k < rows * ATOMS; k += nthreads) {
    const int row = k / ATOMS, col = k % ATOMS, atom = atom0 + col;
    const int re = tile_re<T, ATOMS>(row);
    T* const dst_r = tile + re + col;
    T* const dst_i = tile + tile_im<T, ATOMS>(re) + col;
    if (atom < n) {
      stage_async(dst_r, ut_r + (size_t)row * n + atom);
      stage_async(dst_i, ut_i + (size_t)row * n + atom);
    } else {
      *dst_r = T(0);
      *dst_i = T(0);
    }
  }
  stage_wait();
  if (BF16) {  // each thread rounds the elements it staged (either half)
    for (int k = tid; k < rows * ATOMS; k += nthreads) {
      T* const dst = tile + (k / ATOMS) * 2 * ATOMS + k % ATOMS;
      dst[0] = round_bf16(dst[0]);
      dst[ATOMS] = round_bf16(dst[ATOMS]);
    }
  }
  __syncthreads();

  const int first = blockIdx.y * slots, s = first + slot;
  const int* const seg_e = segs;
  const int* const seg_r = segs + gridDim.y * slots + 1;
  const int e_lo = seg_e[s], e_hi = seg_e[s + 1];
  const int r_lo = seg_r[s], r_hi = seg_r[s + 1];
  const T* const mine = tile + lane * W;
  const int atom = atom0 + lane * W;

  // One walk over the share [e_lo, e_hi), in steps of SNAP_Y_BATCH entries
  // and of one entry only within SNAP_Y_BATCH of a piece's end, so the
  // slots of a warp stay in step.  Pieces: first the head (entries before
  // the first owned row: the tail of a row an earlier slot owns, kept as a
  // partial sum for it), then each owned row r_lo.. r_hi - 1; the last may
  // run on into the next slots' shares and is finished after the barrier.
  Lanes<T, W> acc_r, acc_i, u1r, u1i;
#pragma unroll
  for (int k = 0; k < W; ++k) acc_r.v[k] = acc_i.v[k] = T(0);
  int src1 = -1, r = r_lo - 1, bound = min(rowptr[r_lo], e_hi);
  bool open = false;
  for (int e = e_lo;;) {
    while (e == bound) {  // the piece ends here: hand it on
      if (r < r_lo) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          part_r[slot * ATOMS + lane * W + k] = acc_r.v[k];
          part_i[slot * ATOMS + lane * W + k] = acc_i.v[k];
        }
      } else if (rowptr[r + 1] > e_hi) {
        open = true;
      } else {
        store_vec(y_r, r, n, atom, acc_r);
        store_vec(y_i, r, n, atom, acc_i);
      }
      if (++r >= r_hi) break;
#pragma unroll
      for (int k = 0; k < W; ++k) acc_r.v[k] = acc_i.v[k] = T(0);
      bound = min(rowptr[r + 1], e_hi);
    }
    if (r >= r_hi) break;
    if (e + SNAP_Y_BATCH <= bound) {
      // the table lines SNAP_Y_AHEAD entries on, into L1 ahead of use
      const int ahead = min(e + SNAP_Y_AHEAD, e_hi - 1);
      prefetch_l1(packed + ahead);
      prefetch_l1(coef + ahead);
      unsigned p[SNAP_Y_BATCH];
      T c[SNAP_Y_BATCH];
#pragma unroll
      for (int k = 0; k < SNAP_Y_BATCH; ++k) {
        p[k] = __ldg(packed + e + k);
        c[k] = __ldg(coef + e + k);
      }
#pragma unroll
      for (int k = 0; k < SNAP_Y_BATCH; ++k)
        add_entry<T, ATOMS, SIGMA, BF16>(p[k], c[k], mine, &src1, &u1r, &u1i,
                                         &acc_r, &acc_i);
      e += SNAP_Y_BATCH;
    } else {
      add_entry<T, ATOMS, SIGMA, BF16>(__ldg(packed + e), __ldg(coef + e),
                                       mine, &src1, &u1r, &u1i, &acc_r,
                                       &acc_i);
      ++e;
    }
  }
  __syncthreads();
  if (open) {  // add the later slots' heads in slot order
    const int end = rowptr[r_hi];
    for (int t = slot + 1; seg_e[first + t] < end; ++t) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        acc_r.v[k] += part_r[t * ATOMS + lane * W + k];
        acc_i.v[k] += part_i[t * ATOMS + lane * W + k];
      }
    }
    store_vec(y_r, r_hi - 1, n, atom, acc_r);
    store_vec(y_i, r_hi - 1, n, atom, acc_i);
  }
}

// The launch plan (lanes, row slots, row groups, shared-memory bytes) comes
// from kernels/launch_plan.y_plan; the bytes are checked here against this
// file's own count.  Lanes are a template parameter: 4, 8, 16 or 32.
template <typename T, int LANES, bool SIGMA, bool BF16>
static int launch_lanes(const void* ut_r, const void* ut_i,
                        const void* rowptr, const void* packed,
                        const void* coef, const void* segs, void* y_r,
                        void* y_i, int rows, int n, int slots, int groups,
                        int smem, int lane_atoms, int coef_stride, int device,
                        cudaStream_t stream) {
  const int atoms = LANES * YVec<T>::width;
  // no tile may straddle two lanes' coefficient rows
  if (lane_atoms > 0 && (lane_atoms % atoms != 0 || n % lane_atoms != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool granted[SNAP_DEVICES] = {};  // per kernel instance, device
  cudaError_t err =
      allow_smem(snap_y_kernel<T, LANES, SIGMA, BF16>,
                 device < SNAP_DEVICES ? &granted[device] : nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + atoms - 1) / atoms, groups), block(LANES, slots);
  snap_y_kernel<T, LANES, SIGMA, BF16><<<grid, block, smem, stream>>>(
      static_cast<const T*>(ut_r), static_cast<const T*>(ut_i),
      static_cast<const int*>(rowptr), static_cast<const unsigned*>(packed),
      static_cast<const T*>(coef), static_cast<const int*>(segs),
      static_cast<T*>(y_r), static_cast<T*>(y_i), rows, n, lane_atoms,
      coef_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SIGMA, bool BF16>
static int launch(const void* ut_r, const void* ut_i, const void* rowptr,
                  const void* packed, const void* coef, const void* segs,
                  void* y_r, void* y_i, int rows, int n, int lanes,
                  int slots, int groups, int smem, int lane_atoms,
                  int coef_stride, int device, void* stream) {
  if (n < 0 || rows < 1 || rows > SNAP_Y_ROWS_MAX || slots < 1 ||
      lanes * slots > SNAP_Y_THREADS_MAX || groups < 1 || groups > rows ||
      groups > 65535 || lane_atoms < 0 || coef_stride < 0 ||
      smem != y_smem_bytes(rows, (int)sizeof(T), lanes, slots) ||
      smem > SNAP_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNAP_Y_LANES_CASE(L)                                                \
  case L:                                                                   \
    return launch_lanes<T, L, SIGMA, BF16>(ut_r, ut_i, rowptr, packed, coef, \
                                           segs, y_r, y_i, rows, n, slots,  \
                                           groups, smem, lane_atoms,        \
                                           coef_stride, device, s);
  switch (lanes) {
    SNAP_Y_LANES_CASE(4)
    SNAP_Y_LANES_CASE(8)
    SNAP_Y_LANES_CASE(16)
    SNAP_Y_LANES_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define SNAP_Y_SYMBOL(name, T, SIGMA, BF16)                                  \
  extern "C" int name(const void* ut_r, const void* ut_i, const void* rowptr, \
                      const void* packed, const void* coef, const void* segs, \
                      void* y_r, void* y_i, int rows, int n, int lanes,      \
                      int slots, int groups, int smem, int lane_atoms,       \
                      int coef_stride, int device, void* stream) {           \
    return launch<T, SIGMA, BF16>(ut_r, ut_i, rowptr, packed, coef, segs,    \
                                  y_r, y_i, rows, n, lanes, slots, groups,   \
                                  smem, lane_atoms, coef_stride, device,     \
                                  stream);                                   \
  }

SNAP_Y_SYMBOL(snap_y_half_f32, float, true, false)
SNAP_Y_SYMBOL(snap_y_half_f64, double, true, false)
SNAP_Y_SYMBOL(snap_y_half_bf16_f32, float, true, true)
SNAP_Y_SYMBOL(snap_y_half_bf16_f64, double, true, true)
SNAP_Y_SYMBOL(snap_y_full_f32, float, false, false)
SNAP_Y_SYMBOL(snap_y_full_f64, double, false, false)

template <typename T, bool SIGMA, bool BF16>
static cudaError_t y_occupancy(int lanes, int threads, int smem,
                               int* blocks) {
#define SNAP_Y_OCCUPANCY_CASE(L)                                          \
  case L: {                                                              \
    const cudaError_t err = allow_smem(snap_y_kernel<T, L, SIGMA, BF16>); \
    return err != cudaSuccess                                            \
               ? err                                                     \
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(           \
                     blocks, snap_y_kernel<T, L, SIGMA, BF16>, threads,  \
                     smem);                                              \
  }
  switch (lanes) {
    SNAP_Y_OCCUPANCY_CASE(4)
    SNAP_Y_OCCUPANCY_CASE(8)
    SNAP_Y_OCCUPANCY_CASE(16)
    SNAP_Y_OCCUPANCY_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of a Y kernel resident per SM for a block of `lanes` x
// (`threads` / `lanes`) threads and `smem` bytes of dynamic shared memory
// (the launch plan's occupancy); variant 0 half, 1 full, 2 half with bf16
// operands.
extern "C" int snap_y_blocks_per_sm(int f64, int variant, int lanes,
                                    int threads, int smem, int* blocks,
                                    int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (f64) {
    err = variant == 0   ? y_occupancy<double, true, false>(lanes, threads,
                                                            smem, blocks)
          : variant == 1 ? y_occupancy<double, false, false>(lanes, threads,
                                                             smem, blocks)
                         : y_occupancy<double, true, true>(lanes, threads,
                                                           smem, blocks);
  } else {
    err = variant == 0   ? y_occupancy<float, true, false>(lanes, threads,
                                                           smem, blocks)
          : variant == 1 ? y_occupancy<float, false, false>(lanes, threads,
                                                            smem, blocks)
                         : y_occupancy<float, true, true>(lanes, threads,
                                                          smem, blocks);
  }
  return static_cast<int>(err);
}
