// Linked-cell neighbor build on the card, gated by a device flag.
//
// Replaces the reference's jnp build (repro/md/cell_list.py: _bin_atoms and
// device_neighbors, no Pallas kernel).  The MD device loop decides on the
// card whether to rebuild (half-skin displacement trigger), so both
// launches read a 0-d int32 `trigger` first and return at once when it is
// 0: the host never reads the decision, and every buffer is left untouched.
//
// - cell_bin: one block per cell.  The block walks all atoms in index
//   order, blockDim at a time; each thread bins its atom with the
//   reference's arithmetic, and a warp ballot, __popc and per-warp counts
//   in shared memory give each atom of the cell its rank.  That keeps the
//   order of the reference's stable sort (atoms of a cell in increasing
//   index) without a sort or an atomic slot counter.  Slots past the
//   cell's count hold N (empty); atoms past cell_cap are dropped and the
//   count is raised into flags[FLAG_CELL_MAX] (integer atomicMax: its
//   result does not depend on order).  O(ncells * N) bin computations,
//   216 x 2000 at snap-2j8.
// - cell_build: one warp per atom.  The warp walks the deduplicated
//   stencil in the reference's order, each cell's slots 32 at a time; a
//   ballot and a prefix __popc pack the candidates within rcut + skin to
//   the front in candidate order, as the reference's stable argsort does.
//   Slots from the count up to K are zeroed; the count goes into
//   flags[FLAG_NBR_MAX] with atomicMax; lane 0 copies pos[i] into
//   pos_ref[i] when pos_ref is given.
//
// Which pairs fall inside the cutoff is decided by float rounding, so the
// arithmetic is the reference's, step by step (rn_math.cuh): the lists are
// then bitwise those of the plain PyTorch version (kernels/neighbors.py).
//
// Bound on the H100: bytes.  At snap-2j8 the build writes 2000 x 52 lists
// (index, mask, three shifts: ~2.9 MB in f64) and reads 48 KB of positions
// and a 22 KB cell table, ~1 us at 3.35 TB/s; the candidate tests (~250
// atoms in an atom's 27 cells, ~20 flops each) are ~10 MFLOP, under 1 us.
// Neither launch is tuned: a warp walks 27 x 25 slots in 27 chunks of 32
// lanes, 7 of them idle, and three f64 divisions a candidate dominate.

#include "rn_math.cuh"
#include "snap_common.cuh"

#define CELL_FLAG_NBR_MAX 0
#define CELL_FLAG_CELL_MAX 1

// Bin of one coordinate: frac = p / box, wrapped by frac - floor(frac),
// scaled by n, truncated, clamped to n - 1 (and to 0: a non-finite
// position converts to 0 here and to the most negative int in the plain
// version, so both clamp it to bin 0).
template <typename T>
__device__ __forceinline__ int bin_of(T p, T box, int n) {
  T f = rn_div(p, box);
  f = rn_sub(f, floor(f));
  const int b = static_cast<int>(rn_mul(f, static_cast<T>(n)));
  return max(min(b, n - 1), 0);
}

// The deduplicated stencil of one axis, ascending (md/neighbor.py
// dedup_stencil: sorted {-1, 0, 1} mod n): min(n, 3) offsets, the a-th of
// them 0, 1 or n - 1.
__device__ __forceinline__ int axis_count(int n) { return n < 3 ? n : 3; }
__device__ __forceinline__ int axis_offset(int n, int a) {
  return a < 2 ? a : n - 1;
}

template <typename T>
__global__ void cell_bin_kernel(const T* __restrict__ pos,
                                const T* __restrict__ box,
                                const int* __restrict__ trigger,
                                int* __restrict__ table, int* flags, int n,
                                int nx, int ny, int nz, int cap) {
  if (*trigger == 0) return;
  __shared__ int warp_count[32];
  __shared__ int base;
  const int cell = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T bx = box[0], by = box[1], bz = box[2];
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + threadIdx.x;
    bool in = false;
    if (i < n) {
      const int b0 = bin_of(pos[3 * i], bx, nx);
      const int b1 = bin_of(pos[3 * i + 1], by, ny);
      const int b2 = bin_of(pos[3 * i + 2], bz, nz);
      in = (b0 * ny + b1) * nz + b2 == cell;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    if (in) {
      int rank = base + __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_count[w];
      if (rank < cap) table[(size_t)cell * cap + rank] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < nwarps; ++w) s += warp_count[w];
      base += s;
    }
    __syncthreads();
  }
  const int count = base;
  for (int s = count + threadIdx.x; s < cap; s += blockDim.x)
    table[(size_t)cell * cap + s] = n;
  if (threadIdx.x == 0) atomicMax(flags + CELL_FLAG_CELL_MAX, count);
}

template <typename T>
__global__ void cell_build_kernel(
    const T* __restrict__ pos, const T* __restrict__ box,
    const int* __restrict__ trigger, const int* __restrict__ table,
    int* __restrict__ nbr_idx, bool* __restrict__ mask,
    T* __restrict__ shifts, T* __restrict__ pos_ref, int* flags, int n,
    int nx, int ny, int nz, int cap, int K, T rb2) {
  if (*trigger == 0) return;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;   // the whole warp shares i
  const T bx = box[0], by = box[1], bz = box[2];
  const T px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  const int b0 = bin_of(px, bx, nx), b1 = bin_of(py, by, ny),
            b2 = bin_of(pz, bz, nz);
  int* row_idx = nbr_idx + (size_t)i * K;
  bool* row_mask = mask + (size_t)i * K;
  T* row_shift = shifts + (size_t)i * K * 3;
  int count = 0;
  for (int a = 0; a < axis_count(nx); ++a)
    for (int b = 0; b < axis_count(ny); ++b)
      for (int c = 0; c < axis_count(nz); ++c) {
        const int cell = (((b0 + axis_offset(nx, a)) % nx) * ny +
                          (b1 + axis_offset(ny, b)) % ny) * nz +
                         (b2 + axis_offset(nz, c)) % nz;
        const int* slots = table + (size_t)cell * cap;
        for (int s0 = 0; s0 < cap; s0 += 32) {
          const int s = s0 + lane;
          const int j = s < cap ? slots[s] : n;
          bool valid = false;
          T hx = T(0), hy = T(0), hz = T(0);
          if (j < n && j != i) {
            const T dx = rn_sub(pos[3 * j], px);
            const T dy = rn_sub(pos[3 * j + 1], py);
            const T dz = rn_sub(pos[3 * j + 2], pz);
            hx = rn_mul(-bx, rint(rn_div(dx, bx)));
            hy = rn_mul(-by, rint(rn_div(dy, by)));
            hz = rn_mul(-bz, rint(rn_div(dz, bz)));
            const T ex = rn_add(dx, hx), ey = rn_add(dy, hy),
                    ez = rn_add(dz, hz);
            const T r2 = rn_add(rn_add(rn_mul(ex, ex), rn_mul(ey, ey)),
                                rn_mul(ez, ez));
            valid = r2 < rb2;
          }
          const unsigned ballot = __ballot_sync(0xffffffffu, valid);
          if (valid) {
            const int k = count + __popc(ballot & ((1u << lane) - 1u));
            if (k < K) {
              row_idx[k] = j;
              row_mask[k] = true;
              row_shift[3 * k] = hx;
              row_shift[3 * k + 1] = hy;
              row_shift[3 * k + 2] = hz;
            }
          }
          count += __popc(ballot);
        }
      }
  for (int k = min(count, K) + lane; k < K; k += 32) {
    row_idx[k] = 0;
    row_mask[k] = false;
    row_shift[3 * k] = T(0);
    row_shift[3 * k + 1] = T(0);
    row_shift[3 * k + 2] = T(0);
  }
  if (lane == 0) {
    atomicMax(flags + CELL_FLAG_NBR_MAX, count);
    if (pos_ref != nullptr) {
      pos_ref[3 * i] = px;
      pos_ref[3 * i + 1] = py;
      pos_ref[3 * i + 2] = pz;
    }
  }
}

static const int BIN_THREADS = 256;
static const int BUILD_THREADS = 256;   // 8 atoms a block

template <typename T>
static int launch_bin(const void* pos, const void* box, const void* trigger,
                      void* table, void* flags, int n, int nx, int ny,
                      int nz, int cap, int device, void* stream) {
  if (n < 0 || nx < 1 || ny < 1 || nz < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_bin_kernel<T><<<nx * ny * nz, BIN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(box),
      static_cast<const int*>(trigger), static_cast<int*>(table),
      static_cast<int*>(flags), n, nx, ny, nz, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_build(const void* pos, const void* box,
                        const void* trigger, const void* table,
                        void* nbr_idx, void* mask, void* shifts,
                        void* pos_ref, void* flags, int n, int nx, int ny,
                        int nz, int cap, int K, double rb2, int device,
                        void* stream) {
  if (n < 0 || nx < 1 || ny < 1 || nz < 1 || cap < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int per_block = BUILD_THREADS / 32;
  cell_build_kernel<T><<<(n + per_block - 1) / per_block, BUILD_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(box),
      static_cast<const int*>(trigger), static_cast<const int*>(table),
      static_cast<int*>(nbr_idx), static_cast<bool*>(mask),
      static_cast<T*>(shifts), static_cast<T*>(pos_ref),
      static_cast<int*>(flags), n, nx, ny, nz, cap, K,
      static_cast<T>(rb2));
  return static_cast<int>(cudaGetLastError());
}

#define CELL_BIN(SFX, T)                                                     \
  extern "C" int cell_bin_##SFX(const void* pos, const void* box,            \
                                const void* trigger, void* table,            \
                                void* flags, int n, int nx, int ny, int nz,  \
                                int cap, int device, void* stream) {         \
    return launch_bin<T>(pos, box, trigger, table, flags, n, nx, ny, nz,     \
                         cap, device, stream);                               \
  }
#define CELL_BUILD(SFX, T)                                                   \
  extern "C" int cell_build_##SFX(                                           \
      const void* pos, const void* box, const void* trigger,                 \
      const void* table, void* nbr_idx, void* mask, void* shifts,            \
      void* pos_ref, void* flags, int n, int nx, int ny, int nz, int cap,    \
      int K, double rb2, int device, void* stream) {                         \
    return launch_build<T>(pos, box, trigger, table, nbr_idx, mask, shifts,  \
                           pos_ref, flags, n, nx, ny, nz, cap, K, rb2,       \
                           device, stream);                                  \
  }

CELL_BIN(f32, float)
CELL_BIN(f64, double)
CELL_BUILD(f32, float)
CELL_BUILD(f64, double)
