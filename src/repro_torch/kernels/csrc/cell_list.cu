// Linked-cell neighbor build on the card, gated by a device flag.
//
// Replaces the reference's jnp build (repro/md/cell_list.py: _bin_atoms and
// device_neighbors, no Pallas kernel).  The MD device loop decides on the
// card whether to rebuild (half-skin displacement trigger), so both
// launches read a 0-d int32 `trigger` first and return at once when it is
// 0: the host never reads the decision, and every buffer is left untouched.
//
// - cell_bin: a stable counting sort by cell in one block (a redesign of
//   the first form's block a cell, which binned all N atoms again in each
//   of the ncells blocks: O(ncells * N) bins, 216 x 2000 at snap-2j8).
//   Each atom is binned once with the reference's arithmetic (the trigger,
//   the box and a thread's first atoms loaded in one round trip), the
//   cells are counted with shared-memory atomics and one warp sums the
//   counts into starts; the atoms are put in their cell's range at an
//   atomic cursor (an order that varies), and then each atom's slot is its
//   rank, the number of its cell's members below it (a cell of up to
//   BIN_SMALL atoms), or a warp's ballot walk over the atoms in index order
//   finds the first cell_cap of a larger cell.  That is the order of the
//   reference's stable sort (atoms of a cell in increasing index); slots
//   past the cell's count hold N (empty); atoms past cell_cap are dropped
//   and the largest count is raised into flags[FLAG_CELL_MAX] (integer
//   atomicMax: its result does not depend on order).  O(N + ncells) work;
//   the arrays (2 N + 2 ncells + 1 words) live in shared memory, or in the
//   wrapper's scratch past 226 KB (about 29,000 atoms).  One launch, so a
//   gated call (trigger 0) costs one launch that returns at once.  One
//   SM's FP64 divisions and shared-memory round trips bound it (~7 us at
//   snap-2j8); spreading it over a cluster of 8 blocks through
//   distributed shared memory was slower there (its barriers and remote
//   round trips cost more than the work they split).
// - cell_build: one block per cell (a redesign of the first form's one
//   warp an atom, which walked 27 cells of table slots from memory, 7 of
//   every 32 lanes idle, and left the card mostly idle).  The block reads the
//   cell's neighborhood from the table once: the slots of the
//   deduplicated stencil, in the reference's order, compacted (empty slots
//   dropped, order kept: a block-wide prefix sum) into shared memory with
//   each candidate's position.  The cell's own members come first in that
//   list; each warp takes one of them at a time and walks the staged
//   candidates 32 at a time, and a ballot and a prefix __popc pack the
//   candidates within rcut + skin to the front in candidate order, as the
//   reference's stable argsort does.  Slots from the count up to K are
//   zeroed; the count goes into flags[FLAG_NBR_MAX] with atomicMax; lane 0
//   copies pos[i] into pos_ref[i] when pos_ref is given.  A cell's atoms
//   are shared among blocks BUILD_SPLIT at a time (blockIdx.y), so a few
//   crowded cells still spread over the card.  The table must be
//   cell_bin's of the same positions: the atoms a full row dropped (index
//   past the row's largest) are found by binning the atoms above it, and
//   get their rows from the same candidates.  A neighborhood of more than
//   BUILD_TILE slots is walked from the table in memory, in the same
//   order.
//
// Which pairs fall inside the cutoff is decided by float rounding, so the
// arithmetic is the reference's, step by step (rn_math.cuh; the shift
// -box * rint(d / box) from image_fast, which skips the division where its
// value is certain, and image_slow where a lane needs it): the lists are
// then bitwise those of the plain PyTorch version (kernels/neighbors.py).
//
// Bound on the H100: bytes.  At snap-2j8 the build writes 2000 x 52 lists
// (index, mask, three shifts: ~2.9 MB in f64) and reads 48 KB of positions
// and a 22 KB cell table, ~1 us at 3.35 TB/s; the candidate tests (~250
// atoms in an atom's 27 cells, ~20 flops each) are ~10 MFLOP, under 1 us.
// What holds the build back is latency: 216 blocks (one a cell) on 132
// SMs, each a chain of dependent steps (the trigger, the table, the
// positions, two barriers) before its warps walk about 250 candidates
// each.  cell_bin reads 48 KB and writes a 22 KB table (~0.02 us of
// bytes); one block's chain of barriers (bin, scan, place, rank) bounds
// it.

#include <climits>

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

#define BIN_THREADS 1024
#define BIN_WARPS (BIN_THREADS / 32)
#define BIN_SMALL 64   // cells up to this many atoms are ranked, larger walked
// dynamic shared memory the arrays may take (the rest of the block's 227 KB
// holds the static arrays); kernels/neighbors.py holds the same
#define BIN_SMEM_MAX (SNAP_SMEM_MAX - 1024)

// Keeps a loaded value's load ahead of this point (the compiler would
// otherwise sink it past the trigger's early return).
__device__ __forceinline__ void issued(float v) { asm volatile("" ::"f"(v)); }
__device__ __forceinline__ void issued(double v) { asm volatile("" ::"d"(v)); }

// One block of BIN_THREADS.  Its arrays (each atom's cell, the atoms by
// cell, each cell's start and cursor: cell_bin_words int32 words) lie in
// shared memory, or in the wrapper's scratch where they do not fit.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(BIN_THREADS) cell_bin_kernel(
    const T* __restrict__ pos, const T* __restrict__ box,
    const int* __restrict__ trigger, int* __restrict__ table, int* flags,
    int* scratch, int n, int nx, int ny, int nz, int cap) {
  extern __shared__ __align__(16) unsigned char snap_smem[];
  __shared__ int s_big;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the trigger, the box and the thread's first two atoms in one round trip
  const int fire = *trigger;
  const T bx = box[0], by = box[1], bz = box[2];
  T x[2][3];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * BIN_THREADS;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[u][a] = i < n ? pos[3 * i + a] : T(0);
      issued(x[u][a]);
    }
  }
  if (fire == 0) return;
  const int ncells = nx * ny * nz;
  // STAGED: the arrays in shared memory (the compiler then knows their
  // space: shared-memory loads and atomics, not generic ones)
  int* cell = STAGED ? reinterpret_cast<int*>(snap_smem) : scratch;
  int* member = cell + n;
  int* start = member + n;            // ncells + 1
  int* cursor = start + ncells + 1;   // ncells
  for (int c = tid; c < ncells; c += BIN_THREADS) cursor[c] = 0;
  if (tid == 0) s_big = 0;
  __syncthreads();
  // each atom binned once, with the reference's arithmetic; cell counts
  for (int i0 = tid; i0 < n; i0 += 2 * BIN_THREADS) {
    if (i0 != tid) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * BIN_THREADS;
#pragma unroll
        for (int a = 0; a < 3; ++a) x[u][a] = i < n ? pos[3 * i + a] : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * BIN_THREADS;
      if (i < n) {
        const int c = (bin_of(x[u][0], bx, nx) * ny +
                       bin_of(x[u][1], by, ny)) * nz +
                      bin_of(x[u][2], bz, nz);
        cell[i] = c;
        atomicAdd(cursor + c, 1);
      }
    }
  }
  __syncthreads();
  // warp 0: the counts' exclusive sum into start (a lane 8 cells a step),
  // the largest count into flags, the cursors back to 0
  if (warp == 0) {
    int carry = 0, top = 0;
    for (int c0 = 0; c0 < ncells; c0 += 32 * 8) {
      int v[8], s = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + lane * 8 + q;
        v[q] = c < ncells ? cursor[c] : 0;
        s += v[q];
        top = max(top, v[q]);
      }
      int y = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, d);
        if (lane >= d) y += z;
      }
      int run = carry + y - s;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + lane * 8 + q;
        if (c < ncells) {
          start[c] = run;
          cursor[c] = 0;
        }
        run += v[q];
      }
      carry += __shfl_sync(0xffffffffu, y, 31);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      top = max(top, __shfl_xor_sync(0xffffffffu, top, d));
    if (lane == 0) {
      start[ncells] = carry;
      s_big = top > BIN_SMALL;
      atomicMax(flags + CELL_FLAG_CELL_MAX, top);
    }
  }
  __syncthreads();
  // the atoms grouped by cell (in no fixed order within a cell)
  for (int i = tid; i < n; i += BIN_THREADS) {
    const int c = cell[i];
    member[start[c] + atomicAdd(cursor + c, 1)] = i;
  }
  __syncthreads();
  // the table in index order: in a cell of up to BIN_SMALL atoms, each
  // atom goes to the slot of its rank (the number of its cell's members
  // below it), if that is under cap; slots past a cell's count hold N
  for (int i = tid; i < n; i += BIN_THREADS) {
    const int c = cell[i], s = start[c], len = start[c + 1] - s;
    if (len > BIN_SMALL) continue;
    int r = 0;
    for (int t = 0; t < len; ++t) r += member[s + t] < i;
    if (r < cap) table[(size_t)c * cap + r] = i;
  }
  for (int k = tid; k < ncells * cap; k += BIN_THREADS) {
    const int c = k / cap;
    if (k - c * cap >= start[c + 1] - start[c]) table[k] = n;
  }
  // a larger cell: a warp walks the atoms in index order until it has
  // min(count, cap) of them
  if (!s_big) return;
  for (int c = warp; c < ncells; c += BIN_WARPS) {
    const int len = start[c + 1] - start[c];
    if (len <= BIN_SMALL) continue;   // warp-uniform
    const int want = min(len, cap);
    int* row = table + (size_t)c * cap;
    int got = 0;
    for (int i0 = 0; i0 < n && got < want; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < n && cell[i] == c;
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      const int k = got + __popc(ballot & ((1u << lane) - 1u));
      if (in && k < cap) row[k] = i;
      got += __popc(ballot);
    }
  }
}

// int32 words of cell_bin's arrays (kernels/neighbors.py holds the same
// count).
static long long cell_bin_words(int n, int ncells) {
  return 2 * (long long)n + 2 * (long long)ncells + 1;
}

#define BUILD_WARPS 8
#define BUILD_THREADS (32 * BUILD_WARPS)
#define BUILD_TILE 1024   // stencil slots a block stages (27 x cap <= it)
#define BUILD_SLOTS (BUILD_TILE / BUILD_THREADS)
#define BUILD_SPLIT 32    // atoms of a cell a block takes (blockIdx.y)

// Where a warp reads an atom's candidates: the block's staged neighborhood
// (STAGED) or the table and positions in memory.
template <typename T>
struct Neighborhood {
  const int* cells;   // the stencil's cells, in the reference's order
  int ncell;
  const int* j;       // STAGED: candidates and their positions
  const T *x, *y, *z;
  int count;
};

// The list of atom i (the whole warp): every candidate of the
// neighborhood within rb2, packed to the front in candidate order.
template <typename T, bool STAGED>
__device__ __forceinline__ void build_row(
    int i, const T* __restrict__ pos, const int* __restrict__ table,
    const Neighborhood<T>& hood, const ImageAxis<T> (&ax)[3], int* nbr_idx,
    bool* mask, T* shifts, T* pos_ref, int* flags, int n, int cap, int K,
    T rb2) {
  const int lane = threadIdx.x & 31;
  const T px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  int* row_idx = nbr_idx + (size_t)i * K;
  bool* row_mask = mask + (size_t)i * K;
  T* row_shift = shifts + (size_t)i * K * 3;
  int count = 0;
  for (int c = 0; c < (STAGED ? 1 : hood.ncell); ++c) {
    const int* slots = table + (size_t)(STAGED ? 0 : hood.cells[c]) * cap;
    const int len = STAGED ? hood.count : cap;
    for (int s0 = 0; s0 < len; s0 += 32) {
      const int s = s0 + lane;
      const int j = s >= len ? n : STAGED ? hood.j[s] : slots[s];
      const bool test = j < n && j != i;
      T dx = T(0), dy = T(0), dz = T(0);
      if (test) {
        dx = rn_sub(STAGED ? hood.x[s] : pos[3 * j], px);
        dy = rn_sub(STAGED ? hood.y[s] : pos[3 * j + 1], py);
        dz = rn_sub(STAGED ? hood.z[s] : pos[3 * j + 2], pz);
      }
      // the shift -box * rint(d / box): the negated product, bit for bit
      bool sx, sy, sz;
      T hx = -image_fast(dx, ax[0], sx), hy = -image_fast(dy, ax[1], sy),
        hz = -image_fast(dz, ax[2], sz);
      if (__any_sync(0xffffffffu, sx || sy || sz)) {
        if (sx) hx = -image_slow(dx, ax[0]);
        if (sy) hy = -image_slow(dy, ax[1]);
        if (sz) hz = -image_slow(dz, ax[2]);
      }
      const T ex = rn_add(dx, hx), ey = rn_add(dy, hy), ez = rn_add(dz, hz);
      const T r2 = rn_add(rn_add(rn_mul(ex, ex), rn_mul(ey, ey)),
                          rn_mul(ez, ez));
      const bool valid = test && r2 < rb2;
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

// The block's share of the cell's atoms: members first .. first +
// BUILD_SPLIT - 1 (of the staged list's head, which is the cell's own row,
// or of the table row itself), a warp an atom; then, in the first share of
// a full row, the atoms it dropped: each warp bins 32 atoms above the
// row's largest index at a time and builds the rows of those in the cell.
template <typename T, bool STAGED>
__device__ __forceinline__ void build_cell(
    int cell, int members, int last, const T* __restrict__ pos,
    const int* __restrict__ table, const Neighborhood<T>& hood,
    const ImageAxis<T> (&ax)[3], int* nbr_idx, bool* mask, T* shifts,
    T* pos_ref, int* flags, int n, int nx, int ny, int nz, int cap, int K,
    T rb2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = table + (size_t)cell * cap;
  const int first = blockIdx.y * BUILD_SPLIT;
  const int end = min(first + BUILD_SPLIT, STAGED ? members : cap);
  for (int k = first + warp; k < end; k += BUILD_WARPS) {
    const int i = STAGED ? hood.j[k] : row[k];   // warp-uniform
    if (i < n)
      build_row<T, STAGED>(i, pos, table, hood, ax, nbr_idx, mask, shifts,
                           pos_ref, flags, n, cap, K, rb2);
  }
  if (members < cap || blockIdx.y != 0) return;
  for (int i0 = last + 1 + warp * 32; i0 < n; i0 += BUILD_THREADS) {
    const int i = i0 + lane;
    bool in = false;
    if (i < n) {
      const int b0 = bin_of(pos[3 * i], ax[0].box, nx);
      const int b1 = bin_of(pos[3 * i + 1], ax[1].box, ny);
      const int b2 = bin_of(pos[3 * i + 2], ax[2].box, nz);
      in = (b0 * ny + b1) * nz + b2 == cell;
    }
    for (unsigned found = __ballot_sync(0xffffffffu, in); found;
         found &= found - 1)
      build_row<T, STAGED>(i0 + __ffs(found) - 1, pos, table, hood, ax,
                           nbr_idx, mask, shifts, pos_ref, flags, n, cap, K,
                           rb2);
  }
}

template <typename T>
__global__ void __launch_bounds__(BUILD_THREADS) cell_build_kernel(
    const T* __restrict__ pos, const T* __restrict__ box,
    const int* __restrict__ trigger, const int* __restrict__ table,
    int* __restrict__ nbr_idx, bool* __restrict__ mask,
    T* __restrict__ shifts, T* __restrict__ pos_ref, int* flags, int n,
    int nx, int ny, int nz, int cap, int K, T rb2) {
  if (*trigger == 0) return;
  __shared__ int s_cells[27], s_warp[BUILD_WARPS], s_members, s_last;
  // the staged neighborhood (dynamic: none when it is walked from memory)
  extern __shared__ __align__(16) unsigned char snap_smem[];
  T* s_x = reinterpret_cast<T*>(snap_smem);
  T* s_y = s_x + BUILD_TILE;
  T* s_z = s_y + BUILD_TILE;
  int* s_j = reinterpret_cast<int*>(s_z + BUILD_TILE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cell = blockIdx.x;
  const int cx = axis_count(nx), cy = axis_count(ny), cz = axis_count(nz);
  const int ncell = cx * cy * cz, slots = ncell * cap;
  if (tid < ncell) {   // the stencil in the reference's order
    const int a = tid / (cy * cz), b = (tid / cz) % cy, c = tid % cz;
    const int c0 = cell / (ny * nz), c1 = (cell / nz) % ny, c2 = cell % nz;
    s_cells[tid] = (((c0 + axis_offset(nx, a)) % nx) * ny +
                    (c1 + axis_offset(ny, b)) % ny) * nz +
                   (c2 + axis_offset(nz, c)) % nz;
  }
  if (tid == 0) {
    s_members = 0;
    s_last = -1;
  }
  __syncthreads();
  const ImageAxis<T> ax[3] = {image_axis(box[0]), image_axis(box[1]),
                              image_axis(box[2])};
  Neighborhood<T> hood{s_cells, ncell, s_j, s_x, s_y, s_z, 0};
  if (slots > BUILD_TILE) {   // walked from memory
    for (int k = tid; k < cap; k += BUILD_THREADS) {
      const int j = table[(size_t)cell * cap + k];
      if (j < n) {
        atomicAdd(&s_members, 1);
        atomicMax(&s_last, j);
      }
    }
    __syncthreads();
    if (s_members > 0)
      build_cell<T, false>(cell, s_members, s_last, pos, table, hood, ax,
                           nbr_idx, mask, shifts, pos_ref, flags, n, nx, ny,
                           nz, cap, K, rb2);
    return;
  }
  // stage the neighborhood: thread tid reads slots tid * BUILD_SLOTS ..
  // + BUILD_SLOTS - 1, and a block-wide exclusive sum of its kept slots
  // gives where they go, so the staged order is the slot order and the
  // cell's own members (stencil cell 0) come first
  int j[BUILD_SLOTS], kept = 0, mine = 0, last = -1;
#pragma unroll
  for (int q = 0; q < BUILD_SLOTS; ++q) {
    const int r = tid * BUILD_SLOTS + q;
    j[q] = r < slots ? table[(size_t)s_cells[r / cap] * cap + r % cap] : n;
    kept += j[q] < n;
    if (r < cap && j[q] < n) {
      ++mine;
      last = max(last, j[q]);
    }
  }
  if (mine > 0) {
    atomicAdd(&s_members, mine);
    atomicMax(&s_last, last);
  }
  int scan = kept;   // inclusive within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += v;
  }
  if (lane == 31) s_warp[warp] = scan;
  __syncthreads();
  const int members = s_members;
  if (members <= (int)blockIdx.y * BUILD_SPLIT) return;   // no share here
  int at = scan - kept;
  for (int w = 0; w < BUILD_WARPS; ++w) {
    at += w < warp ? s_warp[w] : 0;
    hood.count += s_warp[w];
  }
#pragma unroll
  for (int q = 0; q < BUILD_SLOTS; ++q) {
    if (j[q] < n) {
      s_j[at] = j[q];
      s_x[at] = pos[3 * j[q]];
      s_y[at] = pos[3 * j[q] + 1];
      s_z[at] = pos[3 * j[q] + 2];
      ++at;
    }
  }
  __syncthreads();
  build_cell<T, true>(cell, members, s_last, pos, table, hood, ax, nbr_idx,
                      mask, shifts, pos_ref, flags, n, nx, ny, nz, cap, K,
                      rb2);
}

template <typename T>
static int launch_bin(const void* pos, const void* box, const void* trigger,
                      void* table, void* flags, void* scratch, int n, int nx,
                      int ny, int nz, int cap, int device, void* stream) {
  if (n < 0 || nx < 1 || ny < 1 || nz < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      scratch != nullptr ? 0 : cell_bin_words(n, nx * ny * nz) * 4;
  if (smem > BIN_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(pos);
  const T* b = static_cast<const T*>(box);
  const int* trig = static_cast<const int*>(trigger);
  int* tab = static_cast<int*>(table);
  int* fl = static_cast<int*>(flags);
  if (scratch != nullptr) {
    cell_bin_kernel<T, false><<<1, BIN_THREADS, 0, s>>>(
        p, b, trig, tab, fl, static_cast<int*>(scratch), n, nx, ny, nz, cap);
    return static_cast<int>(cudaGetLastError());
  }
  // the grant leaves room for the kernel's static shared memory
  static bool granted[SNAP_DEVICES] = {};  // per kernel instance, device
  if (device >= SNAP_DEVICES || !granted[device]) {
    err = cudaFuncSetAttribute(cell_bin_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BIN_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < SNAP_DEVICES) granted[device] = true;
  }
  cell_bin_kernel<T, true><<<1, BIN_THREADS, smem, s>>>(
      p, b, trig, tab, fl, nullptr, n, nx, ny, nz, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_build(const void* pos, const void* box,
                        const void* trigger, const void* table,
                        void* nbr_idx, void* mask, void* shifts,
                        void* pos_ref, void* flags, int n, int nx, int ny,
                        int nz, int cap, int K, double rb2, int device,
                        void* stream) {
  if (n < 0 || nx < 1 || ny < 1 || nz < 1 || cap < 1 || K < 1 ||
      (cap + BUILD_SPLIT - 1) / BUILD_SPLIT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const dim3 grid(nx * ny * nz, (cap + BUILD_SPLIT - 1) / BUILD_SPLIT);
  const bool staged = (nx < 3 ? nx : 3) * (ny < 3 ? ny : 3) *
                          (nz < 3 ? nz : 3) * cap <= BUILD_TILE;
  const size_t smem = staged ? BUILD_TILE * (3 * sizeof(T) + sizeof(int))
                             : 0;
  cell_build_kernel<T><<<grid, BUILD_THREADS, smem,
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
                                void* flags, void* scratch, int n, int nx,   \
                                int ny, int nz, int cap, int device,         \
                                void* stream) {                              \
    return launch_bin<T>(pos, box, trigger, table, flags, scratch, n, nx,    \
                         ny, nz, cap, device, stream);                       \
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
