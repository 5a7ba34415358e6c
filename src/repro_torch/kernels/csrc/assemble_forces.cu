// Force assembly by destination (Newton's third law):
//     F_i = [offset <= i < offset + n_local] sum_k (m d)[i - offset, k]
//           - sum_{(j, k): nbr[j, k] = i, m[j, k]} d[j, k],
// with d the per-pair dE/dr [n_local, nnbor, 3] of the atoms offset ..
// offset + n_local - 1, m its mask and F [n_out, 3].  Unsharded, offset is
// 0 and n_local = n_out = natoms.  Atom-sharded, d holds one rank's rows,
// the neighbor index is global, and F is the rank's full-length partial:
// its own rows at the rank's offset, its Newton reactions on any row; a
// reduce-scatter over the ranks then sums the partials (the reference's
// psum_scatter in repro/core/snap.py:assemble_forces(axis_name=...)).
//
// Replaces the scatter of repro/core/snap.py:assemble_forces (jnp, no
// Pallas kernel).  index_add_ on a CUDA tensor accumulates with float
// atomics, so forces would differ in the last bits from run to run; here
// every sum has a fixed order.  Two parts, both launched on the caller's
// stream with no host sync:
//
// - destination_csr: the flat neighbor index sorted by destination, stable
//   (within a destination's segment, pairs in ascending flat index), and
//   the CSR row pointers over n_out rows; pairs that are masked, or name no
//   row in 0 .. n_out - 1, sort past rowptr[n_out] in ascending order.  A
//   counting sort in three kernels behind one memset of the counters, each
//   over the whole card: csr_count_kernel counts each destination with
//   integer atomics (their result does not depend on order) and each
//   tile's left-out pairs, and the last block to finish (a ticket after a
//   fence) scans the counts into the row pointers and the tiles' left-out
//   counts into their offsets; csr_place_kernel puts each pair in its
//   segment at an atomic cursor (an order that varies) and each left-out
//   pair at its tile offset plus its rank among the tile's (ballots, in
//   pair order: an order that does not); csr_sort_kernel gives each
//   segment a warp that sorts it by pair index (a bitonic sort across the
//   warp up to 32 pairs, ranks by shuffles up to 64), so the output is one
//   fixed permutation.  A segment longer than CSR_SORT_CAP (a destination
//   named by many rows) is left out by the place kernel and filled by its
//   warp, which walks every pair in order.  Tiles read their pairs q-major
//   (a warp's loads consecutive), and a tile's counts meet in a shared-
//   memory window of rows first (the rows a tile names lie close together
//   in a list built from positions), so a row's global counter and cursor
//   take one atomic a tile, not one a pair.  What bounds it is the chain
//   of dependent steps, each a round trip (the count's atomics, the
//   ticket, the last block's scan; the placement's cursors; the segments'
//   loads) and the gaps between the three kernels; one thread-block
//   cluster doing all of it through distributed shared memory (one launch,
//   no global atomic) was no faster at snap-2j8 and slower at the
//   serving batch's 262,144 pairs, bound by 8 SMs' loads and scattered
//   stores.  It replaces torch.sort (four cub radix-sort kernels) +
//   searchsorted and the sentinel where, int32 cast and arange around
//   them.
// - assemble_forces_kernel: a block takes ASM_ROWS output rows and gives
//   each ASM_GROUPS threads (a thread: row t % ASM_ROWS, group t /
//   ASM_ROWS).  Group g sums the row's own slots g, g + ASM_GROUPS, ...
//   and its incoming segment's entries g, g + ASM_GROUPS, ... in order,
//   each term d * m (the mask as a multiply, as the plain version does, so a
//   non-finite dE/dr in a masked slot gives what it gives there); the
//   groups' partial sums then meet in a fixed tree in shared memory, and F
//   is own - incoming.  Every sum's order depends on nnbor and the segment
//   length alone, never on the row, n_out, the offset or the grid: two
//   evaluations give the same bits, and a serving lane gives a solo
//   request's.  d is read where the fused dE kernel left it, through
//   strides (the [nnbor, 4, natoms_pad] planes viewed as [n_local, nnbor,
//   3]: strides (1, 4 natoms_pad, natoms_pad)), so the ASM_ROWS threads of
//   a group read consecutive atoms; a contiguous [n_local, nnbor, 3] input
//   goes through the same kernel with its own strides.
//
// Bound on the H100: bytes.  The assembly reads d and the mask once for
// the own rows, the sorted order and d again for the incoming ones
// (scattered, from L2: d is 1.2 MB at snap-2j8), and writes F; the CSR
// reads the index and the mask twice and writes the order and row
// pointers.  What holds both back is latency: dependent steps (counts,
// sums, placement, a sort; row bounds, order, d) of well under a
// microsecond of traffic each.

#include <climits>

#include "snap_common.cuh"

#define CSR_THREADS 1024
#define CSR_WARPS (CSR_THREADS / 32)
#define CSR_ITEMS 2           // pairs a thread: base + q * CSR_THREADS + tid
#define CSR_TILE (CSR_THREADS * CSR_ITEMS)   // pairs a block (count, place)
#define CSR_SCAN_ITEMS 4      // counts a thread sums in the last block's scan
#define CSR_WINDOW 4096      // rows a block counts in shared memory first
#define CSR_SORT_THREADS 256
#define CSR_SORT_CAP 64       // longest segment a warp sorts (2 pairs a lane)
#define ASM_ROWS 16
#define ASM_GROUPS 16
#define ASM_THREADS (ASM_ROWS * ASM_GROUPS)
#define ASM_BATCH 4      // slots (or segment entries) a thread loads at once

// The row pair p goes to: nbr[p] when it is kept and names a row, else
// n_out (left out).
template <typename Idx>
__device__ __forceinline__ int key_of(const Idx* __restrict__ nbr,
                                      const bool* __restrict__ mask,
                                      long long p, int n_out) {
  const long long j = static_cast<long long>(nbr[p]);
  const bool kept = mask[p];
  return kept && j >= 0 && j < n_out ? static_cast<int>(j) : n_out;
}

// The keys of the thread's pairs of tile blockIdx.x (q-major, so a warp's
// loads are consecutive); -1 past the last pair.  Every load is issued
// before any is used.
template <typename Idx>
__device__ __forceinline__ void tile_keys(const Idx* __restrict__ nbr,
                                          const bool* __restrict__ mask,
                                          int P, int n_out,
                                          int (&key)[CSR_ITEMS]) {
  const long long base = (long long)blockIdx.x * CSR_TILE + threadIdx.x;
  long long j[CSR_ITEMS];
  bool kept[CSR_ITEMS];
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q) {
    const long long p = base + q * CSR_THREADS;
    j[q] = p < P ? static_cast<long long>(nbr[p]) : -1;
    kept[q] = p < P && mask[p];
  }
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q)
    key[q] = base + q * CSR_THREADS >= P ? -1
             : kept[q] && j[q] >= 0 && j[q] < n_out ? static_cast<int>(j[q])
                                                    : n_out;
}

// The block's window of rows [wb, wb + CSR_WINDOW) from its least kept
// key: the rows a tile names lie close together in a list built from
// positions, so its counts are summed in shared memory first and reach
// the global counters once a row, not once a pair.
__device__ __forceinline__ int window_base(const int (&key)[CSR_ITEMS],
                                           int n_out) {
  __shared__ int s_min;
  int m = INT_MAX;
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q)
    if (key[q] >= 0 && key[q] < n_out) m = min(m, key[q]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (threadIdx.x == 0) s_min = INT_MAX;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMin(&s_min, m);
  __syncthreads();
  return s_min;
}

// Exclusive sum of v over the block's threads in thread order (blockDim.x
// == CSR_THREADS); *total gets the block's sum.  Ends in a barrier, so it
// may be called again at once.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int s_warp[CSR_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < CSR_WARPS; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

#define CSR_CHUNK (CSR_THREADS * CSR_SCAN_ITEMS)
static_assert(CSR_CHUNK <= CSR_WINDOW, "the scan stages a chunk in s_hist");

// One CSR_CHUNK of an exclusive scan through shared memory (buf), so that
// every global load and store is coalesced: dst[c0 + i] = base + the sum
// of src[c0 ..] before i, for c0 + i < n; src zeroed behind when zero is
// set.  src is read from L2 (other blocks' atomics and stores).  Returns
// base + the chunk's sum.
template <typename Out>
__device__ int scan_chunk(int* src, Out* dst, int c0, int n, int base,
                          bool zero, int* buf) {
#pragma unroll
  for (int q = 0; q < CSR_SCAN_ITEMS; ++q) {
    const int i = q * CSR_THREADS + threadIdx.x;
    buf[i] = c0 + i < n ? __ldcg(src + c0 + i) : 0;
  }
  __syncthreads();
  int v[CSR_SCAN_ITEMS], s = 0;
#pragma unroll
  for (int q = 0; q < CSR_SCAN_ITEMS; ++q) {
    v[q] = buf[threadIdx.x * CSR_SCAN_ITEMS + q];
    s += v[q];
  }
  int chunk;
  int run = base + block_exclusive_sum(s, &chunk);   // ends in a barrier
#pragma unroll
  for (int q = 0; q < CSR_SCAN_ITEMS; ++q) {
    buf[threadIdx.x * CSR_SCAN_ITEMS + q] = run;
    run += v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CSR_SCAN_ITEMS; ++q) {
    const int i = q * CSR_THREADS + threadIdx.x;
    if (c0 + i < n) {
      dst[c0 + i] = static_cast<Out>(buf[i]);
      if (zero) src[c0 + i] = 0;
    }
  }
  __syncthreads();
  return base + chunk;
}

template <typename Idx>
__global__ void __launch_bounds__(CSR_THREADS) csr_count_kernel(
    const Idx* __restrict__ nbr, const bool* __restrict__ mask, int P,
    int n_out, int* count, unsigned* done, int* tile_tail, int* tile_off,
    long long* __restrict__ rowptr) {
  __shared__ bool s_last;
  __shared__ int s_hist[CSR_WINDOW];
  int key[CSR_ITEMS], tail = 0;
  tile_keys(nbr, mask, P, n_out, key);
  for (int w = threadIdx.x; w < CSR_WINDOW; w += CSR_THREADS) s_hist[w] = 0;
  const int wb = window_base(key, n_out);   // ends in a barrier
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q) {
    if (key[q] >= 0 && key[q] < n_out) {
      if (key[q] - wb < CSR_WINDOW)
        atomicAdd(s_hist + (key[q] - wb), 1);
      else
        atomicAdd(count + key[q], 1);
    }
    tail += key[q] == n_out;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < CSR_WINDOW; w += CSR_THREADS)
    if (s_hist[w] > 0) atomicAdd(count + wb + w, s_hist[w]);
  int tails;
  block_exclusive_sum(tail, &tails);
  if (threadIdx.x == 0) tile_tail[blockIdx.x] = tails;
  // the last block to finish sees every count: it makes the row pointers
  // (and zeroes the counts, the place kernel's cursors) and the tiles'
  // offsets of the left-out pairs.  The barrier, then thread 0's fence
  // before its ticket, publish the block's atomics and stores (a fence is
  // cumulative over what the barrier ordered before it); the last block's
  // thread 0 fences again and its barrier orders the block's reads after
  // (a fence in every thread costs microseconds here).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (s_last) __threadfence();   // and acquires the other blocks'
  }
  __syncthreads();
  if (!s_last) return;
  int kept = 0;
  for (int c0 = 0; c0 < n_out; c0 += CSR_CHUNK)   // zeroed: the cursors
    kept = scan_chunk(count, rowptr, c0, n_out, kept, true, s_hist);
  if (threadIdx.x == 0) rowptr[n_out] = kept;
  for (int c0 = 0, run = kept; c0 < (int)gridDim.x; c0 += CSR_CHUNK)
    run = scan_chunk(tile_tail, tile_off, c0, gridDim.x, run, false, s_hist);
}

template <typename Idx>
__global__ void __launch_bounds__(CSR_THREADS) csr_place_kernel(
    const Idx* __restrict__ nbr, const bool* __restrict__ mask, int P,
    int n_out, int* cursor, const int* __restrict__ tile_off,
    const long long* __restrict__ rowptr, long long* __restrict__ order) {
  __shared__ int s_left[CSR_ITEMS][CSR_WARPS];
  __shared__ int s_hist[CSR_WINDOW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int key[CSR_ITEMS];
  tile_keys(nbr, mask, P, n_out, key);
  for (int w = threadIdx.x; w < CSR_WINDOW; w += CSR_THREADS) s_hist[w] = 0;
  const int wb = window_base(key, n_out);   // ends in a barrier
  long long start[CSR_ITEMS], end[CSR_ITEMS];
  unsigned left[CSR_ITEMS];
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q) {
    const bool seg = key[q] >= 0 && key[q] < n_out;
    start[q] = seg ? rowptr[key[q]] : 0;
    end[q] = seg ? rowptr[key[q] + 1] : 0;
    left[q] = __ballot_sync(0xffffffffu, key[q] == n_out);
    if (lane == 0) s_left[q][warp] = __popc(left[q]);
  }
  __syncthreads();
  // the left-out pairs' offsets in pair order, (q, warp) major: warp 0
  // scans the CSR_ITEMS x CSR_WARPS counts (lane w holds warp w's)
  if (warp == 0) {
    int base = tile_off[blockIdx.x];
#pragma unroll
    for (int q = 0; q < CSR_ITEMS; ++q) {
      const int c = s_left[q][lane];
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      s_left[q][lane] = base + x - c;
      base += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  // a segment's slots: a window row's pairs take one global cursor step
  // for the block (their count), then a shared-memory cursor each; a pair
  // outside the window takes a global step of its own
  bool placed[CSR_ITEMS], local[CSR_ITEMS];
  int slot[CSR_ITEMS];
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q) {
    placed[q] = key[q] >= 0 && key[q] < n_out &&
                end[q] - start[q] <= CSR_SORT_CAP;
    local[q] = placed[q] && key[q] - wb < CSR_WINDOW;
    slot[q] = local[q] ? atomicAdd(s_hist + (key[q] - wb), 1)
              : placed[q] ? atomicAdd(cursor + key[q], 1)
                          : -1;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < CSR_WINDOW; w += CSR_THREADS) {
    const int c = s_hist[w];
    if (c > 0) s_hist[w] = atomicAdd(cursor + wb + w, c);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q)
    if (local[q]) slot[q] += s_hist[key[q] - wb];
  const long long base = (long long)blockIdx.x * CSR_TILE + threadIdx.x;
#pragma unroll
  for (int q = 0; q < CSR_ITEMS; ++q) {
    const long long p = base + q * CSR_THREADS;
    if (key[q] == n_out)
      order[s_left[q][warp] + __popc(left[q] & ((1u << lane) - 1u))] = p;
    else if (slot[q] >= 0)
      order[start[q] + slot[q]] = p;
  }
}

// A warp's segment order[start ..] of len (33 .. CSR_SORT_CAP) pair
// indices sorted ascending: each pair's rank is the number of smaller ones
// (shuffled through the warp, two a lane).
__device__ __forceinline__ void rank_sort(long long* order, long long start,
                                          int len, int lane) {
  const int v0 = static_cast<int>(order[start + lane]);
  const int v1 =
      32 + lane < len ? static_cast<int>(order[start + 32 + lane]) : INT_MAX;
  int r0 = 0, r1 = 0;
  for (int t = 0; t < len; ++t) {
    const int u = __shfl_sync(0xffffffffu, t < 32 ? v0 : v1, t & 31);
    r0 += u < v0;
    r1 += u < v1;
  }
  __syncwarp();
  order[start + r0] = v0;
  if (32 + lane < len) order[start + r1] = v1;
}

template <typename Idx>
__global__ void __launch_bounds__(CSR_SORT_THREADS) csr_sort_kernel(
    const Idx* __restrict__ nbr, const bool* __restrict__ mask, int P,
    int n_out, const long long* __restrict__ rowptr,
    long long* __restrict__ order) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (CSR_SORT_THREADS / 32) + (threadIdx.x >> 5);
  if (i >= n_out) return;   // warp-uniform
  const long long start = rowptr[i];
  const int len = static_cast<int>(rowptr[i + 1] - start);
  if (len > CSR_SORT_CAP) {   // walk every pair in order
    long long at = start;
    for (long long p0 = 0; p0 < P; p0 += 32) {
      const long long p = p0 + lane;
      const bool hit = p < P && key_of(nbr, mask, p, n_out) == i;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) order[at + __popc(ballot & ((1u << lane) - 1u))] = p;
      at += __popc(ballot);
    }
  } else if (len > 32) {
    rank_sort(order, start, len, lane);
  } else if (len > 1) {   // a bitonic sort across the warp, a pair a lane
    int v = lane < len ? static_cast<int>(order[start + lane]) : INT_MAX;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int other = __shfl_xor_sync(0xffffffffu, v, j);
        v = ((lane & j) == 0) == ((lane & k) == 0) ? min(v, other)
                                                   : max(v, other);
      }
    }
    if (lane < len) order[start + lane] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(ASM_THREADS) assemble_forces_kernel(
    const T* __restrict__ d, const bool* __restrict__ mask,
    const long long* __restrict__ order, const long long* __restrict__ rowptr,
    T* __restrict__ f, int n_out, int n_local, int offset, int nnbor,
    long long sr, long long sk, long long sc) {
  __shared__ T s_sum[6][ASM_GROUPS][ASM_ROWS];
  const int row = threadIdx.x % ASM_ROWS, g = threadIdx.x / ASM_ROWS;
  const int i = blockIdx.x * ASM_ROWS + row;
  T own[3] = {T(0), T(0), T(0)}, in[3] = {T(0), T(0), T(0)};
  if (i < n_out) {
    // the segment's bounds first: their loads overlap the own row's
    const long long e0 = rowptr[i], e1 = rowptr[i + 1];
    const int r = i - offset;
    if (r >= 0 && r < n_local) {
      const T* dr = d + r * sr;
      const bool* mr = mask + (size_t)r * nnbor;
      // ASM_BATCH slots a step: every load of a step before its adds, the
      // adds in slot order
      for (int k0 = g; k0 < nnbor; k0 += ASM_BATCH * ASM_GROUPS) {
        T v[ASM_BATCH][3], m[ASM_BATCH];
#pragma unroll
        for (int u = 0; u < ASM_BATCH; ++u) {
          const int k = k0 + u * ASM_GROUPS;
          m[u] = k < nnbor && mr[k] ? T(1) : T(0);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[u][c] = k < nnbor ? dr[k * sk + c * sc] : T(0);
        }
#pragma unroll
        for (int u = 0; u < ASM_BATCH; ++u)
          if (k0 + u * ASM_GROUPS < nnbor) {
#pragma unroll
            for (int c = 0; c < 3; ++c) own[c] += v[u][c] * m[u];
          }
      }
    }
    for (long long b0 = e0 + g; b0 < e1; b0 += ASM_BATCH * ASM_GROUPS) {
      int p[ASM_BATCH];
#pragma unroll
      for (int u = 0; u < ASM_BATCH; ++u) {
        const long long e = b0 + u * ASM_GROUPS;
        p[u] = e < e1 ? static_cast<int>(order[e]) : -1;
      }
      T v[ASM_BATCH][3], m[ASM_BATCH];
#pragma unroll
      for (int u = 0; u < ASM_BATCH; ++u) {
        const int j = p[u] < 0 ? 0 : p[u] / nnbor;
        const int k = p[u] < 0 ? 0 : p[u] - j * nnbor;
        m[u] = p[u] >= 0 && mask[p[u]] ? T(1) : T(0);
        const T* dj = d + j * sr + k * sk;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[u][c] = p[u] >= 0 ? dj[c * sc] : T(0);
      }
#pragma unroll
      for (int u = 0; u < ASM_BATCH; ++u)
        if (p[u] >= 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) in[c] += v[u][c] * m[u];
        }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s_sum[c][g][row] = own[c];
    s_sum[3 + c][g][row] = in[c];
  }
  __syncthreads();
#pragma unroll
  for (int h = ASM_GROUPS / 2; h > 0; h >>= 1) {
    if (g < h) {
#pragma unroll
      for (int c = 0; c < 6; ++c) s_sum[c][g][row] += s_sum[c][g + h][row];
    }
    __syncthreads();
  }
  // the block's 3 * ASM_ROWS outputs, consecutive threads on consecutive
  // addresses
  const int t = threadIdx.x, first = blockIdx.x * ASM_ROWS;
  if (t < 3 * ASM_ROWS && first + t / 3 < n_out) {
    const int c = t % 3, rr = t / 3;
    f[(size_t)first * 3 + t] = s_sum[c][0][rr] - s_sum[3 + c][0][rr];
  }
}

// int32 words of destination_csr's scratch: n_out counters, the ticket,
// and each tile's left-out count and offset.  kernels/assemble.py holds the
// same count.
static long long csr_words(int P, int n_out) {
  const long long tiles =
      P == 0 ? 1 : (P + (long long)CSR_TILE - 1) / CSR_TILE;
  return (long long)n_out + 1 + 2 * tiles;
}

template <typename Idx>
static int launch_csr(const void* nbr, const void* mask, void* order,
                      void* rowptr, void* work, long long work_words, int P,
                      int n_out, int device, void* stream) {
  if (P < 0 || n_out < 0 || work_words < csr_words(P, n_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = P == 0 ? 1 : (P + CSR_TILE - 1) / CSR_TILE;
  int* count = static_cast<int*>(work);
  unsigned* done = reinterpret_cast<unsigned*>(count + n_out);
  int* tile_tail = reinterpret_cast<int*>(done + 1);
  int* tile_off = tile_tail + tiles;
  err = cudaMemsetAsync(work, 0, ((size_t)n_out + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Idx* idx = static_cast<const Idx*>(nbr);
  const bool* m = static_cast<const bool*>(mask);
  long long* rp = static_cast<long long*>(rowptr);
  long long* ord = static_cast<long long*>(order);
  csr_count_kernel<Idx><<<tiles, CSR_THREADS, 0, s>>>(
      idx, m, P, n_out, count, done, tile_tail, tile_off, rp);
  csr_place_kernel<Idx><<<tiles, CSR_THREADS, 0, s>>>(
      idx, m, P, n_out, count, tile_off, rp, ord);
  if (n_out > 0)
    csr_sort_kernel<Idx><<<(n_out + CSR_SORT_THREADS / 32 - 1) /
                               (CSR_SORT_THREADS / 32),
                           CSR_SORT_THREADS, 0, s>>>(idx, m, P, n_out, rp,
                                                     ord);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* d, const void* mask, const void* order,
                  const void* rowptr, void* f, int n_out, int n_local,
                  int offset, int nnbor, long long sr, long long sk,
                  long long sc, int device, void* stream) {
  if (n_out < 0 || n_local < 0 || offset < 0 || nnbor < 0 ||
      offset + n_local > n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  assemble_forces_kernel<T><<<(n_out + ASM_ROWS - 1) / ASM_ROWS, ASM_THREADS,
                              0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const bool*>(mask),
      static_cast<const long long*>(order),
      static_cast<const long long*>(rowptr), static_cast<T*>(f), n_out,
      n_local, offset, nnbor, sr, sk, sc);
  return static_cast<int>(cudaGetLastError());
}

#define DESTINATION_CSR(SFX, IDX)                                            \
  extern "C" int destination_csr_##SFX(                                      \
      const void* nbr, const void* mask, void* order, void* rowptr,          \
      void* work, long long work_words, int P, int n_out, int device,        \
      void* stream) {                                                        \
    return launch_csr<IDX>(nbr, mask, order, rowptr, work, work_words, P,    \
                           n_out, device, stream);                           \
  }
#define ASSEMBLE_FORCES(SFX, T)                                              \
  extern "C" int assemble_forces_##SFX(                                      \
      const void* d, const void* mask, const void* order,                    \
      const void* rowptr, void* f, int n_out, int n_local, int offset,       \
      int nnbor, long long sr, long long sk, long long sc, int device,       \
      void* stream) {                                                        \
    return launch<T>(d, mask, order, rowptr, f, n_out, n_local, offset,      \
                     nnbor, sr, sk, sc, device, stream);                     \
  }

DESTINATION_CSR(i32, int)
DESTINATION_CSR(i64, long long)
ASSEMBLE_FORCES(f32, float)
ASSEMBLE_FORCES(f64, double)
