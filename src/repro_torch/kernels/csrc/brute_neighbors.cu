// The serving path's O(N^2) neighbor build, all lanes of a batch in one
// launch.
//
// Replaces the reference's jnp build (repro/md/cell_list.py:204
// brute_neighbors_device under jax.vmap, repro/kernels/ops.py:244; no
// Pallas kernel).  Every batched step of the force service runs it: B
// configurations of up to N atoms, pos [B, N, 3], box [B, 3] and n_valid
// [B] int32, all read on the card.  It writes the padded lists nbr_idx
// [B, N, K] int32, mask [B, N, K] bool and disp [B, N, K, 3] (the
// minimum-imaged displacement pos[j] - pos[i]), and raises flags[b, 0] to
// the lane's largest neighbor count, counted past K (flags [B, 2] int32,
// zeroed by the launcher on the stream; slot 1 stays 0).
//
// A block owns BRUTE_WARPS x ATOMS atoms i of one lane (blockIdx.y), two
// to a warp (one where that would leave SMs with less than two blocks: the
// n128 bucket), and walks the lane's valid atoms j < n_valid in tiles of
// BRUTE_TILE positions staged in shared memory with cp.async, double
// buffered: the next tile is in flight while the warps test the current
// one, and each position is read from memory once a block instead of once
// a warp.  A warp tests 32 candidates j against each of its atoms; a
// ballot and a prefix __popc pack the pairs within rcut to the front of the
// row in increasing j, the order of the plain version's stable argsort.
// Slots from min(count, K) up to K get index 0, mask false and
// displacement +0.0; lane 0 raises the flag with an integer atomicMax,
// whose result does not depend on order.  Atoms at or past n_valid get
// empty rows, so a lane with n_valid = 0 writes empty rows and leaves its
// flag 0.
//
// The arithmetic is the plain version's, step by step (rn_math.cuh):
// d = pos[j] - pos[i], dd = d - box * rint(d / box), r2 = (dx^2 + dy^2) +
// dz^2, a pair when r2 < rc2.  The product box * rint(d / box) comes from
// image_fast, which skips the division wherever rint's value is certain
// (all but pairs within 2^-40 of half a box, or past 1.5 boxes) and gives
// the division's bits, the sign of a zero included; a warp divides
// (image_slow) only where a vote finds a lane that needs it.  fl(dx^2) <=
// r2, so a warp none of whose candidates has fl(dx^2) < rc2 skips y and z;
// atoms in lattice order (consecutive atoms on one plane) skip most.  rc2
// is rcut * rcut in double, rounded to T on the host as PyTorch rounds the
// Python scalar it compares an f32 tensor with; a NaN coordinate fails the
// test and gives no pair.
//
// Bound on the H100: operations.  At the n2048 bucket (4 x 2000 atoms in
// lanes of 2048) the plain version's arithmetic is 16.0 M pairs, 20
// operations each, 0.0094 ms at 34 TFLOP/s in f64, against 7.8 MB of
// lists (0.0023 ms at 3.35 TB/s).  The first form (one warp an atom,
// candidates read from memory, three f64 divisions a pair) took 0.085 ms,
// the divisions (about ten dependent f64 instructions each) setting its
// time; this one takes about 0.05 ms in f64 and in f32, bound by
// instruction issue (about 90 instructions a warp to test 64 pairs), not
// by the f64 units.

#include "rn_math.cuh"
#include "snap_common.cuh"

#define BRUTE_WARPS 8
#define BRUTE_TILE 256     // positions j a stage
#define BRUTE_THREADS (32 * BRUTE_WARPS)

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Stage positions j0 .. j0 + BRUTE_TILE - 1 (those below nv) of lane
// positions p as three planes: consecutive threads read consecutive
// addresses.  One commit group a stage.
template <typename T>
__device__ __forceinline__ void stage(T (*tile)[BRUTE_TILE], const T* p,
                                      int j0, int nv) {
  const int rows = min(BRUTE_TILE, nv - j0);
  for (int e = threadIdx.x; e < 3 * rows; e += BRUTE_THREADS)
    copy_async(&tile[e % 3][e / 3], p + 3 * (size_t)j0 + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int ATOMS>
__global__ void __launch_bounds__(BRUTE_THREADS)
    brute_build_kernel(const T* __restrict__ pos, const T* __restrict__ box,
                       const int* __restrict__ n_valid,
                       int* __restrict__ nbr_idx, bool* __restrict__ mask,
                       T* __restrict__ disp, int* flags, int n, int K,
                       T rc2) {
  __shared__ T tile[2][3][BRUTE_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int first = blockIdx.x * (BRUTE_WARPS * ATOMS);
  const int nv = min(max(n_valid[b], 0), n);
  const T* p = pos + (size_t)b * n * 3;
  const ImageAxis<T> ax = image_axis(box[3 * b]),
                     ay = image_axis(box[3 * b + 1]),
                     az = image_axis(box[3 * b + 2]);
  int i[ATOMS], count[ATOMS];
  T px[ATOMS], py[ATOMS], pz[ATOMS];
  bool any_live = false;
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    i[a] = first + warp * ATOMS + a;
    count[a] = 0;
    px[a] = py[a] = pz[a] = T(0);
    if (i[a] < nv) {
      px[a] = p[3 * i[a]];
      py[a] = p[3 * i[a] + 1];
      pz[a] = p[3 * i[a] + 2];
      any_live = true;
    }
  }
  if (first < nv) {   // block-uniform: the tile loop and its barriers
    const size_t row0 = (size_t)b * n;
    const int tiles = (nv + BRUTE_TILE - 1) / BRUTE_TILE;
    stage(tile[0], p, 0, nv);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        stage(tile[(t + 1) & 1], p, (t + 1) * BRUTE_TILE, nv);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();
      const T(*s)[BRUTE_TILE] = tile[t & 1];
      const int j0 = t * BRUTE_TILE, rows = min(BRUTE_TILE, nv - j0);
      for (int c0 = 0; any_live && c0 < rows; c0 += 32) {
        // jj < BRUTE_TILE (c0 and the tile are multiples of 32): a lane
        // past rows reads a stale slot, which `test` keeps out
        const int jj = c0 + lane, j = j0 + jj;
        const bool in = jj < rows;
        const T qx = s[0][jj], qy = s[1][jj], qz = s[2][jj];
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          const bool test = in && i[a] < nv && j != i[a];
          const T dx = rn_sub(qx, px[a]);
          bool slow;
          T ix = image_fast(dx, ax, slow);
          slow = slow && test;
          if (__any_sync(0xffffffffu, slow) && slow) ix = image_slow(dx, ax);
          const T ex = rn_sub(dx, ix), xx = rn_mul(ex, ex);
          bool valid = test && xx < rc2;
          if (__any_sync(0xffffffffu, valid)) {
            const T dy = valid ? rn_sub(qy, py[a]) : T(0),
                    dz = valid ? rn_sub(qz, pz[a]) : T(0);
            bool sy, sz;
            T iy = image_fast(dy, ay, sy), iz = image_fast(dz, az, sz);
            if (__any_sync(0xffffffffu, sy || sz)) {
              if (sy) iy = image_slow(dy, ay);
              if (sz) iz = image_slow(dz, az);
            }
            const T ey = rn_sub(dy, iy), ez = rn_sub(dz, iz);
            const T r2 = rn_add(rn_add(xx, rn_mul(ey, ey)), rn_mul(ez, ez));
            valid = valid && r2 < rc2;
            const unsigned ballot = __ballot_sync(0xffffffffu, valid);
            if (valid) {
              const int k = count[a] + __popc(ballot & ((1u << lane) - 1u));
              if (k < K) {
                const size_t slot = (row0 + i[a]) * K + k;
                nbr_idx[slot] = j;
                mask[slot] = true;
                disp[3 * slot] = ex;
                disp[3 * slot + 1] = ey;
                disp[3 * slot + 2] = ez;
              }
            }
            count[a] += __popc(ballot);
          }
        }
      }
      __syncthreads();   // the next stage overwrites this buffer
    }
  }
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    if (i[a] >= n) continue;   // warp-uniform
    const size_t row = ((size_t)b * n + i[a]) * K;
    for (int k = min(count[a], K) + lane; k < K; k += 32) {
      nbr_idx[row + k] = 0;
      mask[row + k] = false;
      disp[3 * (row + k)] = T(0);
      disp[3 * (row + k) + 1] = T(0);
      disp[3 * (row + k) + 2] = T(0);
    }
    if (lane == 0 && count[a] > 0) atomicMax(flags + 2 * b, count[a]);
  }
}

template <typename T>
static int launch_brute(const void* pos, const void* box,
                        const void* n_valid, void* nbr_idx, void* mask,
                        void* disp, void* flags, int B, int n, int K,
                        double rc2, int device, void* stream) {
  if (B < 0 || B > 65535 || n < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(flags, 0, sizeof(int) * 2 * (size_t)B, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  // two atoms a warp (each staged position read once for both) where the
  // grid still gives every SM two blocks, else one (small buckets)
  static int sms[SNAP_DEVICES];
  if (device < SNAP_DEVICES && sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sm = device < SNAP_DEVICES ? sms[device] : 132;
  const int pairs = (n + 2 * BRUTE_WARPS - 1) / (2 * BRUTE_WARPS);
  const bool two = (long long)pairs * B >= 2LL * sm;
  const int per_block = (two ? 2 : 1) * BRUTE_WARPS;
  const dim3 grid((n + per_block - 1) / per_block, B);
  const auto kernel =
      two ? brute_build_kernel<T, 2> : brute_build_kernel<T, 1>;
  kernel<<<grid, BRUTE_THREADS, 0, s>>>(
      static_cast<const T*>(pos), static_cast<const T*>(box),
      static_cast<const int*>(n_valid), static_cast<int*>(nbr_idx),
      static_cast<bool*>(mask), static_cast<T*>(disp),
      static_cast<int*>(flags), n, K, static_cast<T>(rc2));
  return static_cast<int>(cudaGetLastError());
}

#define BRUTE_BUILD(SFX, T)                                                  \
  extern "C" int brute_build_##SFX(                                          \
      const void* pos, const void* box, const void* n_valid, void* nbr_idx,  \
      void* mask, void* disp, void* flags, int B, int n, int K, double rc2,  \
      int device, void* stream) {                                            \
    return launch_brute<T>(pos, box, n_valid, nbr_idx, mask, disp, flags,   \
                           B, n, K, rc2, device, stream);                    \
  }

BRUTE_BUILD(f32, float)
BRUTE_BUILD(f64, double)
