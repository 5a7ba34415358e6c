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
// zeroed by the caller; slot 1 stays 0).
//
// One warp per atom i of a lane (blockIdx.y is the lane): the warp walks
// the lane's valid atoms j < n_valid 32 at a time, and a ballot and a
// prefix __popc pack the pairs within rcut to the front of the row in
// increasing j, the order of the plain version's stable argsort.  Slots
// from min(count, K) up to K get index 0, mask false and displacement
// +0.0; lane 0 raises the flag with an integer atomicMax, whose result does
// not depend on order.  Atoms at or past n_valid get empty rows, so a lane
// with n_valid = 0 writes empty rows and leaves its flag 0.
//
// The arithmetic is the plain version's, step by step (rn_math.cuh):
// d = pos[j] - pos[i], dd = d - box * rint(d / box), r2 = (dx^2 + dy^2) +
// dz^2, a pair when r2 < rc2.  rc2 is rcut * rcut in double, rounded to T
// on the host as PyTorch rounds the Python scalar it compares an f32
// tensor with; a NaN coordinate fails the test and gives no pair.
//
// Bound on the H100: operations.  At the n2048 bucket (4 x 2000 atoms in
// lanes of 2048) the warps test 16.0 M pairs, 20 operations each, 0.0094
// ms at 34 TFLOP/s in f64, against 7.8 MB of lists (0.0023 ms at 3.35
// TB/s).  An f64 division is a sequence of about ten dependent f64
// instructions on the card, so the three divisions of a pair set the time;
// nothing here is tuned (no staging of positions in shared memory, no
// path that skips the division where rint(d / box) is 0).

#include "rn_math.cuh"
#include "snap_common.cuh"

template <typename T>
__global__ void brute_build_kernel(const T* __restrict__ pos,
                                   const T* __restrict__ box,
                                   const int* __restrict__ n_valid,
                                   int* __restrict__ nbr_idx,
                                   bool* __restrict__ mask,
                                   T* __restrict__ disp, int* flags, int n,
                                   int K, T rc2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;   // the whole warp shares i
  const int nv = min(max(n_valid[b], 0), n);
  const T* p = pos + (size_t)b * n * 3;
  const size_t row = (size_t)b * n + i;
  int* row_idx = nbr_idx + row * K;
  bool* row_mask = mask + row * K;
  T* row_disp = disp + row * K * 3;
  int count = 0;
  if (i < nv) {
    const T bx = box[3 * b], by = box[3 * b + 1], bz = box[3 * b + 2];
    const T px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
    for (int j0 = 0; j0 < nv; j0 += 32) {
      const int j = j0 + lane;
      bool valid = false;
      T ex = T(0), ey = T(0), ez = T(0);
      if (j < nv && j != i) {
        const T dx = rn_sub(p[3 * j], px);
        const T dy = rn_sub(p[3 * j + 1], py);
        const T dz = rn_sub(p[3 * j + 2], pz);
        ex = rn_sub(dx, rn_mul(bx, rint(rn_div(dx, bx))));
        ey = rn_sub(dy, rn_mul(by, rint(rn_div(dy, by))));
        ez = rn_sub(dz, rn_mul(bz, rint(rn_div(dz, bz))));
        const T r2 = rn_add(rn_add(rn_mul(ex, ex), rn_mul(ey, ey)),
                            rn_mul(ez, ez));
        valid = r2 < rc2;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int k = count + __popc(ballot & ((1u << lane) - 1u));
        if (k < K) {
          row_idx[k] = j;
          row_mask[k] = true;
          row_disp[3 * k] = ex;
          row_disp[3 * k + 1] = ey;
          row_disp[3 * k + 2] = ez;
        }
      }
      count += __popc(ballot);
    }
  }
  for (int k = min(count, K) + lane; k < K; k += 32) {
    row_idx[k] = 0;
    row_mask[k] = false;
    row_disp[3 * k] = T(0);
    row_disp[3 * k + 1] = T(0);
    row_disp[3 * k + 2] = T(0);
  }
  if (lane == 0 && count > 0) atomicMax(flags + 2 * b, count);
}

static const int BRUTE_THREADS = 256;   // 8 atoms a block

template <typename T>
static int launch_brute(const void* pos, const void* box,
                        const void* n_valid, void* nbr_idx, void* mask,
                        void* disp, void* flags, int B, int n, int K,
                        double rc2, int device, void* stream) {
  if (B < 0 || B > 65535 || n < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || n == 0) return 0;
  const int per_block = BRUTE_THREADS / 32;
  const dim3 grid((n + per_block - 1) / per_block, B);
  brute_build_kernel<T><<<grid, BRUTE_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
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
