// Force assembly by destination (Newton's third law):
//     F_i = [offset <= i < offset + n_local] sum_k d[i - offset, k]
//           - sum_{(j, k): nbr[j, k] = i} d[j, k],
// with d the masked per-pair dE/dr [n_local, nnbor, 3] of the atoms
// offset .. offset + n_local - 1 and F [n_out, 3].  Unsharded, offset is 0
// and n_local = n_out = natoms.  Atom-sharded, d holds one rank's rows,
// the neighbor index is global, and F is the rank's full-length partial:
// its own rows at the rank's offset, its Newton reactions on any row; a
// reduce-scatter over the ranks then sums the partials (the reference's
// psum_scatter in repro/core/snap.py:assemble_forces(axis_name=...)).
//
// Replaces the scatter of repro/core/snap.py:assemble_forces (jnp, no
// Pallas kernel), which the first port did with index_add_: on a CUDA
// tensor that accumulates with float atomics, so forces differed in the
// last bits from run to run.  Here the flat neighbor index is sorted by
// destination once per call (a stable sort on the card, CSR row pointers
// by binary search over the n_out rows; no host sync), and one thread per
// output row adds its own row, when it has one, then walks its incoming
// segment in sorted order: every sum has a fixed order, so two
// evaluations of the same inputs give the same bits.
//
// Bound on the H100: 3 adds per pair on each side against 24 (f64) or 12
// (f32) bytes of d per pair plus 8 of sort order, so bytes bound it; the
// incoming gathers are scattered, served from L2 (d is 1.2 MB at snap-2j8).

#include "snap_common.cuh"

template <typename T>
__global__ void assemble_forces_kernel(const T* __restrict__ d,
                                       const long long* __restrict__ order,
                                       const long long* __restrict__ rowptr,
                                       T* __restrict__ f, int n_out,
                                       int n_local, int offset, int nnbor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  T fx = T(0), fy = T(0), fz = T(0);
  const int r = i - offset;
  if (r >= 0 && r < n_local) {
    const T* di = d + (size_t)r * nnbor * 3;
    for (int k = 0; k < nnbor; ++k) {
      fx += di[3 * k];
      fy += di[3 * k + 1];
      fz += di[3 * k + 2];
    }
  }
  const long long end = rowptr[i + 1];
  for (long long e = rowptr[i]; e < end; ++e) {
    const T* dj = d + (size_t)order[e] * 3;
    fx -= dj[0];
    fy -= dj[1];
    fz -= dj[2];
  }
  f[(size_t)i * 3] = fx;
  f[(size_t)i * 3 + 1] = fy;
  f[(size_t)i * 3 + 2] = fz;
}

template <typename T>
static int launch(const void* d, const void* order, const void* rowptr,
                  void* f, int n_out, int n_local, int offset, int nnbor,
                  int device, void* stream) {
  if (n_out < 0 || n_local < 0 || offset < 0 || nnbor < 0 ||
      offset + n_local > n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  const int block = 128;
  assemble_forces_kernel<T><<<(n_out + block - 1) / block, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const long long*>(order),
      static_cast<const long long*>(rowptr), static_cast<T*>(f), n_out,
      n_local, offset, nnbor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int assemble_forces_f32(const void* d, const void* order,
                                   const void* rowptr, void* f, int n_out,
                                   int n_local, int offset, int nnbor,
                                   int device, void* stream) {
  return launch<float>(d, order, rowptr, f, n_out, n_local, offset, nnbor,
                       device, stream);
}

extern "C" int assemble_forces_f64(const void* d, const void* order,
                                   const void* rowptr, void* f, int n_out,
                                   int n_local, int offset, int nnbor,
                                   int device, void* stream) {
  return launch<double>(d, order, rowptr, f, n_out, n_local, offset,
                        nnbor, device, stream);
}
