// Arithmetic rounded one operation at a time, for the neighbor builds.
//
// Which pairs fall inside a cutoff is decided by float rounding, so the
// builds (cell_list.cu, brute_neighbors.cu) repeat their plain PyTorch
// versions' arithmetic step by step: every sum, difference, product and
// quotient rounded on its own with the _rn intrinsics (nvcc would contract
// a * b + c into an FMA otherwise), and rint (round half to even, as
// torch.round and jnp.round).  The lists are then bitwise those of the
// plain versions (kernels/neighbors.py).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double rn_div(double a, double b) {
  return __ddiv_rn(a, b);
}
