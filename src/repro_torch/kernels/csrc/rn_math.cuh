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

// The minimum image's product p = box * rint(d / box), bitwise, without the
// division where rint's value is certain.
//
// Rounding is monotone, so with lo = fl(c0 |box|), hi = fl(c1 |box|) and
// top = fl(c2 |box|) (c0 = 1/2 - e, c1 = 1/2 + e, c2 = 3/2 - e; e = 2^-40
// in double, 2^-16 in float, far above the two roundings of the threshold
// and of the quotient):
// - |d| < lo: |fl(d / box)| < 1/2, rint gives a zero of the quotient's
//   sign, sign(d) xor sign(box), and box times it is a zero of d's sign;
// - hi < |d| < top: |fl(d / box)| lies in (1/2, 3/2), rint gives +-1 and
//   p is |box| with d's sign.
// image_fast gives that p and flags anything else (|d| within e of half a
// box, past 3/2 box, a non-finite d, a box that is not finite or under
// 1e-30) as slow: there image_slow takes the division itself.  A warp runs
// image_slow only where a vote finds a slow lane, so the division's code
// stays out of the common path.  d - p is +0.0 for d = +-0.0 (the plain
// version's -0.0 - -0.0) and d itself for any other d under half a box.
template <typename T>
struct ImageAxis {
  T box, abs, lo, hi, top;
};

template <typename T>
__device__ __forceinline__ ImageAxis<T> image_axis(T box) {
  constexpr T e = sizeof(T) == 8 ? T(9.094947017729282e-13)    // 2^-40
                                 : T(1.52587890625e-05);       // 2^-16
  const T a = fabs(box);
  ImageAxis<T> ax{box, a, T(0), T(0), T(0)};
  if (a >= T(1e-30) && isfinite(a)) {
    ax.lo = rn_mul(T(0.5) - e, a);
    ax.hi = rn_mul(T(0.5) + e, a);
    ax.top = rn_mul(T(1.5) - e, a);
  }
  return ax;
}

template <typename T>
__device__ __forceinline__ T image_fast(T d, const ImageAxis<T>& ax,
                                        bool& slow) {
  const T ad = fabs(d);
  const bool zero = ad < ax.lo, one = ad > ax.hi && ad < ax.top;
  slow = !(zero || one);
  return copysign(one ? ax.abs : T(0), d);
}

template <typename T>
__device__ __forceinline__ T image_slow(T d, const ImageAxis<T>& ax) {
  return rn_mul(ax.box, rint(rn_div(d, ax.box)));
}
