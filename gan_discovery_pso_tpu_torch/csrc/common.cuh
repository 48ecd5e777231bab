// Device helpers shared by the port's kernels.
//
// Every comparison here keeps NaN the way the plain PyTorch versions do:
// torch.amin/amax propagate it, and torch.argmin puts it first.

#pragma once

#include <cuda_runtime.h>

namespace gdpt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// min and max over the 32 lanes of a warp, NaN-propagating; every lane ends
// with the warp's result
__device__ __forceinline__ void warp_min_max(float& mn, float& mx) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(kFullMask, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(kFullMask, mx, off));
  }
}

// true when (av, ai) comes before (bv, bi) in torch.argmin's order: NaN
// first, then the lower value, then the lower index. The order is total, so
// any reduction tree finds the same winner.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  const bool a_nan = av != av;
  const bool b_nan = bv != bv;
  if (a_nan != b_nan) return a_nan;
  if (!a_nan && av != bv) return av < bv;
  return ai < bi;
}

__device__ __forceinline__ void take_if_before(float& v, int& i, float ov, int oi) {
  if (before(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// argmin over the 32 lanes of a warp; every lane ends with the winner
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    take_if_before(v, i, __shfl_xor_sync(kFullMask, v, off),
                   __shfl_xor_sync(kFullMask, i, off));
  }
}

}  // namespace gdpt
