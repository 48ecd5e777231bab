// Per-row min-max rescale of [N, F] to [0, 1], with an optional bf16 output.
//
// Replaces the Pallas TPU kernel gan_discovery_pso_tpu/ops/pallas/rescale.py
// (_kernel, called by rescale01_rows / rescale01_per_sample_pallas). The
// discovery fitness runs it once per PSO iteration on every generated image:
// on the main path [C*N, 784] fp32 rows (C classes x N particles, 1x28x28).
//
// Bound: bytes. Each element is read, compared twice, subtracted, divided and
// written: about 5 operations per 8 bytes (fp32 out), far below the card's
// ratio of operations to bytes. At [256, 784] the function moves 1.6 MB,
// about 0.48 us at 3.35 TB/s, so a single launch is bound by launch latency;
// at [4096, 784] it moves 25.7 MB, about 7.7 us.
//
// Design: two paths of one entry point, chosen by the row length; the
// wrapper's geometry helper (ops/kernels/rescale.py:rescale_geometry) sizes
// the short path's warp teams.
// - Short rows (F <= kShortMaxF): the row is read once from device memory
//   into registers as float4 and written from them: float4 for fp32, 4 x
//   bf16 packed in 8 bytes for bf16. A team of warps holds a row: one warp
//   when there are rows enough to fill the card ([4096, 784]: 7 float4 a
//   lane, 8 rows a CTA, min and max by warp shuffles only, no shared memory
//   and no barrier), up to 8 warps when there are few ([256, 784]: one CTA
//   a row, 1 float4 a thread, one shared-memory step and one barrier). One
//   warp a row at [256, 784] leaves 2 warps per SM, each running 28 IEEE
//   divides in turn, and is slower than a team of 8 (kernel_sweep.py). A
//   scalar head and tail take the elements before the first 16-byte boundary
//   and after the last, so odd F works; a base that is not aligned (an
//   offset view) takes a scalar walk, still held in registers.
// - Long rows (F > kShortMaxF, e.g. 256x256 CLARO slices): one 256-thread
//   CTA per row, float4 with the same head and tail, min and max over warps
//   through one shared-memory step, and a second pass over the row (now in
//   L2) that writes it.
//
// Numerics, bit-equal to the plain PyTorch version
// (ops/kernels/rescale.py:rescale01_rows_plain):
// - min and max propagate NaN, as torch.amin/amax do (the order in which a
//   warp combines them does not change a min or a max);
// - (x - mn) / (mx - mn) with IEEE round-to-nearest subtract and divide;
// - the clamp keeps NaN (a constant row gives 0/0), as torch.clamp does:
//   fminf/fmaxf alone would turn that NaN into 0 or 1;
// - bf16 by round-to-nearest-even, as tensor.to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kShortMaxF = 4096;  // the longest row held in registers
constexpr int kLongThreads = 256;
constexpr int kLongWarps = kLongThreads / 32;

__device__ __forceinline__ float scale01(float v, float mn, float range) {
  float y = __fdiv_rn(__fsub_rn(v, mn), range);
  if (y == y) y = fminf(fmaxf(y, 0.0f), 1.0f);  // NaN passes through
  return y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive outputs at p, 16-byte aligned for fp32, 8 for bf16
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void min_max4(float& mn, float& mx, float4 v) {
  mn = gdpt::nan_min(gdpt::nan_min(mn, v.x), gdpt::nan_min(v.y, gdpt::nan_min(v.z, v.w)));
  mx = gdpt::nan_max(gdpt::nan_max(mx, v.x), gdpt::nan_max(v.y, gdpt::nan_max(v.z, v.w)));
}

__device__ __forceinline__ float4 scale01_4(float4 v, float mn, float range) {
  return make_float4(scale01(v.x, mn, range), scale01(v.y, mn, range),
                     scale01(v.z, mn, range), scale01(v.w, mn, range));
}

__device__ __forceinline__ float& component(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// elements of the row before its first 16-byte boundary (at most f)
__device__ __forceinline__ int head_len(const float* row, int f) {
  const int h = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) >> 2;
  return min(h, f);
}

// A team of `team` warps per row (1, 2, 4 or 8), the row held in registers:
// each thread holds up to 4*K elements, K * 128 * team >= f. With team == 1
// a CTA holds rows_per_cta rows and needs no barrier; with team > 1 a CTA is
// one row (rows_per_cta == 1) and its warps combine min and max through
// shared memory. vec: both bases aligned (x to 16 bytes, out to 4
// elements), so a row's input and output share their head length.
template <typename OutT, int K>
__global__ void __launch_bounds__(256) rescale_short_kernel(
    const float* __restrict__ x, OutT* __restrict__ out, int n, int f, int team,
    int rows_per_cta, int vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * rows_per_cta + warp / team;
  if (row >= n) return;  // team == 1 only: whole warps, no barrier follows
  const int tid = (warp % team) * 32 + lane;  // thread of the team
  const int stride = 32 * team;
  const float* r = x + static_cast<long long>(row) * f;
  OutT* o = out + static_cast<long long>(row) * f;

  float mn = gdpt::pos_inf();
  float mx = gdpt::neg_inf();
  float4 v[K];
  int h = f, body = 0, t0 = f;  // the scalar walk: everything is "head"
  if (vec) {
    h = head_len(r, f);
    body = (f - h) >> 2;  // float4s
    t0 = h + (body << 2);
  }
  const int tail = f - t0;
  const float4* r4 = reinterpret_cast<const float4*>(r + h);
  // vec: v[k] holds float4 tid + stride*k of the body, hv and tv an element
  // of the head and the tail (< 4 each). Scalar: element tid + stride*j sits
  // in component j % 4 of v[j / 4].
  float hv = 0.0f, tv = 0.0f;
  if (vec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = tid + stride * k;
      if (q < body) {
        v[k] = r4[q];
        min_max4(mn, mx, v[k]);
      }
    }
    if (tid < h) {
      hv = r[tid];
      mn = gdpt::nan_min(mn, hv);
      mx = gdpt::nan_max(mx, hv);
    }
    if (tid < tail) {
      tv = r[t0 + tid];
      mn = gdpt::nan_min(mn, tv);
      mx = gdpt::nan_max(mx, tv);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * K; ++j) {
      const int e = tid + stride * j;
      if (e < f) {
        const float val = r[e];
        component(v[j >> 2], j & 3) = val;
        mn = gdpt::nan_min(mn, val);
        mx = gdpt::nan_max(mx, val);
      }
    }
  }
  gdpt::warp_min_max(mn, mx);
  if (team > 1) {  // uniform: every warp of the CTA is in the one team
    __shared__ float s_mn[8];
    __shared__ float s_mx[8];
    if (lane == 0) {
      s_mn[warp] = mn;
      s_mx[warp] = mx;
    }
    __syncthreads();
    mn = lane < team ? s_mn[lane] : gdpt::pos_inf();
    mx = lane < team ? s_mx[lane] : gdpt::neg_inf();
    gdpt::warp_min_max(mn, mx);
  }

  const float range = __fsub_rn(mx, mn);
  if (vec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = tid + stride * k;
      if (q < body) store4(o + h + 4 * q, scale01_4(v[k], mn, range));
    }
    if (tid < h) store1(o + tid, scale01(hv, mn, range));
    if (tid < tail) store1(o + t0 + tid, scale01(tv, mn, range));
  } else {
#pragma unroll
    for (int j = 0; j < 4 * K; ++j) {
      const int e = tid + stride * j;
      if (e < f) store1(o + e, scale01(component(v[j >> 2], j & 3), mn, range));
    }
  }
}

// One CTA per row, two passes (the second from L2).
template <typename OutT>
__global__ void __launch_bounds__(kLongThreads) rescale_long_kernel(
    const float* __restrict__ x, OutT* __restrict__ out, int f, int vec) {
  const float* r = x + static_cast<long long>(blockIdx.x) * f;
  OutT* o = out + static_cast<long long>(blockIdx.x) * f;
  // scalar walk: everything is "head"
  const int h = vec ? head_len(r, f) : f;
  const int body = (f - h) >> 2;
  const int t0 = h + (body << 2);
  const float4* r4 = reinterpret_cast<const float4*>(r + h);

  float mn = gdpt::pos_inf();
  float mx = gdpt::neg_inf();
#pragma unroll 4
  for (int q = threadIdx.x; q < body; q += kLongThreads) min_max4(mn, mx, r4[q]);
  for (int j = threadIdx.x; j < h; j += kLongThreads) {
    mn = gdpt::nan_min(mn, r[j]);
    mx = gdpt::nan_max(mx, r[j]);
  }
  for (int j = t0 + threadIdx.x; j < f; j += kLongThreads) {
    mn = gdpt::nan_min(mn, r[j]);
    mx = gdpt::nan_max(mx, r[j]);
  }
  gdpt::warp_min_max(mn, mx);
  __shared__ float s_mn[kLongWarps];
  __shared__ float s_mx[kLongWarps];
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_mn[threadIdx.x >> 5] = mn;
    s_mx[threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  // every warp combines the per-warp results itself
  mn = lane < kLongWarps ? s_mn[lane] : gdpt::pos_inf();
  mx = lane < kLongWarps ? s_mx[lane] : gdpt::neg_inf();
  gdpt::warp_min_max(mn, mx);

  const float range = __fsub_rn(mx, mn);
#pragma unroll 4
  for (int q = threadIdx.x; q < body; q += kLongThreads) {
    store4(o + h + 4 * q, scale01_4(r4[q], mn, range));
  }
  for (int j = threadIdx.x; j < h; j += kLongThreads) store1(o + j, scale01(r[j], mn, range));
  for (int j = t0 + threadIdx.x; j < f; j += kLongThreads) {
    store1(o + j, scale01(r[j], mn, range));
  }
}

template <typename OutT>
cudaError_t launch(const float* x, OutT* out, int n, int f, int team, int rows_per_cta,
                   int vec, cudaStream_t s) {
  if (f > kShortMaxF) {
    rescale_long_kernel<OutT><<<n, kLongThreads, 0, s>>>(x, out, f, vec);
    return cudaGetLastError();
  }
  if (team < 1 || team > 8 || rows_per_cta < 1 || (team > 1 && rows_per_cta != 1) ||
      team * rows_per_cta > 8) {
    return cudaErrorInvalidValue;
  }
  const int ctas = (n + rows_per_cta - 1) / rows_per_cta;
  const int threads = 32 * team * rows_per_cta;
  const int per_thread = (f + 32 * team - 1) / (32 * team);  // elements
  if (per_thread <= 4) {
    rescale_short_kernel<OutT, 1><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  } else if (per_thread <= 8) {
    rescale_short_kernel<OutT, 2><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  } else if (per_thread <= 16) {
    rescale_short_kernel<OutT, 4><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  } else if (per_thread <= 32) {
    rescale_short_kernel<OutT, 8><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  } else if (per_thread <= 64) {
    rescale_short_kernel<OutT, 16><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  } else {
    rescale_short_kernel<OutT, 32><<<ctas, threads, 0, s>>>(x, out, n, f, team, rows_per_cta, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [n, f] fp32, contiguous. out: [n, f], fp32 or (out_bf16 != 0) bf16.
// Rows of at most kShortMaxF floats are held in registers, `team` warps a
// row and rows_per_cta rows a CTA (one of the two 1, at most 8 warps a
// CTA), ceil(n / rows_per_cta) CTAs; longer rows take a CTA each and
// ignore team and rows_per_cta. vec: x 16-byte aligned and out aligned to
// 4 elements. Returns the cudaError_t of the launch.
extern "C" int gdpt_rescale01_rows(const void* x, void* out, int n, int f, int out_bf16,
                                   int team, int rows_per_cta, int vec, void* stream) {
  cudaError_t err = cudaSuccess;
  if (n > 0 && f > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xin = static_cast<const float*>(x);
    err = out_bf16 ? launch(xin, static_cast<__nv_bfloat16*>(out), n, f, team,
                            rows_per_cta, vec, s)
                   : launch(xin, static_cast<float*>(out), n, f, team, rows_per_cta, vec, s);
  }
  return static_cast<int>(err);
}
