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
// about 0.48 us at 3.35 TB/s, so a single launch is bound by launch latency.
//
// Design: one block per row. Pass 1 reads the row with a strided loop
// (neighbouring threads on neighbouring addresses) and reduces min and max
// with warp shuffles and one shared-memory step. Pass 2 re-reads the row, now
// in L1/L2, normalises and writes it, casting in the kernel when the caller
// asks for bf16, so the downstream conv reads half the bytes. Loops make any
// F work; no padding as on the TPU's (8, 128) tiles.
//
// Numerics, bit-equal to the plain PyTorch version
// (ops/kernels/rescale.py:rescale01_rows_plain):
// - min and max propagate NaN, as torch.amin/amax do;
// - (x - mn) / (mx - mn) with IEEE round-to-nearest subtract and divide;
// - the clamp keeps NaN (a constant row gives 0/0), as torch.clamp does:
//   fminf/fmaxf alone would turn that NaN into 0 or 1;
// - bf16 by round-to-nearest-even, as tensor.to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename OutT>
__device__ __forceinline__ OutT convert(float v);

template <>
__device__ __forceinline__ float convert<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    rescale01_rows_kernel(const float* __restrict__ x, OutT* __restrict__ out,
                          int f) {
  const float* row = x + static_cast<long long>(blockIdx.x) * f;
  OutT* out_row = out + static_cast<long long>(blockIdx.x) * f;

  float mn = __int_as_float(0x7f800000);   // +inf
  float mx = __int_as_float(0xff800000);   // -inf
  for (int j = threadIdx.x; j < f; j += kThreads) {
    const float v = row[j];
    mn = nan_min(mn, v);
    mx = nan_max(mx, v);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  __shared__ float s_mn[kWarps];
  __shared__ float s_mx[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kWarps ? s_mn[lane] : __int_as_float(0x7f800000);
    mx = lane < kWarps ? s_mx[lane] : __int_as_float(0xff800000);
    for (int off = 16; off > 0; off >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      s_mn[0] = mn;
      s_mx[0] = mx;
    }
  }
  __syncthreads();
  mn = s_mn[0];
  mx = s_mx[0];

  const float range = __fsub_rn(mx, mn);
  for (int j = threadIdx.x; j < f; j += kThreads) {
    float y = __fdiv_rn(__fsub_rn(row[j], mn), range);
    if (y == y) y = fminf(fmaxf(y, 0.0f), 1.0f);  // NaN passes through
    out_row[j] = convert<OutT>(y);
  }
}

}  // namespace

// x: [n, f] fp32, contiguous. out: [n, f], fp32 or (out_bf16 != 0) bf16.
// Returns the cudaError_t of the launch.
extern "C" int gdpt_rescale01_rows(const void* x, void* out, int n, int f,
                                   int out_bf16, void* stream) {
  if (n > 0 && f > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xin = static_cast<const float*>(x);
    if (out_bf16) {
      rescale01_rows_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
          xin, static_cast<__nv_bfloat16*>(out), f);
    } else {
      rescale01_rows_kernel<float><<<n, kThreads, 0, s>>>(
          xin, static_cast<float*>(out), f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
