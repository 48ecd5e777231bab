// The fused post-fitness PSO update, one block per swarm.
//
// Replaces the Pallas TPU kernel gan_discovery_pso_tpu/ops/pallas/swarm_update.py
// (_kernel, called by pso_update_pallas from pso/swarm.py:pso_iteration_pallas).
// The JAX package runs it under a class vmap; here the class axis is a
// written-out batch dimension: grid = number of swarms B, each swarm of N
// particles in d dimensions. In order, per swarm:
//   1. personal best where fitness < p_best_val;
//   2. global-best argmin over p_best_val, NaN first, then the lowest value,
//      the lowest index winning a tie (torch.argmin's order);
//   3. g_best_val, g_prev_val and the "appended" flag, where the first
//      improvement overwrites +inf and does not count;
//   4. vel = w*v + (w_cogn*r1)*(g - x) + (w_soci*r2)*(p - x), with the
//      reference's naming swap (w_cognitive couples the GLOBAL best) and r1,
//      r2 scalar per particle;
//   5. x += vel.
//
// Bound: bytes. About 10 operations per 24 bytes of particle state read and
// written. At [8, 32, 100] the function moves about 0.63 MB, about 0.19 us at
// 3.35 TB/s: a launch at main-path shapes is bound by launch latency, and the
// gain over the plain version is the ~20 kernels it replaces.
//
// Design: phase 1 loops over the N particles (one value each), writes the new
// p_best_val and reduces (value, index) pairs with warp shuffles and one
// shared-memory step. Phase 2 loops over the N*d elements. The winning row of
// the new p_best_pos is computed from the inputs (improved[cand] ? pos : pbp)
// rather than read back, so no block reads its own global writes. Loops make
// any N and d work in one block: no TPU-style (8, 128) padding and no second
// grid phase. The inertia w and the global-best values are device tensors
// [B], so the caller's loop never waits on the host.
//
// Numerics: each product and sum is rounded on its own (__fmul_rn etc.), in
// the plain PyTorch version's association order, so the result is bit-equal
// to ops/kernels/swarm_update.py:swarm_update_plain; nvcc would otherwise
// contract a*b + c into one FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// true when (av, ai) comes before (bv, bi) in torch.argmin's order
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  const bool a_nan = av != av;
  const bool b_nan = bv != bv;
  if (a_nan != b_nan) return a_nan;
  if (!a_nan && av != bv) return av < bv;
  return ai < bi;
}

__device__ __forceinline__ void take_if_before(float& v, int& i, float ov,
                                               int oi) {
  if (before(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads) swarm_update_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ pbp, const float* __restrict__ pbv,
    const float* __restrict__ fit, const float* __restrict__ r1,
    const float* __restrict__ r2, const float* __restrict__ gbp,
    const float* __restrict__ gbv, const float* __restrict__ gpv,
    const float* __restrict__ w, float w_cogn, float w_soci,
    float* __restrict__ out_pos, float* __restrict__ out_vel,
    float* __restrict__ out_pbp, float* __restrict__ out_pbv,
    float* __restrict__ out_gbp, float* __restrict__ out_gbv,
    float* __restrict__ out_gpv, unsigned char* __restrict__ out_appended,
    int n, int d) {
  const int b = blockIdx.x;
  const long long nd = static_cast<long long>(n) * d;
  pos += b * nd;
  vel += b * nd;
  pbp += b * nd;
  out_pos += b * nd;
  out_vel += b * nd;
  out_pbp += b * nd;
  pbv += static_cast<long long>(b) * n;
  fit += static_cast<long long>(b) * n;
  r1 += static_cast<long long>(b) * n;
  r2 += static_cast<long long>(b) * n;
  out_pbv += static_cast<long long>(b) * n;
  gbp += static_cast<long long>(b) * d;
  out_gbp += static_cast<long long>(b) * d;

  // phase 1: personal bests and the argmin over them
  float best_v = __int_as_float(0x7f800000);  // +inf
  int best_i = n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float f = fit[i];
    const float p = pbv[i];
    const float v = f < p ? f : p;
    out_pbv[i] = v;
    take_if_before(best_v, best_i, v, i);
  }
  for (int off = 16; off > 0; off >>= 1) {
    take_if_before(best_v, best_i, __shfl_xor_sync(0xffffffffu, best_v, off),
                   __shfl_xor_sync(0xffffffffu, best_i, off));
  }
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ int s_cand;
  __shared__ bool s_g_improved;
  __shared__ bool s_cand_improved;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_v[warp] = best_v;
    s_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) take_if_before(best_v, best_i, s_v[k], s_i[k]);
    const int cand = best_i;
    const float g_old = gbv[b];
    const bool g_improved = best_v < g_old;
    const bool appended = g_improved && !isinf(g_old);
    out_gbv[b] = g_improved ? best_v : g_old;
    out_gpv[b] = appended ? g_old : gpv[b];
    out_appended[b] = appended ? 1 : 0;
    s_cand = cand;
    s_g_improved = g_improved;
    s_cand_improved = fit[cand] < pbv[cand];
  }
  __syncthreads();

  // phase 2: the move
  const int cand = s_cand;
  const bool g_improved = s_g_improved;
  const float* cand_row = (s_cand_improved ? pos : pbp) + cand * static_cast<long long>(d);
  const float wb = w[b];
  for (int j = threadIdx.x; j < d; j += kThreads) {
    out_gbp[j] = g_improved ? cand_row[j] : gbp[j];
  }
  for (long long e = threadIdx.x; e < nd; e += kThreads) {
    const int i = static_cast<int>(e / d);
    const int j = static_cast<int>(e - static_cast<long long>(i) * d);
    const float x = pos[e];
    const float p = fit[i] < pbv[i] ? x : pbp[e];
    const float g = g_improved ? cand_row[j] : gbp[j];
    out_pbp[e] = p;
    const float v_new = __fadd_rn(
        __fadd_rn(__fmul_rn(wb, vel[e]),
                  __fmul_rn(__fmul_rn(w_cogn, r1[i]), __fsub_rn(g, x))),
        __fmul_rn(__fmul_rn(w_soci, r2[i]), __fsub_rn(p, x)));
    out_vel[e] = v_new;
    out_pos[e] = __fadd_rn(x, v_new);
  }
}

}  // namespace

// Tensors are fp32 and contiguous: pos, vel, pbp [B, n, d]; pbv, fit, r1, r2
// [B, n]; gbp [B, d]; gbv, gpv, w [B]. Outputs of the same shapes, plus
// out_appended [B] bool. n >= 1. Returns the cudaError_t of the launch.
extern "C" int gdpt_swarm_update(
    const void* pos, const void* vel, const void* pbp, const void* pbv,
    const void* fit, const void* r1, const void* r2, const void* gbp,
    const void* gbv, const void* gpv, const void* w, float w_cogn,
    float w_soci, void* out_pos, void* out_vel, void* out_pbp, void* out_pbv,
    void* out_gbp, void* out_gbv, void* out_gpv, void* out_appended,
    int n_swarms, int n, int d, void* stream) {
  if (n_swarms > 0 && n > 0) {
    swarm_update_kernel<<<n_swarms, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(vel),
        static_cast<const float*>(pbp), static_cast<const float*>(pbv),
        static_cast<const float*>(fit), static_cast<const float*>(r1),
        static_cast<const float*>(r2), static_cast<const float*>(gbp),
        static_cast<const float*>(gbv), static_cast<const float*>(gpv),
        static_cast<const float*>(w), w_cogn, w_soci,
        static_cast<float*>(out_pos), static_cast<float*>(out_vel),
        static_cast<float*>(out_pbp), static_cast<float*>(out_pbv),
        static_cast<float*>(out_gbp), static_cast<float*>(out_gbv),
        static_cast<float*>(out_gpv), static_cast<unsigned char*>(out_appended),
        n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
