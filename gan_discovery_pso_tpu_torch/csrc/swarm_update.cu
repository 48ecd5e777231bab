// The fused post-fitness PSO update, on a grid of (particle tile, swarm).
//
// Replaces the Pallas TPU kernel gan_discovery_pso_tpu/ops/pallas/swarm_update.py
// (_kernel, called by pso_update_pallas from pso/swarm.py:pso_iteration_pallas).
// The JAX package runs it under a class vmap; here the class axis is a
// written-out batch dimension: B swarms, each of N particles in d dimensions.
// In order, per swarm:
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
// written (pos, vel, p_best_pos in; pos, vel, p_best_pos out). At [8, 32, 100]
// the function moves about 0.63 MB (0.19 us at 3.35 TB/s), so a launch there
// is bound by launch latency; at the Pallas kernel's range, [1, 4096, 1024],
// it moves about 100.7 MB (30 us).
//
// Design, for Hopper's 132 SMs:
// - Grid (tiles, B). A CTA owns a contiguous tile of particle rows; the
//   wrapper's geometry helper (ops/kernels/swarm_update.py:swarm_geometry)
//   sizes tiles so that B = 1 fills the card too, with at least one row per
//   warp.
// - The argmin needs every particle of the swarm, so every CTA of a swarm
//   reduces min(fit, p_best_val) over all N itself: 8*N bytes from L2, next
//   to the 24*d bytes per row of its tile, with warp shuffles and one
//   shared-memory step. No CTA talks to another, and since (value, index)
//   is a total order, every CTA finds the same winner. Chosen over a thread
//   block cluster reducing through distributed shared memory: the redundant
//   pass is short next to the tile's streaming even at N = 4096, and a
//   cluster would cap the grid's x extent and its scheduling.
// - The winning row is computed from the inputs (improved[cand] ? pos : pbp),
//   so no CTA reads another's writes. Tile 0 alone writes g_best_pos,
//   g_best_val, g_prev_val and the flag; each CTA writes p_best_val for its
//   own rows.
// - The move: one warp per row. The row's fit, p_best_val, r1 and r2 are
//   loaded once into registers; lanes walk d with float4 loads and stores
//   (when d % 4 == 0 and the rows are 16-byte aligned, else scalar), with no
//   per-element index arithmetic and no integer divide. p_best_pos is not
//   read for a row that improved. The g-best row (d <= 1024) is staged once
//   per CTA in shared memory.
// - w, g_best_val and g_prev_val are device tensors [B], so the caller's
//   loop never waits on the host.
//
// Numerics: each product and sum is rounded on its own (__fmul_rn etc.), in
// the plain PyTorch version's association order, so the result is bit-equal
// to ops/kernels/swarm_update.py:swarm_update_plain; nvcc would otherwise
// contract a*b + c into one FMA.
//
// The split form, for a swarm whose particles are spread over ranks
// (parallel/swarm_sharding.py). The fused kernel's argmin sees only the rows
// it is given, so on a shard it would move every particle towards the shard's
// best. The split pair runs around the collective that finds the global best:
// - swarm_pbest_local_kernel: steps 1 and 2 on the shard: the personal best
//   of each row (p_best_val, p_best_pos written whole), and the shard's
//   candidate: its row, its value and its GLOBAL index (the shard's first
//   row + the local index), in step 2's order. Tile 0 of a swarm reduces the
//   argmin; every tile writes its own rows.
// - the caller's collective (an all-reduce MIN of an order-preserving key,
//   then the winner's row) gives every rank the same winner;
// - swarm_move_kernel: steps 3 to 5 from the winner: the g-best bookkeeping
//   (tile 0) and the move of the shard's rows, the g-best row staged in
//   dynamic shared memory.
// Both are bound by bytes: p_best_pos is written by the first and read by
// the second, so the pair moves 2 * 4 * d bytes a row more than the fused
// kernel. Their arithmetic is the fused kernel's, in the same order, so the
// pair over all shards is bit-equal to swarm_update_plain on the whole swarm.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStagedD = 1024;  // the g-best row staged in shared memory

__device__ __forceinline__ float new_velocity(float wb, float v, float a, float g,
                                              float x, float s, float p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(wb, v), __fmul_rn(a, __fsub_rn(g, x))),
                   __fmul_rn(s, __fsub_rn(p, x)));
}

// kVecD: d % 4 == 0 and the [., d] rows are 16-byte aligned.
template <bool kVecD>
__global__ void __launch_bounds__(kThreads) swarm_update_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ pbp, const float* __restrict__ pbv,
    const float* __restrict__ fit, const float* __restrict__ r1,
    const float* __restrict__ r2, const float* __restrict__ gbp,
    const float* __restrict__ gbv, const float* __restrict__ gpv,
    const float* __restrict__ w, float w_cogn, float w_soci,
    float* __restrict__ out_big, float* __restrict__ out_small,
    unsigned char* __restrict__ out_appended, int n_swarms, int n, int d,
    int rows_per_cta) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row1 = min(n, row0 + rows_per_cta);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the outputs, carved from two buffers:
  // out_big [pos | vel | p_best_pos], B*n*d each;
  // out_small [g_best_pos (B*d) | p_best_val (B*n) | g_best_val (B) | g_prev_val (B)]
  const long long nd = static_cast<long long>(n) * d;
  const long long bnd = n_swarms * nd;
  float* out_pos = out_big + b * nd;
  float* out_vel = out_big + bnd + b * nd;
  float* out_pbp = out_big + 2 * bnd + b * nd;
  float* out_gbp = out_small + static_cast<long long>(b) * d;
  float* out_pbv = out_small + static_cast<long long>(n_swarms) * d + static_cast<long long>(b) * n;
  float* out_gbv = out_small + static_cast<long long>(n_swarms) * (d + n);
  float* out_gpv = out_gbv + n_swarms;

  pos += b * nd;
  vel += b * nd;
  pbp += b * nd;
  pbv += static_cast<long long>(b) * n;
  fit += static_cast<long long>(b) * n;
  r1 += static_cast<long long>(b) * n;
  r2 += static_cast<long long>(b) * n;
  gbp += static_cast<long long>(b) * d;

  // phase 1: argmin of min(fit, p_best_val) over the whole swarm
  float best_v = gdpt::pos_inf();
  int best_i = n;  // loses to every real index
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float f = fit[i];
    const float p = pbv[i];
    gdpt::take_if_before(best_v, best_i, f < p ? f : p, i);
  }
  gdpt::warp_argmin(best_v, best_i);
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ __align__(16) float s_g[kMaxStagedD];
  if (lane == 0) {
    s_v[warp] = best_v;
    s_i[warp] = best_i;
  }
  __syncthreads();
  // every warp reduces the per-warp winners itself: no lone thread, no
  // second barrier
  best_v = lane < kWarps ? s_v[lane] : gdpt::pos_inf();
  best_i = lane < kWarps ? s_i[lane] : n;
  gdpt::warp_argmin(best_v, best_i);

  const int cand = best_i;
  const float g_old = gbv[b];
  const bool g_improved = best_v < g_old;
  const float* g_src =
      g_improved ? (fit[cand] < pbv[cand] ? pos : pbp) + cand * static_cast<long long>(d)
                 : gbp;
  const bool tile0 = blockIdx.x == 0;
  if (tile0 && threadIdx.x == 0) {
    const bool appended = g_improved && !isinf(g_old);
    out_gbv[b] = g_improved ? best_v : g_old;
    out_gpv[b] = appended ? g_old : gpv[b];
    out_appended[b] = appended ? 1 : 0;
  }

  // the g-best row, staged once per CTA (uniform branch: d is the same for
  // every thread)
  const bool staged = d <= kMaxStagedD;
  if (staged || tile0) {
    float* dst = staged ? s_g : out_gbp;
    if (kVecD) {
      const float4* src4 = reinterpret_cast<const float4*>(g_src);
      for (int q = threadIdx.x; q < (d >> 2); q += kThreads) {
        const float4 v = src4[q];
        reinterpret_cast<float4*>(dst)[q] = v;
        if (staged && tile0) reinterpret_cast<float4*>(out_gbp)[q] = v;
      }
    } else {
      for (int j = threadIdx.x; j < d; j += kThreads) {
        const float v = g_src[j];
        dst[j] = v;
        if (staged && tile0) out_gbp[j] = v;
      }
    }
  }
  if (staged) __syncthreads();
  const float* g = staged ? s_g : g_src;

  // phase 2: the move, one warp per row of this CTA's tile
  const float wb = w[b];
  for (int i = row0 + warp; i < row1; i += kWarps) {
    const float f = fit[i];
    const float pv = pbv[i];
    const bool improved = f < pv;
    const float a = __fmul_rn(w_cogn, r1[i]);
    const float s = __fmul_rn(w_soci, r2[i]);
    if (lane == 0) out_pbv[i] = improved ? f : pv;
    const long long base = static_cast<long long>(i) * d;
    if (kVecD) {
      const float4* x4 = reinterpret_cast<const float4*>(pos + base);
      const float4* v4 = reinterpret_cast<const float4*>(vel + base);
      const float4* p4 = reinterpret_cast<const float4*>(pbp + base);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* o_x4 = reinterpret_cast<float4*>(out_pos + base);
      float4* o_v4 = reinterpret_cast<float4*>(out_vel + base);
      float4* o_p4 = reinterpret_cast<float4*>(out_pbp + base);
#pragma unroll 2
      for (int q = lane; q < (d >> 2); q += 32) {
        const float4 x = x4[q];
        const float4 v = v4[q];
        float4 p = x;
        if (!improved) p = p4[q];
        const float4 gg = g4[q];
        float4 nv;
        nv.x = new_velocity(wb, v.x, a, gg.x, x.x, s, p.x);
        nv.y = new_velocity(wb, v.y, a, gg.y, x.y, s, p.y);
        nv.z = new_velocity(wb, v.z, a, gg.z, x.z, s, p.z);
        nv.w = new_velocity(wb, v.w, a, gg.w, x.w, s, p.w);
        o_p4[q] = p;
        o_v4[q] = nv;
        o_x4[q] = make_float4(__fadd_rn(x.x, nv.x), __fadd_rn(x.y, nv.y),
                              __fadd_rn(x.z, nv.z), __fadd_rn(x.w, nv.w));
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float x = pos[base + j];
        const float p = improved ? x : pbp[base + j];
        const float nv = new_velocity(wb, vel[base + j], a, g[j], x, s, p);
        out_pbp[base + j] = p;
        out_vel[base + j] = nv;
        out_pos[base + j] = __fadd_rn(x, nv);
      }
    }
  }
}

// argmin of min(fit, pbv) over the n rows of one swarm, by the whole CTA, in
// gdpt::before's order; every thread returns the winner
__device__ __forceinline__ void cta_argmin(const float* __restrict__ fit,
                                           const float* __restrict__ pbv, int n,
                                           float& best_v, int& best_i) {
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  best_v = gdpt::pos_inf();
  best_i = n;  // loses to every real index
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float f = fit[i];
    const float p = pbv[i];
    gdpt::take_if_before(best_v, best_i, f < p ? f : p, i);
  }
  gdpt::warp_argmin(best_v, best_i);
  if (lane == 0) {
    s_v[warp] = best_v;
    s_i[warp] = best_i;
  }
  __syncthreads();
  best_v = lane < kWarps ? s_v[lane] : gdpt::pos_inf();
  best_i = lane < kWarps ? s_i[lane] : n;
  gdpt::warp_argmin(best_v, best_i);
}

// Steps 1-2 on a shard. Outputs: out_pbp [B, n, d], out_pbv [B, n], out_cand
// [B, d + 1] (the candidate's row, then its value), out_idx [B] (its global
// index).
template <bool kVecD>
__global__ void __launch_bounds__(kThreads) swarm_pbest_local_kernel(
    const float* __restrict__ pos, const float* __restrict__ pbp,
    const float* __restrict__ pbv, const float* __restrict__ fit,
    float* __restrict__ out_pbp, float* __restrict__ out_pbv,
    float* __restrict__ out_cand, int* __restrict__ out_idx, int n, int d,
    int row_offset, int rows_per_cta) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row1 = min(n, row0 + rows_per_cta);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long nd = static_cast<long long>(n) * d;
  pos += b * nd;
  pbp += b * nd;
  out_pbp += b * nd;
  pbv += static_cast<long long>(b) * n;
  fit += static_cast<long long>(b) * n;
  out_pbv += static_cast<long long>(b) * n;

  // the personal best, one warp per row of this CTA's tile
  for (int i = row0 + warp; i < row1; i += kWarps) {
    const float f = fit[i];
    const float pv = pbv[i];
    const bool improved = f < pv;
    if (lane == 0) out_pbv[i] = improved ? f : pv;
    const long long base = static_cast<long long>(i) * d;
    const float* src = (improved ? pos : pbp) + base;
    if (kVecD) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* o4 = reinterpret_cast<float4*>(out_pbp + base);
      for (int q = lane; q < (d >> 2); q += 32) o4[q] = s4[q];
    } else {
      for (int j = lane; j < d; j += 32) out_pbp[base + j] = src[j];
    }
  }
  if (blockIdx.x != 0) return;  // uniform over the CTA

  // the shard's candidate, from the inputs (no CTA reads another's writes)
  float best_v;
  int best_i;
  cta_argmin(fit, pbv, n, best_v, best_i);
  const float* row =
      (fit[best_i] < pbv[best_i] ? pos : pbp) + static_cast<long long>(best_i) * d;
  float* cand = out_cand + static_cast<long long>(b) * (d + 1);
  for (int j = threadIdx.x; j < d; j += kThreads) cand[j] = row[j];
  if (threadIdx.x == 0) {
    cand[d] = best_v;
    out_idx[b] = row_offset + best_i;
  }
}

// Steps 3-5 on a shard, from the winner [B, d + 1] (row, then value) that
// every rank holds after the collective. Outputs: out_big [pos | vel], B*n*d
// each; out_small [g_best_pos (B*d) | g_best_val (B) | g_prev_val (B)];
// out_appended [B].
template <bool kVecD>
__global__ void __launch_bounds__(kThreads) swarm_move_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ pbp, const float* __restrict__ r1,
    const float* __restrict__ r2, const float* __restrict__ win,
    const float* __restrict__ gbp, const float* __restrict__ gbv,
    const float* __restrict__ gpv, const float* __restrict__ w, float w_cogn,
    float w_soci, float* __restrict__ out_big, float* __restrict__ out_small,
    unsigned char* __restrict__ out_appended, int n_swarms, int n, int d,
    int rows_per_cta) {
  extern __shared__ __align__(16) float s_g[];  // the g-best row, d floats
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row1 = min(n, row0 + rows_per_cta);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long nd = static_cast<long long>(n) * d;
  const long long bnd = n_swarms * nd;
  float* out_pos = out_big + b * nd;
  float* out_vel = out_big + bnd + b * nd;
  float* out_gbp = out_small + static_cast<long long>(b) * d;
  float* out_gbv = out_small + static_cast<long long>(n_swarms) * d;
  float* out_gpv = out_gbv + n_swarms;
  pos += b * nd;
  vel += b * nd;
  pbp += b * nd;
  r1 += static_cast<long long>(b) * n;
  r2 += static_cast<long long>(b) * n;

  const float* wrow = win + static_cast<long long>(b) * (d + 1);
  const float win_v = wrow[d];
  const float g_old = gbv[b];
  const bool g_improved = win_v < g_old;
  const float* g_src = g_improved ? wrow : gbp + static_cast<long long>(b) * d;
  const bool tile0 = blockIdx.x == 0;
  if (tile0 && threadIdx.x == 0) {
    const bool appended = g_improved && !isinf(g_old);
    out_gbv[b] = g_improved ? win_v : g_old;
    out_gpv[b] = appended ? g_old : gpv[b];
    out_appended[b] = appended ? 1 : 0;
  }
  // the winner's row starts d + 1 floats after the previous one: scalar loads
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = g_src[j];
    s_g[j] = v;
    if (tile0) out_gbp[j] = v;
  }
  __syncthreads();

  const float wb = w[b];
  for (int i = row0 + warp; i < row1; i += kWarps) {
    const float a = __fmul_rn(w_cogn, r1[i]);
    const float s = __fmul_rn(w_soci, r2[i]);
    const long long base = static_cast<long long>(i) * d;
    if (kVecD) {
      const float4* x4 = reinterpret_cast<const float4*>(pos + base);
      const float4* v4 = reinterpret_cast<const float4*>(vel + base);
      const float4* p4 = reinterpret_cast<const float4*>(pbp + base);
      const float4* g4 = reinterpret_cast<const float4*>(s_g);
      float4* o_x4 = reinterpret_cast<float4*>(out_pos + base);
      float4* o_v4 = reinterpret_cast<float4*>(out_vel + base);
#pragma unroll 2
      for (int q = lane; q < (d >> 2); q += 32) {
        const float4 x = x4[q];
        const float4 v = v4[q];
        const float4 p = p4[q];
        const float4 gg = g4[q];
        float4 nv;
        nv.x = new_velocity(wb, v.x, a, gg.x, x.x, s, p.x);
        nv.y = new_velocity(wb, v.y, a, gg.y, x.y, s, p.y);
        nv.z = new_velocity(wb, v.z, a, gg.z, x.z, s, p.z);
        nv.w = new_velocity(wb, v.w, a, gg.w, x.w, s, p.w);
        o_v4[q] = nv;
        o_x4[q] = make_float4(__fadd_rn(x.x, nv.x), __fadd_rn(x.y, nv.y),
                              __fadd_rn(x.z, nv.z), __fadd_rn(x.w, nv.w));
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float x = pos[base + j];
        const float nv = new_velocity(wb, vel[base + j], a, s_g[j], x, s, pbp[base + j]);
        out_vel[base + j] = nv;
        out_pos[base + j] = __fadd_rn(x, nv);
      }
    }
  }
}

}  // namespace

// Tensors are fp32 and contiguous: pos, vel, pbp [B, n, d]; pbv, fit, r1, r2
// [B, n]; gbp [B, d]; gbv, gpv, w [B]. The outputs: out_big, 3*B*n*d
// floats, and out_small, B*d + B*n + 2*B floats, laid out as in the
// kernel; out_appended [B] bool. Grid: ceil(n / rows_per_cta) CTAs of
// rows_per_cta particle rows per swarm; vec_d selects the float4 rows.
// Returns the cudaError_t of the launch.
extern "C" int gdpt_swarm_update(
    const void* pos, const void* vel, const void* pbp, const void* pbv,
    const void* fit, const void* r1, const void* r2, const void* gbp,
    const void* gbv, const void* gpv, const void* w, float w_cogn,
    float w_soci, void* out_big, void* out_small, void* out_appended,
    int n_swarms, int n, int d, int rows_per_cta, int vec_d, void* stream) {
  if (n_swarms > 0 && n > 0) {
    if (rows_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + rows_per_cta - 1) / rows_per_cta, n_swarms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto kernel = vec_d ? swarm_update_kernel<true> : swarm_update_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(pos), static_cast<const float*>(vel),
        static_cast<const float*>(pbp), static_cast<const float*>(pbv),
        static_cast<const float*>(fit), static_cast<const float*>(r1),
        static_cast<const float*>(r2), static_cast<const float*>(gbp),
        static_cast<const float*>(gbv), static_cast<const float*>(gpv),
        static_cast<const float*>(w), w_cogn, w_soci, static_cast<float*>(out_big),
        static_cast<float*>(out_small), static_cast<unsigned char*>(out_appended),
        n_swarms, n, d, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split pair. Tensors are fp32 (out_idx int32) and contiguous: pos, pbp
// [B, n, d]; pbv, fit [B, n]. Outputs: out_pbp [B, n, d], out_pbv [B, n],
// out_cand [B, d + 1], out_idx [B]. row_offset is the shard's first global
// row. Returns the cudaError_t of the launch.
extern "C" int gdpt_swarm_pbest_local(
    const void* pos, const void* pbp, const void* pbv, const void* fit, void* out_pbp,
    void* out_pbv, void* out_cand, void* out_idx, int n_swarms, int n, int d,
    int row_offset, int rows_per_cta, int vec_d, void* stream) {
  if (n_swarms > 0 && n > 0) {
    if (rows_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + rows_per_cta - 1) / rows_per_cta, n_swarms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto kernel = vec_d ? swarm_pbest_local_kernel<true> : swarm_pbest_local_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(pos), static_cast<const float*>(pbp),
        static_cast<const float*>(pbv), static_cast<const float*>(fit),
        static_cast<float*>(out_pbp), static_cast<float*>(out_pbv),
        static_cast<float*>(out_cand), static_cast<int*>(out_idx), n, d, row_offset,
        rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

// pos, vel, pbp [B, n, d]; r1, r2 [B, n]; win [B, d + 1]; gbp [B, d]; gbv,
// gpv, w [B]. Outputs: out_big 2*B*n*d floats, out_small B*d + 2*B floats,
// out_appended [B] bool, laid out as in the kernel. The g-best row takes d
// floats of dynamic shared memory (d <= 58,112 on Hopper).
extern "C" int gdpt_swarm_move(
    const void* pos, const void* vel, const void* pbp, const void* r1, const void* r2,
    const void* win, const void* gbp, const void* gbv, const void* gpv, const void* w,
    float w_cogn, float w_soci, void* out_big, void* out_small, void* out_appended,
    int n_swarms, int n, int d, int rows_per_cta, int vec_d, void* stream) {
  if (n_swarms > 0 && n > 0) {
    if (rows_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + rows_per_cta - 1) / rows_per_cta, n_swarms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto kernel = vec_d ? swarm_move_kernel<true> : swarm_move_kernel<false>;
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(pos), static_cast<const float*>(vel),
        static_cast<const float*>(pbp), static_cast<const float*>(r1),
        static_cast<const float*>(r2), static_cast<const float*>(win),
        static_cast<const float*>(gbp), static_cast<const float*>(gbv),
        static_cast<const float*>(gpv), static_cast<const float*>(w), w_cogn, w_soci,
        static_cast<float*>(out_big), static_cast<float*>(out_small),
        static_cast<unsigned char*>(out_appended), n_swarms, n, d, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}
